"""Estimator front-end of the port (counterpart of ``repro.api``): the
reference engine and the sharded one.

>>> from repro_torch.api import SparseLinearRegression
>>> model = SparseLinearRegression(kappa=20, gamma=10.0)   # runs on "cuda"
>>> model.fit(X, y).score(X, y)            # X: (samples, n) or (N, m, n)
>>> SparseLinearRegression(kappa=20, device="cpu")          # asks for the CPU

The paper's four models are here — :class:`SparseLinearRegression`,
:class:`SparseLogisticRegression`, :class:`SparseSVM` and
:class:`SparseSoftmaxRegression` — with the direct x-update or the
feature-split sub-solver (``n_feature_blocks > 1``). Entry points run on the
card unless the caller asks for the CPU: with ``device=None`` and no CUDA
device they raise ``RuntimeError``. ``precision="bf16"`` / ``"fp16"`` fit
bf16 / fp16 data (or f32 data, which the engine casts once) through the
dense, Woodbury and PCG x-updates and Newton-CG, with f32 iterates.
``precision="fp64_polish"`` runs the (7b) projection's polish in f64.
``SolverOptions(engine="sharded", mesh=<DeviceMesh>)`` runs the sharded
engine (:class:`~repro_torch.core.sharded.ShardedBiCADMM`) on a
``torch.distributed`` (nodes, feat) grid, one process a rank, each rank
calling the same entry point on the same global data; ``engine="auto"``
picks it from the mesh and the data's shape (:func:`select_engine`).
Hyperparameter sweeps run through :func:`solve_path` / :func:`solve_grid` and
the estimators' ``fit_path`` / ``fit_grid`` (kappa, gamma and rho_c grids;
kappa only under the feature split), and one solve may override kappa,
gamma or rho_c. :func:`fit_many` fits a fleet of independent problems
(stacked arrays or a list of mixed shapes) in one lane-batched driver.
``SolverOptions(recovery=RecoveryPolicy())`` reruns a DIVERGED solve
through the escalation ladder (:func:`recover`; retry, rho restart,
precision, x-solver), logged in ``FitResult.recovery``. :func:`stream` and
the estimators' ``partial_fit`` fit a growing or sliding-window dataset
chunk by chunk over incrementally maintained factors.
What an engine cannot do raises :class:`CapabilityError` up front (the
sharded engine's per-solve overrides, penalty grids, fleets, streams and
fp16 data, as in the JAX package); so do the feature split under a reduced
precision on the reference engine and the serving plane (``serve``), which
the port has not ported.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from . import runtime
from .core.bicadmm import BiCADMM, BiCADMMConfig, BiCADMMState
from .core.fleet import fit_many as _ref_fit_many
from .core.fleet import fit_many_stacked as _ref_fit_many_stacked
from .core.losses import Loss, get_loss
from .core.path import fit_grid as _ref_fit_grid
from .core.path import fit_path as _ref_fit_path
from .core import prox
from .core.prox import XSOLVERS
from .core.recovery import (RecoveryAttempt, RecoveryPolicy, SolveDiverged,
                            sanitize_state)
from .core.results import FitResult, FleetResult, SolveStatus, SparsePath
from .core.sharded import PROJECTIONS as SHARDED_PROJECTIONS
from .core.sharded import X_UPDATE_MODES, ShardedBiCADMM
from .core.streaming import StreamingBiCADMM
from .kernels.ops import matvec_auto
from .runtime import CapabilityError

__all__ = ["CapabilityError", "Capabilities", "FitResult", "FleetResult",
           "RecoveryAttempt", "RecoveryPolicy", "SolveDiverged",
           "SolveStatus", "SolverOptions", "SparseEstimator",
           "SparseLinearRegression", "SparseLogisticRegression",
           "SparsePath", "SparseProblem", "SparseSVM",
           "SparseSoftmaxRegression", "StreamingSolver",
           "engine_capabilities", "fit_many", "make_adapter", "recover",
           "select_engine", "solve", "solve_grid", "solve_path", "stream",
           "validate_data"]

ENGINES = ("auto", "reference", "sharded")


@dataclasses.dataclass(frozen=True)
class SparseProblem:
    """WHAT to solve: loss, sparsity budget and penalty weights."""
    loss: Loss | str
    kappa: int
    n_classes: int = 1
    gamma: float = 1.0
    rho_c: float = 1.0
    alpha: float = 0.5          # rho_b = alpha * rho_c unless rho_b is set
    rho_b: float | None = None

    def __post_init__(self):
        if self.kappa < 1:
            raise ValueError(f"kappa must be >= 1, got {self.kappa}")
        if self.n_classes < 1:
            raise ValueError("n_classes must be >= 1")
        if self.gamma <= 0 or self.rho_c <= 0:
            raise ValueError("gamma and rho_c must be positive")
        if isinstance(self.loss, Loss):
            # a Loss instance carries its own class count: adopt it when
            # n_classes was left at the default, reject a contradiction
            if self.n_classes not in (1, self.loss.n_classes):
                raise ValueError(
                    f"n_classes={self.n_classes} contradicts the loss "
                    f"instance's n_classes={self.loss.n_classes}")
            object.__setattr__(self, "n_classes", self.loss.n_classes)
        name = self.loss if isinstance(self.loss, str) else self.loss.name
        if name.startswith("softmax") and self.n_classes < 2:
            raise ValueError("softmax needs n_classes >= 2")

    def resolve_loss(self) -> Loss:
        """The :class:`Loss` this problem names."""
        if isinstance(self.loss, Loss):
            return self.loss
        return get_loss(self.loss, self.n_classes)


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """HOW to solve it. ``device`` is where the solve runs: ``None`` (the
    card) or ``"cuda"``, or ``"cpu"`` when asked for explicitly. ``mesh``:
    a :class:`torch.distributed.device_mesh.DeviceMesh` with named
    dimensions ``nodes_axis`` (a name or a tuple of names) and
    ``feat_axis``, for the sharded engine; ``x_update`` and
    ``sharded_projection`` are its x-update and projection modes."""
    engine: str = "auto"
    mesh: Any = None
    max_iter: int = 300
    tol: float = 1e-4
    zt_iters: int = 120
    x_solver: str = "auto"
    x_update: str = "auto"
    n_feature_blocks: int = 1
    inner_iters: int = 15
    rho_l: float = 1.0
    newton_iters: int = 12
    cg_iters: int = 200
    cg_tol: float = 1e-6
    force_feature_split: bool = False
    projection: str = "ladder"
    sharded_projection: str = "ladder_exact"
    polish: bool = True
    over_relax: float = 1.0
    precision: Any = "fp32"
    divergence_tol: float = 1e12
    recovery: Any = None
    nodes_axis: str | tuple[str, ...] = "nodes"
    feat_axis: str = "feat"
    device: Any = None

    def __post_init__(self):
        object.__setattr__(self, "precision",
                           runtime.resolve_precision(self.precision))
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; expected one "
                             f"of {ENGINES}")
        if self.engine == "sharded" and self.mesh is None:
            raise ValueError("engine='sharded' requires a mesh")
        if self.engine == "reference" and self.mesh is not None:
            raise ValueError("a mesh requires engine='sharded' (or 'auto', "
                             "which selects the sharded engine from it)")
        if self.projection not in ("ladder", "sort"):
            raise ValueError(f"unknown projection mode {self.projection!r}")
        if self.sharded_projection not in SHARDED_PROJECTIONS:
            raise ValueError(
                f"unknown sharded projection {self.sharded_projection!r}; "
                f"expected one of {SHARDED_PROJECTIONS}")
        if self.x_solver not in XSOLVERS:
            raise ValueError(f"unknown x_solver {self.x_solver!r}; expected "
                             f"one of {XSOLVERS}")
        if self.x_update not in X_UPDATE_MODES:
            raise ValueError(f"unknown x_update mode {self.x_update!r}; "
                             f"expected one of {X_UPDATE_MODES}")
        if self.divergence_tol <= 0:
            raise ValueError("divergence_tol must be positive")
        if self.recovery is not None and not isinstance(self.recovery,
                                                        RecoveryPolicy):
            raise TypeError("recovery must be a RecoveryPolicy or None, "
                            f"got {type(self.recovery).__name__}")
        if self.mesh is not None:
            names = set(getattr(self.mesh, "mesh_dim_names", None) or ())
            nodes = (self.nodes_axis if isinstance(self.nodes_axis, tuple)
                     else (self.nodes_axis,))
            missing = (set(nodes) | {self.feat_axis}) - names
            if missing:
                raise ValueError(f"mesh lacks the axis name(s) "
                                 f"{sorted(missing)}; has {sorted(names)}")

    @property
    def use_feature_split(self) -> bool:
        """Whether these options take the reference engine's feature-split
        sub-solver."""
        return self.n_feature_blocks > 1 or self.force_feature_split


@dataclasses.dataclass(frozen=True)
class Capabilities:
    """What an engine can do (see ``repro.api.Capabilities``). On the
    reference engine ``grid_strategy`` is ``"vmap"``: a grid's points run
    together on a lane axis (``"cold-scan"`` under the feature split, whose
    per-point factors and inner state have no lane axis); the sharded
    engine runs a grid as a cold scan. ``fleet``: ``fit_many``, and
    ``stream``: ``partial_fit`` / :func:`stream`, both off under the feature
    split and on the sharded engine, as in the JAX package."""
    engine: str
    distributed: bool
    dynamic_penalties: bool
    per_solve_overrides: bool
    penalty_grids: bool
    grid_strategy: str | None
    gather_free: bool
    warm_start: bool = True
    fleet: bool = False
    serve: bool = False
    stream: bool = False
    precisions: tuple = ("float32", "bfloat16", "float16")


def engine_capabilities(engine: str = "reference",
                        options: SolverOptions | None = None
                        ) -> Capabilities:
    """The :class:`Capabilities` of ``engine`` under ``options`` (defaults
    when omitted). The feature split bakes the penalties into its per-block
    factors, so with it only kappa may change between solves; the sharded
    engine bakes them into its per-rank factors too, and certifies float32
    and bfloat16 data (fp16's narrow exponent underflows the psum'd ladder
    statistics on badly scaled shards), as in the JAX package."""
    options = options if options is not None else SolverOptions()
    if engine == "reference":
        dyn = not options.use_feature_split
        return Capabilities(engine="reference", distributed=False,
                            dynamic_penalties=dyn, per_solve_overrides=True,
                            penalty_grids=dyn,
                            grid_strategy="vmap" if dyn else "cold-scan",
                            gather_free=False, fleet=dyn, stream=dyn)
    if engine == "sharded":
        return Capabilities(
            engine="sharded", distributed=True, dynamic_penalties=False,
            per_solve_overrides=False, penalty_grids=False,
            grid_strategy="cold-scan",
            gather_free=options.sharded_projection != "exact",
            precisions=("float32", "bfloat16"))
    raise ValueError(f"unknown engine {engine!r}")


def _mesh_sizes(options: SolverOptions) -> tuple[int, int]:
    """(N, M): the node and feature extents of ``options.mesh``."""
    shape = dict(zip(options.mesh.mesh_dim_names, options.mesh.mesh.shape))
    nodes = (options.nodes_axis if isinstance(options.nodes_axis, tuple)
             else (options.nodes_axis,))
    N = 1
    for a in nodes:
        N *= shape[a]
    return N, shape[options.feat_axis]


def select_engine(options: SolverOptions, *, n_samples: int | None = None,
                  n_features: int | None = None) -> str:
    """Resolve ``options.engine`` (``repro.api.select_engine``): ``"auto"``
    picks the sharded engine when a mesh of more than one rank is given and
    the data's shape fits its layout (rows divisible over the nodes, at
    least one column a feature block), else the reference engine."""
    if options.engine != "auto":
        return options.engine
    if options.mesh is None:
        return "reference"
    N, M = _mesh_sizes(options)
    if N * M == 1:
        return "reference"      # one rank adds collectives, not speed
    if n_samples is not None and n_samples % N != 0:
        return "reference"      # rows do not tile the node axis
    if n_features is not None and n_features < M:
        return "reference"      # fewer columns than feature blocks
    return "sharded"


def _check_sweep(caps: Capabilities, gammas, rho_cs) -> None:
    if (gammas is not None or rho_cs is not None) and not caps.penalty_grids:
        raise CapabilityError(
            f"the {caps.engine!r} engine (as configured) supports "
            "kappa-only sweeps: penalty-dependent factors are baked in at "
            "setup, so gammas=/rho_cs= grids are unavailable "
            "(Capabilities.penalty_grids=False)")


def _check_fleet(caps: Capabilities) -> None:
    if not caps.fleet:
        raise CapabilityError(
            f"the {caps.engine!r} engine (as configured) does not support "
            "fleet fitting (Capabilities.fleet=False): fit_many needs the "
            "lane-batched masked driver — use the reference engine with "
            "n_feature_blocks=1")


def _check_stream(caps: Capabilities) -> None:
    if not caps.stream:
        raise CapabilityError(
            f"the {caps.engine!r} engine (as configured) cannot stream "
            "(Capabilities.stream=False): partial_fit maintains the "
            "x-update factors incrementally, which needs the reference "
            "engine with n_feature_blocks=1")


def _check_precision(caps: Capabilities, options: SolverOptions) -> None:
    """Raise :class:`CapabilityError` when the engine does not certify the
    policy's data dtype (as ``repro.api._check_precision``)."""
    pol = options.precision
    data = pol.data if pol.data is not None else "float32"
    if data not in caps.precisions:
        raise CapabilityError(
            f"the {caps.engine!r} engine does not certify data dtype "
            f"{data!r} (precision policy {runtime.precision_name(pol)!r}); "
            f"certified dtypes: {caps.precisions} "
            "(Capabilities.precisions)")


def build_config(problem: SparseProblem,
                 options: SolverOptions) -> BiCADMMConfig:
    """Fold a (problem, options) pair into the engine's config."""
    return BiCADMMConfig(
        kappa=problem.kappa, gamma=problem.gamma, rho_c=problem.rho_c,
        alpha=problem.alpha, rho_b=problem.rho_b,
        max_iter=options.max_iter, tol=options.tol,
        divergence_tol=options.divergence_tol, zt_iters=options.zt_iters,
        n_feature_blocks=options.n_feature_blocks,
        inner_iters=options.inner_iters, rho_l=options.rho_l,
        newton_iters=options.newton_iters, polish=options.polish,
        over_relax=options.over_relax,
        force_feature_split=options.force_feature_split,
        projection=options.projection,
        x_solver=options.x_solver, cg_iters=options.cg_iters,
        cg_tol=options.cg_tol, precision=options.precision)


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------
def _as_tensor(a, device: torch.device | None) -> torch.Tensor:
    """``a`` as a tensor on ``device`` (where it lies when None)."""
    t = torch.as_tensor(a)
    if t.dtype == torch.float64:
        t = t.to(torch.float32)       # the fp32 policy's data dtype
    return t if device is None else t.to(device)


def validate_data(X: torch.Tensor, y: torch.Tensor) -> None:
    """One clear ``ValueError`` for data the solver cannot fit: empty or
    mismatched shapes, non-finite entries."""
    if X.numel() == 0:
        raise ValueError(f"X is empty (shape {tuple(X.shape)}); there is "
                         "nothing to fit")
    n_rows = X.shape[0] if X.ndim == 2 else X.shape[0] * X.shape[1]
    if y.numel() != n_rows:
        raise ValueError(
            f"y has {y.numel()} targets but X has {n_rows} sample rows "
            f"(X shape {tuple(X.shape)}, y shape {tuple(y.shape)})")
    # the extremes are non-finite exactly when an entry is: no temporary of
    # X's size (X may fill a good part of the card)
    if X.is_floating_point() and not bool(
            torch.isfinite(torch.stack(torch.aminmax(X))).all()):
        raise ValueError("X contains non-finite entries (NaN or Inf); "
                         "clean or impute the data before fitting")
    if y.is_floating_point() and not bool(torch.isfinite(y).all()):
        raise ValueError("y contains non-finite entries (NaN or Inf); "
                         "clean or impute the targets before fitting")


def _stack(X, y, device: torch.device | None,
           precision: runtime.PrecisionPolicy):
    """(samples, n) or (N, m, n) data on ``device`` (where it lies when
    None) in the stacked layout: float32, or already in the precision
    policy's data dtype (bf16 / fp16 data that the engine reads as it
    is)."""
    X, y = _as_tensor(X, device), _as_tensor(y, device)
    if X.ndim not in (2, 3):
        raise ValueError(f"X must be (samples, n) or (N, m, n); "
                         f"got shape {tuple(X.shape)}")
    validate_data(X, y)
    if X.ndim == 2:
        X, y = X[None], y.reshape(1, -1)
    data = precision.data_dtype(torch.float32)
    if X.dtype not in (torch.float32, data):
        raise CapabilityError(
            f"X has dtype {X.dtype}; precision "
            f"{runtime.precision_name(precision)!r} fits float32 data"
            + ("" if data == torch.float32 else f" or {data} data"))
    # hand back the caller's own tensors where no reshape or cast is needed,
    # so the solver's setup cache (keyed on tensor identity) hits on refits
    if tuple(y.shape) != tuple(X.shape[:2]):
        y = y.reshape(X.shape[0], X.shape[1])
    return X, y.to(X.dtype)


# --------------------------------------------------------------------------
# the engine adapter and the functional entry point
# --------------------------------------------------------------------------
class _ReferenceAdapter:
    """The reference engine behind the uniform surface."""
    name = "reference"

    def __init__(self, problem: SparseProblem, options: SolverOptions):
        self.caps = engine_capabilities("reference", options)
        _check_precision(self.caps, options)
        self.device = runtime.resolve_device(options.device)
        self.solver = BiCADMM(problem.resolve_loss(),
                              build_config(problem, options))

    def place(self, As, bs):
        """The stacked data on the engine's device."""
        return As.to(self.device), bs.to(self.device)

    def fit(self, As, bs, *, kappa=None, gamma=None, rho_c=None,
            state=None) -> FitResult:
        """One solve; overrides / ``state`` route through ``run_from``
        (a gamma / rho_c override under the feature split raises the
        engine's ``ValueError``)."""
        overrides = dict(kappa=kappa, gamma=gamma, rho_c=rho_c)
        if state is None and all(v is None for v in overrides.values()):
            return self.solver.fit(As, bs)
        state = state if state is not None else self.solver.init_state(As, bs)
        return self.solver.run_from(As, bs, state, **overrides)

    def fit_path(self, As, bs, kappas, *, gammas=None, rho_cs=None,
                 warm_start=True) -> SparsePath:
        """Warm-started hyperparameter path."""
        _check_sweep(self.caps, gammas, rho_cs)
        return _ref_fit_path(self.solver, As, bs, kappas, gammas=gammas,
                             rho_cs=rho_cs, warm_start=warm_start)

    def fit_grid(self, As, bs, kappas, *, gammas=None, rho_cs=None
                 ) -> SparsePath:
        """Independent cold fits of the grid, on a lane axis."""
        _check_sweep(self.caps, gammas, rho_cs)
        return _ref_fit_grid(self.solver, As, bs, kappas, gammas=gammas,
                             rho_cs=rho_cs)

    def fit_many_stacked(self, As, bs, *, kappas=None, gammas=None,
                         rho_cs=None, states=None,
                         iter_caps=None) -> FleetResult:
        """Stacked fleet fit (capability-checked adapter entry)."""
        _check_fleet(self.caps)
        return _ref_fit_many_stacked(self.solver, As, bs, kappas=kappas,
                                     gammas=gammas, rho_cs=rho_cs,
                                     states=states, iter_caps=iter_caps)

    def fit_many(self, problems, *, kappas=None, gammas=None,
                 rho_cs=None, on_bucket=None) -> list[FitResult]:
        """Heterogeneous fleet fit (capability-checked adapter entry)."""
        _check_fleet(self.caps)
        return _ref_fit_many(self.solver, problems, kappas=kappas,
                             gammas=gammas, rho_cs=rho_cs,
                             on_bucket=on_bucket)


class _ShardedAdapter:
    """The sharded engine behind the uniform surface
    (``repro.api._ShardedAdapter``): every rank calls it with the same
    global data, re-flattened to the (N m, n) rows the grid splits; each
    rank moves only its block to its device."""
    name = "sharded"

    def __init__(self, problem: SparseProblem, options: SolverOptions):
        self.caps = engine_capabilities("sharded", options)
        _check_precision(self.caps, options)
        self.device = runtime.resolve_device(options.device)
        self.solver = ShardedBiCADMM(
            problem.resolve_loss(), build_config(problem, options),
            options.mesh, nodes_axis=options.nodes_axis,
            feat_axis=options.feat_axis,
            projection=options.sharded_projection,
            x_update=options.x_update, device=self.device)

    @staticmethod
    def place(As, bs):
        """The data where it lies: the engine cuts each rank's block."""
        return As, bs

    @staticmethod
    def _flat(As, bs):
        N, m, n = As.shape
        return As.reshape(N * m, n), bs.reshape(-1)

    def fit(self, As, bs, *, kappa=None, gamma=None, rho_c=None,
            state=None, **kw) -> FitResult:
        """One sharded solve (no per-solve hyperparameter overrides)."""
        if not (kappa is None and gamma is None and rho_c is None):
            raise CapabilityError(
                "per-solve kappa/gamma/rho_c overrides are unavailable on "
                "the sharded engine (Capabilities.per_solve_overrides="
                "False): penalties are baked into its cached per-rank "
                "factors — use fit_path for kappa sweeps, or a new problem")
        A, b = self._flat(As, bs)
        return self.solver.fit(A, b, state=state, **kw)

    def fit_path(self, As, bs, kappas, *, gammas=None, rho_cs=None,
                 warm_start=True, **kw) -> SparsePath:
        """Warm-started kappa path."""
        _check_sweep(self.caps, gammas, rho_cs)
        A, b = self._flat(As, bs)
        return self.solver.fit_path(A, b, kappas, warm_start=warm_start,
                                    **kw)

    def fit_grid(self, As, bs, kappas, *, gammas=None, rho_cs=None
                 ) -> SparsePath:
        """Independent cold fits of the grid: a sequential cold scan
        (``.strategy`` says "cold-scan")."""
        _check_sweep(self.caps, gammas, rho_cs)
        A, b = self._flat(As, bs)
        return self.solver.fit_path(A, b, kappas, warm_start=False)

    def fit_many_stacked(self, As, bs, **kw) -> FleetResult:
        """Fleets are a reference-engine capability: raises
        :class:`CapabilityError`."""
        _check_fleet(self.caps)

    def fit_many(self, problems, **kw) -> list[FitResult]:
        """Unsupported on the sharded engine: raises
        :class:`CapabilityError`."""
        _check_fleet(self.caps)


def make_adapter(problem: SparseProblem, options: SolverOptions,
                 engine: str | None = None):
    """The engine adapter (and its solver; every configuration check
    happens here, at construction)."""
    engine = engine if engine is not None else select_engine(options)
    if engine == "reference":
        return _ReferenceAdapter(problem, options)
    if engine == "sharded":
        if options.mesh is None:
            raise ValueError("engine='sharded' requires a mesh")
        return _ShardedAdapter(problem, options)
    raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")


def _data(problem: SparseProblem, options: SolverOptions, X, y,
          adapter_for=None):
    """(adapter, As, bs): the stacked data, the engine negotiated from its
    shape (``adapter_for(engine)`` builds its adapter; ``make_adapter`` by
    default), and the data placed for that engine."""
    As, bs = _stack(X, y, None, options.precision)
    N, m, n = As.shape
    engine = select_engine(options, n_samples=N * m, n_features=n)
    adapter = (adapter_for(engine) if adapter_for is not None
               else make_adapter(problem, options, engine))
    return (adapter, *adapter.place(As, bs))


def _diverged(res: FitResult) -> bool:
    return (res.status is not None
            and int(res.status) == int(SolveStatus.DIVERGED))


def solve(problem: SparseProblem, X, y, *,
          options: SolverOptions | None = None, state=None) -> FitResult:
    """Solve one :class:`SparseProblem` on ``(X, y)``; ``state=``
    warm-starts from a previous result's ``.state``. With
    ``SolverOptions(recovery=RecoveryPolicy(...))`` a solve that ends
    DIVERGED is rerun through the escalation ladder (:func:`recover`),
    every attempt logged in ``FitResult.recovery``."""
    options = options if options is not None else SolverOptions()
    adapter, As, bs = _data(problem, options, X, y)
    res = adapter.fit(As, bs, state=state)
    if options.recovery is not None and _diverged(res):
        res = _run_ladder(problem, options, As, bs, failed=res,
                          policy=options.recovery)
    return res


# --------------------------------------------------------------------------
# divergence recovery: the escalation ladder
# --------------------------------------------------------------------------
def _ladder_plan(problem: SparseProblem, options: SolverOptions,
                 policy: RecoveryPolicy, n: int, overrides: dict):
    """The rungs to try, in order: ``(stage, detail, problem, options)``,
    cut to ``policy.max_attempts`` (``repro.api._ladder_plan``). Each rung
    bakes its fix into the problem / options pair, so the rung's solver
    runs the changed configuration (and a fault can target it by
    config)."""
    plan = []
    if policy.retry:
        plan.append(("retry", "same configuration", problem, options))
    if policy.rho_restart:
        base = overrides.get("rho_c") or problem.rho_c
        rho = base * policy.rho_scale
        plan.append(("rho_restart", f"rho_c={rho:g}",
                     dataclasses.replace(problem, rho_c=rho), options))
    if policy.precision_escalation:
        for preset in runtime.escalation_ladder(options.precision):
            plan.append(("precision", preset, problem,
                         dataclasses.replace(options, precision=preset)))
    if policy.solver_fallback and problem.resolve_loss().name == "squared":
        fallback = "dense" if n <= prox.DENSE_MAX_N else "woodbury"
        if fallback != options.x_solver:
            plan.append(("x_solver", fallback, problem,
                         dataclasses.replace(options, x_solver=fallback)))
    return plan[:policy.max_attempts]


def _ladder_adapter(problem: SparseProblem, options: SolverOptions,
                    cache: dict | None):
    """The reference adapter of one ladder rung, memoized in ``cache``
    when one is given (a caller that retries many lanes builds each rung's
    solver once)."""
    if cache is None:
        return _ReferenceAdapter(problem, options)
    key = (problem.kappa, problem.gamma, problem.rho_c, problem.alpha,
           problem.rho_b, problem.n_classes,
           getattr(problem.loss, "name", problem.loss), options.x_solver,
           runtime.precision_name(options.precision), options.max_iter,
           options.tol, options.divergence_tol, str(options.device))
    if key not in cache:
        cache[key] = _ReferenceAdapter(problem, options)
    return cache[key]


def _run_ladder(problem: SparseProblem, options: SolverOptions, As, bs, *,
                failed: FitResult | None, policy: RecoveryPolicy,
                overrides: dict | None = None,
                adapter_cache: dict | None = None) -> FitResult:
    """Run the recovery ladder on stacked data: the first attempt that
    does not end DIVERGED (its log in ``.recovery``), or the last one,
    still DIVERGED, when every rung failed. ``overrides``: per-solve
    kappa / gamma / rho_c."""
    overrides = {k: v for k, v in (overrides or {}).items() if v is not None}
    attempts: list[RecoveryAttempt] = []
    state = None
    result = failed
    device = runtime.resolve_device(options.device)
    As, bs = As.to(device), bs.to(device)     # the rungs run the reference
    if failed is not None:
        attempts = list(failed.recovery or ())
        # a sharded engine's state does not carry over: a cold restart
        state = (sanitize_state(failed.state)
                 if isinstance(failed.state, BiCADMMState) else None)
    plan = _ladder_plan(problem, options, policy, As.shape[2], overrides)
    for idx, (stage, detail, prob, opts) in enumerate(plan):
        if policy.backoff_s > 0:
            time.sleep(policy.backoff_s * (2 ** idx))
        over = dict(overrides)
        if stage == "rho_restart":
            over.pop("rho_c", None)   # the restarted rho is baked in
        adapter = _ladder_adapter(prob, opts, adapter_cache)
        res = adapter.fit(As, bs, state=state, **over)
        attempts.append(RecoveryAttempt(stage, detail, int(res.status),
                                        int(res.iters)))
        result = res._replace(recovery=tuple(attempts))
        if not _diverged(res):
            return result
        state = sanitize_state(res.state)
    return result


def recover(problem: SparseProblem, X, y, *,
            options: SolverOptions | None = None,
            failed: FitResult | None = None,
            policy: RecoveryPolicy | None = None,
            kappa=None, gamma=None, rho_c=None) -> FitResult:
    """Run the divergence-recovery ladder for ``problem`` on ``(X, y)``
    (``repro.api.recover``): a **retry** from the sanitized last-finite
    state of ``failed``, a **rho restart** (rho_c scaled by
    ``policy.rho_scale``), **precision** escalation (bf16 / fp16 -> fp32
    -> fp64_polish) and an **x-solver** fallback to a direct factorization,
    each enabled by its :class:`RecoveryPolicy` flag. Returns the first
    attempt that does not end DIVERGED, or the last one; the log rides
    ``FitResult.recovery``."""
    options = options if options is not None else SolverOptions()
    policy = (policy if policy is not None
              else options.recovery or RecoveryPolicy())
    device = runtime.resolve_device(options.device)
    As, bs = _stack(X, y, device, options.precision)
    return _run_ladder(problem, options, As, bs, failed=failed,
                       policy=policy,
                       overrides=dict(kappa=kappa, gamma=gamma, rho_c=rho_c))


def solve_path(problem: SparseProblem, X, y, kappas, *,
               options: SolverOptions | None = None, gammas=None,
               rho_cs=None, warm_start: bool = True) -> SparsePath:
    """Warm-started hyperparameter path over ``kappas`` (and optional
    ``gammas`` / ``rho_cs`` grids of the same length)."""
    options = options if options is not None else SolverOptions()
    adapter, As, bs = _data(problem, options, X, y)
    return adapter.fit_path(As, bs, kappas, gammas=gammas, rho_cs=rho_cs,
                            warm_start=warm_start)


def solve_grid(problem: SparseProblem, X, y, kappas, *,
               options: SolverOptions | None = None, gammas=None,
               rho_cs=None) -> SparsePath:
    """Independent cold fits of every grid point; ``path.strategy`` says
    how the grid ran (``"vmap"``, or ``"cold-scan"`` under the feature
    split and on the sharded engine)."""
    options = options if options is not None else SolverOptions()
    adapter, As, bs = _data(problem, options, X, y)
    return adapter.fit_grid(As, bs, kappas, gammas=gammas, rho_cs=rho_cs)


def _stack_many(Xs, ys, device: torch.device):
    """Stacked fleet data on ``device`` in the (B, N, m, n) / (B, N, m)
    layout: ``(B, samples, n)`` (N = 1) or ``(B, N, m, n)``."""
    Xs, ys = _as_tensor(Xs, device), _as_tensor(ys, device)
    if Xs.ndim == 3:
        Xs = Xs[:, None]
    if Xs.ndim != 4:
        raise ValueError(f"stacked fleet data must be (B, samples, n) or "
                         f"(B, N, m, n); got shape {tuple(Xs.shape)}")
    validate_data(Xs.reshape(-1, Xs.shape[-1]), ys)
    return Xs, ys.reshape(Xs.shape[:3]).to(Xs.dtype)


def fit_many(problem: SparseProblem, Xs, ys, *, kappas=None, gammas=None,
             rho_cs=None, options: SolverOptions | None = None,
             states=None, iter_caps=None) -> FleetResult | list[FitResult]:
    """Fit a fleet of B independent instances of ``problem`` in one
    lane-batched driver (``repro.api.fit_many``).

    * Stacked arrays ``Xs (B, samples, n)`` or ``(B, N, m, n)`` with
      matching ``ys``: returns a :class:`FleetResult` (``result[i]`` is
      problem i's :class:`FitResult`). ``states`` warm-starts every lane
      from a previous fleet's ``.state``; ``iter_caps`` caps each lane's
      iterations below ``max_iter`` (a capped lane ends ``ABORTED``, a
      cap of 0 never steps).
    * Sequences ``Xs`` / ``ys`` of per-problem arrays of mixed shapes:
      bucketed by ``(N, n)``, zero-padded along the samples
      (``repro_torch.core.fleet``), one fleet a bucket; returns a list of
      :class:`FitResult` in input order.

    ``kappas`` / ``gammas`` / ``rho_cs`` are optional per-problem vectors.
    Fleets need the direct x-update on the reference engine
    (``Capabilities.fleet``; ``engine="sharded"`` raises
    :class:`CapabilityError`); the data is float32 and the fit runs on
    ``options.device``.
    """
    options = options if options is not None else SolverOptions()
    adapter = make_adapter(problem, options, engine="reference"
                           if options.engine == "auto" else options.engine)
    if isinstance(Xs, (list, tuple)):
        if not isinstance(ys, (list, tuple)) or len(ys) != len(Xs):
            raise ValueError("sequence input needs per-problem ys of the "
                             "same length as Xs")
        if states is not None or iter_caps is not None:
            raise ValueError("states=/iter_caps= require stacked-array "
                             "input (one shape signature)")
        problems = []
        for X, y in zip(Xs, ys):
            X, y = _as_tensor(X, adapter.device), _as_tensor(y,
                                                            adapter.device)
            validate_data(X, y)
            problems.append((X, y.to(X.dtype)))
        return adapter.fit_many(problems, kappas=kappas, gammas=gammas,
                                rho_cs=rho_cs)
    As, bs = _stack_many(Xs, ys, adapter.device)
    return adapter.fit_many_stacked(As, bs, kappas=kappas, gammas=gammas,
                                    rho_cs=rho_cs, states=states,
                                    iter_caps=iter_caps)


# --------------------------------------------------------------------------
# streaming: minibatch partial_fit over incrementally maintained factors
# --------------------------------------------------------------------------
class StreamingSolver:
    """Stateful streaming front-end over
    :class:`~repro_torch.core.streaming.StreamingBiCADMM`
    (``repro.api.StreamingSolver``): one growing (or sliding-window)
    dataset, fitted chunk by chunk through :meth:`partial_fit`. ``window``
    bounds the replay window in chunks (``None``: keep everything, ``0``:
    keep no rows, dense regime only); ``drift_tol`` tunes the drift probe.
    With ``SolverOptions(recovery=...)`` a refit still DIVERGED after the
    engine's refactorize rung goes through the recovery ladder on the
    replay window's data."""

    name = "streaming"

    def __init__(self, problem: SparseProblem,
                 options: SolverOptions | None = None, *,
                 window: int | None = None, drift_tol: float = 0.5):
        options = options if options is not None else SolverOptions()
        engine = "reference" if options.engine == "auto" else options.engine
        self.caps = engine_capabilities(engine, options)
        _check_stream(self.caps)
        _check_precision(self.caps, options)
        self.problem = problem
        self.options = options
        self.device = runtime.resolve_device(options.device)
        self.engine = StreamingBiCADMM(
            problem.resolve_loss(), build_config(problem, options),
            window=window, drift_tol=drift_tol, device=self.device)

    @property
    def result(self) -> FitResult | None:
        """The latest refit's result (None before the first chunk)."""
        return self.engine.result

    @property
    def m_seen(self) -> int:
        """Total rows absorbed over the stream's lifetime."""
        return self.engine.m_seen

    @property
    def mode(self) -> str | None:
        """The resolved incremental regime (dense/woodbury/pcg/direct)."""
        return self.engine.mode

    def partial_fit(self, X, y, *, kappa=None, gamma=None,
                    rho_c=None) -> FitResult:
        """Absorb one ``(rows, n)`` chunk and refit warm-started; ``kappa``
        / ``gamma`` / ``rho_c`` override the problem for this refit only."""
        X, y = _as_tensor(X, self.device), _as_tensor(y, self.device)
        if X.ndim != 2:
            raise ValueError(f"streaming chunks must be (rows, n); "
                             f"got shape {tuple(X.shape)}")
        validate_data(X, y)
        res = self.engine.partial_fit(X, y, kappa=kappa, gamma=gamma,
                                      rho_c=rho_c)
        if (self.options.recovery is not None and _diverged(res)
                and self.engine._chunks):
            A_win, y_win = self.engine._window_data()
            res = _run_ladder(self.problem, self.options,
                              A_win[None], y_win.reshape(1, -1),
                              failed=res, policy=self.options.recovery,
                              overrides=dict(kappa=kappa, gamma=gamma,
                                             rho_c=rho_c))
            self.engine.adopt(res)
        return res


def stream(problem: SparseProblem, *, options: SolverOptions | None = None,
           window: int | None = None,
           drift_tol: float = 0.5) -> StreamingSolver:
    """Open a :class:`StreamingSolver` for ``problem``, the minibatch entry
    point (``Capabilities.stream``):

    >>> s = stream(SparseProblem(loss="squared", kappa=10, gamma=10.0))
    >>> for X_t, y_t in chunks:
    ...     res = s.partial_fit(X_t, y_t)     # incremental factor updates

    The feature split and the sharded engine cannot stream and raise
    :class:`CapabilityError`."""
    return StreamingSolver(problem, options, window=window,
                           drift_tol=drift_tol)


def _unported(what: str):
    def method(*args, **kwargs):
        raise CapabilityError(f"{what} is not ported to repro_torch yet; "
                              "use the JAX package (repro.api)")
    method.__name__ = what.split(".")[-1]
    method.__doc__ = "Not ported yet: raises :class:`CapabilityError`."
    return method


# --------------------------------------------------------------------------
# estimators
# --------------------------------------------------------------------------
class SparseEstimator:
    """Base estimator: a :class:`SparseProblem` on a negotiated engine
    (:func:`select_engine` from the options and the data's shape; an
    explicit engine is built, and checked, at construction), with
    sklearn-shaped ``fit`` / ``predict`` / ``score``. ``device=`` (or
    ``options=SolverOptions(device=...)``) says where it runs."""
    _loss_name: str = "squared"
    _score_kind: str = "r2"           # "r2" | "accuracy"

    def __init__(self, kappa: int, *, gamma: float = 1.0,
                 rho_c: float = 1.0, alpha: float = 0.5,
                 rho_b: float | None = None, n_classes: int = 1,
                 options: SolverOptions | None = None, device=None,
                 **option_kw):
        if options is not None and (option_kw or device is not None):
            raise ValueError("pass options=SolverOptions(...) or option "
                             "keywords, not both")
        self.problem = SparseProblem(
            loss=self._loss_name, kappa=kappa, n_classes=n_classes,
            gamma=gamma, rho_c=rho_c, alpha=alpha, rho_b=rho_b)
        self.options = (options if options is not None
                        else SolverOptions(device=device, **option_kw))
        self._adapters: dict = {}
        # the adapter of the last fit: the configured engine's until then
        self._adapter = self._adapter_named(
            "reference" if self.options.engine == "auto"
            else self.options.engine)
        self.result_: FitResult | None = None
        self._stream: StreamingSolver | None = None

    def _adapter_named(self, name: str):
        ad = self._adapters.get(name)
        if ad is None:
            ad = self._adapters[name] = make_adapter(self.problem,
                                                     self.options, name)
        return ad

    def _data(self, X, y):
        """(adapter, As, bs) of a fit, the adapter kept for the next call
        (module ``_data``)."""
        out = _data(self.problem, self.options, X, y, self._adapter_named)
        self._adapter = out[0]
        return out

    @property
    def device(self) -> torch.device:
        """The device this estimator fits and predicts on."""
        return self._adapter.device

    def fit(self, X, y, *, state=None) -> "SparseEstimator":
        """Fit on ``(X, y)``; ``state=`` warm-starts from a previous
        result's ``.state``. With ``options=SolverOptions(recovery=...)`` a
        DIVERGED fit reruns through the recovery ladder, as in
        :func:`solve`. Returns ``self``."""
        adapter, As, bs = self._data(X, y)
        res = adapter.fit(As, bs, state=state)
        if self.options.recovery is not None and _diverged(res):
            res = _run_ladder(self.problem, self.options, As, bs,
                              failed=res, policy=self.options.recovery)
        self._stream = None       # a full fit resets any open stream
        self._set_fitted(res)
        return self

    def partial_fit(self, X, y, *, window: int | None = None
                    ) -> "SparseEstimator":
        """Absorb one ``(rows, n)`` chunk and refit incrementally. The first
        call opens a :class:`StreamingSolver` (``window=`` bounds its replay
        window in chunks and is read on that call only); later calls stream
        into it: rank-k factor updates plus a warm-started refit, never a
        factorization from scratch. A full :meth:`fit` resets the stream.
        Returns ``self``."""
        if self._stream is None:
            self._stream = StreamingSolver(self.problem, self.options,
                                           window=window)
        self._set_fitted(self._stream.partial_fit(X, y),
                         engine=self._stream.name)
        return self

    def fit_path(self, X, y, kappas, *, gammas=None, rho_cs=None,
                 warm_start: bool = True) -> SparsePath:
        """Warm-started sweep; the estimator is left fitted on the LAST
        grid point (the sparsest, for descending kappa ladders)."""
        adapter, As, bs = self._data(X, y)
        path = adapter.fit_path(As, bs, kappas, gammas=gammas,
                                rho_cs=rho_cs, warm_start=warm_start)
        self._set_fitted(self._last_point(path))
        return path

    def fit_grid(self, X, y, kappas, *, gammas=None, rho_cs=None
                 ) -> SparsePath:
        """Independent cold fits; the estimator is left fitted on the last
        grid point."""
        adapter, As, bs = self._data(X, y)
        path = adapter.fit_grid(As, bs, kappas, gammas=gammas,
                                rho_cs=rho_cs)
        self._set_fitted(self._last_point(path))
        return path

    @staticmethod
    def _last_point(path: SparsePath) -> FitResult:
        return FitResult(path.coef[-1], path.z[-1], path.support[-1],
                         path.iters[-1], path.p_r[-1], path.d_r[-1],
                         path.b_r[-1], state=path.state,
                         status=path.status[-1])

    def _set_fitted(self, res: FitResult, engine: str | None = None
                    ) -> None:
        self.result_ = res
        K = self.problem.n_classes
        self.coef_ = res.coef[:, 0] if K == 1 else res.coef
        self.support_ = res.support
        self.n_iter_ = int(res.iters)
        self.engine_ = engine or self._adapter.name
        self.capabilities_ = self._adapter.caps

    def _scores(self, X) -> torch.Tensor:
        if self.result_ is None:
            raise RuntimeError("estimator is not fitted; call fit() first")
        X = _as_tensor(X, self.device)
        if X.ndim == 3:
            X = X.reshape(-1, X.shape[-1])
        coef = self.result_.coef                     # (n, K), f32
        # bf16 / fp16 X against the f32 coefficients: the matvec kernel,
        # which widens X as it reads it (no f32 copy of X), f32 out
        scores = (X @ coef if X.dtype == coef.dtype
                  else matvec_auto(X.contiguous(), coef))   # (samples, K)
        return scores[:, 0] if self.problem.n_classes == 1 else scores

    def decision_function(self, X) -> torch.Tensor:
        """Raw decision values: residual fit / margins / ``(m, C)``
        logits, per the loss's ``decision`` map."""
        return self.problem.resolve_loss().decision(self._scores(X))

    def predict(self, X) -> torch.Tensor:
        """Predicted targets: response (regression), {-1, +1} labels
        (margin losses) or argmax class labels (softmax)."""
        return self.problem.resolve_loss().predict(self._scores(X))

    def score(self, X, y) -> float:
        """R^2 for regression, accuracy for classification."""
        y = _as_tensor(y, self.device).reshape(-1)
        yhat = self.predict(X)
        if self._score_kind == "accuracy":
            return float(torch.mean((yhat == y).to(torch.float32)))
        ss_res = torch.sum((y - yhat) ** 2)
        ss_tot = torch.sum((y - torch.mean(y)) ** 2)
        return float(1.0 - ss_res / torch.clamp_min(ss_tot, 1e-30))


class SparseLinearRegression(SparseEstimator):
    """SLR: exact-l0 least squares (the paper's SLS experiments)."""
    _loss_name = "squared"


class SparseLogisticRegression(SparseEstimator):
    """SLogR: exact-l0 logistic regression, labels in {-1, +1}."""
    _loss_name = "logistic"
    _score_kind = "accuracy"


class SparseSVM(SparseEstimator):
    """SSVM: exact-l0 support vector machine. Defaults to the Huberized
    (smoothed) hinge; ``hinge="plain"`` takes the non-smooth hinge prox."""
    _loss_name = "smoothed_hinge"
    _score_kind = "accuracy"

    def __init__(self, kappa: int, *, hinge: str = "smoothed", **kw):
        if hinge not in ("smoothed", "plain"):
            raise ValueError(f"hinge must be 'smoothed' or 'plain', "
                             f"got {hinge!r}")
        self._loss_name = "smoothed_hinge" if hinge == "smoothed" else "hinge"
        super().__init__(kappa, **kw)


class SparseSoftmaxRegression(SparseEstimator):
    """SSR: exact-l0 softmax regression over C classes; ``coef_`` is
    ``(n, C)`` and ``kappa`` budgets the flattened ``(n*C,)`` vector."""
    _loss_name = "softmax"
    _score_kind = "accuracy"

    def __init__(self, kappa: int, n_classes: int, **kw):
        super().__init__(kappa, n_classes=n_classes, **kw)


# functional entry points of the JAX api that wait for later slices
serve = _unported("serve")
