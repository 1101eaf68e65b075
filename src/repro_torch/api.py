"""Estimator front-end of the port (counterpart of ``repro.api``), on the
reference engine.

>>> from repro_torch.api import SparseLinearRegression
>>> model = SparseLinearRegression(kappa=20, gamma=10.0)   # runs on "cuda"
>>> model.fit(X, y).score(X, y)            # X: (samples, n) or (N, m, n)
>>> SparseLinearRegression(kappa=20, device="cpu")          # asks for the CPU

Entry points run on the card unless the caller asks for the CPU: with
``device=None`` and no CUDA device they raise ``RuntimeError``. What this
slice has not ported raises :class:`CapabilityError` up front: the other
three estimators, the sharded engine and meshes, the feature-split
sub-solver, ``projection="sort"``, precisions other than ``"fp32"``,
per-solve ``gamma``/``rho_c`` overrides, divergence recovery, and the
path, grid, fleet, serving and streaming entry points.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from . import runtime
from .core.bicadmm import BiCADMM, BiCADMMConfig
from .core.losses import Loss, get_loss
from .core.prox import XSOLVERS
from .core.results import FitResult, SolveStatus
from .runtime import CapabilityError

__all__ = ["CapabilityError", "Capabilities", "FitResult", "SolveStatus",
           "SolverOptions", "SparseEstimator", "SparseLinearRegression",
           "SparseLogisticRegression", "SparseProblem", "SparseSVM",
           "SparseSoftmaxRegression", "engine_capabilities", "solve",
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

    def resolve_loss(self) -> Loss:
        """The :class:`Loss` this problem names (unported losses raise
        :class:`CapabilityError`)."""
        if isinstance(self.loss, Loss):
            return self.loss
        return get_loss(self.loss, self.n_classes)


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """HOW to solve it. ``device`` is where the solve runs: ``None`` (the
    card) or ``"cuda"``, or ``"cpu"`` when asked for explicitly."""
    engine: str = "auto"
    mesh: Any = None
    max_iter: int = 300
    tol: float = 1e-4
    zt_iters: int = 120
    x_solver: str = "auto"
    n_feature_blocks: int = 1
    cg_iters: int = 200
    cg_tol: float = 1e-6
    force_feature_split: bool = False
    projection: str = "ladder"
    polish: bool = True
    over_relax: float = 1.0
    precision: Any = "fp32"
    divergence_tol: float = 1e12
    recovery: Any = None
    device: Any = None

    def __post_init__(self):
        object.__setattr__(self, "precision",
                           runtime.resolve_precision(self.precision))
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; expected one "
                             f"of {ENGINES}")
        if self.projection not in ("ladder", "sort"):
            raise ValueError(f"unknown projection mode {self.projection!r}")
        if self.x_solver not in XSOLVERS:
            raise ValueError(f"unknown x_solver {self.x_solver!r}; expected "
                             f"one of {XSOLVERS}")
        if self.divergence_tol <= 0:
            raise ValueError("divergence_tol must be positive")


@dataclasses.dataclass(frozen=True)
class Capabilities:
    """What the port's engine can do (see ``repro.api.Capabilities``)."""
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
    precisions: tuple = ("float32",)


def engine_capabilities(engine: str = "reference") -> Capabilities:
    """The reference engine's capabilities in this port; other engines
    raise :class:`CapabilityError`."""
    if engine != "reference":
        raise CapabilityError(f"engine {engine!r} is not ported to "
                              "repro_torch yet; use engine='reference'")
    return Capabilities(engine="reference", distributed=False,
                        dynamic_penalties=False, per_solve_overrides=False,
                        penalty_grids=False, grid_strategy=None,
                        gather_free=False)


def _check_options(options: SolverOptions) -> None:
    """Raise :class:`CapabilityError` for every option this slice has not
    ported."""
    unported = []
    if options.engine == "sharded" or options.mesh is not None:
        unported.append("the sharded engine (engine='sharded' / mesh=)")
    if options.n_feature_blocks > 1 or options.force_feature_split:
        unported.append("the feature-split sub-solver (n_feature_blocks > 1 "
                        "/ force_feature_split)")
    if options.projection != "ladder":
        unported.append(f"projection={options.projection!r}")
    if options.precision != runtime.PRECISION_PRESETS["fp32"]:
        unported.append(
            f"precision={runtime.precision_name(options.precision)!r}")
    if options.recovery is not None:
        unported.append("divergence recovery (recovery=)")
    if unported:
        raise CapabilityError("not ported to repro_torch yet: "
                              + "; ".join(unported))


def build_config(problem: SparseProblem,
                 options: SolverOptions) -> BiCADMMConfig:
    """Fold a (problem, options) pair into the engine's config."""
    return BiCADMMConfig(
        kappa=problem.kappa, gamma=problem.gamma, rho_c=problem.rho_c,
        alpha=problem.alpha, rho_b=problem.rho_b,
        max_iter=options.max_iter, tol=options.tol,
        divergence_tol=options.divergence_tol, zt_iters=options.zt_iters,
        polish=options.polish, over_relax=options.over_relax,
        x_solver=options.x_solver, cg_iters=options.cg_iters,
        cg_tol=options.cg_tol, precision=options.precision)


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------
def _as_tensor(a, device: torch.device) -> torch.Tensor:
    t = torch.as_tensor(a)
    if t.dtype == torch.float64:
        t = t.to(torch.float32)       # the fp32 policy's data dtype
    return t.to(device)


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
    if X.is_floating_point() and not bool(torch.isfinite(X).all()):
        raise ValueError("X contains non-finite entries (NaN or Inf); "
                         "clean or impute the data before fitting")
    if y.is_floating_point() and not bool(torch.isfinite(y).all()):
        raise ValueError("y contains non-finite entries (NaN or Inf); "
                         "clean or impute the targets before fitting")


def _stack(X, y, device: torch.device):
    """(samples, n) or (N, m, n) data on ``device`` in the stacked layout."""
    X, y = _as_tensor(X, device), _as_tensor(y, device)
    if X.ndim not in (2, 3):
        raise ValueError(f"X must be (samples, n) or (N, m, n); "
                         f"got shape {tuple(X.shape)}")
    validate_data(X, y)
    if X.ndim == 2:
        X, y = X[None], y.reshape(1, -1)
    if X.dtype != torch.float32:
        raise CapabilityError(f"X has dtype {X.dtype}; this slice fits "
                              "float32 data")
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
        _check_options(options)
        self.caps = engine_capabilities("reference")
        self.device = runtime.resolve_device(options.device)
        self.solver = BiCADMM(problem.resolve_loss(),
                              build_config(problem, options))

    def fit(self, As, bs, *, kappa=None, gamma=None, rho_c=None,
            state=None) -> FitResult:
        if gamma is not None or rho_c is not None:
            raise CapabilityError(
                "per-solve gamma/rho_c overrides need the spectral factors "
                "of a later slice; build a new problem instead")
        if state is None and kappa is None:
            return self.solver.fit(As, bs)
        state = state if state is not None else self.solver.init_state(As, bs)
        return self.solver.run_from(As, bs, state, kappa=kappa)


def solve(problem: SparseProblem, X, y, *,
          options: SolverOptions | None = None, state=None) -> FitResult:
    """Solve one :class:`SparseProblem` on ``(X, y)``; ``state=``
    warm-starts from a previous result's ``.state``."""
    options = options if options is not None else SolverOptions()
    adapter = _ReferenceAdapter(problem, options)
    As, bs = _stack(X, y, adapter.device)
    return adapter.fit(As, bs, state=state)


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
    """Base estimator: a :class:`SparseProblem` on the reference engine,
    with sklearn-shaped ``fit`` / ``predict`` / ``score``. ``device=``
    (or ``options=SolverOptions(device=...)``) says where it runs."""
    _loss_name: str = "squared"

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
        self._adapter = _ReferenceAdapter(self.problem, self.options)
        self.result_: FitResult | None = None

    @property
    def device(self) -> torch.device:
        """The device this estimator fits and predicts on."""
        return self._adapter.device

    def fit(self, X, y, *, state=None) -> "SparseEstimator":
        """Fit on ``(X, y)``; ``state=`` warm-starts from a previous
        result's ``.state``. Returns ``self``."""
        As, bs = _stack(X, y, self.device)
        res = self._adapter.fit(As, bs, state=state)
        self.result_ = res
        self.coef_ = res.coef[:, 0]
        self.support_ = res.support
        self.n_iter_ = int(res.iters)
        self.engine_ = self._adapter.name
        self.capabilities_ = self._adapter.caps
        return self

    partial_fit = _unported("SparseEstimator.partial_fit")
    fit_path = _unported("SparseEstimator.fit_path")
    fit_grid = _unported("SparseEstimator.fit_grid")

    def _scores(self, X) -> torch.Tensor:
        if self.result_ is None:
            raise RuntimeError("estimator is not fitted; call fit() first")
        X = _as_tensor(X, self.device)
        if X.ndim == 3:
            X = X.reshape(-1, X.shape[-1])
        return (X @ self.result_.coef)[:, 0]

    def decision_function(self, X) -> torch.Tensor:
        """Raw decision values (the fitted response for regression)."""
        return self.problem.resolve_loss().decision(self._scores(X))

    def predict(self, X) -> torch.Tensor:
        """Predicted targets."""
        return self.problem.resolve_loss().predict(self._scores(X))

    def score(self, X, y) -> float:
        """R^2 of the prediction."""
        y = _as_tensor(y, self.device).reshape(-1)
        yhat = self.predict(X)
        ss_res = torch.sum((y - yhat) ** 2)
        ss_tot = torch.sum((y - torch.mean(y)) ** 2)
        return float(1.0 - ss_res / torch.clamp_min(ss_tot, 1e-30))


class SparseLinearRegression(SparseEstimator):
    """SLR: exact-l0 least squares (the paper's SLS experiments)."""
    _loss_name = "squared"


class _UnportedEstimator(SparseEstimator):
    def __init__(self, *args, **kwargs):
        raise CapabilityError(
            f"{type(self).__name__} is not ported to repro_torch yet (its "
            "loss needs the Newton-CG x-update); use the JAX package")


class SparseLogisticRegression(_UnportedEstimator):
    """SLogR — not ported yet (raises :class:`CapabilityError`)."""


class SparseSVM(_UnportedEstimator):
    """SSVM — not ported yet (raises :class:`CapabilityError`)."""


class SparseSoftmaxRegression(_UnportedEstimator):
    """SSR — not ported yet (raises :class:`CapabilityError`)."""


# functional entry points of the JAX api that wait for later slices
solve_path = _unported("solve_path")
solve_grid = _unported("solve_grid")
fit_many = _unported("fit_many")
serve = _unported("serve")
stream = _unported("stream")
recover = _unported("recover")
