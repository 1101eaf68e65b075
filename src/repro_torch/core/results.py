"""Result types of the port's solver (counterpart of
``repro.core.results``): :class:`SolveStatus`, the in-loop
:func:`divergence_probe`, :func:`classify_status`, :func:`mark_aborted`,
:class:`FitResult`, the fleet's :class:`FleetResult` and the stacked
:class:`SparsePath` of a hyperparameter sweep.
"""
from __future__ import annotations

import enum
from typing import Any, NamedTuple

import torch


class SolveStatus(enum.IntEnum):
    """How a solve ended. Stored on results as an int32 tensor."""

    CONVERGED = 0   # all three residuals under tol, iterates finite
    MAX_ITER = 1    # iteration budget exhausted before the tolerance
    DIVERGED = 2    # non-finite iterates or residual blow-up; loop exited
    ABORTED = 3     # stopped early by an external cap


def divergence_probe(state, divergence_tol) -> torch.Tensor:
    """``True`` once a solve has gone bad: a residual is non-finite, or the
    primal/dual residuals passed ``divergence_tol``. Fresh and resumed
    states carry ``inf`` residuals by construction, hence the ``k > 0``
    guard."""
    finite = (torch.isfinite(state.p_r) & torch.isfinite(state.d_r)
              & torch.isfinite(state.b_r))
    blown = (state.p_r > divergence_tol) | (state.d_r > divergence_tol)
    return (state.k > 0) & (~finite | blown)


def classify_status(iters, p_r, d_r, b_r, *, tol,
                    divergence_tol) -> torch.Tensor:
    """:class:`SolveStatus` code from the final residuals (int32 tensor,
    no device sync)."""
    finite = torch.isfinite(p_r) & torch.isfinite(d_r) & torch.isfinite(b_r)
    converged = finite & (p_r < tol) & (d_r < tol) & (b_r < tol)
    diverged = (iters > 0) & (~finite | (p_r > divergence_tol)
                              | (d_r > divergence_tol))
    code = torch.where(diverged, int(SolveStatus.DIVERGED),
                       int(SolveStatus.MAX_ITER))
    code = torch.where(converged, int(SolveStatus.CONVERGED), code)
    return code.to(torch.int32)


def mark_aborted(status, iters, iter_caps, max_iter) -> torch.Tensor:
    """Reclassify ``MAX_ITER`` lanes that a per-lane external iteration cap
    stopped (deadline caps, inert cap-0 padding) as ``ABORTED``.
    Elementwise, no device sync."""
    budget = torch.clamp_max(torch.as_tensor(iter_caps,
                                             device=status.device), max_iter)
    hit = ((status == int(SolveStatus.MAX_ITER)) & (budget < max_iter)
           & (iters >= budget))
    return torch.where(hit, int(SolveStatus.ABORTED), status).to(torch.int32)


def status_name(status) -> str:
    """Human-readable name of a scalar status code (syncs the scalar)."""
    return SolveStatus(int(status)).name


class FitResult(NamedTuple):
    """One solve. ``coef`` is ``(n, K)``; ``z`` and ``support`` stay on the
    flat ``(n*K,)`` layout the engine iterates in."""
    coef: torch.Tensor       # (n, K) final sparse solution (polished)
    z: torch.Tensor          # (n*K,) consensus iterate before thresholding
    support: torch.Tensor    # (n*K,) bool
    iters: torch.Tensor      # () outer iterations spent
    p_r: torch.Tensor        # primal residual (14)
    d_r: torch.Tensor        # dual residual
    b_r: torch.Tensor        # bi-linear constraint residual
    history: Any = None
    state: Any = None        # resumable solver state — warm-start the next
    status: Any = None       # () int32 SolveStatus code
    recovery: Any = None

    @property
    def x(self) -> torch.Tensor:
        """Flat ``(n*K,)`` view of ``coef``."""
        return self.coef.reshape(-1)

    @property
    def x_sparse(self) -> torch.Tensor:
        """Flat ``(n*K,)`` view of ``coef`` (the sharded engine's name)."""
        return self.coef.reshape(-1)

    @property
    def converged(self) -> bool:
        """Whether this solve ended :data:`SolveStatus.CONVERGED`."""
        return int(self.status) == int(SolveStatus.CONVERGED)

    @property
    def status_name(self) -> str | None:
        """Name of the status code (``"CONVERGED"`` …), or ``None``."""
        return None if self.status is None else status_name(self.status)


class FleetResult(NamedTuple):
    """B independent problems solved together (:mod:`.fleet`,
    ``repro_torch.api.fit_many``); leading axis = problem. Each lane has
    its own data, hyperparameters and stopping point. ``result[i]`` is the
    i-th problem's :class:`FitResult`, with its slice of the batched state
    (a solo ``run_from`` can resume from it)."""
    coef: torch.Tensor         # (B, n, K) sparse solutions
    z: torch.Tensor            # (B, n*K) consensus iterates
    support: torch.Tensor      # (B, n*K) bool
    iters: torch.Tensor        # (B,) outer iterations spent per problem
    p_r: torch.Tensor          # (B,)
    d_r: torch.Tensor          # (B,)
    b_r: torch.Tensor          # (B,)
    cardinality: torch.Tensor  # (B,) int32 ||coef_b||_0
    kappas: torch.Tensor       # (B,)
    gammas: torch.Tensor       # (B,)
    rho_cs: torch.Tensor       # (B,)
    train_loss: Any = None     # (B,) per-problem training loss
    state: Any = None          # batched solver state: warm-start the refit
    strategy: str | None = None  # "fleet-vmap"
    status: Any = None         # (B,) int32 SolveStatus codes

    def __len__(self) -> int:
        return int(self.coef.shape[0])

    def __getitem__(self, i: int) -> FitResult:
        """The i-th problem's solo-shaped :class:`FitResult` view."""
        state = None if self.state is None else type(self.state)(
            *(None if f is None else f[i] for f in self.state))
        status = None if self.status is None else self.status[i]
        return FitResult(self.coef[i], self.z[i], self.support[i],
                         self.iters[i], self.p_r[i], self.d_r[i],
                         self.b_r[i], history=None, state=state,
                         status=status)

    @property
    def x(self) -> torch.Tensor:
        """Flat ``(B, n*K)`` view of ``coef``."""
        return self.coef.reshape(self.coef.shape[0], -1)


class SparsePath(NamedTuple):
    """Stacked per-grid-point results of a sweep (:mod:`.path`); leading
    axis = grid index. The grids themselves stay on the host."""
    coef: torch.Tensor         # (P, n, K) sparse solutions
    z: torch.Tensor            # (P, n*K) consensus iterates
    support: torch.Tensor      # (P, n*K) bool
    iters: torch.Tensor        # (P,) outer iterations spent per point
    p_r: torch.Tensor          # (P,)
    d_r: torch.Tensor          # (P,)
    b_r: torch.Tensor          # (P,)
    cardinality: torch.Tensor  # (P,) int32 ||coef_p||_0
    kappas: torch.Tensor       # (P,) host tensors in the data dtype
    gammas: torch.Tensor       # (P,)
    rho_cs: torch.Tensor       # (P,)
    train_loss: Any = None     # (P,) sum-loss on the training data
    state: Any = None          # solver state after the last point
    strategy: str | None = None  # "warm-scan" | "cold-scan"
    status: Any = None         # (P,) int32 SolveStatus codes

    @property
    def x(self) -> torch.Tensor:
        """Flat ``(P, n*K)`` view of ``coef``."""
        return self.coef.reshape(self.coef.shape[0], -1)

    @property
    def x_sparse(self) -> torch.Tensor:
        """Flat ``(P, n*K)`` view of ``coef`` (the sharded engine's name)."""
        return self.coef.reshape(self.coef.shape[0], -1)
