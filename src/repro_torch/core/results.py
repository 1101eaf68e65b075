"""Result types of the port's solver (counterpart of
``repro.core.results``): :class:`SolveStatus`, the in-loop
:func:`divergence_probe`, :func:`classify_status` and :class:`FitResult`.
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
    def converged(self) -> bool:
        """Whether this solve ended :data:`SolveStatus.CONVERGED`."""
        return int(self.status) == int(SolveStatus.CONVERGED)

    @property
    def status_name(self) -> str | None:
        """Name of the status code (``"CONVERGED"`` …), or ``None``."""
        return None if self.status is None else status_name(self.status)
