"""Divergence-recovery policy of the port's solve plane (counterpart of
``repro.core.recovery``).

The engine detects a bad solve in its loop (``SolveStatus.DIVERGED``, see
:mod:`.results`); this module says what to do about it. The ladder
executor lives in :mod:`repro_torch.api` (``_run_ladder``, ``recover``).
The escalation ladder, in order, each rung a principled fix:

1. **retry**: re-solve from the sanitized last-finite state.
2. **rho_restart**: scale the consensus penalty ``rho_c`` up, into the
   regime where bi-linear ADMM provably converges.
3. **precision**: escalate bf16 / fp16 data to fp32, then fp32 to the
   fp64 KKT polish (``runtime.escalation_ladder``; torch always has f64).
4. **x_solver**: swap an iterative x-update (pcg) for a direct
   factorization (woodbury / dense).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

__all__ = [
    "RecoveryPolicy",
    "RecoveryAttempt",
    "SolveDiverged",
    "sanitize_state",
]


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """What to try, and in what order, when a solve ends DIVERGED. Set on
    ``SolverOptions(recovery=...)`` to make ``api.solve`` and the
    estimators' ``fit`` recover; every attempt is logged in
    ``FitResult.recovery``."""

    max_attempts: int = 4          # total ladder rungs to run
    retry: bool = True             # rung: plain re-solve, last-finite state
    rho_restart: bool = True       # rung: scale rho_c by rho_scale
    rho_scale: float = 10.0
    precision_escalation: bool = True   # rung(s): bf16/fp16->fp32->fp64_polish
    solver_fallback: bool = True   # rung: pcg/auto -> woodbury/dense
    backoff_s: float = 0.0         # sleep backoff_s * 2**i before rung i

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("RecoveryPolicy.max_attempts must be >= 1")
        if self.rho_scale <= 1.0:
            raise ValueError("RecoveryPolicy.rho_scale must be > 1")
        if self.backoff_s < 0:
            raise ValueError("RecoveryPolicy.backoff_s must be >= 0")


class RecoveryAttempt(NamedTuple):
    """One recovery-ladder rung, as logged in ``FitResult.recovery``.
    ``stage="refactorize"`` is the streaming engine's rung: a failed
    Cholesky downdate, a non-finite accumulator or a post-divergence
    rebuild triggered a full refactorization from the replay window."""

    stage: str    # "retry" | "rho_restart" | "precision" | "x_solver"
                  # | "refactorize"
    detail: str   # the knob change, e.g. "rho_c=10" or "fp32"
    status: int   # SolveStatus code the attempt ended with
    iters: int    # outer iterations the attempt spent


class SolveDiverged(RuntimeError):
    """A solve ended DIVERGED and the recovery ladder (if any) could not
    bring it back. ``.result`` carries the last attempt's FitResult."""

    def __init__(self, message: str, result: Any = None):
        super().__init__(message)
        self.result = result


def sanitize_state(state):
    """The last-finite restart point: every non-finite entry of every
    floating field of ``state`` (a ``BiCADMMState``, its feature-split
    ``inner`` state too) is zeroed; a zero coordinate re-enters the solve
    cold, the finite ones keep their warm values. Counters and residuals
    are left to ``reset_for_resume``."""
    if state is None:
        return None

    def clean(leaf):
        if torch.is_tensor(leaf) and leaf.is_floating_point():
            return torch.where(torch.isfinite(leaf), leaf,
                               torch.zeros_like(leaf))
        if dataclasses.is_dataclass(leaf) and not isinstance(leaf, type):
            return type(leaf)(**{f.name: clean(getattr(leaf, f.name))
                                 for f in dataclasses.fields(leaf)})
        return leaf

    return type(state)(*(clean(f) for f in state))
