"""Deterministic fault injection for the port's solve plane (counterpart of
``repro.faults``).

The solver asks this module for an *iterate hook* when it is built
(``active_hook(solver)`` in ``BiCADMM.__init__``). Outside an
:func:`inject` context the answer is ``None`` and the solver runs exactly
the healthy loop. Inside a context, solvers matching the injection's
``where`` predicate get the hook, which runs after every step of the
solver's own loop (solo and lane-batched alike), at a chosen iteration, in
a chosen lane: the place a real numerical blow-up would appear. A hook
captured at construction stays with that solver and never reaches solvers
built outside the context or beyond the injection's ``limit``.

The hooks act on the port's ``BiCADMMState`` (torch tensors, on any
device) with ``torch.where``: no host read. The module imports nothing of
``repro_torch``; it sits below ``core``.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Callable

import torch

__all__ = [
    "inject",
    "active_hook",
    "nan_x",
    "inf_x",
    "scale_dual",
    "failing",
    "deadline_storm",
]


class _Injection:
    """One active fault: a state hook, a solver predicate, a hook budget."""

    def __init__(self, hook, where, limit):
        self.hook = hook
        self.where = where
        self.limit = limit
        self.hooked: list[Any] = []   # solvers that received the hook
        self._lock = threading.Lock()

    def select(self, solver):
        with self._lock:
            if self.limit is not None and len(self.hooked) >= self.limit:
                return None
            if self.where is not None and not self.where(solver):
                return None
            self.hooked.append(solver)
            return self.hook


_ACTIVE: list[_Injection] = []


@contextlib.contextmanager
def inject(hook: Callable, *, where: Callable | None = None,
           limit: int | None = None):
    """Arm ``hook`` for solvers constructed inside the ``with`` block.

    ``hook``
        ``state -> state`` function applied after every solver step (built
        with :func:`nan_x` / :func:`inf_x` / :func:`scale_dual`), on solo
        ``()``-counter and lane ``(B,)``-counter states alike.
    ``where``
        Optional ``solver -> bool`` predicate; only matching solvers are
        hooked. Key on config knobs (``s.cfg.rho_c``, ``s.cfg.x_solver``,
        ``s.cfg.precision.data``) to make one recovery-ladder rung the
        genuine fix.
    ``limit``
        Maximum number of solvers to hook (``limit=1`` poisons the first
        solve and leaves the recovery ladder's solvers clean).

    Yields the injection record; ``.hooked`` lists the solvers that were
    poisoned. Injections nest: the innermost matching one wins.
    """
    entry = _Injection(hook, where, limit)
    _ACTIVE.append(entry)
    try:
        yield entry
    finally:
        _ACTIVE.remove(entry)


def active_hook(solver):
    """The hook the innermost matching active injection assigns to
    ``solver``, or ``None`` (always, outside any context)."""
    for entry in reversed(_ACTIVE):
        hook = entry.select(solver)
        if hook is not None:
            return hook
    return None


# ----------------------------------------------------------- state hooks --

def _trigger(state, at_iter, lane):
    """Boolean trigger shaped like ``state.k``: the iteration matches and
    (for lane states) the lane index matches."""
    trig = state.k == at_iter
    if lane is not None and trig.ndim == 1:
        trig = trig & (torch.arange(trig.shape[0],
                                    device=trig.device) == lane)
    return trig


def _masked(trig, arr):
    """``trig`` broadcast against ``arr``'s leading axes."""
    return trig.reshape(trig.shape + (1,) * (arr.ndim - trig.ndim))


def nan_x(at_iter: int, *, lane: int | None = None, value=math.nan):
    """Hook: overwrite the primal / consensus iterates (``x``, ``z``) and
    the dual ``u`` with ``value`` (NaN by default) on the step where the
    iteration counter equals ``at_iter`` (in one lane when ``lane`` is
    given). All three are hit because the solver recomputes ``x`` from
    ``(z, u)`` every step: a poisoned ``x`` alone would be repaired on the
    next iteration."""
    def hook(state):
        trig = _trigger(state, at_iter, lane)

        def poison(arr):
            return torch.where(_masked(trig, arr), value, arr)
        return state._replace(x=poison(state.x), z=poison(state.z),
                              u=poison(state.u))
    return hook


def inf_x(at_iter: int, *, lane: int | None = None):
    """Hook: overwrite ``x``, ``z`` and ``u`` with ``+inf`` at iteration
    ``at_iter``."""
    return nan_x(at_iter, lane=lane, value=math.inf)


def scale_dual(at_iter: int, scale: float = 1e30, *,
               lane: int | None = None):
    """Hook: multiply the consensus dual ``u`` by ``scale`` at iteration
    ``at_iter``: an exploding dual that stays finite for a few steps and is
    caught by the residual-blowup probe rather than the finiteness one."""
    def hook(state):
        mask = _masked(_trigger(state, at_iter, lane), state.u)
        return state._replace(u=torch.where(mask, state.u * scale, state.u))
    return hook


# ------------------------------------------------------ host-level faults --

@contextlib.contextmanager
def failing(obj, attr: str, exc: BaseException, *, times: int = 1):
    """Monkeypatch ``obj.attr`` (a callable) to raise ``exc`` for its first
    ``times`` calls, then delegate to the original: the solver-thread
    exception fault."""
    orig = getattr(obj, attr)
    budget = {"left": times}
    lock = threading.Lock()

    def wrapper(*args, **kwargs):
        with lock:
            fire = budget["left"] > 0
            if fire:
                budget["left"] -= 1
        if fire:
            raise exc
        return orig(*args, **kwargs)

    setattr(obj, attr, wrapper)
    try:
        yield
    finally:
        setattr(obj, attr, orig)


async def deadline_storm(service, X, y, *, count: int = 16,
                         deadline: float = 1e-4, **submit_kw):
    """Submit ``count`` near-instantly-expiring fits at once and gather
    every outcome (results and exceptions alike): the deadline-storm fault.
    ``service`` is anything with an async ``submit_fit(X, y, deadline=...)``
    (the serving plane, when it is ported). Returns the outcome list."""
    import asyncio

    futures = [service.submit_fit(X, y, deadline=deadline, **submit_kw)
               for _ in range(count)]
    return await asyncio.gather(*futures, return_exceptions=True)
