"""Streaming Bi-cADMM: minibatch fits with incrementally maintained factors
(counterpart of ``repro.core.streaming``).

:class:`StreamingBiCADMM` absorbs data in row chunks through
:meth:`~StreamingBiCADMM.partial_fit` and keeps the (7a) x-update exact
under growth by maintaining the setup state incrementally (one stream,
N = 1):

* **dense** (``n <= DENSE_MAX_N``): the n x n Gram ``G = A^T A``, its
  shifted factor ``L = chol(G + c I)``, ``A^T b`` and ``b^T b``. A new chunk
  is a rank-k Cholesky update (:func:`.prox.chol_update`), an evicted chunk
  a rank-k downdate, both on the ``chol_rank_update`` kernel. With
  ``window=0`` the engine holds no rows at all.
* **woodbury** (``m <= WOODBURY_MAX_M``, ``m < n``): the m x m dual Gram
  ``W = A A^T`` and its shifted factor grow by a bordered append
  (:func:`.prox.chol_append`); evicting the oldest rows drops the leading
  block and repairs the trailing factor with one rank-p update
  (``M22 = L21 L21^T + L22 L22^T``).
* **pcg** (large m and n): the Jacobi diagonal ``diag(A^T A)`` and
  ``A^T b`` accumulate per chunk; the matrix-free solve streams over the
  replay window.
* **direct** (the other losses): Newton-CG needs the data itself, so
  refits warm-start :meth:`BiCADMM.run_from` on the replay window.

The accumulators live in the precision policy's accumulation dtype (f32
under bf16 / fp16 data) and the solver state in its state dtype. Per-refit
``gamma`` / ``rho_c`` overrides take an eigendecomposition of the
maintained Gram, never a recompute from data. The plain products that fold
a chunk in (``X^T X``, ``A_win X^T``) are ``torch.matmul``, as the JAX
package's are ``jnp`` matmuls outside any Pallas kernel.

Every refit warm-starts from the previous state; a drift probe (one
cached-factor x-solve) re-projects the consensus block when a chunk moves
the S^kappa support. A failed downdate or a non-finite accumulator takes
the **refactorize** rung (the accumulators rebuilt from the replay window,
logged as a ``RecoveryAttempt`` with ``stage="refactorize"``); a refit
still DIVERGED after it goes to the api layer's recovery ladder.
"""
from __future__ import annotations

import dataclasses

import torch

from . import bilinear, prox
from .bicadmm import BiCADMM, BiCADMMState, SolveParams, reset_for_resume
from .recovery import RecoveryAttempt, SolveDiverged, sanitize_state
from .results import FitResult, SolveStatus, classify_status
from .. import runtime

__all__ = [
    "CGStreamAccum",
    "DenseStreamAccum",
    "StreamingBiCADMM",
    "WoodburyStreamAccum",
]


# ------------------------------------------------------ accumulators ----
@dataclasses.dataclass(frozen=True)
class DenseStreamAccum:
    """Dense-regime sufficient statistics: everything a refit (and its KKT
    polish) needs, with no raw rows."""

    G: torch.Tensor      # (n, n) Gram A^T A over the window
    L: torch.Tensor      # (n, n) lower chol(G + c I), by up/downdates
    Atb: torch.Tensor    # (n,)
    yty: torch.Tensor    # () b^T b


@dataclasses.dataclass(frozen=True)
class WoodburyStreamAccum:
    """Woodbury-regime statistics: the raw dual Gram (for the
    dynamic-penalty eigh) and its shifted factor."""

    W: torch.Tensor      # (m, m) raw A A^T over the window
    L: torch.Tensor      # (m, m) lower chol(W + c I)
    Atb: torch.Tensor    # (n,)
    yty: torch.Tensor    # ()


@dataclasses.dataclass(frozen=True)
class CGStreamAccum:
    """Matrix-free-regime statistics: the Jacobi diagonal and A^T b."""

    colsq: torch.Tensor  # (n,) diag(A^T A) over the window
    Atb: torch.Tensor    # (n,)
    yty: torch.Tensor    # ()


def _leaves(acc) -> list[torch.Tensor]:
    return [getattr(acc, f.name) for f in dataclasses.fields(acc)]


def _dense_absorb(acc: DenseStreamAccum, X, y) -> DenseStreamAccum:
    Xa, ya = X.to(acc.G.dtype), y.to(acc.G.dtype)
    return DenseStreamAccum(G=acc.G + Xa.T @ Xa,
                            L=prox.chol_update(acc.L, Xa.T),
                            Atb=acc.Atb + Xa.T @ ya, yty=acc.yty + ya @ ya)


def _dense_evict(acc: DenseStreamAccum, X, y):
    Xa, ya = X.to(acc.G.dtype), y.to(acc.G.dtype)
    L, ok = prox.chol_downdate(acc.L, Xa.T)
    return DenseStreamAccum(G=acc.G - Xa.T @ Xa, L=L,
                            Atb=acc.Atb - Xa.T @ ya,
                            yty=acc.yty - ya @ ya), ok


def _wood_absorb(acc: WoodburyStreamAccum, A_win, X, y,
                 c: float) -> WoodburyStreamAccum:
    dt = acc.W.dtype
    Xa, ya = X.to(dt), y.to(dt)
    C = A_win.to(dt) @ Xa.T                   # (m_old, k) cross block
    D = Xa @ Xa.T                             # (k, k)
    W = torch.cat([torch.cat([acc.W, C], dim=1),
                   torch.cat([C.T, D], dim=1)], dim=0)
    k = X.shape[0]
    eye = torch.eye(k, dtype=dt, device=D.device)
    L = prox.chol_append(acc.L, C, D + torch.as_tensor(c, dtype=dt) * eye)
    return WoodburyStreamAccum(W=W, L=L, Atb=acc.Atb + Xa.T @ ya,
                               yty=acc.yty + ya @ ya)


def _wood_evict(acc: WoodburyStreamAccum, X, y) -> WoodburyStreamAccum:
    dt = acc.W.dtype
    Xa, ya = X.to(dt), y.to(dt)
    p = X.shape[0]
    # dropping the leading p rows of the bordered factor [[L11, 0], [L21,
    # L22]] leaves L22 with M22 - L21 L21^T; one rank-p UPDATE with the
    # cross block restores chol(M22) exactly (no downdate: it cannot fail)
    L = prox.chol_update(acc.L[p:, p:], acc.L[p:, :p])
    return WoodburyStreamAccum(W=acc.W[p:, p:], L=L,
                               Atb=acc.Atb - Xa.T @ ya,
                               yty=acc.yty - ya @ ya)


def _cg_absorb(acc: CGStreamAccum, X, y) -> CGStreamAccum:
    dt = acc.Atb.dtype
    Xa, ya = X.to(dt), y.to(dt)
    return CGStreamAccum(colsq=acc.colsq + torch.einsum("mn,mn->n", Xa, Xa),
                         Atb=acc.Atb + Xa.T @ ya, yty=acc.yty + ya @ ya)


def _cg_evict(acc: CGStreamAccum, X, y) -> CGStreamAccum:
    dt = acc.Atb.dtype
    Xa, ya = X.to(dt), y.to(dt)
    return CGStreamAccum(colsq=acc.colsq - torch.einsum("mn,mn->n", Xa, Xa),
                         Atb=acc.Atb - Xa.T @ ya, yty=acc.yty - ya @ ya)


# ---------------------------------------------------------- the engine ----
class StreamingBiCADMM:
    """Minibatch Bi-cADMM over an incrementally maintained setup state
    (``repro.core.streaming.StreamingBiCADMM``).

    Feed row chunks through :meth:`partial_fit`; each call absorbs the
    chunk, evicts chunks past the replay ``window`` and refits warm-started
    from the previous state. ``window``: ``None`` keeps everything, ``w >=
    1`` the last w chunks (downdates), ``0`` no rows at all (dense regime
    only). ``solver`` shares an existing :class:`BiCADMM` (and its caches)
    across streams. ``device`` is where the stream lives (``None``: the
    card; ``"cpu"`` when asked for).
    """

    def __init__(self, loss, cfg, *, n_classes: int = 1,
                 window: int | None = None, drift_tol: float = 0.5,
                 solver: BiCADMM | None = None, device=None):
        if solver is None:
            solver = BiCADMM(loss, cfg, n_classes=n_classes)
        self.solver = solver
        self.cfg = solver.cfg
        self.loss = solver.loss
        self.device = runtime.resolve_device(device)
        if self.cfg.use_feature_split:
            raise ValueError(
                "streaming requires n_feature_blocks=1: the feature-split "
                "sub-solver bakes penalties into per-block factors that "
                "cannot be incrementally updated")
        if window is not None and window < 0:
            raise ValueError("window must be None (unbounded) or >= 0")
        self.window = window
        self.drift_tol = float(drift_tol)
        if not 0.0 <= self.drift_tol <= 1.0:
            raise ValueError("drift_tol must be in [0, 1]")
        self._chunks: list[tuple[torch.Tensor, torch.Tensor]] = []
        self._win_cache: tuple[torch.Tensor, torch.Tensor] | None = None
        self._fcache: tuple | None = None
        self._acc = None
        self._mode: str | None = None
        self._m = 0                    # rows currently inside the window
        self.m_seen = 0                # rows absorbed over the stream's life
        self.n_features: int | None = None
        self._data_dtype = None
        self._state: BiCADMMState | None = None
        self._result: FitResult | None = None
        self.refactorizations = 0
        self.drift_reprojections = 0

    # -- bookkeeping -------------------------------------------------------
    @property
    def _c(self) -> float:
        """Factor shift sigma + rho_c baked into L (N = 1 per stream)."""
        return 1.0 / self.cfg.gamma + self.cfg.rho_c

    @property
    def mode(self) -> str | None:
        """Resolved regime: dense | woodbury | pcg | direct (None: no data)."""
        return self._mode

    @property
    def m_window(self) -> int:
        """Rows currently inside the replay window / accumulators."""
        return self._m

    @property
    def result(self) -> FitResult | None:
        """The most recent refit's result (None before the first chunk)."""
        return self._result

    @property
    def nbytes(self) -> int:
        """Device bytes held by the accumulators and the replay window."""
        leaves = [] if self._acc is None else _leaves(self._acc)
        leaves += [t for c in self._chunks for t in c]
        return int(sum(t.numel() * t.element_size() for t in leaves))

    def _admit(self, X, y):
        X = torch.as_tensor(X, device=self.device)
        y = torch.as_tensor(y, device=self.device)
        if X.dtype == torch.float64:
            X = X.to(torch.float32)
        if y.dtype == torch.float64:
            y = y.to(torch.float32)
        if X.ndim != 2:
            raise ValueError(f"X chunk must be 2-D (rows, features), "
                             f"got shape {tuple(X.shape)}")
        if tuple(y.shape) != (X.shape[0],):
            raise ValueError(f"y chunk must be ({X.shape[0]},), "
                             f"got {tuple(y.shape)}")
        if X.shape[0] == 0:
            raise ValueError("empty chunk: X has no rows")
        pol = self.cfg.precision
        X = pol.cast_data(X)
        if y.is_floating_point():
            y = pol.cast_data(y)
        if self.n_features is None:
            self.n_features = int(X.shape[1])
            self._data_dtype = X.dtype
            n = self.n_features
            self._empty_As = torch.zeros((1, 0, n), dtype=X.dtype,
                                         device=self.device)
            self._empty_bs = torch.zeros((1, 0), dtype=y.dtype,
                                         device=self.device)
        elif X.shape[1] != self.n_features:
            raise ValueError(f"chunk has {X.shape[1]} features; this stream "
                             f"is fitted on {self.n_features}")
        return X, y

    def _resolve_mode(self, m_total: int) -> str:
        if self.loss.name != "squared":
            return "direct"
        return self.solver._x_engine(m_total, self.n_features, False).kind

    def _window_data(self):
        if self._win_cache is None:
            if not self._chunks:
                raise RuntimeError("no rows inside the replay window")
            if len(self._chunks) == 1:
                self._win_cache = self._chunks[0]
            else:
                self._win_cache = (
                    torch.cat([c[0] for c in self._chunks], dim=0),
                    torch.cat([c[1] for c in self._chunks], dim=0))
        return self._win_cache

    def _accum_dtype(self) -> torch.dtype:
        return self.cfg.precision.accum_dtype(self._data_dtype)

    def _fresh_accum(self, mode: str):
        n = self.n_features
        kw = dict(dtype=self._accum_dtype(), device=self.device)
        zAtb = torch.zeros((n,), **kw)
        zero = torch.zeros((), **kw)
        if mode == "dense":
            L0 = torch.sqrt(torch.as_tensor(self._c, **kw)) * torch.eye(n,
                                                                       **kw)
            return DenseStreamAccum(G=torch.zeros((n, n), **kw), L=L0,
                                    Atb=zAtb, yty=zero)
        if mode == "pcg":
            return CGStreamAccum(colsq=torch.zeros((n,), **kw), Atb=zAtb,
                                 yty=zero)
        if mode == "woodbury":
            return WoodburyStreamAccum(W=torch.zeros((0, 0), **kw),
                                       L=torch.zeros((0, 0), **kw),
                                       Atb=zAtb, yty=zero)
        return None

    def _shifted_chol(self, M: torch.Tensor) -> torch.Tensor:
        """chol(M + c I), NaN where M + c I is not positive definite."""
        eye = torch.eye(M.shape[0], dtype=M.dtype, device=M.device)
        return prox.cholesky(M + self._c * eye)

    # -- incremental updates ----------------------------------------------
    def _absorb_one(self, X, y) -> None:
        """Fold one chunk into the accumulators (the window not yet
        appended: the woodbury cross block needs the pre-chunk window)."""
        mode = self._mode
        self._fcache = None
        if mode in (None, "direct"):
            return
        if mode == "dense":
            self._acc = _dense_absorb(self._acc, X, y)
        elif mode == "pcg":
            self._acc = _cg_absorb(self._acc, X, y)
        else:  # woodbury
            dt = self._acc.Atb.dtype
            if self._acc.W.shape[0] == 0:
                Xa, ya = X.to(dt), y.to(dt)
                W = Xa @ Xa.T
                self._acc = WoodburyStreamAccum(
                    W=W, L=self._shifted_chol(W),
                    Atb=self._acc.Atb + Xa.T @ ya,
                    yty=self._acc.yty + ya @ ya)
            else:
                A_win, _ = self._window_data()
                self._acc = _wood_absorb(self._acc, A_win, X, y, self._c)

    def _evict_oldest(self) -> list[str]:
        """Downdate the oldest chunk out of the window; a downdate that
        loses positive-definiteness routes to the refactorize rung."""
        Xe, ye = self._chunks.pop(0)
        self._win_cache = None
        self._fcache = None
        self._m -= Xe.shape[0]
        mode = self._mode
        if mode == "dense":
            new, ok = _dense_evict(self._acc, Xe, ye)
            if bool(ok):
                self._acc = new
                return []
            self.refactorizations += 1
            self._rebuild()
            return ["cholesky downdate lost positive-definiteness"]
        if mode == "pcg":
            self._acc = _cg_evict(self._acc, Xe, ye)
        elif mode == "woodbury":
            self._acc = _wood_evict(self._acc, Xe, ye)
        return []

    def _rebuild(self) -> None:
        """Full refactorization: rebuild every accumulator from the replay
        window (the recovery rung, also used on regime transitions)."""
        mode = self._mode
        self._fcache = None
        if mode in (None, "direct"):
            return
        self._acc = self._fresh_accum(mode)
        if not self._chunks:
            return
        dt = self._accum_dtype()
        A_win, y_win = self._window_data()
        Aa, ya = A_win.to(dt), y_win.to(dt)
        if mode == "dense":
            G = Aa.T @ Aa
            self._acc = DenseStreamAccum(G=G, L=self._shifted_chol(G),
                                         Atb=Aa.T @ ya, yty=ya @ ya)
        elif mode == "woodbury":
            W = Aa @ Aa.T
            self._acc = WoodburyStreamAccum(W=W, L=self._shifted_chol(W),
                                            Atb=Aa.T @ ya, yty=ya @ ya)
        else:
            self._acc = CGStreamAccum(
                colsq=torch.einsum("mn,mn->n", Aa, Aa), Atb=Aa.T @ ya,
                yty=ya @ ya)

    def _accum_finite(self) -> bool:
        if self._acc is None:
            return True
        return all(bool(torch.isfinite(t).all()) for t in _leaves(self._acc))

    # -- absorb -------------------------------------------------------------
    def absorb(self, X, y) -> list[str]:
        """Absorb one chunk without refitting: validate, fold into the
        accumulators, evict past the window bound, and route accumulator
        corruption through the refactorize rung. Returns the rung reasons
        to attach to the next refit's recovery log (usually empty)."""
        X, y = self._admit(X, y)
        k = int(X.shape[0])
        rungs: list[str] = []
        new_mode = self._resolve_mode(self._m + k)
        if self.window == 0 and new_mode != "dense":
            raise ValueError(
                f"window=0 (no replay rows) is only valid in the dense "
                f"regime; this stream resolves to {new_mode!r}")
        self.m_seen += k
        if new_mode != self._mode:
            # regime transition (e.g. woodbury -> pcg as m outgrows the dual
            # factor): rebuild the new regime's accumulators from the
            # window, new chunk included; with window=0 (dense, first chunk)
            # absorb into fresh accumulators instead
            self._mode = new_mode
            if self.window == 0:
                if self._acc is None:
                    self._acc = self._fresh_accum(new_mode)
                self._absorb_one(X, y)
                self._m += k
            else:
                self._chunks.append((X, y))
                self._win_cache = None
                self._m += k
                self._rebuild()
        else:
            self._absorb_one(X, y)
            if self.window != 0:
                self._chunks.append((X, y))
                self._win_cache = None
            self._m += k
        while self.window not in (None, 0) and len(self._chunks) > self.window:
            rungs += self._evict_oldest()
        if not self._accum_finite():
            rungs.append("non-finite streaming accumulator")
            self.refactorizations += 1
            self._rebuild()
            if not self._accum_finite():
                raise SolveDiverged(
                    "streaming accumulators are non-finite even after full "
                    "refactorization: the replay window itself is poisoned",
                    result=self._result)
        return rungs

    # -- factors -----------------------------------------------------------
    def solo_factors(self, dyn: bool = False):
        """The stream's x-update factors over the current accumulators,
        with the node axis of one (N = 1). ``dyn=True``: spectral factors
        from an eigendecomposition of the maintained Gram (G or W), so
        per-refit gamma / rho_c overrides never recompute from data.
        Memoized until the next absorb or evict."""
        key = (id(self._acc), id(self._win_cache), bool(dyn))
        if self._fcache is not None and self._fcache[0] == key:
            return self._fcache[1]
        acc, mode, cfg = self._acc, self._mode, self.cfg
        if mode == "dense":
            if dyn:
                evals, V = prox._eigh(acc.G[None])
                f = prox.EighRidgeFactors(V, evals, acc.Atb[None])
            else:
                f = prox.RidgeFactors(acc.L[None], acc.Atb[None], self._c)
        elif mode == "woodbury":
            A_win, _ = self._window_data()
            if dyn:
                evals, U = prox._eigh(acc.W[None])
                f = prox.WoodburyEighFactors(A_win[None], U, evals,
                                             acc.Atb[None])
            else:
                f = prox.WoodburyFactors(A_win[None], acc.L[None],
                                         acc.Atb[None], self._c)
        elif mode == "pcg":
            A_win, _ = self._window_data()
            f = prox.CGFactors(A_win[None], acc.Atb[None], acc.colsq[None],
                               cfg.cg_iters, cfg.cg_tol)
        else:
            f = None
        self._fcache = (key, f)
        return f

    # -- warm start + drift probe -----------------------------------------
    def warm_state(self) -> BiCADMMState:
        """The refit's starting state: the previous result's, or a zero
        state for a new stream."""
        if self._state is not None:
            return self._state
        return self.solver._init_state(self._empty_As, self.n_features,
                                       self.loss.n_classes)

    def _drift_guard(self, state: BiCADMMState, params: SolveParams,
                     dyn: bool) -> BiCADMMState:
        """One cached-factor x-solve probes whether the fresh chunk moved
        the S^kappa ladder out from under the warm iterate; on a support
        shift past ``drift_tol`` the consensus block is re-projected onto
        the new top-kappa set before the refit iterates."""
        f = self.solo_factors(dyn)
        if f is None or self._result is None:
            return state
        kap = params.kappa
        q = state.z - state.u[0]
        x_p = prox.x_solve(f, q[None], params.rho_c, params.sigma,
                           x0=state.x)[0]
        dt = state.z.dtype
        w = (x_p + state.u[0]).to(dt)
        new_supp = torch.abs(bilinear.hard_threshold(w, kap)) > 0
        old_supp = torch.abs(bilinear.hard_threshold(state.z, kap)) > 0
        overlap = int(torch.sum(new_supp & old_supp))
        if overlap >= kap * (1.0 - self.drift_tol):
            return state
        self.drift_reprojections += 1
        t = torch.sum(torch.abs(w)).to(dt)
        zero = torch.zeros((), dtype=dt, device=w.device)
        s = bilinear.s_update(w, t, zero, kap)
        return state._replace(x=x_p[None].to(dt), z=w, t=t, s=s, v=zero)

    # -- refit -------------------------------------------------------------
    def _refit(self, state: BiCADMMState, *, kappa, gamma, rho_c,
               dyn: bool) -> FitResult:
        solver = self.solver
        if self._mode == "dense":
            params = solver._make_params(1, kappa=kappa, gamma=gamma,
                                         rho_c=rho_c)
            st = solver._run_while(self.solo_factors(dyn), self._empty_As,
                                   self._empty_bs, params,
                                   reset_for_resume(state))
            return self.finalize_dense(st, params)
        A_win, y_win = self._window_data()
        As, bs = solver._cast(A_win[None], y_win[None])
        f = self.solo_factors(dyn)
        if f is not None:
            solver.seed_setup(As, bs, f, dynamic_penalties=dyn)
        return solver.run_from(As, bs, state, kappa=kappa, gamma=gamma,
                               rho_c=rho_c)

    def finalize_dense(self, st: BiCADMMState, params: SolveParams
                       ) -> FitResult:
        """Data-free finalize of the dense regime: hard-threshold, then the
        masked-ridge KKT polish straight from the maintained Gram (the
        batch engine's dense polish with G accumulated)."""
        cfg, acc = self.cfg, self._acc
        z_sparse = bilinear.hard_threshold(st.z, params.kappa)
        support = torch.abs(z_sparse) > 0
        if cfg.polish:
            G = acc.G
            pen = torch.where(support, 0.0, 1e8)
            H = G + torch.diag((pen + params.sigma).to(G.dtype))
            x = torch.linalg.solve(H, acc.Atb)
            x_final = torch.where(support, x, 0.0)
        else:
            x_final = z_sparse
        coef = x_final.reshape(self.n_features, self.loss.n_classes)
        status = classify_status(st.k, st.p_r, st.d_r, st.b_r, tol=cfg.tol,
                                 divergence_tol=cfg.divergence_tol)
        return FitResult(coef, st.z, support, st.k, st.p_r, st.d_r, st.b_r,
                         None, st, status=status)

    def adopt(self, res: FitResult) -> None:
        """Install a refit result as the stream's warm state."""
        self._state = res.state
        self._result = res

    def seed_state(self, state: BiCADMMState) -> None:
        """Warm-start the next refit from an externally stored state (the
        stream itself starts empty)."""
        self._state = state

    def train_loss(self, coef) -> float | None:
        """Squared-loss training objective over the window from the
        accumulators alone: ``0.5 (x^T G x - 2 x^T A^T b + b^T b)``; None
        outside the dense regime."""
        if self._mode != "dense":
            return None
        acc = self._acc
        x = torch.as_tensor(coef, device=self.device).reshape(-1).to(
            acc.Atb.dtype)
        return float(0.5 * (x @ (acc.G @ x) - 2.0 * x @ acc.Atb + acc.yty))

    def partial_fit(self, X, y, *, kappa=None, gamma=None,
                    rho_c=None) -> FitResult:
        """Absorb one row chunk and refit, warm-started from the previous
        state; ``kappa`` / ``gamma`` / ``rho_c`` override the config for
        this refit. A refit that ends DIVERGED is retried once through the
        full-refactorization rung; every rung taken is logged in
        ``result.recovery``. A still-diverged result is returned as is."""
        rungs = self.absorb(X, y)
        dyn = gamma is not None or rho_c is not None
        params = self.solver._make_params(1, kappa=kappa, gamma=gamma,
                                          rho_c=rho_c)
        state = self._drift_guard(self.warm_state(), params, dyn)
        res = self._refit(state, kappa=kappa, gamma=gamma, rho_c=rho_c,
                          dyn=dyn)
        if (int(res.status) == int(SolveStatus.DIVERGED)
                and (self.window != 0 and self._chunks
                     or self._mode == "dense")):
            rungs.append("post-divergence rebuild")
            self.refactorizations += 1
            self._rebuild()
            res = self._refit(sanitize_state(reset_for_resume(res.state)),
                              kappa=kappa, gamma=gamma, rho_c=rho_c, dyn=dyn)
        if rungs:
            att = tuple(RecoveryAttempt("refactorize", r, int(res.status),
                                        int(res.iters)) for r in rungs)
            res = res._replace(recovery=(res.recovery or ()) + att)
        self.adopt(res)
        return res
