"""Distributed Bi-cADMM on a ``torch.distributed`` process grid (counterpart
of ``repro.core.sharded``, the JAX package's ``shard_map`` engine).

The grid is a :class:`torch.distributed.device_mesh.DeviceMesh` with named
dimensions: the ``nodes`` axis (one name, or a tuple such as
``("pod", "data")`` whose product is the node axis, first name major) is the
paper's sample decomposition over N nodes, the ``feat`` axis the feature
decomposition of each node's data over M ranks. Rank (i, j) holds the block
A_ij: the rows of node i and the columns [j nb, (j + 1) nb) of A, nb =
ceil(n / M), zero-padded to nb columns. One process per rank (the kernels'
scratch is per process), every rank running the same program on its block:

* the x-update (7a), by ``x_update``: ``"subsolver"``, the paper's
  Algorithm 2 across ``feat`` (the ``block_matvec`` / ``block_rmatvec``
  kernels on the rank's (1, m_loc, nb) block, its (nb, nb) Cholesky factor
  set up once through the ``gram`` kernel, in f32 for bf16 / fp16 data);
  the two exact projection modes take the mean of the partial predictions
  over the all-gathered (M, m_loc, K) stack, the approximate ones a psum
  over M. ``"cg"``: Jacobi-PCG on the squared loss's normal equations, one
  (m_loc,) psum of A p and psum'd dots a CG step (``prox.pcg``'s
  ``dot_fn``). ``"auto"`` takes cg for the squared loss when nb exceeds
  ``prox.DENSE_MAX_N``.
* the consensus center: a psum over ``nodes``.
* the (z, t) FISTA step and the s-step, by ``projection``:
  ``"ladder_exact"`` (default) runs the reference engine's exact sort-free
  projections on the rank's shard with every reduction psum'd over
  ``feat`` (:class:`~.bilinear.LadderOps`: the bracketing rounds on the
  ``ladder_stats`` kernel, one (2, B) psum a round, one (2, k) psum a
  polish or search step); ``"exact"`` all-gathers z, w and s and runs the
  full-vector projections replicated on every rank; ``"batched"`` and
  ``"bisect"`` are the approximate ladder and scalar bisections.

A psum is ``all_reduce`` (SUM, or MAX) on the process group of its mesh
dimension(s); a gather is ``all_gather_into_tensor`` in the feature-block
order. Every rank reads the same replicated stopping test once an outer
iteration. On one card several ranks share the device through a gloo
group, which stages CUDA tensors through the host (NCCL refuses two ranks
on one device).

``fit(A_global, b_global)`` takes the global arrays on every rank (the JAX
api's contract), cuts the rank's block, casts it by the precision policy
and moves it to the rank's device (the mesh's device type unless
``device=`` says otherwise), and returns the same global
:class:`~.results.FitResult` on every rank, its ``.state`` the global
:class:`ShardedGlobalState` to warm-start the next fit. ``fit_path`` is a
host loop over kappa with the warm carry (``warm_start=False``: the cold
scan ``fit_grid`` uses). The set-up (the block cut, the cast and the
factors) is cached on the data tensors' memory and layout.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import bilinear, prox
from .bicadmm import BiCADMMConfig, _fista_betas, _zt_update
from .losses import Loss, get_loss
from .results import FitResult, SparsePath, classify_status, divergence_probe
from .subsolver import _block_solve, subsolver_setup
from .. import faults, runtime
from ..kernels.ops import (block_matvec_auto, block_rmatvec_auto,
                           ladder_stats_auto, matvec_auto, rmatvec_auto)

X_UPDATE_MODES = ("auto", "subsolver", "cg")
PROJECTIONS = ("ladder_exact", "exact", "batched", "bisect")


class ShardedState(NamedTuple):
    """One rank's iterates."""
    x: torch.Tensor       # (nb, K) this node's estimate, this feature block
    u: torch.Tensor       # (nb, K)
    z: torch.Tensor       # (nb, K) the consensus, this feature block
    t: torch.Tensor       # ()
    s: torch.Tensor       # (nb, K)
    v: torch.Tensor       # ()
    nu: torch.Tensor      # (m_loc, K) inner dual (this node, every block)
    omega: torch.Tensor   # (m_loc, K)
    k: torch.Tensor
    p_r: torch.Tensor
    d_r: torch.Tensor
    b_r: torch.Tensor


class ShardedGlobalState(NamedTuple):
    """Resumable state as global tensors (``repro.core.sharded``'s layout):
    x / u (N, n_pad, K) node-major, z / s (n_pad, K), nu / omega
    (n_samples, K); every rank holds all of it."""
    x: torch.Tensor
    u: torch.Tensor
    z: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor
    v: torch.Tensor
    nu: torch.Tensor
    omega: torch.Tensor


ShardedResult = FitResult
ShardedPathResult = SparsePath


# --------------------------------------------------------------------------
# the grid and its collectives
# --------------------------------------------------------------------------
def _names(axis) -> tuple[str, ...]:
    return axis if isinstance(axis, tuple) else (axis,)


class Grid:
    """This rank's place on a mesh: N nodes (the product of the node
    dimensions), M feature blocks, its node index ``i`` and block index
    ``j``, and the process groups of the two axes. ``order[axis]`` lists
    the members of that axis' group (their positions in it) by index."""

    def __init__(self, mesh, nodes_axis, feat_axis: str):
        names = tuple(mesh.mesh_dim_names or ())
        wanted = (*_names(nodes_axis), feat_axis)
        missing = sorted(set(wanted) - set(names))
        if missing:
            raise ValueError(f"mesh lacks the axis name(s) {missing}; has "
                             f"{sorted(names)}")
        self.mesh = mesh
        shape = dict(zip(names, mesh.mesh.shape))
        coord = dict(zip(names, mesh.get_coordinate()))
        nodes = _names(nodes_axis)
        self.N = math.prod(shape[a] for a in nodes)
        self.M = shape[feat_axis]
        self.i = 0
        for a in nodes:
            self.i = self.i * shape[a] + coord[a]
        self.j = coord[feat_axis]
        self.nodes = _group(mesh, nodes)
        self.feat = _group(mesh, (feat_axis,))
        self.order = {"nodes": _order(mesh, self.nodes, nodes),
                      "feat": _order(mesh, self.feat, (feat_axis,))}


_GROUPS: dict = {}


def _group(mesh, dims: tuple[str, ...]):
    """The process group over the mesh dimensions ``dims`` that holds this
    rank. One dimension: the mesh's own group. Several (the node axis of a
    ("pod", "data", "feat") mesh): a group for every combination of the
    other dimensions, each created by every rank in the same order (as
    ``new_group`` requires), cached per (mesh, dims)."""
    if len(dims) == 1:
        return mesh.get_group(dims[0])
    key = (id(mesh), dims)
    if key not in _GROUPS:
        names = list(mesh.mesh_dim_names)
        idx = [names.index(a) for a in dims]
        rest = [k for k in range(len(names)) if k not in idx]
        ranks = mesh.mesh.permute(*rest, *idx).reshape(
            -1, math.prod(mesh.mesh.shape[k] for k in idx))
        me, mine = dist.get_rank(), None
        for row in ranks.tolist():
            grp = dist.new_group(row)
            if me in row:
                mine = grp
        _GROUPS[key] = (mesh, mine)
    return _GROUPS[key][1]


def _order(mesh, group, dims: tuple[str, ...]) -> list[int]:
    """The positions, in ``group``, of its members sorted by their index
    along ``dims`` (first name major)."""
    names = list(mesh.mesh_dim_names)
    full = mesh.mesh
    members = dist.get_process_group_ranks(group)
    index = {}
    for pos, rank in enumerate(members):
        where = (full == rank).nonzero()[0].tolist()
        k = 0
        for a in dims:
            d = names.index(a)
            k = k * full.shape[d] + where[d]
        index[k] = pos
    return [index[k] for k in sorted(index)]


def _all_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    """``x`` reduced over ``group`` (``x`` is a fresh result of the
    caller's and is reduced in place)."""
    x = x.contiguous()
    dist.all_reduce(x, op=op, group=group)
    return x


def _psum(group):
    """Sum over ``group``; the identity when there is none."""
    if group is None:
        return lambda x: x
    return lambda x: _all_reduce(x, group, dist.ReduceOp.SUM)


def _pmax(group):
    if group is None:
        return lambda x: x
    return lambda x: _all_reduce(x, group, dist.ReduceOp.MAX)


_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _gather(x: torch.Tensor, group, order: list[int]) -> torch.Tensor:
    """(size, *x.shape): every member's ``x`` stacked in index order."""
    out = torch.empty(len(order) * x.numel(), dtype=x.dtype,
                      device=x.device)
    _gather_into(out, x.reshape(-1).contiguous(), group=group)
    out = out.view((len(order),) + tuple(x.shape))
    if order != sorted(order):
        out = out[torch.as_tensor(order, device=x.device)]
    return out


def _tensor_key(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), tuple(t.shape), t.stride(), str(t.dtype),
            str(t.device))


# --------------------------------------------------------------------------
# batched-threshold reductions (the approximate projection mode)
# --------------------------------------------------------------------------
def batched_epigraph_project(z0: torch.Tensor, t0, sum_fn, max_fn,
                             rounds: int = 3, B: int = 32):
    """Projection onto {(z, t): ||z||_1 <= t} by ``rounds`` ladder rounds
    of B thresholds (one ``ladder_stats`` pass and one (2, B) sum each),
    then the root inside the last bracket as if no breakpoint lay there:
    accurate to the ladder's resolution, not exact
    (``repro.core.sharded.batched_epigraph_project``). ``sum_fn`` /
    ``max_fn`` reduce over the feature blocks."""
    az = torch.abs(z0)
    t0 = torch.as_tensor(t0, dtype=z0.dtype, device=z0.device)
    abs_sum = sum_fn(torch.sum(az))
    inside = abs_sum <= t0
    hi0 = max_fn(torch.clamp_min(torch.max(az), 0.0))
    apex = (-t0 - hi0) > 0

    def crossing(thetas):
        st = sum_fn(ladder_stats_auto(az, thetas))
        h = st[0].to(z0.dtype) - t0 - thetas
        return torch.sum((h > 0).to(torch.int32))

    lo, hi = bilinear._bracket_rounds(torch.zeros_like(hi0), hi0, rounds, B,
                                      crossing)
    stats = sum_fn(bilinear.point_stats(az, lo[None]))[:, 0]
    S_lo, cnt = stats[0], stats[1]
    theta = lo + torch.clamp_min(S_lo - t0 - lo, 0.0) / (cnt + 1.0)
    theta = torch.minimum(torch.maximum(theta, lo), hi)
    theta = torch.where(inside, 0.0, theta)
    to_apex = apex & ~inside
    z = torch.where(to_apex, 0.0,
                    torch.sign(z0) * torch.clamp_min(az - theta, 0.0))
    t = torch.where(to_apex, torch.clamp_min(t0, 0.0),
                    torch.where(inside, t0, t0 + theta))
    return z, t


def batched_support_skappa(z: torch.Tensor, kappa, sum_fn, max_fn,
                           rounds: int = 3, B: int = 32):
    """max over S^kappa of z^T s by count bisection on tau through the
    same ladder (``repro.core.sharded.batched_support_skappa``)."""
    az = torch.abs(z)
    kap = torch.as_tensor(kappa, dtype=az.dtype, device=az.device)
    hi0 = max_fn(torch.clamp_min(torch.max(az), 0.0))

    def crossing(taus):
        cnt = sum_fn(ladder_stats_auto(az, taus))[1].to(z.dtype)
        return torch.sum((cnt > kap).to(torch.int32))

    lo, tau = bilinear._bracket_rounds(torch.zeros_like(hi0), hi0, rounds,
                                       B, crossing)
    above = (az > tau).to(z.dtype)
    boundary = ((az > lo) & (az <= tau)).to(z.dtype)
    cnts = sum_fn(torch.stack([torch.sum(above), torch.sum(boundary)]))
    cnt_above, cnt_bnd = cnts[0], cnts[1]
    leftover = torch.clamp_min(kap - cnt_above, 0.0)
    bnd_w = torch.where(cnt_bnd > 0,
                        leftover / torch.where(cnt_bnd > 0, cnt_bnd, 1.0),
                        0.0)
    w = above + torch.clamp_max(bnd_w, 1.0) * boundary
    return sum_fn(torch.sum(az * w)), torch.sign(z) * w


# --------------------------------------------------------------------------
# the sharded solver
# --------------------------------------------------------------------------
@dataclasses.dataclass
class ShardedBiCADMM:
    """Bi-cADMM over a (``nodes``, ``feat``) mesh (module docstring).
    ``A_global`` (n_samples, n), ``b_global`` (n_samples,): rows split over
    the N nodes, columns over the M feature blocks."""
    loss: Loss | str
    cfg: BiCADMMConfig
    mesh: Any
    nodes_axis: str | tuple[str, ...] = "nodes"
    feat_axis: str = "feat"
    n_classes: int = 1
    projection: str = "ladder_exact"
    x_update: str = "auto"
    device: Any = None

    _CACHE_MAX = 4

    def __post_init__(self):
        if isinstance(self.loss, str):
            self.loss = get_loss(self.loss, self.n_classes)
        if self.projection not in PROJECTIONS:
            raise ValueError(f"unknown projection mode {self.projection!r}")
        if self.cfg.projection not in ("ladder", "sort"):
            raise ValueError(
                f"unknown cfg.projection mode {self.cfg.projection!r}")
        if self.cfg.projection == "sort" and self.projection != "exact":
            raise ValueError(
                'cfg.projection="sort" needs the full gathered vector; use '
                'the gather-based engine mode (projection="exact")')
        if self.x_update not in X_UPDATE_MODES:
            raise ValueError(f"unknown x_update mode {self.x_update!r}; "
                             f"expected one of {X_UPDATE_MODES}")
        if self.x_update == "cg" and self.loss.name != "squared":
            raise ValueError('x_update="cg" solves the squared-loss normal '
                             "equations; other losses use the feature-split "
                             'sub-solver (x_update="subsolver")')
        self.grid = Grid(self.mesh, self.nodes_axis, self.feat_axis)
        self._device = runtime.resolve_device(
            self.device if self.device is not None
            else self.mesh.device_type)
        # fault-injection hook (repro_torch.faults), captured once
        self._fault_hook = faults.active_hook(self)
        # the rank's block, cast and on its device, and its set-up factors,
        # keyed on the global data tensors' memory and layout, so a view of
        # the same data (the api's reshape of it) hits; the entries hold
        # the keyed tensors, which keeps that memory theirs while cached
        self._cache: dict = {}

    # -- sizes and set-up ----------------------------------------------------
    def _sizes(self, n: int) -> tuple[int, int, int]:
        N, M = self.grid.N, self.grid.M
        return N, M, -(-n // M)

    def _x_mode(self, nb: int) -> str:
        if self.x_update != "auto":
            return self.x_update
        if self.loss.name == "squared" and nb > prox.DENSE_MAX_N:
            return "cg"
        return "subsolver"

    def _prepare(self, A_global, b_global):
        """(A_blk (m_loc, nb), b_blk (m_loc,), factors) of this rank: its
        block of the data cast by the precision policy, zero-padded to nb
        columns, on its device; the factors are the block's Cholesky factor
        (sub-solver) or its column sums of squares and A_blk^T b_blk
        (cg)."""
        A_global = torch.as_tensor(A_global)
        b_global = torch.as_tensor(b_global)
        n_samples, n = A_global.shape
        N, M, nb = self._sizes(n)
        mode = self._x_mode(nb)
        key = (_tensor_key(A_global), _tensor_key(b_global), mode)
        hit = self._cache.get(key)
        if hit is not None:
            return hit[2]
        if n_samples % N:
            raise ValueError(f"{n_samples} rows do not split over {N} "
                             "nodes")
        cfg, g = self.cfg, self.grid
        m_loc = n_samples // N
        rows = slice(g.i * m_loc, (g.i + 1) * m_loc)
        c0, c1 = min(n, g.j * nb), min(n, (g.j + 1) * nb)
        pol = cfg.precision
        dt = pol.data_dtype(A_global.dtype)
        A_blk = A_global[rows, c0:c1].to(self._device, dt)
        A_blk = F.pad(A_blk, (0, nb - (c1 - c0))).contiguous()
        b_blk = b_global[rows].to(self._device)
        if b_blk.is_floating_point():
            b_blk = pol.cast_data(b_blk)
        sigma = 1.0 / (N * cfg.gamma)
        if mode == "cg":
            fac = (prox.col_sumsq(A_blk), rmatvec_auto(A_blk, b_blk))
        else:
            fac = subsolver_setup(A_blk[None], sigma, cfg.rho_c, cfg.rho_l,
                                  1, prox._accum(dt)).chol[0, 0]
        out = (A_blk, b_blk, fac)
        if len(self._cache) >= self._CACHE_MAX:
            self._cache.pop(next(iter(self._cache)))
        self._cache[key] = (A_global, b_global, out)
        return out

    # -- resumable state ---------------------------------------------------
    def init_state(self, n: int, n_samples: int,
                   dtype=torch.float32) -> ShardedGlobalState:
        """A fresh zero state for ``n`` features and ``n_samples`` rows, on
        this rank's device."""
        N, M, nb = self._sizes(n)
        K = self.loss.n_classes
        kw = dict(dtype=dtype, device=self._device)
        z = torch.zeros((M * nb, K), **kw)
        return ShardedGlobalState(
            x=torch.zeros((N, M * nb, K), **kw),
            u=torch.zeros((N, M * nb, K), **kw), z=z,
            t=torch.zeros((), **kw), s=torch.zeros_like(z),
            v=torch.zeros((), **kw),
            nu=torch.zeros((n_samples, K), **kw),
            omega=torch.zeros((n_samples, K), **kw))

    def _unpack_state(self, gs: ShardedGlobalState, nb: int,
                      m_loc: int, dt) -> ShardedState:
        """This rank's slices of a global state."""
        g = self.grid
        cols = slice(g.j * nb, (g.j + 1) * nb)
        rows = slice(g.i * m_loc, (g.i + 1) * m_loc)

        def own(t):
            return torch.as_tensor(t).to(self._device, dt)

        inf = torch.full((), math.inf, dtype=dt, device=self._device)
        return ShardedState(
            x=own(gs.x[g.i, cols]), u=own(gs.u[g.i, cols]),
            z=own(gs.z[cols]), t=own(gs.t), s=own(gs.s[cols]),
            v=own(gs.v), nu=own(gs.nu[rows]), omega=own(gs.omega[rows]),
            k=torch.zeros((), dtype=torch.int32, device=self._device),
            p_r=inf, d_r=inf.clone(), b_r=inf.clone())

    def _pack_state(self, st: ShardedState) -> ShardedGlobalState:
        """The global state from every rank's slices (two gathers: over
        ``feat``, then over ``nodes``)."""
        g = self.grid

        def feat(t):                      # (nb, K) -> (n_pad, K)
            return _gather(t, g.feat, g.order["feat"]).flatten(0, 1)

        def nodes(t):                     # (...) -> (N, ...)
            return _gather(t, g.nodes, g.order["nodes"])

        return ShardedGlobalState(
            x=nodes(feat(st.x)), u=nodes(feat(st.u)), z=feat(st.z), t=st.t,
            s=feat(st.s), v=st.v, nu=nodes(st.nu).flatten(0, 1),
            omega=nodes(st.omega).flatten(0, 1))

    def _unpad_flat(self, z: torch.Tensor, n: int) -> torch.Tensor:
        """(n_pad, K) feature-padded iterate -> (n*K,) reference layout."""
        return z[:n].reshape(-1)

    # -- the rank's program --------------------------------------------------
    def _program(self, A_blk, b_blk, fac):
        """The rank's outer step ``step(state, kappa)`` (``repro.core
        .sharded._local_funcs``), the fault hook after it when one was
        captured."""
        cfg, loss, g = self.cfg, self.loss, self.grid
        K = loss.n_classes
        N, M = g.N, g.M
        psum_f, psum_n, pmax_f = _psum(g.feat), _psum(g.nodes), _pmax(g.feat)
        rho_b = cfg.rho_b_eff
        sigma = 1.0 / (N * cfg.gamma)
        c = sigma + cfg.rho_c
        m_loc, nb = A_blk.shape
        mode = self.projection
        exact = mode in ("exact", "ladder_exact")

        def flat(x):
            return x.reshape(-1)

        def unflat(x):
            return x.reshape(nb, K)

        def gather_full(x2d):
            """(nb, K) shard -> (n_pad K,) replicated, the reference
            engine's flat layout."""
            return _gather(x2d, g.feat, g.order["feat"]).reshape(-1)

        def slice_local(flat_g):
            return flat_g.reshape(M * nb, K)[g.j * nb:(g.j + 1) * nb]

        def feat_mean(w):
            if exact:
                # the mean over the gathered (M, m_loc, K) stack: the
                # reference sub-solver's reduction order
                return torch.mean(_gather(w, g.feat, g.order["feat"]), dim=0)
            return psum_f(w) / M

        if self._x_mode(nb) == "cg":
            colsq, Atb = fac
            inv = 1.0 / (colsq + c)

            def cg_dot(u2, w2):
                return psum_f(torch.sum(u2 * w2, dim=-1))

            def normal(p):
                return rmatvec_auto(A_blk, psum_f(matvec_auto(A_blk, p))) \
                    + c * p

            def x_update(x0, nu0, om0, q):
                xf = prox.pcg(normal, Atb + cfg.rho_c * q[:, 0], x0[:, 0],
                              lambda r: inv * r, cfg.cg_iters, cfg.cg_tol,
                              dot_fn=cg_dot)
                return xf[:, None], nu0, om0
        else:
            A1, chol = A_blk[None], fac[None, None]

            def mm_fwd(x):                       # (nb, K) -> (m_loc, K)
                return block_matvec_auto(A1, x[None, None], 1)[0, 0]

            def mm_t(ct):                        # (m_loc, K) -> (nb, K)
                return block_rmatvec_auto(A1, ct[None, None], 1)[0, 0]

            Mf = float(M)

            def x_update(x, nu, om, q):
                """Algorithm 2 across ``feat`` (q: (nb, K) prox center)."""
                for _ in range(cfg.inner_iters):
                    w = mm_fwd(x)
                    w_bar = feat_mean(w)
                    c_t = w + (om - w_bar - nu)
                    rhs = cfg.rho_l * mm_t(c_t) + cfg.rho_c * q
                    x = _block_solve(chol, rhs[None, None])[0, 0]
                    w_bar_new = feat_mean(mm_fwd(x))
                    pq = Mf * (w_bar_new + nu)
                    if K == 1:
                        pred = loss.prox_omega(pq[:, 0], b_blk,
                                               cfg.rho_l / Mf)[:, None]
                    else:
                        pred = loss.prox_omega(pq, b_blk, cfg.rho_l / Mf)
                    om = pred / Mf
                    nu = nu + w_bar_new - om
                return x, nu, om

        def sum_f(x):
            return psum_f(torch.sum(x))

        def max_f(x):
            return pmax_f(torch.clamp_min(torch.max(x), 0.0))

        lops = bilinear.LadderOps(
            sum_fn=sum_f, max_fn=max_f,
            stats_fn=lambda az, th: psum_f(ladder_stats_auto(az, th)),
            point_fn=lambda az, th: psum_f(bilinear.point_stats(az, th)),
            band_fn=lambda az, lo, hi: psum_f(bilinear.band_stats(az, lo,
                                                                  hi)))

        def project(z0f, t0):
            if mode == "batched":
                return batched_epigraph_project(z0f, t0, psum_f, pmax_f)
            return bilinear.project_l1_epigraph_bisect(
                z0f, t0, sum_fn=sum_f, max_fn=max_f)

        def zt_update_sharded(z0, t0, wc, s, v):
            a = N * cfg.rho_c
            L = a + rho_b * (psum_f(torch.sum(s * s)) + 1.0)
            step = 1.0 / L

            def grads(z, t):
                r = psum_f(torch.sum(s * z)) - t + v
                return a * (z - wc) + rho_b * r * s, -rho_b * r

            zf, t = project(flat(z0), t0)
            z = unflat(zf)
            zy, ty = z, t
            for beta in _fista_betas(cfg.zt_iters):
                gz, gt = grads(zy, ty)
                zf, t_new = project(flat(zy - step * gz), ty - step * gt)
                z_new = unflat(zf)
                zy = z_new + beta * (z_new - z)
                ty = t_new + beta * (t_new - t)
                z, t = z_new, t_new
            return z, t

        sqrt_n = float(np.float32(np.sqrt(np.float32(N)))
                       * np.float32(cfg.rho_c))

        def relaxed(st, x_new):
            if cfg.over_relax != 1.0:
                return cfg.over_relax * x_new + (1.0 - cfg.over_relax) * st.z
            return x_new

        def outer_step_exact(st: ShardedState, kappa) -> ShardedState:
            """The paper's "Collect": z, w and s all-gathered over ``feat``
            and the reference engine's full-vector steps replicated."""
            x_new, nu, om = x_update(st.x, st.nu, st.omega, st.z - st.u)
            x_eff = relaxed(st, x_new)
            wc = psum_n(x_eff + st.u) / N
            zg_old = gather_full(st.z)
            zg, t_new = _zt_update(zg_old, st.t, gather_full(wc),
                                   gather_full(st.s), st.v, float(N),
                                   cfg.rho_c, rho_b, cfg.zt_iters,
                                   projection=cfg.projection,
                                   polish_dtype=cfg.precision.kkt_polish)
            sg = bilinear.s_update(
                zg, t_new, st.v, kappa,
                method="sort" if cfg.projection == "sort" else "ladder")
            gval = bilinear.g(zg, sg, t_new)
            z_new, s_new = slice_local(zg), slice_local(sg)
            p_r = psum_n(torch.linalg.vector_norm(gather_full(x_new
                                                              - z_new)))
            d_r = sqrt_n * torch.linalg.vector_norm(zg - zg_old)
            return ShardedState(x_new, st.u + x_eff - z_new, z_new, t_new,
                                s_new, st.v + gval, nu, om, st.k + 1, p_r,
                                d_r, torch.abs(gval))

        def outer_step_ladder(st: ShardedState, kappa) -> ShardedState:
            """The exact sort-free projections on the rank's shard, every
            reduction psum'd over ``feat``."""
            x_new, nu, om = x_update(st.x, st.nu, st.omega, st.z - st.u)
            x_eff = relaxed(st, x_new)
            wc = psum_n(x_eff + st.u) / N
            zf, t_new = _zt_update(flat(st.z), st.t, flat(wc), flat(st.s),
                                   st.v, float(N), cfg.rho_c, rho_b,
                                   cfg.zt_iters, ops=lops,
                                   polish_dtype=cfg.precision.kkt_polish)
            sf = bilinear.s_update(zf, t_new, st.v, kappa, ops=lops)
            z_new, s_new = unflat(zf), unflat(sf)
            gval = bilinear.g(zf, sf, t_new, sum_fn=sum_f)
            p_r = psum_n(torch.sqrt(psum_f(torch.sum((x_new - z_new) ** 2))))
            d_r = sqrt_n * torch.sqrt(psum_f(torch.sum((z_new - st.z) ** 2)))
            return ShardedState(x_new, st.u + x_eff - z_new, z_new, t_new,
                                s_new, st.v + gval, nu, om, st.k + 1, p_r,
                                d_r, torch.abs(gval))

        def outer_step_sharded(st: ShardedState, kappa) -> ShardedState:
            """The approximate projection modes."""
            x_new, nu, om = x_update(st.x, st.nu, st.omega, st.z - st.u)
            x_eff = relaxed(st, x_new)
            wc = psum_n(x_eff + st.u) / N
            z_new, t_new = zt_update_sharded(st.z, st.t, wc, st.s, st.v)
            if mode == "batched":
                u_max, s_star = batched_support_skappa(flat(z_new), kappa,
                                                       psum_f, pmax_f)
            else:
                u_max, s_star = bilinear.support_skappa_bisect(
                    flat(z_new), kappa, sum_fn=sum_f, max_fn=max_f)
            ctar = torch.as_tensor(t_new - st.v, dtype=z_new.dtype)
            c_cl = torch.minimum(torch.maximum(ctar, -u_max), u_max)
            theta = torch.where(u_max > 0, c_cl / torch.where(
                u_max > 0, u_max, 1.0), 0.0)
            s_new = unflat(theta * s_star)
            gval = psum_f(torch.sum(z_new * s_new)) - t_new
            p_r = psum_n(torch.sqrt(psum_f(torch.sum((x_new - z_new) ** 2))))
            d_r = sqrt_n * torch.sqrt(psum_f(torch.sum((z_new - st.z) ** 2)))
            return ShardedState(x_new, st.u + x_eff - z_new, z_new, t_new,
                                s_new, st.v + gval, nu, om, st.k + 1, p_r,
                                d_r, torch.abs(gval))

        step = {"exact": outer_step_exact,
                "ladder_exact": outer_step_ladder}.get(mode,
                                                       outer_step_sharded)
        hook = self._fault_hook
        if hook is None:
            return step
        return lambda st, kappa: hook(step(st, kappa))

    def _run_while(self, step, st: ShardedState, kappa,
                   iters: int) -> ShardedState:
        """Step while the replicated test says so (one host read an outer
        iteration, the same on every rank)."""
        cfg = self.cfg
        while True:
            done = (st.p_r < cfg.tol) & (st.d_r < cfg.tol) & (st.b_r < cfg.tol)
            go = (~done) & (~divergence_probe(st, cfg.divergence_tol)) \
                & (st.k < iters)
            if not bool(go):
                return st
            st = step(st, kappa)

    @staticmethod
    def _reset(st: ShardedState) -> ShardedState:
        inf = torch.full_like(st.p_r, math.inf)
        return st._replace(k=torch.zeros_like(st.k), p_r=inf,
                           d_r=inf.clone(), b_r=inf.clone())

    def _start(self, A_global, b_global, state):
        A_blk, b_blk, fac = self._prepare(A_global, b_global)
        n_samples, n = torch.as_tensor(A_global).shape
        N, M, nb = self._sizes(n)
        sdt = self.cfg.precision.state_dtype(A_blk.dtype)
        if state is None:
            state = self.init_state(n, n_samples, sdt)
        st0 = self._unpack_state(state, nb, n_samples // N, sdt)
        return self._program(A_blk, b_blk, fac), st0, n

    # -- public API ----------------------------------------------------------
    def fit(self, A_global, b_global, *,
            state: ShardedGlobalState | None = None,
            record_history: bool = False, iters: int | None = None
            ) -> FitResult:
        """One solve from ``state`` (a fresh zero state by default);
        ``record_history``: ``iters`` steps (``max_iter`` by default) with
        no stopping test, the residuals of each in ``history`` (iters, 3)."""
        cfg = self.cfg
        step, st, n = self._start(A_global, b_global, state)
        iters = iters if iters is not None else cfg.max_iter
        kappa = float(cfg.kappa)
        hist = None
        if record_history:
            rows = []
            for _ in range(iters):
                st = step(st, kappa)
                rows.append(torch.stack([st.p_r, st.d_r, st.b_r]))
            hist = torch.stack(rows) if rows else None
        else:
            st = self._run_while(step, st, kappa, iters)
        return self._result(st, n, kappa, hist)

    def _result(self, st: ShardedState, n: int, kappa, hist=None, *,
                pack: bool = True) -> FitResult:
        """The global result of a final state (``pack``: with the global
        state; a path point gathers z alone)."""
        cfg, K, g = self.cfg, self.loss.n_classes, self.grid
        gs = self._pack_state(st) if pack else None
        z = gs.z if pack else _gather(st.z, g.feat,
                                      g.order["feat"]).flatten(0, 1)
        zf = self._unpad_flat(z, n)
        z_sparse = bilinear.hard_threshold(zf, kappa)
        status = classify_status(st.k, st.p_r, st.d_r, st.b_r, tol=cfg.tol,
                                 divergence_tol=cfg.divergence_tol)
        return FitResult(z_sparse.reshape(n, K), zf, torch.abs(z_sparse) > 0,
                         st.k, st.p_r, st.d_r, st.b_r, hist, gs,
                         status=status)

    def fit_path(self, A_global, b_global, kappas, *,
                 state: ShardedGlobalState | None = None,
                 warm_start: bool = True) -> SparsePath:
        """The kappa path, point by point: each point's loop starts from
        the previous point's state (``warm_start=False``: from the initial
        state, the cold scan with the same numerics and collectives)."""
        cfg, K = self.cfg, self.loss.n_classes
        step, st_init, n = self._start(A_global, b_global, state)
        kaps = torch.as_tensor(kappas, dtype=st_init.z.dtype)
        if kaps.ndim != 1 or kaps.shape[0] == 0:
            raise ValueError("kappas must be a non-empty 1-D grid")
        carry, pts = st_init, []
        for kap in kaps.tolist():
            st = self._run_while(step, self._reset(carry), kap, cfg.max_iter)
            pts.append(self._result(st, n, kap, pack=False))
            carry = st if warm_start else st_init
        gs = self._pack_state(carry)
        col = {f: torch.stack([getattr(r, f) for r in pts])
               for f in ("coef", "z", "support", "iters", "p_r", "d_r",
                         "b_r", "status")}
        return SparsePath(col["coef"], col["z"], col["support"],
                          col["iters"], col["p_r"], col["d_r"], col["b_r"],
                          torch.sum(col["support"], dim=1, dtype=torch.int32),
                          kaps, torch.full_like(kaps, cfg.gamma),
                          torch.full_like(kaps, cfg.rho_c), state=gs,
                          strategy="warm-scan" if warm_start else "cold-scan",
                          status=col["status"])
