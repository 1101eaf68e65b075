"""The reduced-precision presets of the port (``"bf16"``, ``"fp16"``)
against the JAX package's, on the CPU, same numpy data.

* The policy helpers (``cast_data``, ``data_dtype``, ``state_dtype``,
  ``accum_dtype``, ``needs_x64``) give the JAX package's dtypes for every
  preset (the cases of tests/test_runtime.py).
* The plain products on bf16 / fp16 A — the CPU rows the fits run through —
  against ``repro.kernels.ops``' CPU rows: the same output dtype (the
  natural promotion of the operands, or ``out_dtype``); f32 outputs within
  f32 reassociation (rtol 1e-4, atol 1e-5 per unit of the summed
  magnitudes), bf16 / fp16 outputs within one rounding of their type.
* Whole fits in bf16 and fp16 through the dense, Woodbury and PCG
  x-updates, and a bf16 logistic fit (Newton-CG), against
  ``repro.core.BiCADMM`` at the bounds of tests/test_torch_bicadmm.py: the
  same status and support, ``z`` within 1e-4, ``coef`` within 1e-3,
  iterations within 2. One shape for every fit, so each JAX solver
  compiles once.
* What stays refused raises ``CapabilityError`` up front: the feature
  split under a reduced preset (the JAX package's own sub-solver fails
  there) and ``"fp64_polish"``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jruntime
from repro.core import BiCADMM as JaxBiCADMM
from repro.core import BiCADMMConfig as JaxConfig
from repro.core import prox as jprox
from repro.kernels import ops as jops
from repro_torch import api, runtime
from repro_torch.core import BiCADMM, BiCADMMConfig, prox
from repro_torch.data import (SyntheticSpec, make_sparse_classification,
                              make_sparse_regression)
from repro_torch.kernels import ops

KW = dict(gamma=10.0, rho_c=1.0, alpha=0.5, max_iter=300, tol=1e-4,
          zt_iters=20)
SPEC = SyntheticSpec(2, 40, 60, sparsity_level=0.75, noise=1e-3)
TORCH = {"bfloat16": torch.bfloat16, "float16": torch.float16,
         "float32": torch.float32}
# one rounding of each output type (half its ulp at 1)
ROUNDING = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11,
            torch.float32: 1e-4}


def _name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


# ------------------------------------------------------------ the policy --
def test_policy_validates_dtypes():
    with pytest.raises(ValueError, match="data"):
        runtime.PrecisionPolicy(data="int8")
    with pytest.raises(ValueError, match="accum"):
        runtime.PrecisionPolicy(accum="bfloat16")
    with pytest.raises(ValueError, match="kkt_polish"):
        runtime.PrecisionPolicy(kkt_polish="float32")


@pytest.mark.parametrize("preset", ["fp32", "bf16", "fp16", "fp64_polish"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_policy_helpers_match_jax(preset, dtype):
    pol, jpol = (runtime.PRECISION_PRESETS[preset],
                 jruntime.PRECISION_PRESETS[preset])
    assert runtime.precision_name(pol) == preset
    t = TORCH[dtype]
    for helper in ("data_dtype", "state_dtype", "accum_dtype"):
        got = getattr(pol, helper)(t)
        assert isinstance(got, torch.dtype)
        assert _name(got) == str(getattr(jpol, helper)(jnp.dtype(dtype)))
    assert pol.needs_x64 == jpol.needs_x64
    x = torch.ones(3, dtype=t)
    cast = pol.cast_data(x)
    assert _name(cast.dtype) == str(jpol.cast_data(jnp.ones(3, dtype)).dtype)
    if pol.data is None or pol.data == dtype:
        assert cast is x                        # no-op, the same tensor


def test_policy_dtype_resolution():
    bf16 = runtime.PRECISION_PRESETS["bf16"]
    assert bf16.data_dtype(torch.float32) == torch.bfloat16
    assert bf16.state_dtype(torch.bfloat16) == torch.float32
    assert bf16.accum_dtype(torch.bfloat16) == torch.float32
    fp32 = runtime.PRECISION_PRESETS["fp32"]
    assert fp32.accum_dtype(torch.float32) == torch.float32
    assert bf16.accum_dtype("float16") == torch.float32
    assert not bf16.needs_x64
    assert runtime.PRECISION_PRESETS["fp64_polish"].needs_x64


# ------------------------------------------------- the plain products ----
def _rng_data(seed, shape, dtype):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    t = torch.as_tensor(a).to(TORCH[dtype])
    # the same values on both sides: the rounded tensor, widened to numpy
    return t, jnp.asarray(t.float().numpy()).astype(dtype)


def _check(got, want, scale):
    """Output dtype equal; values within f32 reassociation, or one rounding
    of a bf16 / fp16 output."""
    assert _name(got.dtype) == str(want.dtype)
    w = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), w,
                               rtol=ROUNDING[got.dtype], atol=1e-5 * scale)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("out", [None, "float32"])
@pytest.mark.parametrize("K", [None, 3])
def test_plain_products_on_half_width_a_match_jax(dtype, out, K):
    m, n = 37, 29
    a, ja = _rng_data(0, (m, n), dtype)
    kk = () if K is None else (K,)
    x, jx = _rng_data(1, (n, *kk), "float32")      # f32 iterates
    b, jb = _rng_data(2, (m, *kk), dtype)          # data-typed targets
    od, jod = (None, None) if out is None else (torch.float32, jnp.float32)
    sa = float(np.abs(np.asarray(ja, np.float32)).max())
    _check(ops.matvec_auto(a, x, od), jops.matvec_auto(ja, jx, jod),
           sa * n * 4)
    _check(ops.rmatvec_auto(a, b, od), jops.rmatvec_auto(ja, jb, jod),
           sa * m * 4)
    _check(ops.rmatvec_auto(a, torch.ones((m, *kk)), od),
           jops.rmatvec_auto(ja, jnp.ones((m, *kk), jnp.float32), jod),
           sa * m)
    _check(ops.gram_auto(a, od), jops.gram_auto(ja, jod), sa * sa * m)
    _check(ops.gram_auto(a.mT, od), jops.gram_auto(ja.T, jod), sa * sa * n)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("shift", ["scalar", "vector"])
def test_plain_normal_matvec_keeps_w_in_f32_like_the_cpu_row(dtype, shift):
    """The JAX package's CPU row a.T @ (a @ p) + shift * p promotes bf16 A
    against an f32 p: w and the output stay f32, and so do the port's."""
    m, n = 41, 23
    a, ja = _rng_data(3, (2, m, n), dtype)
    p, jp = _rng_data(4, (2, n), "float32")
    s = (1.5 if shift == "scalar"
         else torch.as_tensor(np.linspace(0.5, 2.0, n, dtype=np.float32)))
    js = s if shift == "scalar" else jnp.asarray(s.numpy())
    got = ops.normal_matvec_auto(a, p, s)
    assert got.dtype == torch.float32 and got.shape == p.shape
    for z in range(2):
        want = jops.normal_matvec_auto(ja[z], jp[z], js)
        scale = float((np.abs(np.asarray(ja[z], np.float32)).T
                       @ (np.abs(np.asarray(ja[z], np.float32))
                          @ np.abs(np.asarray(jp[z])))).max())
        _check(got[z], want, scale)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_setups_build_f32_factors(dtype):
    """Every set-up accumulates and emits in f32 (``_accum``): the Gram,
    A^T b, the Cholesky factors and the Jacobi diagonal, as the JAX
    package's set-ups do."""
    a, ja = _rng_data(5, (2, 30, 50), dtype)
    b, jb = _rng_data(6, (2, 30), dtype)
    diag = prox.col_sumsq(a)
    assert diag.dtype == torch.float32
    for z in range(2):
        want = jprox.col_sumsq(ja[z])
        assert str(want.dtype) == "float32"
        np.testing.assert_allclose(diag[z].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    for f in (prox.ridge_setup(a, b, 0.05, 1.0),
              prox.woodbury_setup(a, b, 0.05, 1.0)):
        assert f.chol.dtype == f.Atb.dtype == torch.float32
    cg = prox.cg_setup(a, b)
    assert cg.Atb.dtype == cg.diag.dtype == torch.float32
    assert cg.A is a                       # read in place, never widened


# ----------------------------------------------------------- whole fits --
@functools.lru_cache(maxsize=None)
def _jax_solver(loss, x_solver, precision, max_iter):
    return JaxBiCADMM(loss, JaxConfig(
        kappa=SPEC.kappa, x_solver=x_solver, precision=precision,
        **{**KW, "max_iter": max_iter}))


def _assert_same(port, jres):
    assert int(port.status) == int(jres.status)
    np.testing.assert_array_equal(port.support.numpy(),
                                  np.asarray(jres.support))
    np.testing.assert_allclose(port.z.numpy(), np.asarray(jres.z),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(port.coef.numpy(), np.asarray(jres.coef),
                               rtol=1e-3, atol=1e-3)
    assert abs(int(port.iters) - int(jres.iters)) <= 2


FITS = [("squared", xs, prec, 300) for prec in ("bf16", "fp16")
        for xs in ("dense", "woodbury", "pcg")]
# Newton-CG: 60 iterations bound the CPU time; both stop at MAX_ITER
FITS.append(("logistic", "auto", "bf16", 60))


@pytest.mark.parametrize("loss,x_solver,precision,max_iter", FITS)
def test_fit_matches_jax(loss, x_solver, precision, max_iter):
    make = (make_sparse_regression if loss == "squared"
            else make_sparse_classification)
    As, bs, _ = make(1, SPEC)
    jres = _jax_solver(loss, x_solver, precision, max_iter).fit(
        jnp.asarray(As), jnp.asarray(bs))
    solver = BiCADMM(loss, BiCADMMConfig(
        kappa=SPEC.kappa, x_solver=x_solver, precision=precision,
        **{**KW, "max_iter": max_iter}))
    A, b = torch.as_tensor(As), torch.as_tensor(bs)
    port = solver.fit(A, b)
    _assert_same(port, jres)
    # f32 iterates over half-width data, as the JAX package keeps them
    assert port.z.dtype == port.coef.dtype == port.state.x.dtype == \
        torch.float32
    # the cast is made once a data pair: a refit finds it and the factors
    cast = solver._cast(A, b)
    assert cast[0].dtype == TORCH[runtime.PRECISION_PRESETS[precision].data]
    assert solver._cast(A, b)[0] is cast[0]


def test_estimator_takes_data_cast_by_the_caller():
    """bf16 data handed in as it is fits exactly as f32 data that the
    engine casts: the same rounded values reach the same solver."""
    As, bs, _ = make_sparse_regression(1, SPEC)
    kw = dict(kappa=SPEC.kappa, gamma=10.0, tol=1e-4, zt_iters=20,
              precision="bf16", device="cpu")
    f32 = api.SparseLinearRegression(**kw).fit(As, bs)
    A16 = torch.as_tensor(As).to(torch.bfloat16)
    b16 = torch.as_tensor(bs).to(torch.bfloat16)
    bf = api.SparseLinearRegression(**kw).fit(A16, b16)
    assert torch.equal(bf.coef_, f32.coef_)
    assert bf.n_iter_ == f32.n_iter_
    assert f32.capabilities_.precisions == ("float32", "bfloat16", "float16")
    # scoring reads the bf16 data through the matvec row, f32 out
    assert bf.predict(A16).dtype == torch.float32
    assert abs(bf.score(A16, b16) - f32.score(As, bs)) < 1e-2


# ------------------------------------------------------------- refusals --
@pytest.mark.parametrize("kw", [
    dict(precision="bf16", n_feature_blocks=2),
    dict(precision="fp16", force_feature_split=True),
    dict(precision=runtime.PrecisionPolicy(data="bfloat16")),  # bf16 state
])
def test_unported_precisions_raise_capability_error(kw):
    with pytest.raises(api.CapabilityError):
        api.SparseLinearRegression(kappa=3, device="cpu", **kw)
    with pytest.raises(runtime.CapabilityError):
        BiCADMMConfig(kappa=3, **kw)


def test_data_of_another_type_than_the_policys_is_refused():
    X16 = torch.ones(4, 3, dtype=torch.float16)
    y = torch.ones(4)
    with pytest.raises(api.CapabilityError):     # fp16 data, bf16 preset
        api.SparseLinearRegression(kappa=2, device="cpu",
                                   precision="bf16").fit(X16, y)
    with pytest.raises(api.CapabilityError):     # half data, fp32 preset
        api.SparseLinearRegression(kappa=2, device="cpu").fit(X16, y)
