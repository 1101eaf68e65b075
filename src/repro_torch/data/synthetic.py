"""Synthetic SML datasets of the paper's §4, on a numpy ``Generator(seed)``
(counterpart of ``repro.data.synthetic``; same recipe, other random bits).

* Standard-normal features, columns normalized to unit l2 norm over the
  global stacked matrix, then split into N nodes of m rows.
* A planted model with kappa = round(n (1 - s_l)) nonzeros.
* Targets b = A x_true + noise * e, e ~ N(0, 1); the classification
  variants take the sign (SLogR / SSVM, 2 % of labels flipped) or the argmax
  over C planted heads (SSR) of the standardized scores.

The generators return numpy arrays — As (N, m, n) float32, bs (N, m)
(float32, or int64 class labels for the softmax), x_true (n,) or (n, C) —
which the estimators move to the solve's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    n_nodes: int          # N
    m_per_node: int       # m_i
    n_features: int       # n
    sparsity_level: float = 0.8   # s_l; kappa = round(n (1 - s_l))
    noise: float = 1e-2
    n_classes: int = 1

    @property
    def kappa(self) -> int:
        return max(1, round(self.n_features * (1.0 - self.sparsity_level)))


def _targets(rng, spec, As, x_true):
    scores = As @ x_true
    noise = rng.standard_normal(scores.shape, dtype=np.float32)
    return (scores + np.float32(spec.noise) * noise).astype(np.float32)


def _features(rng, spec):
    N, m, n = spec.n_nodes, spec.m_per_node, spec.n_features
    A = rng.standard_normal((N * m, n), dtype=np.float32)
    A /= np.linalg.norm(A, axis=0, keepdims=True)
    return A.reshape(N, m, n)


def _planted(rng, spec, K: int = 1):
    """(n, K) with kappa nonzero rows, entries bounded away from 0."""
    n, kappa = spec.n_features, spec.kappa
    v = rng.standard_normal((kappa, K), dtype=np.float32)
    idx = rng.permutation(n)[:kappa]
    x_true = np.zeros((n, K), np.float32)
    x_true[idx] = v + np.sign(v)
    return x_true


def make_sparse_regression(seed: int, spec: SyntheticSpec):
    """Returns (As (N,m,n), bs (N,m), x_true (n,)) — the paper's SLS data."""
    rng = np.random.default_rng(seed)
    As = _features(rng, spec)
    x_true = _planted(rng, spec)[:, 0]
    return As, _targets(rng, spec, As, x_true), x_true


def make_sparse_classification(seed: int, spec: SyntheticSpec):
    """Labels in {-1, +1} from the planted model, 2 % of them flipped
    (SLogR / SSVM). Returns (As, bs float32, x_true (n,))."""
    rng = np.random.default_rng(seed)
    As = _features(rng, spec)
    x_true = _planted(rng, spec)[:, 0]
    scores = As @ x_true
    scores /= scores.std()
    flip = rng.random(scores.shape) < 0.02
    sign = np.sign(scores)
    bs = np.where(flip, -sign, sign).astype(np.float32)
    return As, bs, x_true


def make_sparse_softmax(seed: int, spec: SyntheticSpec):
    """Integer labels, the argmax over C = ``spec.n_classes`` planted heads
    of the standardized scores plus N(0, 0.1^2) noise (SSR). Returns
    (As, bs int64, x_true (n, C))."""
    C = spec.n_classes
    if C < 2:
        raise ValueError("softmax needs n_classes >= 2")
    rng = np.random.default_rng(seed)
    As = _features(rng, spec)
    x_true = _planted(rng, spec, K=C)
    scores = As @ x_true
    scores /= scores.std()
    noise = rng.standard_normal(scores.shape, dtype=np.float32)
    bs = np.argmax(scores + np.float32(0.1) * noise, axis=-1)
    return As, bs, x_true


def _graded(rng, spec, base: float, lo: float):
    """Orthonormal design (QR of a normal matrix) and a planted model with
    linearly graded magnitudes base -> lo: the well-posed family whose
    best-subset support is exactly the top-kappa magnitudes."""
    N, m, n, kappa = (spec.n_nodes, spec.m_per_node, spec.n_features,
                      spec.kappa)
    Q, _ = np.linalg.qr(rng.standard_normal((N * m, n)))
    As = Q.astype(np.float32).reshape(N, m, n)
    mags = np.linspace(base, lo, kappa)
    signs = np.where(rng.random(kappa) < 0.5, 1.0, -1.0)
    idx = rng.permutation(n)[:kappa]
    x_true = np.zeros(n, np.float32)
    x_true[idx] = mags * signs
    return As, x_true


def make_graded_regression(seed: int, spec: SyntheticSpec, *,
                           base: float = 3.0, lo: float = 1.0):
    """Regression targets on the graded family (:func:`_graded`)."""
    rng = np.random.default_rng(seed)
    As, x_true = _graded(rng, spec, base, lo)
    return As, _targets(rng, spec, As, x_true), x_true


def make_graded_classification(seed: int, spec: SyntheticSpec, *,
                               base: float = 3.0, lo: float = 1.0):
    """{-1, +1} labels, the sign of the graded family's scores (a zero
    score counts as +1), no label noise. Returns (As, bs float32,
    x_true (n,))."""
    rng = np.random.default_rng(seed)
    As, x_true = _graded(rng, spec, base, lo)
    scores = As @ x_true
    bs = np.sign(np.where(scores == 0, 1.0, scores)).astype(np.float32)
    return As, bs, x_true
