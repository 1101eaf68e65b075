"""Synthetic SML datasets of the paper's §4, on a numpy ``Generator(seed)``
(counterpart of ``repro.data.synthetic``; same recipe, other random bits).

* Standard-normal features, columns normalized to unit l2 norm over the
  global stacked matrix, then split into N nodes of m rows.
* A planted model with kappa = round(n (1 - s_l)) nonzeros.
* Targets b = A x_true + noise * e, e ~ N(0, 1).

The generators return float32 numpy arrays — As (N, m, n), bs (N, m),
x_true (n,) — which the estimators move to the solve's device.
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


def make_sparse_regression(seed: int, spec: SyntheticSpec):
    """Returns (As (N,m,n), bs (N,m), x_true (n,)) — the paper's SLS data."""
    rng = np.random.default_rng(seed)
    N, m, n, kappa = (spec.n_nodes, spec.m_per_node, spec.n_features,
                      spec.kappa)
    A = rng.standard_normal((N * m, n), dtype=np.float32)
    A /= np.linalg.norm(A, axis=0, keepdims=True)
    As = A.reshape(N, m, n)
    v = rng.standard_normal(kappa, dtype=np.float32)
    vals = v + np.sign(v)                       # bounded away from 0
    idx = rng.permutation(n)[:kappa]
    x_true = np.zeros(n, np.float32)
    x_true[idx] = vals
    return As, _targets(rng, spec, As, x_true), x_true


def make_graded_regression(seed: int, spec: SyntheticSpec, *,
                           base: float = 3.0, lo: float = 1.0):
    """Orthonormal design (QR of a normal matrix) and a planted model with
    linearly graded magnitudes base -> lo: the well-posed family whose
    best-subset support is exactly the top-kappa magnitudes."""
    rng = np.random.default_rng(seed)
    N, m, n, kappa = (spec.n_nodes, spec.m_per_node, spec.n_features,
                      spec.kappa)
    Q, _ = np.linalg.qr(rng.standard_normal((N * m, n)))
    As = Q.astype(np.float32).reshape(N, m, n)
    mags = np.linspace(base, lo, kappa)
    signs = np.where(rng.random(kappa) < 0.5, 1.0, -1.0)
    idx = rng.permutation(n)[:kappa]
    x_true = np.zeros(n, np.float32)
    x_true[idx] = mags * signs
    return As, _targets(rng, spec, As, x_true), x_true
