"""repro_torch.stream: the streaming solve subsystem, one import surface
(counterpart of ``repro.stream``).

Minibatch Bi-cADMM: feed data in row chunks through ``partial_fit`` and the
engine maintains the (7a) x-update factors incrementally: rank-k Cholesky
up/downdates of the dense or Woodbury factor on the card's
``chol_rank_update`` kernel, ``A^T b`` and the preconditioner diagonal in
the precision policy's accumulation dtype, a bounded replay window with
row eviction, and warm-started refits guarded by a support-drift probe
(:mod:`repro_torch.core.streaming`).

Three entry levels, lowest to highest:

* :func:`chol_update` / :func:`chol_downdate` / :func:`chol_append`, the
  incremental Cholesky primitives;
* :class:`StreamingBiCADMM`, the engine (``partial_fit`` on raw chunks);
* :func:`stream` / :class:`StreamingSolver`, the api front-end
  (``Capabilities.stream``); the estimators expose the same path as
  ``model.partial_fit(X_t, y_t)``.

>>> from repro_torch.stream import stream
>>> from repro_torch.api import SparseProblem
>>> s = stream(SparseProblem(loss="squared", kappa=10, gamma=10.0))
>>> for X_t, y_t in chunks:
...     res = s.partial_fit(X_t, y_t)
"""
from .api import StreamingSolver, stream
from .core.prox import chol_append, chol_downdate, chol_update
from .core.streaming import (CGStreamAccum, DenseStreamAccum,
                             StreamingBiCADMM, WoodburyStreamAccum)

__all__ = [
    "CGStreamAccum",
    "DenseStreamAccum",
    "StreamingBiCADMM",
    "StreamingSolver",
    "WoodburyStreamAccum",
    "chol_append",
    "chol_downdate",
    "chol_update",
    "stream",
]
