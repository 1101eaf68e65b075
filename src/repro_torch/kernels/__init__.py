"""Hand-written Hopper kernels of the port and their plain versions.

Importing this package registers every kernel's ``"cuda"`` and ``"cpu"``
rows; it builds nothing and needs neither ``nvcc`` nor a card (the kernels
are compiled at their first launch, see :mod:`repro_torch.kernels.build`).
"""
from . import ops  # noqa: F401  (registers the kernel rows)
