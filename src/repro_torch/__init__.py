"""repro_torch — the PyTorch/CUDA port of the Bi-cADMM system.

A second package beside the JAX reference ``repro``: the same module tree,
PyTorch inside, hand-written Hopper kernels (``csrc/``) where the JAX
package has Pallas kernels. It imports neither ``jax`` nor ``repro``.
Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""
__version__ = "0.1.0"
