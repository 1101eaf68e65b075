"""The LM substrate of the port: the decoder-only dense LM's serving path
(``zoo.init_params`` / ``init_cache`` / ``prefill`` / ``decode_step`` and
``forward``), its causal self-attention on the hand-written flash-attention
kernel."""
from . import zoo  # noqa: F401
