"""Model families of the port (counterpart of ``hetu_tpu/models``):
:mod:`.transformer` (the trunk shared by the causal LM and the encoder,
and its training), :mod:`.bert`, and :mod:`.generate` (decoding with a
KV cache)."""
from . import transformer
from . import bert
from . import generate

__all__ = ["transformer", "bert", "generate"]
