"""Model families of the port (counterpart of ``hetu_tpu/models``):
:mod:`.transformer` (the trunk shared by the causal LM and the encoder)
and :mod:`.bert`, forward only in this slice."""
from . import transformer
from . import bert

__all__ = ["transformer", "bert"]
