"""Model families of the port (counterpart of ``hetu_tpu/models``):
:mod:`.transformer` (the trunk shared by the causal LM and the encoder,
its switch MoE MLP, and its training), :mod:`.bert`, :mod:`.vit`,
:mod:`.generate` (decoding with a KV cache), and the HuggingFace
checkpoint import and export of :mod:`.hf_llama`, :mod:`.hf_gpt2`,
:mod:`.hf_bert` and :mod:`.hf_vit` over :mod:`.hf_common` (no module
imports ``transformers``)."""
from . import transformer
from . import bert
from . import vit
from . import generate
from . import hf_common, hf_llama, hf_gpt2, hf_bert, hf_vit

__all__ = ["transformer", "bert", "vit", "generate", "hf_common", "hf_llama",
           "hf_gpt2", "hf_bert", "hf_vit"]
