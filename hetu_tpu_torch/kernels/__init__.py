"""Hand-written CUDA kernels for Hopper behind the dispatch registry
(counterpart of ``hetu_tpu/kernels``). Sources live in ``csrc/``; each
kernel module registers itself with :mod:`.registry` on import.

Ported so far: ``fused_sgd`` and ``fused_adam`` (:mod:`.fused_opt`), one
launch per parameter; ``flash_attention_fwd`` and ``flash_attention_bwd``
(:mod:`.flash_attention`); ``fused_linear_nll_fwd`` and
``fused_linear_nll_bwd`` (:mod:`.fused_ce`); ``csr_spmm`` and ``csr_spmv``
(:mod:`.csr_spmm`); ``fused_embed_grad`` (:mod:`.embed_grad`).
"""
from . import registry
from . import fused_opt
from . import flash_attention
from . import fused_ce
from . import csr_spmm
from . import embed_grad

__all__ = ["registry", "fused_opt", "flash_attention", "fused_ce",
           "csr_spmm", "embed_grad"]
