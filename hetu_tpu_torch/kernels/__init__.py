"""Hand-written CUDA kernels for Hopper behind the dispatch registry
(counterpart of ``hetu_tpu/kernels``). Sources live in ``csrc/``; each
kernel module registers itself with :mod:`.registry` on import.

Ported so far: ``fused_sgd`` and ``fused_adam`` (:mod:`.fused_opt`), one
launch per parameter; ``flash_attention_fwd`` (:mod:`.flash_attention`)
and ``fused_linear_nll_fwd`` (:mod:`.fused_ce`), forward only.
"""
from . import registry
from . import fused_opt
from . import flash_attention
from . import fused_ce

__all__ = ["registry", "fused_opt", "flash_attention", "fused_ce"]
