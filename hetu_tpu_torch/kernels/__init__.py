"""Hand-written CUDA kernels for Hopper behind the dispatch registry
(counterpart of ``hetu_tpu/kernels``). Sources live in ``csrc/``; each
kernel module registers itself with :mod:`.registry` on import.

Ported so far: ``fused_sgd`` and ``fused_adam`` (:mod:`.fused_opt`), one
launch per parameter.
"""
from . import registry
from . import fused_opt

__all__ = ["registry", "fused_opt"]
