"""Parallel placement (counterpart of ``hetu_tpu/parallel``): so far the
multi-process world of data parallelism (:mod:`.multihost`)."""
from . import multihost

__all__ = ["multihost"]
