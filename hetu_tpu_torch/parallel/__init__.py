"""Parallel placement (counterpart of ``hetu_tpu/parallel``): the
multi-process world of data parallelism and its process grids
(:mod:`.multihost`), and DistGCN's 1.5D products over a grid
(:mod:`.distgcn`)."""
from . import distgcn, multihost

__all__ = ["distgcn", "multihost"]
