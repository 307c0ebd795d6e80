"""Parallel placement (counterpart of ``hetu_tpu/parallel``): the
multi-process world and its transport (:mod:`.multihost`), the five-axis
mesh (:mod:`.mesh`), the transformer pipeline over its ``pp`` axis
(:mod:`.pipeline`), and DistGCN's 1.5D products over a process grid
(:mod:`.distgcn`)."""
from . import distgcn, mesh, multihost, pipeline

__all__ = ["distgcn", "mesh", "multihost", "pipeline"]
