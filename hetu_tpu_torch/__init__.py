"""hetu_tpu_torch — the PyTorch/CUDA port of ``hetu_tpu``, for an NVIDIA
H100. Public surface laid out like ``hetu_tpu/__init__.py``, so model code
written against ``hetu_tpu`` imports unchanged:

    import hetu_tpu_torch as ht
    x = ht.Variable(name='x', trainable=False)
    w = ht.init.random_normal((784, 10), stddev=0.1, name='w')
    loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(ht.matmul_op(x, w), y), [0])
    train_op = ht.optim.SGDOptimizer(0.1).minimize(loss)
    executor = ht.Executor({'train': [loss, train_op]})   # cuda:0
    executor.run('train', feed_dict={...})

This package imports torch, never jax, and nothing of ``hetu_tpu``.
"""
from .graph.ops import *  # noqa: F401,F403 — the ported op registry
from .graph.node import Variable, placeholder_op, Op, find_topo_sort
from .graph.gradients import gradients
from .graph.executor import (
    Executor, HetuConfig, SubExecutor,
    wrapped_mpi_nccl_init, mpi_nccl_init, mpi_nccl_finish, new_group_comm,
)
from .ps import (
    worker_init, worker_finish, get_worker_communicate,
    scheduler_init, scheduler_finish, server_init, server_finish,
)
from .cstable import CacheSparseTable
from .context import context, get_current_context, DeviceGroup
from .dataloader import (
    dataloader_op, Dataloader, DataloaderOp, GNNDataLoaderOp,
)
from .ndarray import (
    cpu, gpu, tpu, array, empty, sparse_array, is_gpu_ctx, is_tpu_ctx,
    NDArray, ND_Sparse_Array, DLContext,
)
from . import optimizer as optim
from . import lr_scheduler as lr
from . import initializers as init
from . import data
from . import metrics
from . import interop
from . import comm_quant
from . import parallel
from . import kernels
from . import models

__version__ = "0.1.0"
