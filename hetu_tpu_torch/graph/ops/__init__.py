"""Graph-level operator library: the ops this slice has ported (counterpart
of ``hetu_tpu/graph/ops/__init__.py``)."""
from .arith import (
    add_op, addbyconst_op, mul_op, mul_byconst_op, div_op, div_const_op,
    opposite_op, sqrt_op, rsqrt_op, oneslike_op, zeroslike_op, where_op,
    relu_op, relu_gradient_op, leaky_relu_op, leaky_relu_gradient_op,
    sigmoid_op, tanh_op, gelu_op, exp_op, log_op,
    softmax_func, softmax_op, softmax_gradient_op,
)
from .shape import (
    array_reshape_op, array_reshape_gradient_op, transpose_op,
    slice_op, slice_gradient_op, split_op, split_gradient_op,
    concat_op, concat_gradient_op, pad_op, pad_gradient_op,
    broadcastto_op, broadcast_shape_op,
    reduce_sum_op, reduce_mean_op, reducesumaxiszero_op, one_hot_op,
)
from .matmul import (
    matmul_op, batch_matmul_op, matrix_dot_op, SparseInputOp, csrmv_op,
    csrmm_op,
)
from .conv import (
    conv2d_op, conv2d_gradient_of_data_op, conv2d_gradient_of_filter_op,
    conv2d_broadcastto_op, conv2d_reducesum_op,
    max_pool2d_op, max_pool2d_gradient_op, avg_pool2d_op,
    avg_pool2d_gradient_op,
)
from .norm import (
    batch_normalization_op, layer_normalization_op, instance_normalization2d_op,
    BatchNormOp,
)
from .dropout import (
    dropout_op, dropout_gradient_op, dropout2d_op, dropout2d_gradient_op,
)
from .gnn import distgcn_15d_op
from .embedding import (
    IndexedRows, embedding_lookup_op, embedding_lookup_gradient_op,
)
from .losses import (
    softmaxcrossentropy_op, softmaxcrossentropy_gradient_op,
    binarycrossentropy_op, binarycrossentropy_gradient_op,
)
from .comm import (
    AllReduceCommunicateOp, allreduceCommunicate_op,
    GroupAllReduceCommunicateOp, groupallreduceCommunicate_op,
    datah2d_op, datad2h_op, dispatch,
)
from ..node import Variable, placeholder_op, Op, PlaceholderOp, find_topo_sort

import types as _types

__all__ = [_k for _k, _v in list(globals().items())
           if not _k.startswith("_") and not isinstance(_v, _types.ModuleType)]
