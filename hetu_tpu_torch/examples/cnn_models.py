"""The CNN example zoo on the port: copies of the builders of
``examples/cnn/models/`` (MLP, LogReg, CNN, LeNet, AlexNet, VGG, ResNet,
RNN, LSTM, ViT) over ``hetu_tpu_torch``. Each builder takes the input and
label nodes and returns ``(loss, y)``; parameter names, shapes and
initializers are the reference's, so checkpoints move between the two
packages.
"""
import numpy as np

import hetu_tpu_torch as ht
from hetu_tpu_torch import init


# -- MLP, LogReg (examples/cnn/models/MLP.py, LogReg.py) -------------------

def _fc_normal(x, shape, name, with_relu=True):
    weight = init.random_normal(shape=shape, stddev=0.1, name=name + '_weight')
    bias = init.random_normal(shape=shape[-1:], stddev=0.1, name=name + '_bias')
    y = ht.matmul_op(x, weight)
    y = y + ht.broadcastto_op(bias, y)
    return ht.relu_op(y) if with_relu else y


def _fc_he(x, shape, name, with_relu=True):
    w = init.he_normal(shape, name=name + '_weight')
    b = init.zeros(shape[-1:], name=name + '_bias')
    y = ht.matmul_op(x, w)
    y = y + ht.broadcastto_op(b, y)
    return ht.relu_op(y) if with_relu else y


def _ce_loss(y, y_):
    return ht.reduce_mean_op(ht.softmaxcrossentropy_op(y, y_), [0])


def mlp(x, y_, num_class=10, input_dim=3072):
    """MLP for flattened CIFAR10 (3072) or MNIST (784)."""
    x = _fc_normal(x, (input_dim, 256), 'mlp_fc1')
    x = _fc_normal(x, (256, 256), 'mlp_fc2')
    y = _fc_normal(x, (256, num_class), 'mlp_fc3', with_relu=False)
    return _ce_loss(y, y_), y


def logreg(x, y_, num_class=10, input_dim=784):
    weight = init.zeros((input_dim, num_class), name='logreg_weight')
    bias = init.zeros((num_class,), name='logreg_bias')
    logit = ht.matmul_op(x, weight) + ht.broadcastto_op(
        bias, ht.matmul_op(x, weight))
    return _ce_loss(logit, y_), logit


# -- CNN-3, LeNet (examples/cnn/models/CNN.py, LeNet.py) -------------------

def cnn_3_layers(x, y_, num_class=10):
    """x expected as (N, 1, 28, 28)."""
    for shape, name in (((32, 1, 5, 5), 'cnn3_conv1'),
                        ((64, 32, 5, 5), 'cnn3_conv2')):
        weight = init.random_normal(shape=shape, stddev=0.1,
                                    name=name + '_weight')
        x = ht.relu_op(ht.conv2d_op(x, weight, padding=2, stride=1))
        x = ht.avg_pool2d_op(x, kernel_H=2, kernel_W=2, padding=0, stride=2)
    shape = (7 * 7 * 64, num_class)
    weight = init.random_normal(shape=shape, stddev=0.1, name='cnn3_fc_weight')
    bias = init.random_normal(shape=shape[-1:], stddev=0.1, name='cnn3_fc_bias')
    y = ht.matmul_op(ht.array_reshape_op(x, (-1, shape[0])), weight)
    y = y + ht.broadcastto_op(bias, y)
    return _ce_loss(y, y_), y


def lenet(x, y_, num_class=10):
    """x expected as (N, 1, 28, 28)."""
    for cin, cout, name in ((1, 6, 'lenet_conv1'), (6, 16, 'lenet_conv2')):
        weight = init.random_normal(shape=(cout, cin, 5, 5), stddev=0.1,
                                    name=name + '_weight')
        x = ht.relu_op(ht.conv2d_op(x, weight, padding=2, stride=1))
        x = ht.max_pool2d_op(x, kernel_H=2, kernel_W=2, padding=0, stride=2)
    x = ht.array_reshape_op(x, (-1, 7 * 7 * 16))
    x = _fc_normal(x, (7 * 7 * 16, 120), 'lenet_fc1')
    x = _fc_normal(x, (120, 84), 'lenet_fc2')
    y = _fc_normal(x, (84, num_class), 'lenet_fc3', with_relu=False)
    return _ce_loss(y, y_), y


# -- AlexNet (examples/cnn/models/AlexNet.py, CIFAR-sized) -----------------

def _conv_relu(x, shape, name, padding=1, stride=1):
    w = init.he_normal(shape, name=name + '_weight')
    return ht.relu_op(ht.conv2d_op(x, w, padding=padding, stride=stride))


def alexnet(x, y_, num_class=10):
    x = _conv_relu(x, (64, 3, 3, 3), 'alexnet_conv1')
    x = ht.max_pool2d_op(x, 2, 2, 0, 2)            # 16x16
    x = _conv_relu(x, (192, 64, 3, 3), 'alexnet_conv2')
    x = ht.max_pool2d_op(x, 2, 2, 0, 2)            # 8x8
    x = _conv_relu(x, (384, 192, 3, 3), 'alexnet_conv3')
    x = _conv_relu(x, (256, 384, 3, 3), 'alexnet_conv4')
    x = _conv_relu(x, (256, 256, 3, 3), 'alexnet_conv5')
    x = ht.max_pool2d_op(x, 2, 2, 0, 2)            # 4x4
    x = ht.array_reshape_op(x, (-1, 256 * 4 * 4))
    x = ht.dropout_op(_fc_he(x, (256 * 4 * 4, 1024), 'alexnet_fc1'), 0.5)
    x = ht.dropout_op(_fc_he(x, (1024, 512), 'alexnet_fc2'), 0.5)
    y = _fc_he(x, (512, num_class), 'alexnet_fc3', with_relu=False)
    return _ce_loss(y, y_), y


# -- VGG-16/19, ResNet-18/34 (examples/cnn/models/VGG.py, ResNet.py) -------

def _conv_bn(x, in_c, out_c, stride, name, kernel=3):
    w = init.he_normal((out_c, in_c, kernel, kernel), name=name + '_weight')
    x = ht.conv2d_op(x, w, padding=kernel // 2, stride=stride)
    scale = init.ones((out_c,), name=name + '_bn_scale')
    bias = init.zeros((out_c,), name=name + '_bn_bias')
    return ht.batch_normalization_op(x, scale, bias)


VGG_WIDTHS = (64, 128, 256, 512, 512)


def _vgg(x, y_, repeats, num_class=10):
    in_c = 3
    for i, (out_c, rep) in enumerate(zip(VGG_WIDTHS, repeats)):
        for j in range(rep):
            x = ht.relu_op(_conv_bn(x, in_c, out_c, 1, f'vgg_block{i}_{j}'))
            in_c = out_c
        x = ht.max_pool2d_op(x, kernel_H=2, kernel_W=2, padding=0, stride=2)
    x = ht.array_reshape_op(x, (-1, 512))
    x = _fc_he(x, (512, 4096), 'vgg_fc1')
    x = _fc_he(x, (4096, 4096), 'vgg_fc2')
    y = _fc_he(x, (4096, num_class), 'vgg_fc3', with_relu=False)
    return _ce_loss(y, y_), y


def vgg16(x, y_, num_class=10):
    return _vgg(x, y_, (2, 2, 3, 3, 3), num_class)


def vgg19(x, y_, num_class=10):
    return _vgg(x, y_, (2, 2, 4, 4, 4), num_class)


def _basic_block(x, in_c, out_c, stride, name):
    out = ht.relu_op(_conv_bn(x, in_c, out_c, stride, name + '_conv1'))
    out = _conv_bn(out, out_c, out_c, 1, name + '_conv2')
    if stride != 1 or in_c != out_c:
        x = _conv_bn(x, in_c, out_c, stride, name + '_short', kernel=1)
    return ht.relu_op(out + x)


def _resnet(x, y_, layers, num_class=10):
    cur_c = 64
    x = ht.relu_op(_conv_bn(x, 3, cur_c, 1, 'resnet_stem'))
    for stage, (n_blocks, out_c, stride) in enumerate(
            zip(layers, (64, 128, 256, 512), (1, 2, 2, 2))):
        for b in range(n_blocks):
            x = _basic_block(x, cur_c, out_c, stride if b == 0 else 1,
                             f'resnet_s{stage}_b{b}')
            cur_c = out_c
    # global average pool: (N, 512, 4, 4) -> (N, 512)
    x = ht.reduce_mean_op(x, [2, 3])
    w = init.he_normal((512, num_class), name='resnet_fc_weight')
    b = init.zeros((num_class,), name='resnet_fc_bias')
    y = ht.matmul_op(x, w)
    y = y + ht.broadcastto_op(b, y)
    return _ce_loss(y, y_), y


def resnet18(x, y_, num_class=10):
    return _resnet(x, y_, (2, 2, 2, 2), num_class)


def resnet34(x, y_, num_class=10):
    return _resnet(x, y_, (3, 4, 6, 3), num_class)


# -- RNN, LSTM over MNIST rows (examples/cnn/models/RNN.py, LSTM.py) --------

def rnn(x, y_, num_class=10, dimhidden=128, diminput=28, nsteps=28):
    w_ih = init.random_normal((diminput, dimhidden), stddev=0.1, name='rnn_w_ih')
    w_hh = init.random_normal((dimhidden, dimhidden), stddev=0.1, name='rnn_w_hh')
    b_h = init.zeros((dimhidden,), name='rnn_b_h')
    w_out = init.random_normal((dimhidden, num_class), stddev=0.1, name='rnn_w_out')
    b_out = init.zeros((num_class,), name='rnn_b_out')
    h = None
    for t in range(nsteps):
        x_t = ht.slice_op(x, (0, t * diminput), (-1, diminput))
        pre = ht.matmul_op(x_t, w_ih)
        if h is not None:
            pre = pre + ht.matmul_op(h, w_hh)
        pre = pre + ht.broadcastto_op(b_h, pre)
        h = ht.tanh_op(pre)
    y = ht.matmul_op(h, w_out)
    y = y + ht.broadcastto_op(b_out, y)
    return _ce_loss(y, y_), y


def lstm(x, y_, num_class=10, dimhidden=128, diminput=28, nsteps=28):
    """The four gate products fused into one (D, 4H) projection a step."""
    H = dimhidden
    w_ih = init.xavier_uniform((diminput, 4 * H), name='lstm_w_ih')
    w_hh = init.xavier_uniform((H, 4 * H), name='lstm_w_hh')
    b = init.zeros((4 * H,), name='lstm_b')
    w_out = init.random_normal((H, num_class), stddev=0.1, name='lstm_w_out')
    b_out = init.zeros((num_class,), name='lstm_b_out')
    h, c = None, None
    for t in range(nsteps):
        x_t = ht.slice_op(x, (0, t * diminput), (-1, diminput))
        gates = ht.matmul_op(x_t, w_ih)
        if h is not None:
            gates = gates + ht.matmul_op(h, w_hh)
        gates = gates + ht.broadcastto_op(b, gates)
        i = ht.sigmoid_op(ht.slice_op(gates, (0, 0), (-1, H)))
        f = ht.sigmoid_op(ht.slice_op(gates, (0, H), (-1, H)))
        g = ht.tanh_op(ht.slice_op(gates, (0, 2 * H), (-1, H)))
        o = ht.sigmoid_op(ht.slice_op(gates, (0, 3 * H), (-1, H)))
        c = i * g if c is None else f * c + i * g
        h = o * ht.tanh_op(c)
    y = ht.matmul_op(h, w_out)
    y = y + ht.broadcastto_op(b_out, y)
    return _ce_loss(y, y_), y


# -- ViT (examples/cnn/models/ViT.py, CIFAR-sized) --------------------------

def _dense(x, fan_in, fan_out, name):
    w = init.xavier_uniform((fan_in, fan_out), name=name + '_w')
    b = init.zeros((fan_out,), name=name + '_b')
    y = ht.matmul_op(ht.array_reshape_op(x, (-1, fan_in)), w)
    return y + ht.broadcastto_op(b, y)


def _ln(x, d, name):
    scale = init.ones((d,), name=name + '_scale')
    bias = init.zeros((d,), name=name + '_bias')
    return ht.layer_normalization_op(x, scale, bias)


def _vit_block(h, batch, tokens, d, heads, dff, name):
    """Pre-LN transformer encoder block on (B, T, D)."""
    hd = d // heads

    def split_heads(t):
        t = ht.array_reshape_op(t, (batch, tokens, heads, hd))
        return ht.transpose_op(t, (0, 2, 1, 3))

    def proj(t, which):
        return ht.array_reshape_op(_dense(t, d, d, name + which),
                                   (batch, tokens, d))

    ln1 = _ln(h, d, name + '_ln1')
    q, k, v = (split_heads(proj(ln1, w)) for w in ('_q', '_k', '_v'))
    scores = ht.mul_byconst_op(ht.batch_matmul_op(q, k, trans_B=True),
                               1.0 / np.sqrt(hd))
    attn = ht.softmax_op(scores)                       # bidirectional
    ctx = ht.transpose_op(ht.batch_matmul_op(attn, v), (0, 2, 1, 3))
    ctx = ht.array_reshape_op(ctx, (batch, tokens, d))
    h = h + proj(ctx, '_o')

    ln2 = _ln(h, d, name + '_ln2')
    f = ht.relu_op(_dense(ln2, d, dff, name + '_f1'))
    f = ht.array_reshape_op(_dense(f, dff, d, name + '_f2'),
                            (batch, tokens, d))
    return h + f


def vit(x, y_, num_class=10, batch=128, image=32, patch=4, d=64,
        heads=4, layers=4, dff=128):
    """x: (B, 3, H, W) NCHW CIFAR batch -> (loss, probs). The reshapes take
    the static ``batch``."""
    n_patch = (image // patch) ** 2                    # 64 tokens
    tokens = n_patch + 1                               # + [CLS]

    # patch embedding: conv stride=patch, then (B, D, P, P) -> (B, P*P, D)
    wp = init.he_normal((d, 3, patch, patch), name='vit_patch_w')
    h = ht.conv2d_op(x, wp, padding=0, stride=patch)   # (B, D, 8, 8)
    h = ht.array_reshape_op(h, (batch, d, n_patch))
    h = ht.transpose_op(h, (0, 2, 1))                  # (B, 64, D)

    cls = init.random_normal((1, 1, d), stddev=0.02, name='vit_cls')
    h = ht.concat_op(ht.broadcast_shape_op(cls, (batch, 1, d)), h, axis=1)
    pos = init.random_normal((1, tokens, d), stddev=0.02, name='vit_pos')
    h = h + ht.broadcastto_op(pos, h)

    for i in range(layers):
        h = _vit_block(h, batch, tokens, d, heads, dff, f'vit_l{i}')

    h = _ln(h, d, 'vit_lnf')
    cls_out = ht.slice_op(h, (0, 0, 0), (batch, 1, d))
    logits = _dense(ht.array_reshape_op(cls_out, (batch, d)), d, num_class,
                    'vit_head')
    loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(logits, y_), [0])
    return loss, ht.softmax_op(logits)


MODELS = {f.__name__: f for f in (mlp, logreg, cnn_3_layers, lenet, alexnet,
                                  vgg16, vgg19, resnet18, resnet34, rnn, lstm,
                                  vit)}
# the models that take flat rows; the others take NCHW images
FLAT = ('mlp', 'logreg', 'rnn', 'lstm')
