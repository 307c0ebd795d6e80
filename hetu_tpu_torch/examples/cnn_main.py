"""CNN example trainer on the port (counterpart of ``examples/cnn/main.py``)
for the models this slice supports: ``mlp`` and ``logreg``.

Usage:
    python -m hetu_tpu_torch.examples.cnn_main --model mlp --dataset CIFAR10
    python -m hetu_tpu_torch.examples.cnn_main --model logreg --dataset MNIST --gpu -1
    python -m hetu_tpu_torch.runner -w 2 \
        python -m hetu_tpu_torch.examples.cnn_main --model mlp \
        --dataset CIFAR10 --comm-mode AllReduce --gpu -1

``--comm-mode AllReduce`` trains data-parallel, one process per device,
under ``hetu_tpu_torch.runner`` (gloo on the CPU with ``--gpu -1``, NCCL
on the cards otherwise, one card per worker); ``HETU_COMM_QUANT`` (int8,
fp8) quantizes the gradient all-reduce of the large parameters, as in the
JAX example. Only rank 0 logs; the loss and accuracy it logs are the
global batch's.
"""
import argparse
import logging
from time import time

import numpy as np

import hetu_tpu_torch as ht
from hetu_tpu_torch import init

logger = logging.getLogger(__name__)


# -- models (copies of examples/cnn/models/MLP.py and LogReg.py) -----------

def fc(x, shape, name, with_relu=True):
    weight = init.random_normal(shape=shape, stddev=0.1, name=name + '_weight')
    bias = init.random_normal(shape=shape[-1:], stddev=0.1, name=name + '_bias')
    x = ht.matmul_op(x, weight)
    x = x + ht.broadcastto_op(bias, x)
    if with_relu:
        x = ht.relu_op(x)
    return x


def mlp(x, y_, num_class=10, input_dim=3072):
    """MLP for flattened CIFAR10 (3072) or MNIST (784)."""
    x = fc(x, (input_dim, 256), 'mlp_fc1', with_relu=True)
    x = fc(x, (256, 256), 'mlp_fc2', with_relu=True)
    y = fc(x, (256, num_class), 'mlp_fc3', with_relu=False)
    loss = ht.softmaxcrossentropy_op(y, y_)
    loss = ht.reduce_mean_op(loss, [0])
    return loss, y


def logreg(x, y_, num_class=10, input_dim=784):
    weight = init.zeros((input_dim, num_class), name='logreg_weight')
    bias = init.zeros((num_class,), name='logreg_bias')
    logit = ht.matmul_op(x, weight) + ht.broadcastto_op(bias, ht.matmul_op(x, weight))
    loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(logit, y_), [0])
    return loss, logit


MODELS = {'mlp': mlp, 'logreg': logreg}

OPTIMIZERS = {
    'sgd': lambda lr: ht.optim.SGDOptimizer(learning_rate=lr),
    'momentum': lambda lr: ht.optim.MomentumOptimizer(learning_rate=lr),
    'nesterov': lambda lr: ht.optim.MomentumOptimizer(learning_rate=lr,
                                                      nesterov=True),
    'adagrad': lambda lr: ht.optim.AdaGradOptimizer(
        learning_rate=lr, initial_accumulator_value=0.1),
    'adam': lambda lr: ht.optim.AdamOptimizer(learning_rate=lr),
}


def load_dataset(dataset):
    """(train_x, train_y, valid_x, valid_y, input_dim, num_class), inputs
    flattened for the dense models."""
    if dataset == 'MNIST':
        (train_x, train_y), (valid_x, valid_y), _ = ht.data.mnist()
        return train_x, train_y, valid_x, valid_y, 784, 10
    num_class = 10 if dataset == 'CIFAR10' else 100
    train_x, train_y, valid_x, valid_y = ht.data.normalize_cifar(
        num_class=num_class)
    return (train_x.reshape(train_x.shape[0], -1), train_y,
            valid_x.reshape(valid_x.shape[0], -1), valid_y, 3072, num_class)


def build(model, dataset, batch_size, opt, learning_rate, data=None):
    """The graph of one run: returns (loss, y, y_, train_op)."""
    train_x, train_y, valid_x, valid_y, input_dim, num_class = (
        data if data is not None else load_dataset(dataset))
    x = ht.dataloader_op([
        ht.Dataloader(train_x, batch_size, 'train'),
        ht.Dataloader(valid_x, batch_size, 'validate'),
    ])
    y_ = ht.dataloader_op([
        ht.Dataloader(train_y, batch_size, 'train'),
        ht.Dataloader(valid_y, batch_size, 'validate'),
    ])
    loss, y = MODELS[model](x, y_, num_class, input_dim)
    train_op = OPTIMIZERS[opt](learning_rate).minimize(loss)
    return loss, y, y_, train_op


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--model', type=str, required=True, choices=sorted(MODELS))
    parser.add_argument('--dataset', type=str, required=True,
                        choices=['MNIST', 'CIFAR10', 'CIFAR100'])
    parser.add_argument('--batch-size', type=int, default=128)
    parser.add_argument('--learning-rate', type=float, default=0.1)
    parser.add_argument('--opt', type=str, default='sgd', choices=sorted(OPTIMIZERS))
    parser.add_argument('--num-epochs', type=int, default=10)
    parser.add_argument('--gpu', type=int, default=0,
                        help='device id; -1 means cpu')
    parser.add_argument('--validate', action='store_true')
    parser.add_argument('--timing', action='store_true')
    parser.add_argument('--comm-mode', default=None)
    parser.add_argument('--steps', type=int, default=None,
                        help='training steps per epoch (default: every batch)')
    parser.add_argument('--seed', type=int, default=None,
                        help='parameter seed (default: a random one)')
    args = parser.parse_args(argv)

    device_id = 0
    if args.comm_mode in ('AllReduce', 'Hybrid'):
        comm, device_id = ht.mpi_nccl_init(init_nccl=args.gpu >= 0)
        executor_ctx = ht.gpu(comm.local_rank()) if args.gpu >= 0 else ht.cpu(0)
    else:
        executor_ctx = ht.cpu(0) if args.gpu == -1 else ht.gpu(args.gpu)
    log = logger.info if device_id == 0 else (lambda *a: None)
    log("Training %s on hetu_tpu_torch (ctx=%s)", args.model, executor_ctx)
    loss, y, y_, train_op = build(args.model, args.dataset, args.batch_size,
                                  args.opt, args.learning_rate)
    eval_nodes = {'train': [loss, y, y_, train_op], 'validate': [loss, y, y_]}
    executor = ht.Executor(eval_nodes, ctx=executor_ctx, seed=args.seed,
                           comm_mode=args.comm_mode)
    if executor.comm_quant_report is not None:
        log("comm_quant %s: %s", executor.config.comm_quant_policy,
            executor.comm_quant_report)
    n_train_batches = executor.get_batch_num('train')
    if args.steps is not None:
        n_train_batches = min(n_train_batches, args.steps)
    n_valid_batches = executor.get_batch_num('validate')

    running_time = 0
    for i in range(args.num_epochs + 1):
        log("Epoch %d", i)
        loss_all = 0
        correct_predictions = []
        start = time()
        for _ in range(n_train_batches):
            loss_val, predict_y, y_val, _ = executor.run(
                'train', eval_node_list=[loss, y, y_, train_op])
            loss_all += loss_val.asnumpy()
            correct_predictions.extend(
                np.equal(np.argmax(y_val.asnumpy(), 1),
                         np.argmax(predict_y.asnumpy(), 1)).astype(float))
        log("Train loss = %f", loss_all / n_train_batches)
        log("Train accuracy = %f", np.mean(correct_predictions))
        if args.timing:
            during_time = time() - start
            log("Running time of current epoch = %fs", during_time)
            if i != 0:
                running_time += during_time
        if args.validate:
            correct_predictions = []
            val_loss_all = 0
            for _ in range(n_valid_batches):
                loss_val, valid_y_predicted, y_val = executor.run(
                    'validate', convert_to_numpy_ret_vals=True)
                val_loss_all += loss_val
                correct_predictions.extend(
                    np.equal(np.argmax(y_val, 1),
                             np.argmax(valid_y_predicted, 1)).astype(float))
            log("Validation loss = %f", val_loss_all / n_valid_batches)
            log("Validation accuracy = %f", np.mean(correct_predictions))
    log("Running time of total %d epoch = %fs", args.num_epochs,
        running_time)
    if args.comm_mode in ('AllReduce', 'Hybrid'):
        ht.mpi_nccl_finish(comm)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s - %(name)s - %(levelname)s - %(message)s')
    main()
