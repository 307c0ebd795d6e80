"""CNN example trainer on the port (counterpart of ``examples/cnn/main.py``)
for the zoo of ``examples/cnn/models`` (``cnn_models.MODELS``: mlp, logreg,
cnn_3_layers, lenet, alexnet, vgg16, vgg19, resnet18, resnet34, rnn, lstm,
vit).

Usage:
    python -m hetu_tpu_torch.examples.cnn_main --model resnet18 --dataset CIFAR10
    python -m hetu_tpu_torch.examples.cnn_main --model resnet18 --dataset CIFAR10 \
        --dtype bfloat16 --num-epochs 0 --steps 30 --profile profile_out
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

``--dtype bfloat16`` computes in bf16 over float32 parameters and slots
(the executor's ``dtype``). After the epochs rank 0 prints one JSON line:
the mean step time on the host clock (each step ends in fetching its
loss, a synchronisation) over the last epoch's steps after ``WARMUP``,
samples a second, and the kernel launches of one step. ``--profile DIR``
adds the device time of one step by kernel group (cuDNN, ``fused_sgd``,
...) and under the convolutions' ops (``ops_us``) from ``torch.profiler``
over ``PROFILE_STEPS`` steps, with the device's busy share; the table goes to
``DIR/profile_cnn_<model>_<dtype>.txt``.
"""
import argparse
import json
import logging
import os
from time import perf_counter, time

import numpy as np
import torch

import hetu_tpu_torch as ht
from hetu_tpu_torch.examples import cnn_models

logger = logging.getLogger(__name__)
WARMUP = 3
PROFILE_STEPS = 5
# the convolutions' ops, forward and backward: the profile's ``ops_us``
# gives their device time whatever cuDNN's engines are named
CONV_OPS = ("aten::cudnn_convolution", "aten::convolution_backward")


MODELS = cnn_models.MODELS

OPTIMIZERS = {
    'sgd': lambda lr: ht.optim.SGDOptimizer(learning_rate=lr),
    'momentum': lambda lr: ht.optim.MomentumOptimizer(learning_rate=lr),
    'nesterov': lambda lr: ht.optim.MomentumOptimizer(learning_rate=lr,
                                                      nesterov=True),
    'adagrad': lambda lr: ht.optim.AdaGradOptimizer(
        learning_rate=lr, initial_accumulator_value=0.1),
    'adam': lambda lr: ht.optim.AdamOptimizer(learning_rate=lr),
}


def load_dataset(dataset, model='mlp'):
    """(train_x, train_y, valid_x, valid_y, input_dim, num_class), as
    ``examples/cnn/main.py`` shapes them for ``model``: rows for the dense
    and recurrent models, NCHW images for the convolutional ones (MNIST as
    (N, 1, 28, 28) for ``lenet`` and ``cnn_3_layers``)."""
    if dataset == 'MNIST':
        (train_x, train_y), (valid_x, valid_y), _ = ht.data.mnist()
        if model in ('cnn_3_layers', 'lenet'):
            train_x = train_x.reshape(-1, 1, 28, 28)
            valid_x = valid_x.reshape(-1, 1, 28, 28)
        return train_x, train_y, valid_x, valid_y, 784, 10
    num_class = 10 if dataset == 'CIFAR10' else 100
    train_x, train_y, valid_x, valid_y = ht.data.normalize_cifar(
        num_class=num_class)
    if model in cnn_models.FLAT:
        train_x = train_x.reshape(train_x.shape[0], -1)
        valid_x = valid_x.reshape(valid_x.shape[0], -1)
    return train_x, train_y, valid_x, valid_y, 3072, num_class


def build(model, dataset, batch_size, opt, learning_rate, data=None):
    """The graph of one run: returns (loss, y, y_, train_op)."""
    train_x, train_y, valid_x, valid_y, input_dim, num_class = (
        data if data is not None else load_dataset(dataset, model))
    x = ht.dataloader_op([
        ht.Dataloader(train_x, batch_size, 'train'),
        ht.Dataloader(valid_x, batch_size, 'validate'),
    ])
    y_ = ht.dataloader_op([
        ht.Dataloader(train_y, batch_size, 'train'),
        ht.Dataloader(valid_y, batch_size, 'validate'),
    ])
    fn = MODELS[model]
    if model in ('mlp', 'logreg'):
        loss, y = fn(x, y_, num_class, input_dim)
    elif model == 'vit':
        # the attention's reshapes take the static batch size
        loss, y = fn(x, y_, num_class, batch=batch_size)
    else:
        loss, y = fn(x, y_, num_class)
    train_op = OPTIMIZERS[opt](learning_rate).minimize(loss)
    return loss, y, y_, train_op


def _sync(executor):
    if executor.config.device.type == 'cuda':
        torch.cuda.synchronize()


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
    parser.add_argument('--dtype', default='float32',
                        choices=['float32', 'bfloat16'],
                        help='compute dtype (parameters stay float32)')
    parser.add_argument('--profile', default=None, metavar='DIR',
                        help='device time of a step by kernel group')
    args = parser.parse_args(argv)
    if args.profile and args.gpu < 0:
        raise SystemExit("--profile measures the card; it needs --gpu >= 0")

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
                           comm_mode=args.comm_mode, dtype=args.dtype)
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
        step_s = []
        for _ in range(n_train_batches):
            t0 = perf_counter()
            ht.kernels.registry.reset_launch_counts()
            loss_val, predict_y, y_val, _ = executor.run(
                'train', eval_node_list=[loss, y, y_, train_op])
            loss_all += loss_val.asnumpy()
            step_s.append(perf_counter() - t0)
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
    timed = step_s[WARMUP:] or step_s
    step_ms = sum(timed) / len(timed) * 1e3
    res = {"summary": "cnn_main", "model": args.model,
           "dataset": args.dataset, "batch_size": args.batch_size,
           "dtype": args.dtype, "device": str(executor.config.device),
           "params": sum(executor.state["params"][id(n)].numel()
                         for n in executor.param_nodes),
           "step_ms": step_ms,
           "samples_per_s": args.batch_size / step_ms * 1e3,
           "launches_per_step": {
               k: v for k, v in ht.kernels.registry.launch_counts().items()
               if v}}
    if args.profile:
        from hetu_tpu_torch.examples import bert_forward
        os.makedirs(args.profile, exist_ok=True)
        _sync(executor)
        res["profile"] = bert_forward.profile(
            lambda: executor.run('train'), step_ms, PROFILE_STEPS,
            os.path.join(args.profile,
                         f"profile_cnn_{args.model}_{args.dtype}.txt"),
            ops=CONV_OPS)
    if device_id == 0:
        print(json.dumps(res), flush=True)
    if args.comm_mode in ('AllReduce', 'Hybrid'):
        ht.mpi_nccl_finish(comm)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s - %(name)s - %(levelname)s - %(message)s')
    main()
