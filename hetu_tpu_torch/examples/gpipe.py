"""GPipe pipeline-parallel MLP on the graph API (counterpart of
``examples/runner/parallel/gpipe.py``): one MLP layer per pipeline stage
(``with ht.context(...)`` per stage), ``Executor([loss, train_op],
gpipe=True)``, and ``run()`` on a list of microbatch feed dicts.

One process per stage, as the reference's MPI ranks: rank i runs the stage
of ``gpu(i)`` (``cpu(i)`` with ``--gpu -1``)::

    python -m hetu_tpu_torch.runner -w 4 python -m \\
        hetu_tpu_torch.examples.gpipe --stages 4 --micro-batches-num 8
    python -m hetu_tpu_torch.runner -w 2 python -m \\
        hetu_tpu_torch.examples.gpipe --stages 2 --gpu -1
    # two stages sharing one card (NCCL refuses that: gloo, host-staged)
    python -m hetu_tpu_torch.runner -w 2 --devices cuda:0,cuda:0 \\
        --backend gloo python -m hetu_tpu_torch.examples.gpipe --stages 2

Alone (no runner) one process runs every stage. A process that has joined
its group already keeps it after ``main`` returns. MNIST comes from
``ht.data.mnist()`` (synthetic when the file is absent). ``--steps N``
stops each epoch after N steps. Each rank prints, last, one JSON line:
its stage, the losses of the last epoch and each epoch's mean, the mean
step time after
``--warmup`` epochs (host clock; each step ends in fetching its losses),
and the kernel launches of its steps per step.
"""
import argparse
import json
import time

import numpy as np

import hetu_tpu_torch as ht
from hetu_tpu_torch.kernels import registry
from hetu_tpu_torch.parallel import multihost


def fc(x, shape, name, with_relu=True):
    weight = ht.init.random_normal(shape, stddev=0.04, name=name + '_weight')
    bias = ht.init.random_normal(shape[-1:], stddev=0.04, name=name + '_bias')
    x = ht.matmul_op(x, weight)
    x = x + ht.broadcastto_op(bias, x)
    if with_relu:
        x = ht.relu_op(x)
    return x


def build(stages, lr, opt, device_of):
    """The MLP, one fc layer a stage (784-512-...-512-10); returns the
    feeds, the loss and the train op."""
    with ht.context(device_of(0)):
        x = ht.Variable(name="dataloader_x", trainable=False)
        activation = fc(x, (784, 512), 'mlp_fc1', with_relu=True)
    for i in range(1, stages - 1):
        with ht.context(device_of(i)):
            activation = fc(activation, (512, 512), 'mlp_fc%d' % (i + 1),
                            with_relu=True)
    with ht.context(device_of(stages - 1)):
        y_pred = fc(activation, (512, 10), 'mlp_fc_out', with_relu=False)
        y_ = ht.Variable(name="dataloader_y", trainable=False)
        loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(y_pred, y_), [0])
        make = (ht.optim.SGDOptimizer if opt == "sgd"
                else ht.optim.AdamOptimizer)
        train_op = make(learning_rate=lr).minimize(loss)
    return x, y_, loss, train_op


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--epochs', type=int, default=4)
    parser.add_argument('--warmup', type=int, default=1)
    parser.add_argument('--stages', type=int, default=4)
    parser.add_argument('--batch-size', type=int, default=256)
    parser.add_argument('--micro-batches-num', type=int, default=8)
    parser.add_argument('--learning-rate', type=float, default=0.1)
    parser.add_argument('--opt', choices=("sgd", "adam"), default="sgd")
    parser.add_argument('--steps', type=int, default=0,
                        help="steps an epoch (0: the whole training set)")
    parser.add_argument('--gpu', type=int, default=0,
                        help="-1: run on the CPU")
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args(argv)

    cpu = args.gpu < 0
    joined = multihost.is_initialized()
    multihost.initialize(device="cpu" if cpu else None)
    world = multihost.process_count()
    if world not in (1, args.stages):
        raise SystemExit(f"--stages {args.stages} needs {args.stages} "
                         f"workers (or one), got {world}")
    device_of = ht.cpu if cpu else ht.gpu
    x, y_, loss, train_op = build(args.stages, args.learning_rate, args.opt,
                                  device_of)
    executor = ht.Executor([loss, train_op], gpipe=True, seed=args.seed,
                           ctx=ht.cpu(0) if cpu else None)

    train_set_x, train_set_y = ht.data.mnist()[0]
    M = args.micro_batches_num
    steps = train_set_x.shape[0] // (M * args.batch_size)
    if args.steps:
        steps = min(steps, args.steps)
    step_s, loss_vals, epoch_means = [], [], []
    registry.reset_launch_counts()
    for epoch in range(args.epochs):
        loss_vals = []
        for step in range(steps):
            feed_dicts_list = []
            for i in range(M):
                lo = (step * M + i) * args.batch_size
                hi = lo + args.batch_size
                feed_dicts_list.append({x: train_set_x[lo:hi],
                                        y_: train_set_y[lo:hi]})
            t0 = time.perf_counter()
            ret = executor.run(feed_dict=feed_dicts_list,
                               convert_to_numpy_ret_vals=True)
            if epoch >= args.warmup:
                step_s.append(time.perf_counter() - t0)
            loss_vals.append(float(np.mean([np.mean(v) for v in ret[0]])))
        epoch_means.append(float(np.mean(loss_vals)))
        if multihost.process_index() == 0:
            print('epoch: {}, mean loss: {:.4f}, min loss: {:.4f}, max '
                  'loss: {:.4f}'.format(epoch, np.mean(loss_vals),
                                        np.min(loss_vals),
                                        np.max(loss_vals)), flush=True)
    n_steps = args.epochs * steps
    sub = executor.subexecutors["default"]
    summary = {
        "rank": multihost.process_index(), "world": world,
        "stages_here": sorted(sub.local), "opt": args.opt,
        "device": str(executor.config.device), "microbatches": M,
        "batch": args.batch_size, "steps": n_steps, "losses": loss_vals,
        "epoch_mean_losses": epoch_means,
        "step_ms": 1e3 * float(np.mean(step_s)) if step_s else None,
        "launches_per_step": {k: v / n_steps for k, v in
                              registry.launch_counts().items() if v}}
    print(json.dumps(summary), flush=True)
    if not joined:
        multihost.shutdown()
    return summary


if __name__ == "__main__":
    main()
