"""Optimizers: SGD / Momentum(+Nesterov) / AdaGrad / Adam (+AdamW)
(counterpart of ``hetu_tpu/optimizer.py``).

SGD and Adam/AdamW apply through the hand-written CUDA kernels of
``kernels/fused_opt.py`` (registry-dispatched), all of a device's
parameters as one group: one dispatch per optimizer node and step, one
launch per ``fused_opt.MAX_TENSORS`` parameters. Momentum and AdaGrad stay
plain torch, one parameter at a time, as the JAX package keeps them plain
``jnp`` expressions. Every apply updates the parameter and its slots in
place, under ``torch.no_grad()``. ``insert_comm_ops`` wraps every
gradient in an all-reduce under ``comm_mode="AllReduce"`` (data
parallelism); the PS and Hybrid modes arrive with slice 4b. A
learning-rate scheduler is refused until ``lr_scheduler.py`` is ported.
"""
from __future__ import annotations

from numbers import Real
from typing import Optional, Sequence

import torch

from .graph.node import Op, PlaceholderOp, find_topo_sort
from .graph.gradients import gradients


class Optimizer:
    """Base optimizer holding the learning rate (a float).

    ``clip_grad_norm`` clips the GLOBAL gradient norm (all trainable vars
    together, torch ``clip_grad_norm_`` semantics) before the update rule.
    """

    def __init__(self, learning_rate, l2reg=0.0, clip_grad_norm=None):
        if not isinstance(learning_rate, Real):
            raise TypeError(
                f"learning_rate must be a float; learning-rate schedulers "
                f"({type(learning_rate).__name__}) are not ported to "
                "hetu_tpu_torch yet")
        self.learning_rate = float(learning_rate)
        self.l2reg = float(l2reg)
        if clip_grad_norm is not None and float(clip_grad_norm) <= 0:
            raise ValueError(
                f"clip_grad_norm must be > 0, got {clip_grad_norm}")
        self.clip_grad_norm = (None if clip_grad_norm is None
                               else float(clip_grad_norm))
        self._lr_tensors: dict[torch.device, torch.Tensor] = {}

    # -- graph construction -------------------------------------------------
    def minimize(self, loss, var_list: Optional[Sequence[Op]] = None):
        if var_list is None:
            var_list = [n for n in find_topo_sort([loss])
                        if isinstance(n, PlaceholderOp) and n.trainable]
        grads = gradients(loss, var_list)
        return OptimizerOp(grads, self, var_list)

    # -- update rules ---------------------------------------------------------
    def lr_tensor(self, device: torch.device) -> torch.Tensor:
        """The learning rate as a 0-d f32 tensor on ``device`` — what the
        kernels read, so a step needs no host value."""
        t = self._lr_tensors.get(device)
        if t is None:
            t = self._lr_tensors[device] = torch.tensor(
                self.learning_rate, dtype=torch.float32, device=device)
        return t

    def _regularized(self, param, grad):
        if self.l2reg > 0:
            return grad + self.l2reg * param
        return grad

    def slot_init(self, param):
        return ()

    def apply_dense(self, param, grad, slot):
        """Update ``param`` (and ``slot``) in place; returns the pair."""
        raise NotImplementedError

    def apply_group(self, params, grads, slots):
        """Update a group of parameters on one device (and their slots) in
        place; returns ``(params, slots)`` as lists. Here one
        :meth:`apply_dense` per parameter; SGD and Adam apply the group
        in one dispatch."""
        pairs = [self.apply_dense(p, g, s)
                 for p, g, s in zip(params, grads, slots)]
        return [p for p, _ in pairs], [s for _, s in pairs]


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate=0.01, l2reg=0.0, clip_grad_norm=None):
        super().__init__(learning_rate, l2reg, clip_grad_norm)

    def apply_dense(self, param, grad, slot):
        from .kernels import fused_opt
        return fused_opt.sgd_step(self, param, grad,
                                  self.lr_tensor(param.device)), slot

    def apply_group(self, params, grads, slots):
        from .kernels import fused_opt
        return fused_opt.sgd_group_step(
            self, params, grads, self.lr_tensor(params[0].device)), list(slots)


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate=0.01, momentum=0.9, nesterov=False,
                 l2reg=0.0, clip_grad_norm=None):
        super().__init__(learning_rate, l2reg, clip_grad_norm)
        self.momentum = float(momentum)
        self.nesterov = nesterov

    def slot_init(self, param):
        return {"velocity": torch.zeros_like(param)}

    def apply_dense(self, param, grad, slot):
        lr = self.learning_rate
        grad = self._regularized(param, grad)
        v = self.momentum * slot["velocity"] - lr * grad
        if self.nesterov:
            new_param = param + self.momentum * v - lr * grad
        else:
            new_param = param + v
        slot["velocity"].copy_(v)
        return param.copy_(new_param), slot


class AdaGradOptimizer(Optimizer):
    def __init__(self, learning_rate=0.01, initial_accumulator_value=0.0,
                 eps=1e-7, l2reg=0.0, clip_grad_norm=None):
        super().__init__(learning_rate, l2reg, clip_grad_norm)
        self.initial_accumulator_value = float(initial_accumulator_value)
        self.eps = float(eps)

    def slot_init(self, param):
        return {"accum": torch.full_like(param, self.initial_accumulator_value)}

    def apply_dense(self, param, grad, slot):
        grad = self._regularized(param, grad)
        accum = slot["accum"] + grad * grad
        new_param = param - self.learning_rate * grad / (torch.sqrt(accum)
                                                         + self.eps)
        slot["accum"].copy_(accum)
        return param.copy_(new_param), slot


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.01, beta1=0.9, beta2=0.999,
                 epsilon=1e-7, l2reg=0.0, weight_decay=0.0,
                 clip_grad_norm=None):
        super().__init__(learning_rate, l2reg, clip_grad_norm)
        self.beta1 = float(beta1)
        self.beta2 = float(beta2)
        self.epsilon = float(epsilon)
        self.weight_decay = float(weight_decay)

    def slot_init(self, param):
        return {"m": torch.zeros_like(param), "v": torch.zeros_like(param),
                "t": torch.zeros((), dtype=torch.float32, device=param.device)}

    def apply_dense(self, param, grad, slot):
        from .kernels import fused_opt
        grad = self._regularized(param, grad)
        return fused_opt.adam_step(self, param, grad, slot,
                                   self.lr_tensor(param.device))

    def apply_group(self, params, grads, slots):
        from .kernels import fused_opt
        grads = [self._regularized(p, g) for p, g in zip(params, grads)]
        return fused_opt.adam_group_step(self, params, grads, slots,
                                         self.lr_tensor(params[0].device))


class AdamWOptimizer(AdamOptimizer):
    def __init__(self, learning_rate=0.01, beta1=0.9, beta2=0.999,
                 epsilon=1e-7, weight_decay=0.01, clip_grad_norm=None):
        super().__init__(learning_rate, beta1, beta2, epsilon,
                         l2reg=0.0, weight_decay=weight_decay,
                         clip_grad_norm=clip_grad_norm)


class OptimizerOp(Op):
    """The graph node applying updates to every trainable var
    (reference optimizer.py:85)."""

    is_optimizer = True

    def __init__(self, grads, optimizer: Optimizer, var_list):
        super().__init__(list(grads), None)
        self.optimizer = optimizer
        self.vars = list(var_list)
        self.name = f"Optimizer_{type(optimizer).__name__}_{self.id}"
        self._comm_inserted = False

    # -- comm strategy rewrite (reference backward_hook optimizer.py:125) ---
    def insert_comm_ops(self, config):
        """Under ``comm_mode="AllReduce"`` every gradient input becomes an
        ``AllReduceCommunicateOp`` of its parameter; once per graph."""
        mode = config.comm_mode
        if mode is None or self._comm_inserted:
            return
        if mode in ("PS", "Hybrid"):
            raise NotImplementedError(
                f"comm_mode={mode!r}: the parameter server arrives with "
                "slice 4b; hetu_tpu_torch runs comm_mode=None and "
                "'AllReduce'")
        from .graph.ops.comm import allreduceCommunicate_op
        self._comm_inserted = True
        self.inputs = [allreduceCommunicate_op(grad, param_node=var)
                       for var, grad in zip(self.vars, self.inputs)]

    # -- executor protocol --------------------------------------------------
    def init_slots(self, params_by_id):
        return tuple(self.optimizer.slot_init(params_by_id[id(v)])
                     for v in self.vars)

    def apply_updates(self, env, slots, tc):
        """Apply every var's update in place (under ``torch.no_grad()``),
        one :meth:`Optimizer.apply_group` per device; records the new
        slots in ``tc.slot_updates``. ``tc.params`` holds the float32
        master parameters, also under bf16 compute."""
        opt = self.optimizer
        params = [tc.params[id(var)] for var in self.vars]
        # mixed precision: the f32 master parameters take f32 gradients
        # (reference optimizer.py:243-244)
        grads = [g if g.dtype == p.dtype else g.to(p.dtype)
                 for g, p in zip((env[id(g)] for g in self.inputs), params)]
        new_params, new_slots = list(params), list(slots)
        with torch.no_grad():
            if opt.clip_grad_norm is not None:
                gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                scale = torch.clamp(opt.clip_grad_norm / (gnorm + 1e-12),
                                    max=1.0)
                grads = [g * scale for g in grads]
            by_device: dict[torch.device, list[int]] = {}
            for i, param in enumerate(params):
                by_device.setdefault(param.device, []).append(i)
            for idx in by_device.values():
                ps, ss = opt.apply_group([params[i] for i in idx],
                                         [grads[i] for i in idx],
                                         [slots[i] for i in idx])
                for i, p, s in zip(idx, ps, ss):
                    new_params[i], new_slots[i] = p, s
        for var, param in zip(self.vars, new_params):
            tc.param_updates[id(var)] = param
        tc.slot_updates[id(self)] = tuple(new_slots)

    def compute(self, input_vals, tc):
        raise AssertionError("OptimizerOp is applied by the executor")
