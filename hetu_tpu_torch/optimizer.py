"""Optimizers: SGD / Momentum(+Nesterov) / AdaGrad / Adam (+AdamW)
(counterpart of ``hetu_tpu/optimizer.py``).

SGD and Adam/AdamW apply through the hand-written CUDA kernels of
``kernels/fused_opt.py`` (registry-dispatched), all of a device's
parameters as one group: one dispatch per optimizer node and step, one
launch per ``fused_opt.MAX_TENSORS`` parameters. Momentum and AdaGrad stay
plain torch, one parameter at a time, as the JAX package keeps them plain
``jnp`` expressions. Every apply updates the parameter and its slots in
place, under ``torch.no_grad()``.

The learning rate is a float or a scheduler of ``lr_scheduler.py``, read
through ``lr_value(step)``: a host float each step, which the kernels
read from a one-element tensor on the device.

``insert_comm_ops`` rewrites each gradient input by the comm mode: an
all-reduce under ``"AllReduce"``; under ``"PS"`` a push to the parameter
server; under ``"Hybrid"`` a push for a sparse table (an ``is_embed``
variable) and an all-reduce for a dense parameter. The server applies the
update of a variable it holds, so ``apply_updates`` skips its gradient.
"""
from __future__ import annotations

from numbers import Real
from typing import Optional, Sequence

import torch

from .graph.node import Op, PlaceholderOp, find_topo_sort
from .graph.gradients import gradients


class Optimizer:
    """Base optimizer holding the learning rate (a float or a scheduler
    of ``lr_scheduler.py``).

    ``clip_grad_norm`` clips the GLOBAL gradient norm (all trainable vars
    together, torch ``clip_grad_norm_`` semantics) before the update rule.
    Parameters on the parameter server are updated there, and their
    gradients are not clipped: the norm is over the gradients applied
    here.
    """

    def __init__(self, learning_rate, l2reg=0.0, clip_grad_norm=None):
        if not (isinstance(learning_rate, Real)
                or hasattr(learning_rate, "get_traced")):
            raise TypeError(
                f"learning_rate must be a float or a scheduler of "
                f"hetu_tpu_torch.lr_scheduler, got "
                f"{type(learning_rate).__name__}")
        self.learning_rate = (float(learning_rate)
                              if isinstance(learning_rate, Real)
                              else learning_rate)
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
    def lr_value(self, step: int = 0) -> float:
        """The learning rate at ``step``, a host float."""
        lr = self.learning_rate
        return lr.get_traced(step) if hasattr(lr, "get_traced") else lr

    def lr_tensor(self, device: torch.device, step: int = 0) -> torch.Tensor:
        """The learning rate at ``step`` as a 0-d f32 tensor on ``device``
        (what the kernels read). A float rate is uploaded once; a scheduled
        one is written into the same tensor when it changes (a fill on the
        device's stream, no host sync)."""
        lr = self.lr_value(step)
        ent = self._lr_tensors.get(device)
        if ent is None:
            ent = self._lr_tensors[device] = [torch.tensor(
                lr, dtype=torch.float32, device=device), lr]
        elif ent[1] != lr:
            ent[0].fill_(lr)
            ent[1] = lr
        return ent[0]

    def _regularized(self, param, grad):
        if self.l2reg > 0:
            return grad + self.l2reg * param
        return grad

    def slot_init(self, param):
        return ()

    def apply_dense(self, param, grad, slot, step=0):
        """Update ``param`` (and ``slot``) in place at the rate of
        ``step``; returns the pair."""
        raise NotImplementedError

    def apply_group(self, params, grads, slots, step=0):
        """Update a group of parameters on one device (and their slots) in
        place; returns ``(params, slots)`` as lists. Here one
        :meth:`apply_dense` per parameter; SGD and Adam apply the group
        in one dispatch."""
        pairs = [self.apply_dense(p, g, s, step)
                 for p, g, s in zip(params, grads, slots)]
        return [p for p, _ in pairs], [s for _, s in pairs]


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate=0.01, l2reg=0.0, clip_grad_norm=None):
        super().__init__(learning_rate, l2reg, clip_grad_norm)

    def apply_dense(self, param, grad, slot, step=0):
        from .kernels import fused_opt
        return fused_opt.sgd_step(self, param, grad,
                                  self.lr_tensor(param.device, step)), slot

    def apply_group(self, params, grads, slots, step=0):
        from .kernels import fused_opt
        return fused_opt.sgd_group_step(
            self, params, grads,
            self.lr_tensor(params[0].device, step)), list(slots)


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate=0.01, momentum=0.9, nesterov=False,
                 l2reg=0.0, clip_grad_norm=None):
        super().__init__(learning_rate, l2reg, clip_grad_norm)
        self.momentum = float(momentum)
        self.nesterov = nesterov

    def slot_init(self, param):
        return {"velocity": torch.zeros_like(param)}

    def apply_dense(self, param, grad, slot, step=0):
        lr = self.lr_value(step)
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

    def apply_dense(self, param, grad, slot, step=0):
        grad = self._regularized(param, grad)
        accum = slot["accum"] + grad * grad
        new_param = param - self.lr_value(step) * grad / (torch.sqrt(accum)
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

    def apply_dense(self, param, grad, slot, step=0):
        from .kernels import fused_opt
        grad = self._regularized(param, grad)
        return fused_opt.adam_step(self, param, grad, slot,
                                   self.lr_tensor(param.device, step))

    def apply_group(self, params, grads, slots, step=0):
        from .kernels import fused_opt
        grads = [self._regularized(p, g) for p, g in zip(params, grads)]
        return fused_opt.adam_group_step(
            self, params, grads, slots, self.lr_tensor(params[0].device, step))


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
        """Rewrite each gradient input by the comm mode, once per graph:
        ``AllReduceCommunicateOp`` of its parameter under ``"AllReduce"``
        and for a dense parameter under ``"Hybrid"``;
        ``ParameterServerCommunicateOp`` (keyed by the variable's name)
        under ``"PS"`` and for a sparse table under ``"Hybrid"``."""
        mode = config.comm_mode
        if mode is None or self._comm_inserted:
            return
        from .graph.ops.comm import allreduceCommunicate_op
        from .graph.ops.ps import parameterServerCommunicate_op
        self._comm_inserted = True
        new_inputs = []
        for var, grad in zip(self.vars, self.inputs):
            sparse = getattr(var, "is_embed", False)
            if mode == "AllReduce" or (mode == "Hybrid" and not sparse):
                new_inputs.append(allreduceCommunicate_op(grad,
                                                          param_node=var))
            else:
                new_inputs.append(parameterServerCommunicate_op(
                    grad, ps_id=var.name, optimizer=self.optimizer))
        self.inputs = new_inputs

    # -- executor protocol --------------------------------------------------
    def init_slots(self, params_by_id):
        """The slots of each var; a var missing from ``params_by_id`` lives
        on the parameter server, which holds its optimizer state."""
        return tuple(self.optimizer.slot_init(params_by_id[id(v)])
                     if id(v) in params_by_id else ()
                     for v in self.vars)

    def apply_updates(self, env, slots, tc):
        """Apply every var's update in place (under ``torch.no_grad()``),
        one :meth:`Optimizer.apply_group` per device; records the new
        slots in ``tc.slot_updates``. ``tc.params`` holds the float32
        master parameters, also under bf16 compute. A gradient that is
        ``None`` was pushed to the parameter server, which applies it: its
        var and slot are left as they are."""
        opt = self.optimizer
        step = getattr(tc, "step", 0)
        local = [i for i, g in enumerate(self.inputs)
                 if env[id(g)] is not None]
        new_slots = list(slots)
        if not local:
            tc.slot_updates[id(self)] = tuple(new_slots)
            return
        params = [tc.params[id(self.vars[i])] for i in local]
        slots = [slots[i] for i in local]
        # mixed precision: the f32 master parameters take f32 gradients
        # (reference optimizer.py:243-244)
        grads = [g if g.dtype == p.dtype else g.to(p.dtype)
                 for g, p in zip((env[id(self.inputs[i])] for i in local),
                                 params)]
        new_params, local_slots = list(params), list(slots)
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
                                         [slots[i] for i in idx], step)
                for i, p, s in zip(idx, ps, ss):
                    new_params[i], local_slots[i] = p, s
        for i, param, slot in zip(local, new_params, local_slots):
            tc.param_updates[id(self.vars[i])] = param
            new_slots[i] = slot
        tc.slot_updates[id(self)] = tuple(new_slots)

    def compute(self, input_vals, tc):
        raise AssertionError("OptimizerOp is applied by the executor")
