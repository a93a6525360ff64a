"""Parallel MAML over a task partition (``repro/algorithms/maml.py``,
paper Snippets 3/4/7).

Model-agnostic: any ``loss_fn(params, batch)`` over a tree of tensors. The
MAML gradient comes from MapReduce AD: the gradient of the parallel loss
is another DrJAX program (paper §6), whose backward runs the map's body's
vjp per task (a second order through each task's inner steps, K2's
included: ``kernels.ops._FlashAttentionBackward``) and turns the
broadcast of the params into a ``reduce_sum``.

The inner steps take ``torch.autograd.grad`` of the support loss, with
``create_graph`` whenever grad mode is on (an outer gradient is being
taken), so the outer gradient differentiates through them;
``torch.func.grad`` cannot run through the model, whose non-reentrant
checkpointing uses saved-tensor hooks that ``torch.func`` refuses.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

from .. import core as drjax

F32 = torch.float32


def _inner_step(loss_fn: Callable, params, lr: torch.Tensor, support):
    """One inner SGD step, ``w - lr * g`` with ``g`` cast to the leaf's
    dtype and the arithmetic in the promoted dtype of the leaf and the f32
    rate, as the reference's ``w - inner_lr_b * gw.astype(w.dtype)``
    (so a bf16 leaf comes out f32). Differentiable in ``params`` when grad
    mode is on."""
    create = torch.is_grad_enabled()
    leaves, spec = pytree.tree_flatten(params)
    with torch.enable_grad():
        wrt = [x if create and x.requires_grad
               else x.detach().requires_grad_(True) for x in leaves]
        loss = loss_fn(pytree.tree_unflatten(wrt, spec), support)
        grads = torch.autograd.grad(loss, wrt, create_graph=create,
                                    materialize_grads=True)
    out = []
    for w, g in zip(leaves if create else wrt, grads):
        dt = torch.promote_types(w.dtype, lr.dtype)
        w = w if create else w.detach()
        out.append(w.to(dt) - lr * g.to(w.dtype).to(dt))
    return pytree.tree_unflatten(out, spec)


def make_parallel_maml(loss_fn: Callable, partition_size: int,
                       inner_lr: float = 0.01, inner_steps: int = 1):
    """Returns ``(parallel_maml_loss, maml_train_step)``.

    ``parallel_maml_loss(params, tasks)``: the mean over the tasks of the
    query loss after ``inner_steps`` SGD steps on the support set;
    ``tasks`` holds ``{"support": ..., "query": ...}`` batches whose leaves
    lead with the task axis. ``maml_train_step(params, tasks, outer_lr)``
    takes the outer gradient and an f32 SGD step, cast back to each leaf's
    dtype (paper Snippet 7); returns (new params, meta-loss)."""

    def maml_task_loss(params, inner_lr_b, task):
        for _ in range(inner_steps):
            params = _inner_step(loss_fn, params, inner_lr_b, task["support"])
        return loss_fn(params, task["query"])

    @drjax.program(partition_size=partition_size)
    def parallel_maml_loss(params, tasks):
        device = pytree.tree_leaves(params)[0].device
        params_b = drjax.broadcast(params)
        lr_b = drjax.broadcast(torch.tensor(inner_lr, dtype=F32,
                                            device=device))
        losses = drjax.map_fn(maml_task_loss, (params_b, lr_b, tasks))
        return drjax.reduce_mean(losses)

    def maml_train_step(params, tasks, outer_lr: float = 0.1):
        """The outer gradient (``torch.autograd.grad`` of the parallel
        loss) and an SGD step: ``(w_f32 - outer_lr * g)`` cast back."""
        leaves, spec = pytree.tree_flatten(params)
        with torch.enable_grad():
            wrt = [x.detach().requires_grad_(True) for x in leaves]
            loss = parallel_maml_loss(pytree.tree_unflatten(wrt, spec), tasks)
            grads = torch.autograd.grad(loss, wrt)
        new = [(w.to(F32) - outer_lr * g).to(w.dtype)
               for w, g in zip(leaves, grads)]
        return pytree.tree_unflatten(new, spec), loss.detach()

    return parallel_maml_loss, maml_train_step
