"""Pipeline parallelism: GPipe-style homogeneous stages over a mesh axis
(port of `bevformer_tensorrt_tpu/parallel/pipeline.py`).

The JAX function runs one `shard_map` whose body scans the ticks and hops
the activations with `ppermute`.  Here every rank of the pp axis runs the
same schedule on its own stage: M + S - 1 ticks, stage s on microbatch
t - s at tick t, its output sent to stage s + 1 in one `batch_isend_irecv`
a tick (`comm.exchange`).  Dead ticks (the bubble) compute nothing.  The
last stage's outputs are broadcast to every rank, which is what the JAX
body's masked `psum` gives.

Each rank holds only its stage's parameters.  The schedule is one autograd
Function: its backward runs the ticks in reverse, each stage taking the
gradient of its output from the next stage, back-propagating through its
saved microbatch graph and sending the gradient of its input to the stage
before.  Every rank of the axis must run that backward (the loss of the
replicated output is the same on every rank; the last stage's cotangent is
the one used).  The stage parameters get their gradients in `.grad`, the
microbatches and the consts theirs through the Function; a tensor that `fn`
reads from its closure is a constant.
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch
import torch.nn as nn

from . import comm


class StageStack(list):
    """The S stages' parameters in stage order (`stack_stage_params`)."""


def stack_stage_params(per_stage_params: list) -> StageStack:
    """The stages' parameters in one list, stage s at index s; a rank keeps
    its own (`stage_param_sharding`)."""
    return StageStack(per_stage_params)


def stage_param_sharding(mesh, stacked_params: StageStack, axis: str = "pp"):
    """This rank's stage of a `StageStack`: what the JAX placement puts on
    its pp device."""
    return stacked_params[mesh.axis_index(axis)]


def _flatten(tree) -> List[torch.Tensor]:
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _flatten(v)]
    raise TypeError(f"pipeline_apply: unsupported leaf {type(tree)}")


def _unflatten(tree, leaves):
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, torch.Tensor):
            return next(it)
        if isinstance(node, dict):
            out = {}
            for k in sorted(node):
                out[k] = build(node[k])
            return {k: out[k] for k in node}
        return type(node)(build(v) for v in node)

    return build(tree)


def _param_leaves(params) -> List[torch.Tensor]:
    """The tensors of a stage that want gradients: modules' parameters, and
    tensors in dicts, lists and tuples."""
    if isinstance(params, nn.Module):
        return [p for p in params.parameters() if p.requires_grad]
    if isinstance(params, torch.Tensor):
        return [params] if params.requires_grad else []
    if isinstance(params, dict):
        return [t for k in sorted(params) for t in _param_leaves(params[k])]
    if isinstance(params, (list, tuple)):
        return [t for v in params for t in _param_leaves(v)]
    return []


class _Schedule:
    def __init__(self, fn, params, x, consts, mesh, axis):
        self.fn, self.params, self.mesh, self.axis = fn, params, mesh, axis
        self.x_tree, self.c_tree = x, consts
        self.S, self.s = mesh.axis_size(axis), mesh.axis_index(axis)
        self.params_leaves = _param_leaves(params)
        self.saved = {}

    def forward(self, x_leaves, c_leaves, grad: bool):
        S, s = self.S, self.s
        M = x_leaves[0].shape[0]
        outs = [torch.zeros_like(l) for l in x_leaves]
        state = None
        for t in range(M + S - 1):
            m, y = t - s, None
            if 0 <= m < M:
                inp = [l[m] for l in x_leaves] if s == 0 else state
                # past stage 0 the input's gradient goes back to the stage before
                inp = [i.detach().requires_grad_(grad and (s > 0 or l.requires_grad))
                       for i, l in zip(inp, x_leaves)]
                c_m = [c[m].detach().requires_grad_(grad and c.requires_grad) for c in c_leaves]
                with torch.set_grad_enabled(grad):
                    y = self.fn(self.params, _unflatten(self.x_tree, inp),
                                *(() if self.c_tree is None else
                                  (_unflatten(self.c_tree, c_m),)))
                y = _flatten(y)
                if grad:
                    self.saved[m] = (inp, c_m, y)
                if s == S - 1:
                    for o, v in zip(outs, y):
                        o[m] = v.detach()
            sends = [(v.detach(), s + 1) for v in y] if y is not None and s < S - 1 else []
            take = s > 0 and 0 <= t + 1 - s < M  # stage s - 1 ran microbatch t + 1 - s
            bufs = [torch.empty_like(l[0]) for l in x_leaves] if take else []
            comm.exchange(sends, [(b, s - 1) for b in bufs], self.mesh, self.axis)
            state = bufs if take else None
        for o in outs:
            comm.broadcast(o, self.mesh, self.axis, S - 1)
        return outs

    def backward(self, grads, x_leaves, c_leaves, need_x, need_c):
        S, s = self.S, self.s
        M = x_leaves[0].shape[0]
        gx = [torch.zeros_like(l) for l in x_leaves] if need_x else None
        gc = [torch.zeros_like(c) for c in c_leaves]
        state = None
        for t in reversed(range(M + S - 1)):
            m, gin = t - s, None
            if 0 <= m < M:
                inp, c_m, y = self.saved.pop(m)
                g_y = ([torch.zeros_like(v) if g is None else g[m] for v, g in zip(y, grads)]
                       if s == S - 1 else state)
                targets = [i for i in inp if i.requires_grad] + [c for c in c_m if c.requires_grad]
                pairs = [(v, g) for v, g in zip(y, g_y) if v.requires_grad]
                if pairs:
                    torch.autograd.backward([v for v, _ in pairs], [g for _, g in pairs],
                                            inputs=targets + self.params_leaves)
                gin = [torch.zeros_like(i) if i.grad is None else i.grad for i in inp]
                for acc, c in zip(gc, c_m):
                    if c.grad is not None:
                        acc[m] += c.grad
                if s == 0 and need_x:
                    for acc, g in zip(gx, gin):
                        acc[m] = g
            sends = [(g, s - 1) for g in gin] if gin is not None and s > 0 else []
            take = s < S - 1 and 0 <= t - 1 - s < M  # stage s + 1 ran microbatch t - 1 - s
            bufs = [torch.empty_like(l[0]) for l in x_leaves] if take else []
            comm.exchange(sends, [(b, s + 1) for b in bufs], self.mesh, self.axis)
            state = bufs if take else None
        if need_x:
            for g in gx:
                comm.broadcast(g, self.mesh, self.axis, 0)
        if need_c:
            for g in gc:
                comm.all_reduce(g, self.mesh, self.axis)
        return gx, gc


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched, n_x, n_c, *tensors):
        x_leaves, c_leaves = list(tensors[:n_x]), list(tensors[n_x:n_x + n_c])
        ctx.sched, ctx.n_x, ctx.n_c = sched, n_x, n_c
        ctx.save_for_backward(*x_leaves, *c_leaves)
        return tuple(sched.forward(x_leaves, c_leaves, grad=True))

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        x_leaves, c_leaves = list(saved[:ctx.n_x]), list(saved[ctx.n_x:])
        need_x = any(ctx.needs_input_grad[3:3 + ctx.n_x])
        need_c = any(ctx.needs_input_grad[3 + ctx.n_x:3 + ctx.n_x + ctx.n_c])
        gx, gc = ctx.sched.backward(grads, x_leaves, c_leaves, need_x, need_c)
        n_p = len(ctx.needs_input_grad) - 3 - ctx.n_x - ctx.n_c
        return (None, None, None, *(gx if gx is not None else [None] * ctx.n_x),
                *(gc if need_c else [None] * ctx.n_c), *([None] * n_p))


def pipeline_apply(
    fn: Callable,        # (stage_params, x[, c]) -> y, the same structure, shapes and dtypes as x
    stage_params: Any,   # this rank's stage (module, list of modules, or tensors), or a StageStack
    x: Any,              # [M, ...] microbatches (M >= 1): a tensor, or a tuple/dict of them
    mesh,
    axis: str = "pp",
    consts: Any = None,  # optional tensors (or a dict / tuple of them) of [M, ...]
                         # per-microbatch constants, the same on every stage (the
                         # stage indexes its current microbatch's slice; they do
                         # NOT hop with the activations)
) -> Any:
    """Run M microbatches through the S homogeneous stages of the pp axis.

    Semantics: out[m] = fn(p[S-1], fn(p[S-2], ... fn(p[0], x[m]))), exactly
    sequential layer application.  With `consts`, fn is called as
    fn(stage_params, x_m, consts_m), consts_m being each leaf's [m]-th
    slice.  Every rank returns the last stage's outputs."""
    S = mesh.axis_size(axis)
    x_leaves, c_leaves = _flatten(x), _flatten(consts)
    M = x_leaves[0].shape[0]
    for leaf in c_leaves:
        if leaf.shape[0] != M:
            raise ValueError(
                f"pipeline_apply: consts leading axis {leaf.shape[0]} != "
                f"microbatch count {M}"
            )
    if isinstance(stage_params, StageStack):
        # one stage per rank, as the JAX function requires of its stacked axis
        if len(stage_params) != S:
            raise ValueError(
                f"pipeline_apply: stacked_params leading axis {len(stage_params)} "
                f"!= mesh '{axis}' size {S} (one stage per device required)"
            )
        stage_params = stage_param_sharding(mesh, stage_params, axis)
    sched = _Schedule(fn, stage_params, x, consts, mesh, axis)
    if not torch.is_grad_enabled():
        outs = sched.forward(x_leaves, c_leaves, grad=False)
    else:
        outs = _Pipeline.apply(sched, len(x_leaves), len(c_leaves), *x_leaves, *c_leaves,
                               *sched.params_leaves)
    return _unflatten(x, list(outs))
