"""Gradients for the CUDA kernels: the kernel runs the forward, the plain
version gives the backward.

The JAX package makes each Pallas kernel differentiable with a
`jax.custom_vjp` whose backward is the VJP of the plain XLA formulation,
recomputed from the saved inputs (`ops/msda.py:718-805`, `ops/dcn.py:257-280`,
`ops/attention.py:80-119`); no backward kernel exists.  `with_plain_vjp` is
the same rule as one `torch.autograd.Function`: the wrappers of
`ops/msda.py`, `ops/attention.py` and `ops/dcn.py` send every CUDA launch
through it, so the kernel's output carries a `grad_fn` whenever an input
requires grad, and `loss.backward()` reaches what feeds the op.  An int8
kernel's plain version here is the floating-point op (straight-through, as
the JAX `_diff` wrappers differentiate `packed="int8"`).  The launch is never
caught: a failed launch raises through the Function.

Each launch is a registered operator of the `bevformer_port` namespace
(`register_op`): its CUDA implementation is the kernel, its CPU
implementation the plain version, and a fake implementation gives the
output's shape and dtype, so `torch.export` keeps the launch as one node.  A
wrapper sends a CUDA tensor through `with_plain_vjp` around the operator, a
CPU tensor to the operator itself, or, where a gradient is wanted on the
CPU (`wants_grad`), to the plain version under autograd, as before the
operators.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch


class _PlainVJP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, launch, plain, static, *inputs):
        ctx.plain, ctx.static = plain, static
        ctx.save_for_backward(*inputs)
        return launch(*inputs)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[3:]
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, needs)]
        wrt = [t for t in inputs if t is not None and t.requires_grad]
        if not wrt:
            return (None,) * (3 + len(inputs))
        with torch.enable_grad():
            out = ctx.plain(*inputs, *ctx.static)
        grads = iter(torch.autograd.grad(out, wrt, grad.to(out.dtype), allow_unused=True))
        return (None, None, None,
                *(next(grads) if t is not None and t.requires_grad else None for t in inputs))


NAMESPACE = "bevformer_port"
# kept for the process's life: the operators go with it
_LIBRARY = torch.library.Library(NAMESPACE, "DEF")


def register_op(schema: str, cpu: Callable, cuda: Callable, fake: Callable):
    """Define the operator `NAMESPACE::schema` with its CPU, CUDA and fake
    implementations, and return it.  (The `torch.library.Library` API: a
    call reaches the implementation with no `torch._dynamo` in between,
    which `torch.library.custom_op`'s wrapper imports at the first call.)"""
    name = schema.split("(", 1)[0]
    _LIBRARY.define(schema)
    _LIBRARY.impl(name, cpu, "CPU")
    _LIBRARY.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIBRARY)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def wants_grad(*tensors) -> bool:
    """Whether autograd would record a call on `tensors` (None skipped)."""
    return torch.is_grad_enabled() and any(
        torch.is_tensor(t) and t.requires_grad for t in tensors)


def with_plain_vjp(launch: Callable, plain: Callable, inputs: Sequence[Optional[torch.Tensor]],
                   static: tuple = ()) -> torch.Tensor:
    """`launch(*inputs)`, differentiable: the backward recomputes
    `plain(*inputs, *static)` under autograd from the saved inputs and
    returns its vector-Jacobian product against the incoming gradient, cast
    to the plain output's dtype (a plain version computing in float32 gets a
    float32 gradient).  `inputs` are the tensors (or None) that gradients may
    flow to; `launch` takes them in that order.  The forward is exactly
    `launch`'s."""
    return _PlainVJP.apply(launch, plain, tuple(static), *inputs)
