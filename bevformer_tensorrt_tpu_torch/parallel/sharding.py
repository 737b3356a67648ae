"""Parameter partition rules and the tensor-parallel shard of a model
(port of `bevformer_tensorrt_tpu/parallel/sharding.py`).

Megatron-style tensor parallelism for the BEVFormer transformer, as
path-regex -> spec rules (first match wins), matched on the port's dotted
parameter names, which keep the flax module names:

  * column-parallel (output features sharded): q/k/v/value projections and
    FFN fc1 - activations become head-sharded / hidden-sharded, no
    communication (the input passes Megatron's f);
  * row-parallel (input features sharded): output projections and FFN fc2 -
    one all-reduce of the partial products per block (g), the bias added once
    after it;
  * everything else (backbone convs, norms, embeddings, the offset and weight
    predictors, the cls/reg branches) replicated.

A spec is a tuple with one entry per dim of the parameter in torch's
[out, in] layout, the mesh axis or None: the JAX kernel's [in, out] spec
with its dims flipped.  As in the JAX package a parameter whose dim does not
divide the axis falls back to replication.  The port computes attention per
head, so it adds one rule of its own: the layers of one module (a "tensor-
parallel unit", named by the module's `TP_LAYERS`) shard together or not at
all, and an attention module's only where its heads divide the axis.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Tuple

import torch
import torch.nn as nn

from . import comm

DEFAULT_RULES: List[Tuple[str, tuple]] = [
    # column-parallel: shard the output-feature dim
    (r".*(q_proj|k_proj|v_proj|value_proj)\.weight$", ("tp", None)),
    (r".*(q_proj|k_proj|v_proj|value_proj)\.bias$", ("tp",)),
    (r".*ffn[^.]*\.fc1\.weight$", ("tp", None)),
    (r".*ffn[^.]*\.fc1\.bias$", ("tp",)),
    # row-parallel: shard the input-feature dim, all-reduce after
    (r".*(output_proj|out_proj)\.weight$", (None, "tp")),
    (r".*ffn[^.]*\.fc2\.weight$", (None, "tp")),
    # default: replicated
    (r".*", ()),
]


@dataclasses.dataclass(eq=False)
class TPShard:
    """How a sharded QDense takes part: "col" or "row" on `axis` of `mesh`."""

    mode: str
    mesh: object
    axis: str = "tp"


def spec_for_path(path: str, rules=DEFAULT_RULES) -> tuple:
    for pat, spec in rules:
        if re.fullmatch(pat, path):
            return spec
    return ()


def _fits(spec: tuple, shape, mesh) -> bool:
    if len(spec) > len(shape):
        return False
    return all(ax is None or dim % mesh.axis_size(ax) == 0 for dim, ax in zip(shape, spec))


def param_shardings(mesh, model: nn.Module, rules=DEFAULT_RULES) -> Dict[str, tuple]:
    """{parameter name: spec} for `model`, replicated where a rule's sharded
    dim does not divide the parameter (the JAX function's fallback).  The
    shapes are the whole parameters: call it before `shard_parameters`."""
    out = {}
    for name, p in model.named_parameters():
        spec = spec_for_path(name, rules)
        out[name] = spec if _fits(spec, p.shape, mesh) else ()
    return out


def _units(model: nn.Module):
    for name, mod in model.named_modules():
        layers = getattr(mod, "TP_LAYERS", None)
        if layers:
            prefix = f"{name}." if name else ""
            yield mod, [(prefix + lname, mod.get_submodule(lname)) for lname in layers]


def _narrow(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    per = t.shape[dim] // n
    return t.narrow(dim, i * per, per).clone()


@torch.no_grad()
def shard_parameters(model: nn.Module, mesh, rules=DEFAULT_RULES, axis: str = "tp"
                     ) -> Dict[str, tuple]:
    """Replace every parameter of a sharded unit by this rank's slice (and
    the layer's folded int8 weight with it), mark its layers column- or
    row-parallel, and return the specs that hold after it (a unit that does
    not shard reports all its parameters replicated).  Every rank of the
    axis must call it on the same whole model."""
    specs = param_shardings(mesh, model, rules)
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    sharded = set()
    for mod, layers in _units(model):
        wspecs = [specs[f"{path}.weight"] for path, _ in layers]
        heads = getattr(mod, "num_heads", None)
        if n == 1 or any(axis not in s for s in wspecs) or (heads is not None and heads % n):
            continue
        if getattr(mod, "int8_flash", False):
            raise ValueError(
                f"{type(mod).__name__}: the int8 flash kernel quantizes q, k and v per tensor, "
                "which a rank holding a share of the heads cannot do alone; exclude "
                "'<module>/flash' from int8 to run it under tensor parallelism")
        for (path, layer), spec in zip(layers, wspecs):
            dim = spec.index(axis)
            layer.weight = nn.Parameter(_narrow(layer.weight, dim, n, i))
            if dim == 0:
                layer.out_features = layer.weight.shape[0]
                if layer.bias is not None:
                    layer.bias = nn.Parameter(_narrow(layer.bias, 0, n, i))
                if layer.wscale is not None:
                    layer.wscale = _narrow(layer.wscale, 0, n, i)
            else:
                layer.in_features = layer.weight.shape[1]
            if layer.wq is not None:
                layer.wq = _narrow(layer.wq, dim, n, i)
            layer.wmat = None
            layer.tp = TPShard("col" if dim == 0 else "row", mesh, axis)
            sharded.update(f"{path}.{p}" for p, _ in layer.named_parameters())
    return {name: (spec if name in sharded else ()) for name, spec in specs.items()}


@torch.no_grad()
def gather_state_dict(model: nn.Module, mesh, specs: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
    """The whole model's state_dict from a sharded one (every rank of the
    axis calls it; each gets the whole): sharded parameters and their folded
    int8 weights are all-gathered along their sharded dim."""
    sd = model.state_dict()
    out = {}
    for name, t in sd.items():
        owner, _, leaf = name.rpartition(".")
        spec = specs.get(name)
        if leaf in ("wq", "wscale"):  # folded int8 weights follow their layer's weight
            layer = model.get_submodule(owner)
            tp = getattr(layer, "tp", None)
            dim = None if tp is None else (0 if tp.mode == "col" else (1 if leaf == "wq" else None))
            spec = None if dim is None else tuple(tp.axis if d == dim else None
                                                  for d in range(t.dim()))
        if spec and any(spec):
            dim = next(d for d, ax in enumerate(spec) if ax is not None)
            t = comm.all_gather(t.contiguous(), mesh, spec[dim], dim)
        out[name] = t
    return out
