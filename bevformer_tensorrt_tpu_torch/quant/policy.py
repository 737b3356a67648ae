"""Mixed-precision quantization policy: per-site exclusion patterns
(port of `bevformer_tensorrt_tpu/quant/policy.py`).

A tuple of path patterns names the sites that stay in the compute dtype
while everything else quantizes.  A site is a module's qualified name with
'/' for '.', e.g.
    pts_bbox_head/transformer/decoder/layer0/self_attn/q_proj
plus three pseudo-leaves for decisions that are not a dense layer's:
    .../msda_tables   int8 value tables in the MSDA kernel
    .../flash         the int8 flash-attention kernel
    .../dcn_tables    the int8 gather table of the DCN im2col
A pattern excludes a site if it is a substring of the path or an fnmatch
glob match, so the same patterns exclude the same sites as in the JAX
package (the port names every submodule as its flax counterpart).

The policy is part of the model config (`BEVFormerConfig.quant_exclude`).
`set_quant_exclude` resolves it once, when the model is built: every site
stores its own path and its resolved mode, and no forward consults a
global.
"""
from __future__ import annotations

import fnmatch
import json
import os
from typing import Sequence, Tuple

import torch.nn as nn


def quant_excluded(path: Sequence[str], exclude: Sequence[str]) -> bool:
    """True if the '/'-joined path matches any pattern of `exclude`."""
    if not exclude:
        return False
    p = "/".join(path)
    return any(pat in p or fnmatch.fnmatch(p, pat) for pat in exclude)


def effective_quant(quant, path: Sequence[str], exclude: Sequence[str]):
    """A site's quant mode under the policy: excluded sites run plain
    floating point."""
    if quant and quant_excluded(path, exclude):
        return False
    return quant


def set_quant_exclude(model: nn.Module, patterns: Sequence[str]) -> None:
    """Publish the exclusion patterns to every quantization site of `model`:
    each module with a `resolve_quant(path, exclude)` method gets its own
    path (parents before children) and resolves its mode."""
    exclude = tuple(patterns or ())
    for name, module in model.named_modules():
        resolve = getattr(module, "resolve_quant", None)
        if resolve is not None:
            resolve(tuple(name.split(".")) if name else (), exclude)


def _policy_path(artifact_path) -> str:
    return str(artifact_path) + ".policy.json"


def save_policy(artifact_path, exclude: Sequence[str] = (), **meta) -> None:
    """Persist the policy as a sidecar next to a scale artifact."""
    with open(_policy_path(artifact_path), "w") as f:
        json.dump({"exclude": list(exclude), **meta}, f)


def load_policy(artifact_path) -> Tuple[str, ...]:
    """The exclusion patterns persisted next to a scale artifact; empty
    when there is no sidecar."""
    p = _policy_path(artifact_path)
    if not os.path.exists(p):
        return ()
    with open(p) as f:
        return tuple(json.load(f).get("exclude", ()))
