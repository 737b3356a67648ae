"""Batched matrix inverse (port of `bevformer_tensorrt_tpu/ops/inverse.py`).

The reference's InverseTRT plugin (TensorRT/plugin/inverse/inverseKernel.cu
:33-39, cuBLAS getrf / getriBatched, float32 only; Python contract
det2trt/models/functions/inverse.py), used for batched 4x4 lidar2img
inverses: `inverse` for any square size, `inverse_4x4` as the JAX package's
closed-form cofactor expansion (no pivoting).
"""
from __future__ import annotations

import torch


def inverse(x: torch.Tensor) -> torch.Tensor:
    """The inverses of a batch of square matrices [..., M, M], computed in
    float32 and returned in the input's dtype."""
    return torch.linalg.inv(x.float()).to(x.dtype)


def inverse_4x4(x: torch.Tensor) -> torch.Tensor:
    """The closed-form cofactor inverse of [..., 4, 4] matrices, float32."""
    x = x.float()
    m = [[x[..., i, j] for j in range(4)] for i in range(4)]

    def det3(r, c):
        a, b, cc = (i for i in range(4) if i != r)
        d, e, f = (j for j in range(4) if j != c)
        return (m[a][d] * (m[b][e] * m[cc][f] - m[b][f] * m[cc][e])
                - m[a][e] * (m[b][d] * m[cc][f] - m[b][f] * m[cc][d])
                + m[a][f] * (m[b][d] * m[cc][e] - m[b][e] * m[cc][d]))

    cof = [[((-1.0) ** (i + j)) * det3(i, j) for j in range(4)] for i in range(4)]
    det = sum(m[0][j] * cof[0][j] for j in range(4))
    adj = torch.stack([torch.stack([cof[j][i] for j in range(4)], -1) for i in range(4)], -2)
    return adj / det[..., None, None]
