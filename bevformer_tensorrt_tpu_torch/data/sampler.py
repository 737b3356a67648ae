"""Index samplers for sharded evaluation and training
(port of `bevformer_tensorrt_tpu/data/sampler.py`).

Equivalents of the reference's samplers (upstream
datasets/samplers/distributed_sampler.py:8-36, the even-split
DistributedSampler, and the group sampler): each process takes a partition
of the frame indices.
"""
from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np


def even_split_indices(n: int, shard: int, num_shards: int) -> np.ndarray:
    """Even split with round-robin padding — every shard gets ceil(n/shards)
    indices (the reference pads so all ranks step together,
    distributed_sampler.py:30-36)."""
    per = -(-n // num_shards)
    idx = np.arange(per * num_shards) % n
    return idx[shard::num_shards][:per]


def scene_group_shards(scene_tokens: Sequence[str], num_shards: int) -> List[List[int]]:
    """Scene-grouped sharding for recurrent eval: all frames of one scene go
    to the same shard (prev_bev recurrence can't cross hosts).  Greedy
    balance by scene length."""
    groups: dict = {}
    for i, tok in enumerate(scene_tokens):
        groups.setdefault(tok, []).append(i)
    shards: List[List[int]] = [[] for _ in range(num_shards)]
    for frames in sorted(groups.values(), key=len, reverse=True):
        min(shards, key=len).extend(frames)
    return shards


class ShuffledBatchSampler:
    """Epoch-shuffled batch index iterator (training; host-local shard)."""

    def __init__(self, n: int, batch: int, shard: int = 0, num_shards: int = 1, seed: int = 0):
        self.n, self.batch = n, batch
        self.shard, self.num_shards = shard, num_shards
        self.rng = np.random.default_rng(seed + shard)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            idx = even_split_indices(self.n, self.shard, self.num_shards)
            self.rng.shuffle(idx)
            for s in range(0, len(idx) - self.batch + 1, self.batch):
                yield idx[s : s + self.batch]


def cbgs_indices(
    frame_labels: Sequence[Sequence[int]], num_classes: int, seed: int = 0
) -> np.ndarray:
    """Class-balanced group sampling (CBGS) resample indices.

    mmdet3d CBGSDataset semantics (the wrapper behind the reference's
    BEVDet-R50-**CBGS** baseline, which its mmdet3d dataset factory wraps
    around the training set): each frame is listed once per class present,
    then every class's list is resampled by ratio (1/num_classes) /
    class_frequency so all classes contribute equally in expectation.

    frame_labels: per frame, the (deduplicated here) class ids present.
    Returns the resampled frame-index array (len ~= sum of per-class picks).
    """
    class_sample_idxs = {c: [] for c in range(num_classes)}
    for idx, labels in enumerate(frame_labels):
        for c in set(int(l) for l in labels if 0 <= int(l) < num_classes):
            class_sample_idxs[c].append(idx)
    duplicated = sum(len(v) for v in class_sample_idxs.values())
    if duplicated == 0:
        return np.arange(len(frame_labels))
    frac = 1.0 / num_classes
    rng = np.random.default_rng(seed)
    out: List[int] = []
    for c, inds in class_sample_idxs.items():
        if not inds:
            continue
        ratio = frac / (len(inds) / duplicated)
        out.extend(rng.choice(inds, int(len(inds) * ratio)).tolist())
    return np.asarray(out, np.int64)
