"""Continuous batching of multi-camera frames across scenes (port of
`bevformer_tensorrt_tpu/runtime/serving.py`).

The reference serves one frame at a time with prev_bev through the host.
This engine serves many scenes on one card:

  * a device pool of per-scene prev_bev slots [S+1, nq, 1, C] float32; slot
    S is scratch and takes the padded lanes' reads and writes,
  * a scene -> slot map with a free list: a slot is claimed when a scene's
    first frame is scheduled and released by `finish_scene`; scenes beyond
    capacity wait until a slot frees (never a slot modulo the pool size),
  * a host scheduler that takes up to B ready frames from different scenes
    a step (a scene's frames depend on each other, so at most one each),
  * one step of a fixed B lanes (`BEVFormer.forward_lanes`): the lanes'
    images cross to the device in one copy, the backbone and the FPN run
    once over all B x cams images, the head lane by lane; the step gathers
    the lanes' prev_bev from the pool and writes the new bev_embed back in
    place (`index_copy_`), so the recurrent state never leaves the device.

With `mesh` (`parallel.make_mesh`), the B lanes are split over the dp
ranks, as the JAX engine shards its frame axis over dp: every rank runs the
same scheduler on the same requests, runs its B / dp lanes, and all-gathers
the lanes' outputs, so each rank writes every lane's new row into its
replicated pool and its `step()` returns what the one-process engine
returns.  The tp ranks of a dp group run the same lanes.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs.bevformer import BEVFormerConfig
from ..models.detectors.bevformer import BEVFormer
from ..parallel import comm
from ..parallel.mesh import batch_sharding
from .engine import TemporalState, place_model, resolve_device


@dataclasses.dataclass
class FrameRequest:
    scene_id: int
    image: np.ndarray       # [1, cams, 3, H, W]
    can_bus: np.ndarray     # [18]
    lidar2img: np.ndarray   # [1, cams, 4, 4]
    scene_token: Any = None
    tag: Any = None         # the caller's correlation id


@dataclasses.dataclass
class _SceneRecord:
    state: TemporalState
    slot: Optional[int] = None   # pool slot, claimed when first scheduled
    has_prev: bool = False       # the slot holds this scene's prev_bev


class ContinuousBatchingEngine:
    """Batched recurrent inference over a pool of scene slots.  The model is
    made as `BEVFormerEngine` makes it: `model`, or a seeded `BEVFormer(cfg)`,
    with `state_dict` loaded strictly when given; on CUDA unless `device`
    says otherwise.  `mesh`: the lanes' data-parallel split (the batch must
    divide over dp)."""

    def __init__(self, cfg: BEVFormerConfig, model: Optional[BEVFormer] = None,
                 state_dict=None, device=None, seed: int = 0, max_scenes: int = 16,
                 batch: int = 4, mesh=None):
        self.mesh = mesh
        self.lanes = slice(0, batch) if mesh is None else batch_sharding(mesh, batch)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = place_model(cfg, model, state_dict, self.device, seed)
        self.batch = batch
        self.max_scenes = max_scenes
        nq = cfg.bev_h * cfg.bev_w
        # slot `max_scenes` is scratch: padded lanes read its contents and
        # write over them without touching a live scene's state
        self.pool = torch.zeros((max_scenes + 1, nq, 1, cfg.embed_dims), dtype=torch.float32,
                                device=self.device)
        self.scenes: Dict[int, _SceneRecord] = {}
        self.queues: Dict[int, collections.deque] = collections.defaultdict(collections.deque)
        self._free_slots: List[int] = list(range(max_scenes))
        shape = (batch, cfg.num_cams, 3, cfg.img_h, cfg.img_w)
        # the lanes' images are stacked here and cross in one copy a step
        self._images = torch.zeros(shape, dtype=torch.float32,
                                   pin_memory=self.device.type == "cuda")

    def submit(self, req: FrameRequest) -> None:
        self.queues[req.scene_id].append(req)
        if req.scene_id not in self.scenes:
            self.scenes[req.scene_id] = _SceneRecord(state=TemporalState())

    def finish_scene(self, scene_id: int) -> None:
        """Release a finished scene's slot (after its last frame's results
        are consumed); frames of the scene still queued are dropped."""
        rec = self.scenes.pop(scene_id, None)
        self.queues.pop(scene_id, None)
        if rec is not None and rec.slot is not None:
            self._free_slots.append(rec.slot)

    def _ready(self) -> List[FrameRequest]:
        """One pending frame per slot-holding scene, up to the batch.  A
        scene without a slot claims one from the free list; when none is
        free it waits."""
        out = []
        for sid, q in self.queues.items():
            if not q or len(out) >= self.batch:
                continue
            rec = self.scenes[sid]
            if rec.slot is None:
                if not self._free_slots:
                    continue
                rec.slot = self._free_slots.pop()
            out.append(q.popleft())
        return out

    @torch.no_grad()
    def step(self) -> List[Tuple[Any, np.ndarray, np.ndarray]]:
        """Run one batched step.  Returns [(tag, classes, coords)] for the
        frames processed, on the host (padded lanes are dropped)."""
        reqs = self._ready()
        if not reqs:
            return []
        B, cfg = self.batch, self.cfg
        # padded lanes: the scratch slot, zero inputs
        slot_ids = np.full(B, self.max_scenes, np.int64)
        use_prev = np.zeros(B, np.float32)
        cbs = np.zeros((B, cfg.can_bus_dims), np.float32)
        l2is = np.zeros((B, cfg.num_cams, 4, 4), np.float32)
        images = self._images.numpy()
        images[len(reqs):] = 0.0
        for i, r in enumerate(reqs):
            rec = self.scenes[r.scene_id]
            delta_cb, up = rec.state.step_can_bus(
                r.can_bus, r.scene_token or r.scene_id, has_prev=rec.has_prev)
            # a scene's first frame reads its slot with use_prev_bev 0
            rec.has_prev = True
            slot_ids[i] = rec.slot
            use_prev[i] = up
            cbs[i] = delta_cb
            l2is[i] = np.asarray(r.lidar2img, np.float32).reshape(cfg.num_cams, 4, 4)
            images[i] = np.asarray(r.image, np.float32).reshape(images.shape[1:])
        dev, mine = self.device, self.lanes
        slots = torch.from_numpy(slot_ids).to(dev)
        bev, classes, coords = self.model.forward_lanes(
            self._images[mine].to(dev, non_blocking=True),
            self.pool.index_select(0, slots[mine]), torch.from_numpy(use_prev[mine]).to(dev),
            torch.from_numpy(cbs[mine]).to(dev), torch.from_numpy(l2is[mine]).to(dev))
        if self.mesh is not None:  # every lane's rows on every rank
            bev, classes, coords = (comm.all_gather(t, self.mesh, "dp", 0)
                                    for t in (bev, classes, coords))
        # live lanes hold distinct slots; padded lanes all write the scratch
        # slot, where the order does not matter
        self.pool.index_copy_(0, slots, bev)
        classes, coords = classes.cpu().numpy(), coords.cpu().numpy()
        return [(r.tag, classes[i], coords[i]) for i, r in enumerate(reqs)]

    def drain(self) -> List[Tuple[Any, np.ndarray, np.ndarray]]:
        results = []
        while any(self.queues.values()):
            got = self.step()
            if not got:
                # every queued scene waits on a slot: nothing moves until
                # finish_scene releases one
                break
            results += got
        return results
