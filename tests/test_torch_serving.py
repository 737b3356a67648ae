"""The port's continuous-batching engine (`runtime/serving.py`) on the CPU:
against the JAX package's engine on the same request streams, and against
the port's own per-frame `BEVFormerEngine` (float32, bfloat16 and int8).

Micro with one encoder and one decoder layer, as tests/test_serving.py builds
it, with seeded flax weights carried across by `params_from_jax`.  Two
streams: 2 scenes x 2 frames at batch 2, and the eviction case of
tests/test_serving.py (3 scenes over 2 slots: scene 2 waits for
`finish_scene`, then runs in a partial batch beside a padded lane, in the
freed slot).  The JAX engine is compiled once and serves both streams.
"""
import numpy as np
import pytest
import torch

from bevformer_tensorrt_tpu.configs.bevformer import bevformer_micro as jax_micro
from bevformer_tensorrt_tpu.models.detectors.bevformer import BEVFormer as JaxBEVFormer
from bevformer_tensorrt_tpu.runtime.serving import ContinuousBatchingEngine as JaxServing
from bevformer_tensorrt_tpu.runtime.serving import FrameRequest as JaxRequest
from bevformer_tensorrt_tpu_torch.configs.bevformer import bevformer_micro
from bevformer_tensorrt_tpu_torch.runtime.engine import BEVFormerEngine
from bevformer_tensorrt_tpu_torch.runtime.serving import ContinuousBatchingEngine, FrameRequest
from bevformer_tensorrt_tpu_torch.runtime.synthetic import camera_rig
from bevformer_tensorrt_tpu_torch.weights import params_from_jax
from torch_port_helpers import random_variables, rel

torch.set_num_threads(2)

LAYERS = dict(encoder_layers=1, decoder_layers=1)
JAX_TOL = 1e-4     # the port against the JAX engine, relative (tests/test_serving.py: 2e-4)
ENGINE_TOL = 1e-5  # a lane against the per-frame engine, float32
# a lane against the per-frame engine in bfloat16 and under int8: measured
# 0 on this CPU (each image's convolutions and every head op are computed as
# in the bs = 1 forward; the int8 scales are per image or static), held at
# the float32 bar
LANE_TOL = {"bfloat16": ENGINE_TOL, "int8": ENGINE_TOL}

# (scenes, max_scenes, batch, scene finished before the second drain)
STREAMS = {"two_scenes": ((0, 1), 4, 2, None), "eviction": ((0, 1, 2), 2, 2, 0)}


@pytest.fixture(scope="module")
def case():
    jcfg = jax_micro(msda_impl="jnp", **LAYERS)
    cfg = bevformer_micro(**LAYERS)
    rng = np.random.default_rng(11)
    l2i = camera_rig(cfg.num_cams, cfg.img_h, cfg.img_w, rng)
    frames = {}
    for s in range(3):
        can_bus = rng.standard_normal(cfg.can_bus_dims).astype(np.float32)
        for t in range(2):
            can_bus = can_bus.copy()
            can_bus[:3] += rng.normal(0, 1.0, 3).astype(np.float32)
            can_bus[-2:] += np.float32(0.1)
            frames[(s, t)] = dict(
                image=rng.standard_normal((1, cfg.num_cams, 3, cfg.img_h, cfg.img_w))
                .astype(np.float32), can_bus=can_bus, lidar2img=l2i)
    nq = cfg.bev_h * cfg.bev_w
    model = JaxBEVFormer(jcfg)
    variables = random_variables(model, rng, frames[(0, 0)]["image"],
                                 np.zeros((nq, 1, cfg.embed_dims), np.float32), np.float32(0.0),
                                 frames[(0, 0)]["can_bus"], l2i)
    jax_engine = JaxServing(model, variables, jcfg, max_scenes=2, batch=2)
    want = {name: serve(jax_engine, JaxRequest, frames, *spec, scene_base=10 * i)
            for i, (name, spec) in enumerate(STREAMS.items())}
    return cfg, params_from_jax(variables), frames, want


def serve(engine, request, frames, scenes, max_scenes, batch, finish, scene_base=0):
    """Submit the stream interleaved (frame t of every scene, then t + 1),
    drain, finish `finish` and drain again; every scene is finished at the
    end.  Returns {(scene, t): (classes, coords)} as numpy."""
    for t in range(2):
        for s in scenes:
            engine.submit(request(scene_id=scene_base + s, scene_token=f"scene{s}",
                                  tag=(s, t), **frames[(s, t)]))
    got = {tag: (np.asarray(c), np.asarray(b)) for tag, c, b in engine.drain()}
    if finish is not None:
        assert set(got) == {(s, t) for s in scenes if s != 2 for t in range(2)}
        engine.finish_scene(scene_base + finish)
        got.update({tag: (np.asarray(c), np.asarray(b)) for tag, c, b in engine.drain()})
    for s in scenes:
        engine.finish_scene(scene_base + s)
    assert set(got) == {(s, t) for s in scenes for t in range(2)}
    return got


def per_frame(cfg, model, frames, scenes):
    """The same frames through the port's per-frame engine, one scene at a
    time from a fresh temporal state."""
    engine = BEVFormerEngine(cfg, model=model, device="cpu")
    out = {}
    for s in scenes:
        engine.reset()
        for t in range(2):
            classes, coords = engine.infer_frame(scene_token=f"scene{s}", **frames[(s, t)])
            out[(s, t)] = (classes.numpy(), coords.numpy())
    return out


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_serving_matches_jax_and_the_per_frame_engine(case, stream):
    cfg, state_dict, frames, want = case
    scenes, max_scenes, batch, finish = STREAMS[stream]
    engine = ContinuousBatchingEngine(cfg, state_dict=state_dict, device="cpu",
                                      max_scenes=max_scenes, batch=batch)
    got = serve(engine, FrameRequest, frames, scenes, max_scenes, batch, finish)
    ref = per_frame(cfg, engine.model, frames, scenes)
    for tag, (classes, coords) in got.items():
        assert classes.shape == (1, 1, cfg.num_query, cfg.num_classes)
        assert rel(classes, want[stream][tag][0]) < JAX_TOL, tag
        assert rel(coords, want[stream][tag][1]) < JAX_TOL, tag
        assert rel(classes, ref[tag][0]) < ENGINE_TOL, tag
        assert rel(coords, ref[tag][1]) < ENGINE_TOL, tag


@pytest.mark.parametrize("mode", sorted(LANE_TOL))
def test_lanes_match_the_per_frame_engine(case, mode):
    """bfloat16, and int8 with calibrated scales: a scale taken over the
    lanes' batch rather than per image would make a lane depend on the
    others and fail here."""
    cfg, state_dict, frames, _ = case
    over = dict(dtype="bfloat16") if mode == "bfloat16" else dict(quant="int8")
    mcfg = bevformer_micro(**LAYERS, **over)
    engine = ContinuousBatchingEngine(mcfg, state_dict=state_dict, device="cpu", max_scenes=2,
                                      batch=2)
    if mode == "int8":
        ref_engine = BEVFormerEngine(mcfg, model=engine.model, device="cpu")
        ref_engine.calibrate([dict(scene_token="calib", **frames[(0, t)]) for t in range(2)],
                             method="max")
    got = serve(engine, FrameRequest, frames, *STREAMS["eviction"])
    ref = per_frame(mcfg, engine.model, frames, STREAMS["eviction"][0])
    for tag, (classes, coords) in got.items():
        assert np.isfinite(coords).all()
        assert rel(classes, ref[tag][0]) <= LANE_TOL[mode], (mode, tag)
        assert rel(coords, ref[tag][1]) <= LANE_TOL[mode], (mode, tag)


def test_pool_is_updated_in_place(case):
    """The pool keeps its storage across steps; each scene's slot then holds
    the per-frame engine's bev_embed of the scene's last frame, and the
    scratch slot took the padded lane's write."""
    cfg, state_dict, frames, _ = case
    engine = ContinuousBatchingEngine(cfg, state_dict=state_dict, device="cpu", max_scenes=2,
                                      batch=2)
    storage = engine.pool.untyped_storage().data_ptr()
    for t in range(2):
        engine.submit(FrameRequest(scene_id=0, scene_token="scene0", tag=(0, t),
                                   **frames[(0, t)]))
    assert len(engine.step()) == 1 and len(engine.step()) == 1
    assert engine.pool.untyped_storage().data_ptr() == storage
    slot = engine.scenes[0].slot
    ref = BEVFormerEngine(cfg, model=engine.model, device="cpu")
    for t in range(2):
        ref.infer_frame(scene_token="scene0", **frames[(0, t)])
    assert rel(engine.pool[slot].numpy(), ref.state.prev_bev.numpy()) < ENGINE_TOL
    assert engine.pool[engine.max_scenes].abs().max() > 0  # the padded lane's write
    others = [s for s in range(engine.max_scenes) if s != slot]
    assert all(engine.pool[s].abs().max() == 0 for s in others)


def test_serving_bench_repeats_alternate(case):
    """`tools/serving_bench.py`'s record with `repeats`: the timed drain and
    the sequential loop alternate, every run is kept, and the record's
    values are their medians."""
    from bevformer_tensorrt_tpu_torch.tools import serving_bench

    cfg, state_dict, _, _ = case
    engine = ContinuousBatchingEngine(cfg, state_dict=state_dict, device="cpu", max_scenes=2,
                                      batch=2)
    rec = serving_bench.bench(cfg, 2, 2, 2, device="cpu", engine=engine, repeats=3)
    assert rec["metric"] == "serving_micro_batch2_fps" and rec["repeats"] == 3
    runs = (rec["serving_fps_runs"], rec["sequential_fps_runs"], rec["speedup_runs"])
    assert all(len(r) == 3 and all(v > 0 for v in r) for r in runs)
    assert rec["value"] == np.median(runs[0])
    assert rec["sequential_fps"] == np.median(runs[1])
    assert rec["speedup_vs_sequential"] == np.median(runs[2])
    assert [a / b for a, b in zip(*runs[:2])] == runs[2]
    one = serving_bench.bench(cfg, 2, 2, 2, device="cpu", engine=engine, skip_sequential=True)
    assert "repeats" not in one and "sequential_fps" not in one and one["value"] > 0
