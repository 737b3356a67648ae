"""The port's loader of upstream-layout BEVFormer checkpoints against the JAX
package's importer (CPU, float32, micro sizes).

One seeded state_dict under the upstream mmdet key names
(`bevformer_torch_oracle.synthetic_bevformer_state_dict`) goes two ways: through
the JAX package's `import_bevformer_checkpoint` and the port's
`params_from_jax`, and through the port's `load_bevformer_checkpoint`.  Both
only move and rename tensors, so they must give the same tensors bit for
bit.  The two packages' engines, each loaded its own way, then agree over two
frames at 1e-4, the bar of tests/test_full_model_parity.py.
"""
import numpy as np
import pytest
import torch

from bevformer_tensorrt_tpu.configs import bevformer as jax_configs
from bevformer_tensorrt_tpu.models.detectors.bevformer import BEVFormer as JaxBEVFormer
from bevformer_tensorrt_tpu.runtime.engine import BEVFormerEngine as JaxEngine
from bevformer_tensorrt_tpu.runtime.torch_import import import_bevformer_checkpoint
from bevformer_tensorrt_tpu_torch.configs import bevformer as configs
from bevformer_tensorrt_tpu_torch.models.detectors.bevformer import BEVFormer
from bevformer_tensorrt_tpu_torch.runtime.engine import BEVFormerEngine
from bevformer_tensorrt_tpu_torch.runtime.torch_import import (
    bevformer_key_map,
    load_bevformer_checkpoint,
    load_torch_checkpoint,
    upstream_layout,
)
from bevformer_tensorrt_tpu_torch.weights import init_weights, params_from_jax
from bevformer_torch_oracle import synthetic_bevformer_state_dict
from torch_port_helpers import engine_frames, rel

torch.set_num_threads(2)

CONFIGS = {
    "micro_r50": {},
    "r101_dcn_four_levels": dict(backbone_depth=101, dcn_stages=(False, False, True, True),
                                 backbone_out_indices=(1, 2, 3), num_levels=4),
}


def both_ways(name, seed=3):
    over = CONFIGS[name]
    cfg = configs.bevformer_micro(**over)
    jcfg = jax_configs.bevformer_micro(msda_impl="jnp", **over)
    upstream = synthetic_bevformer_state_dict(jcfg, np.random.default_rng(seed))
    variables = import_bevformer_checkpoint(
        upstream, depth=jcfg.backbone_depth, encoder_layers=jcfg.encoder_layers,
        decoder_layers=jcfg.decoder_layers, dcn_stages=jcfg.dcn_stages)
    return cfg, jcfg, upstream, variables


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loader_gives_the_importers_tensors_bit_for_bit(name):
    cfg, _, upstream, variables = both_ways(name)
    want = params_from_jax(variables)
    got = load_bevformer_checkpoint(cfg, upstream)
    assert sorted(got) == sorted(want)
    for key, tensor in want.items():
        assert got[key].dtype == torch.float32 and torch.equal(got[key], tensor), key
    model = BEVFormer(cfg)
    model.load_state_dict(got, strict=True)  # every tensor of the model, and no other
    assert sorted(got) == sorted(model.state_dict())
    if name != "micro_r50":
        block = "img_backbone.stage2_block0.conv2"
        np.testing.assert_array_equal(
            got[f"{block}.weight"].numpy(), upstream["img_backbone.layer3.0.conv2.weight"])
        assert tuple(got[f"{block}.conv_offset.weight"].shape) == (27, 256, 3, 3)
        assert "img_neck.fpn3.weight" in got and "img_neck.lateral2.weight" in got


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_upstream_layout_is_the_inverse(name):
    """A seeded port model -> upstream keys -> the loader: the same tensors,
    and as many upstream keys as the synthetic checkpoint has."""
    cfg, _, upstream, _ = both_ways(name)
    model = init_weights(BEVFormer(cfg), torch.Generator().manual_seed(1))
    sd = model.state_dict()
    up = upstream_layout(cfg, sd)
    assert sorted(up) == sorted(upstream)
    assert all(tuple(up[k].shape) == upstream[k].shape for k in up)
    back = load_bevformer_checkpoint(model, up)  # a model stands for its cfg
    assert sorted(back) == sorted(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    assert len(list(bevformer_key_map(cfg))) == len(sd)


def test_two_frames_match_jax_from_one_upstream_checkpoint():
    cfg, jcfg, upstream, variables = both_ways("micro_r50")
    frames = engine_frames(cfg, np.random.default_rng(5))
    jax_engine = JaxEngine(JaxBEVFormer(jcfg), variables, jcfg, donate_prev_bev=False)
    engine = BEVFormerEngine(cfg, state_dict=load_bevformer_checkpoint(cfg, upstream),
                             device="cpu")
    for i, f in enumerate(frames):
        want, got = jax_engine.infer_frame(**f), engine.infer_frame(**f)
        pairs = [("bev_embed", engine.state.prev_bev, jax_engine.state.prev_bev),
                 ("classes", got[0], want[0]), ("coords", got[1], want[1])]
        for what, g, w in pairs:
            assert tuple(g.shape) == np.shape(w), (i, what)
            assert rel(g.numpy(), np.asarray(w)) < 1e-4, (i, what)


def test_missing_and_unknown_keys_raise_with_their_names():
    cfg, _, upstream, _ = both_ways("micro_r50")
    short = {k: v for k, v in upstream.items() if k != "img_neck.fpn_convs.0.conv.bias"}
    with pytest.raises(KeyError, match=r"no key 'img_neck\.fpn_convs\.0\.conv\.bias'"):
        load_bevformer_checkpoint(cfg, short)
    extra = dict(upstream, **{"pts_bbox_head.transformer.stray.weight": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match=r"takes no key 'pts_bbox_head\.transformer\.stray\.weight'"):
        load_bevformer_checkpoint(cfg, extra)
    # a checkpoint of another depth: its first surplus key is named
    deeper = synthetic_bevformer_state_dict(
        jax_configs.bevformer_micro(msda_impl="jnp", backbone_depth=101), np.random.default_rng(0))
    with pytest.raises(KeyError, match=r"takes no key 'img_backbone\.layer3\.10\."):
        load_bevformer_checkpoint(cfg, deeper)
    with pytest.raises(KeyError, match="split"):
        bad = dict(upstream)
        key = "pts_bbox_head.transformer.decoder.layers.0.attentions.0.attn.in_proj_bias"
        bad[key] = bad[key][:-1]
        load_bevformer_checkpoint(cfg, bad)
    with pytest.raises(TypeError, match="BEVFormerConfig"):
        load_bevformer_checkpoint("micro", upstream)
    with pytest.raises(RuntimeError, match="size mismatch"):  # the engine loads strictly
        wrong = load_bevformer_checkpoint(cfg, upstream)
        wrong["img_neck.fpn0.bias"] = wrong["img_neck.fpn0.bias"][:-1]
        BEVFormerEngine(cfg, state_dict=wrong, device="cpu")


def test_what_real_checkpoint_files_carry(tmp_path):
    """A `.pth` wraps the tensors under "state_dict", DataParallel prefixes
    them with "module.", BatchNorm adds its step counters and the head its
    loss weights: all of that loads, from torch tensors as from numpy arrays."""
    cfg, _, upstream, _ = both_ways("micro_r50")
    want = load_bevformer_checkpoint(cfg, upstream)
    as_saved = {f"module.{k}": torch.from_numpy(v) for k, v in upstream.items()}
    as_saved["module.img_backbone.bn1.num_batches_tracked"] = torch.tensor(7)
    as_saved["module.pts_bbox_head.code_weights"] = torch.ones(10)
    path = tmp_path / "bevformer_micro.pth"
    torch.save({"state_dict": as_saved, "meta": {"epoch": 24}}, path)
    got = load_bevformer_checkpoint(cfg, load_torch_checkpoint(str(path)))
    assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)
    torch.save(as_saved, path)  # a bare state_dict
    assert sorted(load_torch_checkpoint(str(path))) == sorted(as_saved)
