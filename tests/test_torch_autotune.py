"""Export-time kernel autotuning (`runtime/autotune.py`, the knob store
`ops/knobs.py`) on the CPU, against the JAX package's
`runtime/autotune.py`: the same sweep on the same grid and bench gives the
same result; the knobs round-trip through `knobs.json`; the default knob set
is the launch rules as they were at every deploy shape; each knob moves its
rule; a loaded program runs under its `knobs.json`; the export CLI's
`--autotune` and the evaluate CLI's `--knobs`.  The sweep itself times the
kernels, so it runs on the card only (`chip_smoke.py`, phase `export`)."""
import importlib
import json

import pytest
import torch

from bevformer_tensorrt_tpu.runtime import autotune as jax_autotune
from bevformer_tensorrt_tpu_torch.ops import attention as attn_ops
from bevformer_tensorrt_tpu_torch.ops import dcn as dcn_ops
from bevformer_tensorrt_tpu_torch.ops import knobs
from bevformer_tensorrt_tpu_torch.ops import msda as msda_ops
from bevformer_tensorrt_tpu_torch.runtime import autotune
from bevformer_tensorrt_tpu_torch.runtime import export as export_rt

int8_ops = importlib.import_module("bevformer_tensorrt_tpu_torch.ops.int8_matmul")


@pytest.fixture(autouse=True)
def _defaults():
    """Every test starts and ends with the default knobs."""
    knobs.apply(None)
    yield
    assert knobs.current() == knobs.DEFAULTS
    knobs.apply(None)


def fake_bench(table):
    def bench_once(k):
        key = (k["MSDA_TAPS_PER_BLOCK"], k["MSDA_BLOCKS_PER_SM"], k["DCN_WIDE_TILE"])
        if key == (2048, 8, False):
            raise RuntimeError("too much shared memory")  # a geometry the card refuses
        return table[key]
    return bench_once


def test_autotune_matches_the_jax_module():
    """One grid (the port's), one fake bench with a set that raises: the JAX
    module's sweep and the port's give the same winner, seconds and table."""
    grid = autotune.DEFAULT_GRID
    times = {(k["MSDA_TAPS_PER_BLOCK"], k["MSDA_BLOCKS_PER_SM"], k["DCN_WIDE_TILE"]):
             0.08 + 0.001 * ((7 * i) % 11) + 1e-7 * i for i, k in enumerate(grid)}
    got = autotune.autotune(fake_bench(times), grid)
    want = jax_autotune.autotune(fake_bench(times), grid)
    assert got == want
    assert len(got["table"]) == len(grid) == 18
    assert grid[0] == {"MSDA_TAPS_PER_BLOCK": 1024, "MSDA_BLOCKS_PER_SM": 4,
                       "DCN_WIDE_TILE": True}
    assert sum("error" in r for r in got["table"]) == 1
    winner = got["knobs"]
    assert got["seconds"] == round(times[(winner["MSDA_TAPS_PER_BLOCK"],
                                          winner["MSDA_BLOCKS_PER_SM"],
                                          winner["DCN_WIDE_TILE"])], 5)
    with pytest.raises(RuntimeError, match="every knob combination failed"):
        autotune.autotune(lambda k: 1 / 0, grid[:3])


def test_autotune_grid_sweeps_msda_and_the_dcn_tile():
    grid = autotune.DEFAULT_GRID
    assert len({json.dumps(k, sort_keys=True) for k in grid}) == 18
    assert {k["MSDA_TAPS_PER_BLOCK"] for k in grid} == {512, 1024, 2048}
    assert {k["MSDA_BLOCKS_PER_SM"] for k in grid} == {2, 4, 8}
    assert {k["DCN_WIDE_TILE"] for k in grid} == {True, False}
    for k in grid:  # the product's and flash's knobs stay at their rules
        knobs.complete(k)
        assert not set(k) & {"GEMM_SMALL_OUTPUTS", "GEMM_SMALL_K", "FLASH_ROW_GROUPS"}
    assert set(autotune.KNOBS) == set(knobs.DEFAULTS)


def test_autotune_select_persist_roundtrip(tmp_path):
    """The JAX round trip (tests/test_export_cli.py): the sweep picks the
    fastest set, a failed set is recorded, the saved knobs load and apply,
    a knob a set does not name is at its default, `apply_knobs(None)`
    restores every default."""
    times = {(k["MSDA_TAPS_PER_BLOCK"], k["MSDA_BLOCKS_PER_SM"], k["DCN_WIDE_TILE"]): 0.5
             for k in autotune.DEFAULT_GRID}
    times[(512, 8, False)] = 0.3
    result = autotune.autotune(fake_bench(times))
    assert result["knobs"] == {"MSDA_TAPS_PER_BLOCK": 512, "MSDA_BLOCKS_PER_SM": 8,
                               "DCN_WIDE_TILE": False}
    assert any("error" in r for r in result["table"])
    autotune.save_knobs(tmp_path, result)
    loaded = autotune.load_knobs(tmp_path)
    assert loaded == result["knobs"]
    knobs.apply({"FLASH_ROW_GROUPS": 1})
    autotune.apply_knobs(loaded)
    try:
        assert knobs.get("MSDA_TAPS_PER_BLOCK") == 512 and knobs.get("MSDA_BLOCKS_PER_SM") == 8
        assert knobs.get("DCN_WIDE_TILE") is False
        assert knobs.get("FLASH_ROW_GROUPS") == 0  # knobs the file does not name: defaults
    finally:
        autotune.apply_knobs(None)
    assert knobs.current() == knobs.DEFAULTS
    assert autotune.load_knobs(tmp_path / "nope") is None
    with autotune.knob_set({"GEMM_SMALL_K": 64}) as now:
        assert now["GEMM_SMALL_K"] == 64 == knobs.get("GEMM_SMALL_K")
        with autotune.knob_set(None):
            assert knobs.current() == knobs.DEFAULTS
        assert knobs.get("GEMM_SMALL_K") == 64
    assert knobs.current() == knobs.DEFAULTS


@pytest.mark.parametrize("bad,match", [
    ({"MSDA_NP": "4"}, "unknown kernel knob"), ({"FLASH_ROW_GROUPS": 3}, "one of"),
    ({"MSDA_TAPS_PER_BLOCK": 0}, "out of range"), ({"DCN_WIDE_TILE": 1}, "true or false"),
    ({"GEMM_SMALL_K": "1024"}, "integer")])
def test_a_knob_the_port_cannot_take_raises(bad, match, tmp_path):
    """Unknown names and values a rule cannot take raise, in `apply_knobs`
    and in `load_knobs`, and leave the store as it was."""
    with pytest.raises((KeyError, ValueError), match=match):
        autotune.apply_knobs(bad)
    assert knobs.current() == knobs.DEFAULTS
    (tmp_path / "knobs.json").write_text(json.dumps({"knobs": bad}))
    with pytest.raises((KeyError, ValueError), match=match):
        autotune.load_knobs(tmp_path)


# Every call of the four launch rules on the main path of the deploy
# configurations (PERF.md section 4), one frame or batch each on an H100 (132
# SMs) with the rules as they stood before the knobs: BEVFormer tiny, small and
# base in float32, bfloat16 and int8 (float32 and bfloat16 activations; TSA's
# tables floating point), BEVDet-R50 int8, YOLOX-x and CenterNet-R18 at batch 8
# at 640 px in float32, bfloat16 and int8.  Every value row's address was
# 16-byte aligned.
# (bs, nq, heads, ch, levels, points, bytes of a table value) -> (qt, lpp, vw, seg, passes,
# cch, chunks, smem, blocks)
MSDA_AT_DEPLOY = {
    (6, 896, 8, 32, 1, 8, 4): (11, 8, 16, 1, 1, 32, 1, 23936, 492),
    (6, 896, 8, 32, 1, 8, 2): (11, 8, 16, 1, 1, 32, 1, 23936, 492),
    (6, 896, 8, 32, 1, 8, 1): (11, 8, 16, 2, 1, 32, 1, 23936, 492),
    (1, 900, 8, 32, 1, 4, 4): (2, 4, 16, 2, 1, 32, 1, 2304, 450),
    (1, 900, 8, 32, 1, 4, 2): (2, 4, 16, 4, 1, 32, 1, 2304, 450),
    (1, 900, 8, 32, 1, 4, 1): (2, 4, 16, 8, 1, 32, 1, 2304, 450),
    (2, 2500, 8, 32, 1, 4, 4): (10, 4, 16, 1, 1, 32, 1, 11520, 500),
    (2, 2500, 8, 32, 1, 4, 2): (10, 4, 16, 1, 1, 32, 1, 11520, 500),
    (6, 7936, 8, 32, 1, 8, 4): (16, 8, 16, 1, 1, 32, 1, 34816, 2976),
    (6, 7936, 8, 32, 1, 8, 2): (16, 8, 16, 1, 1, 32, 1, 34816, 2976),
    (6, 7936, 8, 32, 1, 8, 1): (16, 8, 16, 1, 1, 32, 1, 34816, 2976),
    (6, 14080, 8, 32, 4, 8, 4): (4, 32, 16, 1, 1, 32, 1, 33280, 21120),
    (6, 14080, 8, 32, 4, 8, 2): (4, 32, 16, 2, 1, 32, 1, 33280, 21120),
    (6, 14080, 8, 32, 4, 8, 1): (4, 32, 16, 4, 1, 32, 1, 33280, 21120),
    (2, 22500, 8, 32, 1, 4, 4): (32, 4, 16, 1, 1, 32, 1, 36864, 1408),
    (2, 22500, 8, 32, 1, 4, 2): (32, 4, 16, 1, 1, 32, 1, 36864, 1408),
    (2, 40000, 8, 32, 1, 4, 4): (32, 4, 16, 1, 1, 32, 1, 36864, 2500),
    (2, 40000, 8, 32, 1, 4, 2): (32, 4, 16, 1, 1, 32, 1, 36864, 2500),
}
# (B, Lq, Lk, d, kind) -> (grid, row groups, smem)
FLASH_AT_DEPLOY = {
    (8, 900, 900, 32, "float32"): ((29, 8), 2, 38912),
    (8, 900, 900, 32, "bfloat16"): ((29, 8), 2, 22528),
    (8, 900, 900, 32, "int8"): ((29, 8), 2, 68608),
}
# (cout_g, dtype, groups, pixels) -> configuration, on 132 SMs
DCN_AT_DEPLOY = {
    (256, torch.bfloat16, 1, 3200): "bf16_256x128",
    (256, torch.bfloat16, 1, 22080): "bf16_256x128",
    (256, torch.bfloat16, 1, 34800): "bf16_256x128",
    (512, torch.bfloat16, 1, 5520): "bf16_256x128",
    (512, torch.bfloat16, 1, 8700): "bf16_256x128",
    (64, torch.float32, 1, 51200): "f32_128x128",
    (128, torch.float32, 1, 12800): "f32_128x64",
    (256, torch.float32, 1, 3200): "f32_128x64",
    (256, torch.float32, 1, 22080): "f32_128x128",
    (256, torch.float32, 1, 34800): "f32_128x128",
    (512, torch.float32, 1, 5520): "f32_128x64",
    (512, torch.float32, 1, 8700): "f32_128x128",
}
# configuration -> the (M, N, K) it takes
GEMM_AT_DEPLOY = {
    "64x64": [
        (1, 128, 32), (1, 256, 128), (900, 3, 256), (900, 10, 256), (900, 32, 256),
        (900, 64, 256), (900, 256, 256), (900, 256, 512), (900, 512, 256), (2250, 256, 256),
        (2500, 64, 256), (2500, 64, 512), (2500, 128, 256), (2500, 128, 512), (2500, 256, 256),
        (2500, 256, 512), (2500, 512, 256), (3200, 1, 320), (3200, 4, 320), (3200, 80, 320),
        (3200, 512, 256), (3200, 640, 640), (4096, 128, 576), (4224, 123, 256), (5000, 256, 256),
        (5520, 256, 256), (12800, 1, 320), (12800, 4, 320), (12800, 80, 320), (16384, 1, 576),
        (16384, 2, 576), (16384, 3, 576), (16384, 10, 576), (16384, 64, 576), (22500, 64, 256),
        (22500, 64, 512), (51200, 1, 320), (51200, 4, 320), (204800, 2, 64)],
    "128x64": [
        (3200, 27, 4608), (5520, 27, 4608), (8700, 27, 4608), (12800, 27, 2304),
        (16384, 64, 2304), (22080, 27, 2304), (34800, 27, 2304), (40000, 64, 512),
        (51200, 27, 1152), (67584, 64, 64), (67584, 64, 256), (67584, 64, 576), (144000, 64, 64),
        (144000, 64, 256), (144000, 64, 576), (204800, 64, 576), (270336, 64, 160),
        (353280, 64, 64), (353280, 64, 256), (353280, 64, 576), (556800, 64, 64),
        (556800, 64, 256), (556800, 64, 576), (576000, 64, 160), (819200, 64, 160),
        (1413120, 64, 160), (2227200, 64, 160)],
    "128x128": [
        (256, 512, 2304), (256, 512, 4608), (1024, 256, 1152), (1024, 256, 2304),
        (1056, 256, 2048), (1056, 512, 2048), (1056, 512, 4608), (1056, 2048, 512),
        (1056, 2048, 1024), (2250, 256, 2048), (2250, 256, 2304), (2250, 512, 2048),
        (2250, 512, 4608), (2250, 2048, 512), (2250, 2048, 1024), (3200, 320, 1280),
        (3200, 320, 2880), (3200, 512, 2304), (3200, 512, 4608), (3200, 640, 1280),
        (3200, 640, 5760), (3200, 1280, 1280), (3200, 1280, 2560), (3200, 1280, 5760),
        (4096, 128, 1152), (4096, 512, 4608), (4096, 512, 5760), (4224, 256, 1024),
        (4224, 256, 2304), (4224, 512, 1024), (4224, 1024, 256), (4224, 1024, 512),
        (5520, 256, 2048), (5520, 256, 2304), (5520, 512, 1024), (5520, 512, 2048),
        (5520, 2048, 512), (5520, 2048, 1024), (8700, 256, 2048), (8700, 256, 2304),
        (8700, 512, 1024), (8700, 512, 2048), (8700, 2048, 512), (8700, 2048, 1024),
        (9000, 256, 1024), (9000, 256, 2304), (9000, 512, 1024), (9000, 1024, 256),
        (9000, 1024, 512), (12800, 256, 128), (12800, 256, 1152), (12800, 256, 2304),
        (12800, 320, 320), (12800, 320, 640), (12800, 320, 1280), (12800, 320, 2880),
        (12800, 640, 640), (12800, 640, 2880), (16384, 256, 256), (16384, 256, 4608),
        (16896, 128, 512), (16896, 128, 1152), (16896, 256, 512), (16896, 512, 128),
        (16896, 512, 256), (22080, 256, 512), (22080, 256, 1024), (22080, 1024, 256),
        (22080, 1024, 512), (22500, 128, 256), (22500, 128, 512), (22500, 256, 256),
        (22500, 256, 512), (22500, 512, 256), (34800, 256, 512), (34800, 256, 1024),
        (34800, 256, 2304), (34800, 1024, 256), (34800, 1024, 512), (36000, 128, 512),
        (36000, 128, 1152), (36000, 256, 512), (36000, 512, 128), (36000, 512, 256),
        (40000, 128, 512), (40000, 256, 256), (40000, 256, 512), (40000, 512, 256),
        (45000, 256, 256), (51200, 80, 320), (51200, 128, 64), (51200, 128, 576),
        (51200, 128, 1152), (51200, 160, 160), (51200, 160, 320), (51200, 160, 640),
        (51200, 160, 1440), (51200, 320, 320), (51200, 320, 1440), (51200, 320, 2880),
        (67584, 128, 256), (67584, 256, 64), (80000, 256, 256), (88320, 128, 256),
        (88320, 128, 512), (88320, 128, 1152), (88320, 512, 128), (88320, 512, 256),
        (139200, 128, 256), (139200, 128, 512), (139200, 128, 1152), (139200, 256, 512),
        (139200, 256, 2304), (139200, 512, 128), (139200, 512, 256), (144000, 128, 256),
        (144000, 256, 64), (184950, 256, 256), (204800, 80, 64), (204800, 80, 80),
        (204800, 80, 160), (204800, 80, 720), (204800, 160, 160), (204800, 160, 720),
        (353280, 256, 64), (556800, 256, 64), (819200, 80, 112)],
}


@pytest.mark.parametrize("rule", ["msda", "flash", "dcn", "gemm"])
def test_default_knobs_give_the_rules_at_every_deploy_shape(rule):
    if rule == "msda":
        for (bs, nq, heads, ch, L, P, esz), want in MSDA_AT_DEPLOY.items():
            geo = msda_ops.msda_launch_geometry(bs, nq, heads, ch, L, P, esz, 0, 132)
            got = tuple(geo[k] for k in ("qt", "lpp", "vw", "seg", "passes", "cch", "chunks",
                                         "smem", "blocks"))
            assert got == want, (bs, nq, heads, ch, L, P, esz)
    elif rule == "flash":
        for args, (grid, warps, smem) in FLASH_AT_DEPLOY.items():
            geo = attn_ops.flash_launch_geometry(*args)
            assert (geo["grid"], geo["warps"], geo["smem"]) == (grid, warps, smem), args
    elif rule == "dcn":
        for (cout_g, dtype, groups, pixels), want in DCN_AT_DEPLOY.items():
            assert dcn_ops.dcn_config(cout_g, dtype, groups, pixels, 132) == want
    else:
        for config, shapes in GEMM_AT_DEPLOY.items():
            for M, N, K in shapes:
                assert int8_ops.gemm_config(M, N, K) == config, (M, N, K)


# knob, non-default value, the rule's call, its answer under the default, under the value
MOVES = [
    ("MSDA_TAPS_PER_BLOCK", 2048, lambda: msda_ops.msda_launch_geometry(
        6, 14080, 8, 32, 4, 8, 4)["qt"], 4, 8),
    ("MSDA_BLOCKS_PER_SM", 8, lambda: msda_ops.msda_launch_geometry(
        1, 900, 8, 32, 1, 4, 2)["qt"], 2, 1),
    ("DCN_WIDE_TILE", False, lambda: dcn_ops.dcn_config(256, torch.bfloat16, 1, 6 * 58 * 100),
     "bf16_256x128", "bf16_128x128"),
    ("GEMM_SMALL_OUTPUTS", 0, lambda: int8_ops.gemm_config(900, 256, 256), "64x64", "128x128"),
    ("GEMM_SMALL_K", 4609, lambda: int8_ops.gemm_config(2250, 512, 4608), "128x128", "64x64"),
    ("FLASH_ROW_GROUPS", 1, lambda: attn_ops.flash_launch_geometry(8, 900, 900, 32, "int8")[
        "grid"], (29, 8), (57, 8)),
]


@pytest.mark.parametrize("name,value,rule,default,moved", MOVES, ids=[m[0] for m in MOVES])
def test_each_knob_moves_its_rule(name, value, rule, default, moved):
    assert rule() == default
    with autotune.knob_set({name: value}):
        assert rule() == moved
    assert rule() == default


def test_msda_blocks_scale_with_the_cards_sms():
    """MSDA's spread is blocks an SM times the card's SMs, not 132 fixed."""
    assert msda_ops.msda_launch_geometry(1, 900, 8, 32, 1, 4, 4, sms=132)["qt"] == 2
    assert msda_ops.msda_launch_geometry(1, 900, 8, 32, 1, 4, 4, sms=114)["qt"] == 2
    assert msda_ops.msda_launch_geometry(1, 900, 8, 32, 1, 4, 4, sms=228)["qt"] == 1


class _Toy(torch.nn.Module):
    """A linear layer and one MSDA operator at micro shapes."""

    def __init__(self):
        super().__init__()
        self.proj = torch.nn.Linear(16, 16)

    def forward(self, value, ref, off, attn):
        out = msda_ops.multi_scale_deformable_attn(value, ref, off, attn, ((4, 5),))
        return self.proj(out)


def test_loaded_program_runs_under_its_knobs(tmp_path):
    """`load_program` reads a hand-written `knobs.json`; each call of the
    program runs its module under those knobs (a spy on the store) and
    restores the knobs set before; a directory without one runs under the
    defaults."""
    import test_torch_export  # noqa: F401  (torch._dynamo imported with tools/ off sys.path)

    g = torch.Generator().manual_seed(0)
    args = (torch.randn(1, 20, 2, 8, generator=g), torch.rand(1, 3, 1, 2, generator=g),
            torch.randn(1, 3, 2, 8, generator=g), torch.randn(1, 3, 2, 4, generator=g))
    export_rt.export_program(_Toy(), args, tmp_path / "prog")
    tuned = {"MSDA_TAPS_PER_BLOCK": 512, "FLASH_ROW_GROUPS": 4}
    (tmp_path / "prog" / "knobs.json").write_text(json.dumps({"knobs": tuned, "table": []}))
    program = export_rt.load_program(tmp_path / "prog", "cpu")
    assert program.knobs == tuned
    seen, module = [], program.module

    def spy(*a):
        seen.append(knobs.current())
        return module(*a)

    program.module = spy
    knobs.apply({"GEMM_SMALL_K": 64})
    out = program(*args)
    assert seen == [knobs.complete(tuned)]
    assert knobs.current() == knobs.complete({"GEMM_SMALL_K": 64})
    knobs.apply(None)
    assert out.shape == (1, 3, 16) and torch.isfinite(out).all()
    (tmp_path / "prog" / "knobs.json").unlink()
    untuned = export_rt.load_program(tmp_path / "prog", "cpu")
    assert untuned.knobs is None and torch.equal(untuned(*args), out)


def test_export_cli_autotune_needs_the_card(tmp_path):
    """`--autotune` with `--device cpu` raises before any work, as `--aot`
    does."""
    from bevformer_tensorrt_tpu_torch.tools import export as export_cli

    with pytest.raises(ValueError, match="--autotune"):
        export_cli.main(["micro", "--device", "cpu", "--autotune", "--out", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()


def test_export_cli_sweep_times_each_set_under_its_knobs(monkeypatch):
    """The CLI's sweep: each grid set times the engine's module on the
    seeded rig's second frame with that set applied, a failed set is in the
    table, and the knobs are the defaults again afterwards."""
    from bevformer_tensorrt_tpu_torch.configs.bevformer import bevformer_micro
    from bevformer_tensorrt_tpu_torch.runtime.engine import BEVFormerEngine
    from bevformer_tensorrt_tpu_torch.tools import export as export_cli

    engine = BEVFormerEngine(bevformer_micro(), device="cpu", seed=0)
    calls = []

    def frame_seconds(module, inputs, iters):
        assert module is engine.model and iters == 3 and float(inputs[2]) == 1.0
        calls.append(knobs.current())
        if knobs.get("MSDA_BLOCKS_PER_SM") == 2:
            raise RuntimeError("refused")
        return 0.1 if knobs.get("MSDA_TAPS_PER_BLOCK") == 2048 and knobs.get("DCN_WIDE_TILE") \
            else 0.2

    monkeypatch.setattr(export_cli, "frame_seconds", frame_seconds)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "card")
    res = export_cli.sweep(engine, 3)
    assert calls == [knobs.complete(k) for k in autotune.DEFAULT_GRID]
    assert res["knobs"] == {"MSDA_TAPS_PER_BLOCK": 2048, "MSDA_BLOCKS_PER_SM": 4,
                            "DCN_WIDE_TILE": True}
    assert sum("error" in r for r in res["table"]) == 6 and len(res["table"]) == 18
    assert res["iters"] == 3 and res["device"] == "card" and "synthetic_frames" in res[
        "timing_input"]


def test_evaluate_cli_applies_knobs(tmp_path, monkeypatch, capsys):
    """`tools/evaluate.py --knobs DIR` runs under DIR's knobs, prints them
    on stderr, and restores the knobs set before."""
    from bevformer_tensorrt_tpu_torch.tools import evaluate as evaluate_cli

    tuned = {"MSDA_BLOCKS_PER_SM": 8, "DCN_WIDE_TILE": False}
    autotune.save_knobs(tmp_path, {"knobs": tuned, "seconds": 0.1, "table": []})
    seen = []
    monkeypatch.setattr(evaluate_cli, "evaluate",
                        lambda args: seen.append((args.model, knobs.current())) or "run")
    argv = ["micro", "--infos", str(tmp_path / "none.pkl"), "--device", "cpu"]
    assert evaluate_cli.main(argv + ["--knobs", str(tmp_path)]) == "run"
    assert seen == [("micro", knobs.complete(tuned))]
    assert f"kernel knobs from {tmp_path}: {tuned}" in capsys.readouterr().err
    assert knobs.current() == knobs.DEFAULTS
    assert evaluate_cli.main(argv) == "run" and seen[-1] == ("micro", knobs.DEFAULTS)
