"""The gather probes' plain versions and the kernel bench tool (CPU).

The probes have no counterpart to compare with in the JAX package on a CPU
(its TPU probes time Mosaic programs), so their plain versions are held to
numpy, exactly for the row gather and to 1e-6 for the blend (float32 sums
in another order).  The workload generator is the port's copy of the TPU
probes' `make_workload`: seeded, and local by construction.  The tool is run
end to end at its toy size on the CPU, where the wrappers take their plain
versions and every time is labelled a host time.
"""
import json

import numpy as np
import pytest
import torch

from bevformer_tensorrt_tpu_torch import ops
from bevformer_tensorrt_tpu_torch.ops import gather_probe
from bevformer_tensorrt_tpu_torch.tools import kernel_bench
from bevformer_tensorrt_tpu_torch.tools import kernel_cases as kc
from torch_port_helpers import rel

torch.set_num_threads(2)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


def table_of(rng, B, keys, ch, dtype):
    if dtype == torch.int8:
        return torch.from_numpy(rng.integers(-127, 128, (B, keys, ch)).astype(np.int8))
    return torch.from_numpy(rng.standard_normal((B, keys, ch)).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gather_rows_matches_numpy(dtype, rng):
    table = table_of(rng, 3, 50, 32, DTYPES[dtype])
    idx = rng.integers(-3, 54, (3, 70)).astype(np.int32)  # a few past either end: clamped
    got = ops.gather_rows(table, torch.from_numpy(idx))
    ref = table.float().numpy()
    want = np.stack([ref[b, np.clip(idx[b], 0, 49)] for b in range(3)])
    assert got.dtype == DTYPES[dtype] and tuple(got.shape) == (3, 70, 32)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gather_blend_matches_numpy(dtype, rng):
    B, keys, nq, taps = 2, 40, 9, 5
    table = table_of(rng, B, keys, 32, DTYPES[dtype])
    idx = rng.integers(0, keys, (B, nq, taps, 4)).astype(np.int32)
    w = rng.random((B, nq, taps, 4), dtype=np.float32)
    got = ops.gather_blend(table, torch.from_numpy(idx), torch.from_numpy(w))
    ref = table.float().numpy().astype(np.float64)
    want = np.zeros((B, nq, 32))
    for b in range(B):
        want[b] = (ref[b, idx[b]] * w[b][..., None]).sum(axis=(1, 2))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, nq, 32)
    assert rel(got.numpy(), want) < 1e-6


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gather_blend_library_call_is_the_same_function(dtype, rng):
    """The yardstick the bench times beside `gather_blend`: one
    `F.embedding_bag` over the tables laid end to end.  float32 rows agree
    with the plain version to 1e-6; bfloat16 rows take bfloat16 weights and
    return bfloat16 (two roundings of 2^-9 each: 1e-2); int8 rows have no
    such call.  Indices past either end are clamped, as in the probe."""
    B, keys, nq, taps = 3, 40, 9, 5
    table = table_of(rng, B, keys, 32, DTYPES[dtype])
    idx = torch.from_numpy(rng.integers(-2, keys + 2, (B, nq, taps, 4)).astype(np.int32))
    w = torch.from_numpy(rng.random((B, nq, taps, 4), dtype=np.float32))
    library = kc.gather_blend_library(table, idx, w)
    if dtype == "int8":
        assert library is None
        return
    got = library()
    assert got.dtype == DTYPES[dtype] and tuple(got.shape) == (B, nq, 32)
    want = gather_probe.gather_blend_plain(table, idx, w)
    assert rel(got.float().numpy(), want.numpy()) < (1e-6 if dtype == "float32" else 1e-2)


def test_probes_refuse_what_they_do_not_take(rng):
    table = table_of(rng, 2, 20, 32, torch.float32)
    idx = torch.zeros(2, 4, 3, 4, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        ops.gather_rows(table, idx.reshape(2, -1).long())
    with pytest.raises(ValueError, match=r"\[B, n\]"):
        ops.gather_rows(table, idx)
    with pytest.raises(ValueError, match="tables"):
        ops.gather_rows(table, idx.reshape(1, -1))
    with pytest.raises(ValueError, match="corners"):
        ops.gather_blend(table, idx, torch.ones(2, 4, 3, 2))
    with pytest.raises(TypeError, match="float32"):
        ops.gather_blend(table, idx, torch.ones(2, 4, 3, 4, dtype=torch.float64))
    with pytest.raises(ValueError, match="keys, ch"):
        ops.gather_blend(table[0], idx, torch.ones(2, 4, 3, 4))


def test_make_workload_is_seeded_and_local():
    """Two draws from one seed are equal; the tap indices of each row of 128
    consecutive taps lie in `span` consecutive 128-key panels, the rows'
    first panels grow along the table, and the corners follow the tap."""
    B, nq, taps, keys, row = 3, 64, 8, 128 * 20, 50
    a = gather_probe.make_workload(np.random.default_rng(4), B, nq, taps, keys, 3, row)
    b = gather_probe.make_workload(np.random.default_rng(4), B, nq, taps, keys, 3, row)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    idx, w = a
    assert idx.dtype == np.int32 and w.dtype == np.float32
    assert idx.shape == w.shape == (B, nq, taps, 4)
    assert idx.min() >= 0 and idx.max() < keys and 0 <= w.min() and w.max() < 1
    for span in (1, 3, 20):
        idx, _ = gather_probe.make_workload(np.random.default_rng(span), B, nq, taps, keys, span,
                                            row)
        k = idx[..., 0].reshape(B, nq * taps // 128, 128)
        first = k.min(-1) // 128
        assert ((k.max(-1) // 128 - first) < span).all()
        assert (np.diff(first, axis=1) >= -span).all()
        np.testing.assert_array_equal(idx[..., 1], np.minimum(idx[..., 0] + 1, keys - 1))
        np.testing.assert_array_equal(idx[..., 3], np.minimum(idx[..., 0] + row + 1, keys - 1))
    wide = gather_probe.make_workload(np.random.default_rng(0), B, nq, taps, keys, 20, row)[0]
    tight = gather_probe.make_workload(np.random.default_rng(0), B, nq, taps, keys, 1, row)[0]
    spread = lambda i: np.ptp(i[..., 0].reshape(B, -1, 128), axis=-1).mean()  # noqa: E731
    assert spread(wide) > 10 * spread(tight)
    with pytest.raises(ValueError, match="128"):
        gather_probe.make_workload(np.random.default_rng(0), 1, 3, 8, keys, 1)


def test_msda_gather_operands_replay_the_op(rng):
    """The indices and weights that the bench tool's split hands to the
    probes are the MSDA op's own: the blend over them is the op (1e-6)."""
    gen = torch.Generator().manual_seed(3)
    (value, ref, off, attn), shapes = kc.msda_inputs(kc.TOY_SHAPES["msda"]["toy"], torch.float32,
                                                     gen, "cpu", heads=2)
    table, idx, w = kc.msda_gather_operands(value, ref, off, attn, shapes)
    bs, nq = value.shape[0], ref.shape[1]
    got = ops.gather_blend(table, idx, w).reshape(bs, 2, nq, 32).permute(0, 2, 1, 3)
    want = ops.multi_scale_deformable_attn_plain(value, ref, off, attn, shapes)
    assert rel(got.reshape(bs, nq, 64).numpy(), want.numpy()) < 1e-6
    assert (w.reshape(bs * 2, nq, -1).sum(-1) <= 1 + 1e-5).all()  # softmax x bilinear x validity


def blend_hits(nq, entries, geo):
    """How often the loops of `csrc/gather_probe.cu::gather_blend_kernel`
    reach each (query, entry) of one table under `geo` (every table's blocks
    walk the same way), and the blocks of one table: a block per tile of qt
    queries; warp w takes rounds o0 = w * per_warp, + 8 * per_warp, ... while
    o0 < qt and the tile has query o0; row group g takes output o0 + g / seg
    (where it is < qt and a query) and chunks g % seg, + seg, ..., each up to
    the warp's steps for its first chunk of the round."""
    qt, seg, rpw, chunk = geo["qt"], geo["seg"], geo["rows_per_warp"], geo["chunk"]
    warps, per_warp = geo["threads"] // 32, rpw // seg
    q0 = np.arange(0, nq, qt)
    chunks = -(-entries // chunk)
    hits = np.zeros((nq, entries), np.int64)
    for warp in range(warps):
        for o0 in range(warp * per_warp, qt, warps * per_warp):
            for g in range(rpw):
                og, sg = divmod(g, seg)
                q = q0 + o0 + og
                q = q[(q0 + o0 < nq) & (o0 + og < qt) & (q < nq)]
                for c0 in range(0, chunks, seg):
                    steps = min(chunk, entries - c0 * chunk)
                    e = (c0 + sg) * chunk + np.arange(steps)
                    e = e[e < entries]
                    np.add.at(hits, (q[:, None], e[None, :]), 1)
    return hits, len(q0)


@pytest.mark.parametrize("esz", [4, 2, 1])
@pytest.mark.parametrize("B,nq,taps", [
    (48, 14080, 32), (48, 896, 8),  # the base and tiny cross-attention shapes
    (3, 77, 1), (3, 77, 3), (4, 1, 8), (1, 500, 32), (2, 1000, 5), (1, 100, 64)])
def test_gather_blend_geometry_covers_every_entry_once(B, nq, taps, esz):
    """The blend's launch geometry: every (table, query) and each of its
    entries is reached exactly once by the kernel's loops, the grid and the
    block fit the card, no shared memory (under Hopper's 227 KB), and the
    values the kernel checks (a power-of-two seg of at most the rows a warp
    instruction reads, a tile of whole warp rounds)."""
    entries = 4 * taps
    geo = gather_probe.gather_blend_geometry(B, nq, entries, esz)
    assert geo["lanes_per_row"] * 16 == 32 * esz and geo["rows_per_warp"] * geo["lanes_per_row"] == 32
    hits, tiles = blend_hits(nq, entries, geo)
    assert (hits == 1).all()
    assert geo["blocks"] == B * tiles < 2 ** 31 and geo["threads"] == 256
    assert geo["smem"] == 0 <= 232448
    seg, rpw = geo["seg"], geo["rows_per_warp"]
    assert seg & (seg - 1) == 0 and seg <= rpw and geo["qt"] % (rpw // seg) == 0
    if B * nq >= 132 * 32 * rpw:  # outputs enough to fill the card: one group an output
        assert seg == 1
    with pytest.raises(ValueError, match="entries"):
        gather_probe.gather_blend_geometry(B, nq, entries + 2, esz)


def test_bounds_count_bytes_once_and_name_what_binds():
    assert kc.bound(3.35e9, 0, torch.float32) == (pytest.approx(1.0), "bytes")
    assert kc.bound(0, 67e9, torch.float32) == (pytest.approx(1.0), "operations")
    nbytes, flops, col = kc.dcn_work(kc.DCN_SHAPES["base_s3"], 4)
    assert col == 6 * 9 * 256 * 5800 * 4 and flops == 8 * col // 4
    assert nbytes == col + (6 * 256 * 5800 + 6 * 27 * 5800) * 4
    int8_bytes, _, _ = kc.dcn_work(kc.DCN_SHAPES["base_s3"], 4, 1, 6 * 4 * 4)
    assert nbytes - int8_bytes == 6 * 256 * 5800 * 3 - 96  # the map at one byte a value
    table = torch.zeros(2, 10, 32)
    idx = torch.zeros(2, 100, dtype=torch.int32)
    assert kc.gather_rows_work(table, idx)[0] == 2 * 10 * 128 + 200 * (4 + 128)  # table < rows read
    assert kc.gather_blend_work(table, idx.reshape(2, 5, 5, 4))[0] == 2560 + 200 * 8 + 2 * 5 * 128


def test_kernel_bench_tool_rehearses_on_the_cpu(tmp_path, capsys, monkeypatch):
    """`--device cpu`: toy shapes, plain versions (no launch, nothing built),
    one JSON object per line after the device line, host times under their
    own key and no bound."""
    from bevformer_tensorrt_tpu_torch.ops import _cuda

    out = tmp_path / "bench.json"
    ops.reset_launch_counts()
    assert kernel_bench.main(["--device", "cpu", "--out", str(out)]) == 0
    assert [fn.launches for fn in ops.KERNEL_WRAPPERS] == [0] * 12 and not _cuda._libs
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("cpu")
    rows = [json.loads(line) for line in lines[1:]]
    assert rows == json.loads(out.read_text())["rows"]
    assert {r["part"] for r in rows} == {"probes", "production", "split"}
    assert {r["kernel"] for r in rows} == {
        "gather_rows", "gather_blend", "msda", "msda_int8", "flash_attn", "flash_int8",
        "dcn_im2col", "dcn_im2col_int8", "dcn_op", "dcn_op_int8", "int8_gemm"}
    for r in rows:
        assert r["device"] == "cpu" and r["cpu_ms"] > 0
        assert "ms" not in r and "bound_ms" not in r and "library_ms" not in r
    probes = [r for r in rows if r["part"] == "probes"]
    assert sorted({r["span"] for r in probes}) == [1, 2]
    assert {r["dtype"] for r in probes} == {"float32", "bfloat16", "int8"}
    for r in probes:  # the library's call beside each probe, where there is one
        none = r["kernel"] == "gather_blend" and r["dtype"] == "int8"
        assert (r["library_cpu_ms"] is None) if none else r["library_cpu_ms"] > 0
    split, = [r for r in rows if r["part"] == "split"]
    assert 0 < split["gather_blend_share_of_kernel"] and split["gather_rows_cpu_ms"] > 0
    assert split["gather_blend_library_cpu_ms"] > 0
    gemm, = [r for r in rows if r["kernel"] == "int8_gemm"]  # per shape: its tile configuration
    M, K, N = kc.TOY_SHAPES["gemm"]["toy"]
    assert (gemm["M"], gemm["K"], gemm["N"], gemm["config"]) == (M, K, N, "64x64")
    assert not {"tops", "bound_fraction"} & set(gemm)  # device rates come from a card only
    only = kernel_bench.main(["--device", "cpu", "--parts", "split"])
    assert only == 0 and len(capsys.readouterr().out.strip().splitlines()) == 2
    with pytest.raises(SystemExit, match="nvcc"):
        kernel_bench.main(["--device", "cpu", "--build-report"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):  # no card: raise, do not run on the CPU
        kernel_bench.main([])


def test_kernel_bench_dcn_split_rehearses_on_the_cpu(capsys):
    """`--parts dcn_split` on the CPU: one row per operand kind at the toy
    shape, the op's plain version under its host time, nothing built."""
    from bevformer_tensorrt_tpu_torch.ops import _cuda

    ops.reset_launch_counts()
    assert kernel_bench.main(["--device", "cpu", "--parts", "dcn_split"]) == 0
    assert [fn.launches for fn in ops.KERNEL_WRAPPERS] == [0] * 12 and not _cuda._libs
    lines = capsys.readouterr().out.strip().splitlines()
    rows = [json.loads(line) for line in lines[1:]]
    assert [(r["part"], r["kernel"], r["kind"]) for r in rows] == [
        ("dcn_split", "dcn_op", kind) for kind in kernel_bench.DCN_KINDS]
    assert all(r["cpu_ms"] > 0 and "ms" not in r for r in rows)
    assert {r["dtype"] for r in rows} == {"bfloat16", "float32"}


def test_kernel_bench_dispatch_layers_compute_one_function(monkeypatch):
    """`--parts dispatch`: each registered operator and the model's wrapper
    around it give the same output on the CPU (the launch functions are
    CUDA's), every frame's calls name a timed case, and the part refuses
    to run without a card."""
    monkeypatch.setattr(kc, "DCN_SHAPES", dict(kc.DCN_SHAPES, base_s3=(1, 64, 6, 7, 32, 1, 1,
                                                                          0, 0, 1)))
    bench = kernel_bench.Bench(torch.device("cpu"), [])
    with torch.inference_mode():
        cases = kernel_bench.dispatch_cases(bench)
        for name, (shape, launch, op, wrapper) in cases.items():
            assert torch.equal(op(), wrapper()), name
    assert {k for calls in kernel_bench.DISPATCH_FRAMES.values() for k in calls} <= set(cases)
    assert sum(kernel_bench.DISPATCH_FRAMES["tiny int8"].values()) == 220
    with pytest.raises(SystemExit, match="CUDA"):
        kernel_bench.main(["--device", "cpu", "--parts", "dispatch"])
