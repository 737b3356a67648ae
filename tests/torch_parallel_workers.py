"""The ranks of the parallel layer's CPU tests (tests/test_torch_parallel*.py).

`run_world(scenarios, n, workdir)` starts one process of this file, which
imports torch and the port once and forks the n ranks (a rank's own start
would import them again); the ranks meet on one free port (bound at port 0,
so parallel test workers do not collide), each joins a gloo world through
`parallel.init_distributed` with torchrun's variables, runs the named
scenarios in order and pickles what each returned to
`<workdir>/<scenario>_<rank>.pkl`.  Where a rank fails the others are
killed.  The scenarios import torch and the port only: the tests compute the
JAX package's side in their own process and hand it over as pickled numpy
in `workdir`.  Where a scenario compares with one process, rank 0 computes
the one-process side and holds the world's result against it.
"""
import os
import pickle
import socket
import subprocess
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(scenarios, n: int, workdir, timeout: float = 300.0) -> dict:
    """{scenario: [rank 0's result, rank 1's, ...]} of one spawned world."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), str(REPO / "tests")]),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, __file__, str(workdir), str(n), str(free_port()),
                             *scenarios], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        out = proc.communicate(timeout=timeout)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
    if proc.returncode != 0:
        raise RuntimeError(f"the world exited {proc.returncode}:\n{out[-4000:]}")
    return {s: [pickle.loads((Path(workdir) / f"{s}_{r}.pkl").read_bytes()) for r in range(n)]
            for s in scenarios}


def _load(workdir, name):
    return pickle.loads((Path(workdir) / name).read_bytes())


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def max_err(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())


# --- scenarios: (workdir) -> picklable result -------------------------------------


def tp_chain(workdir):
    """Column-parallel fc1 -> row-parallel fc2 with the batch on dp, against
    the unsharded product (tests/test_parallel.py's chain)."""
    import torch.nn as nn
    import torch.nn.functional as F

    from bevformer_tensorrt_tpu_torch.models.layers import QDense
    from bevformer_tensorrt_tpu_torch.parallel import comm, make_mesh, shard_parameters
    from bevformer_tensorrt_tpu_torch.parallel.mesh import batch_sharding

    class Chain(nn.Module):
        TP_LAYERS = ("fc1", "fc2")

        def __init__(self):
            super().__init__()
            self.fc1, self.fc2 = QDense(64, 128, bias=False), QDense(128, 64, bias=False)

        def forward(self, x):
            return self.fc2(F.relu(self.fc1(x)))

    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 64)).astype(np.float32)
    w1 = rng.standard_normal((64, 128)).astype(np.float32)
    w2 = rng.standard_normal((128, 64)).astype(np.float32)
    mesh = make_mesh(dp=2, tp=4)
    m = nn.Module()
    m.ffn = Chain()  # the rules match FFN layers by their path
    m.load_state_dict({"ffn.fc1.weight": torch.from_numpy(w1.T.copy()),
                       "ffn.fc2.weight": torch.from_numpy(w2.T.copy())})
    specs = shard_parameters(m, mesh)
    with torch.no_grad():
        out = comm.all_gather(m.ffn(torch.from_numpy(x)[batch_sharding(mesh, 16)]), mesh, "dp", 0)
    want = np.maximum(x.astype(np.float64) @ w1, 0) @ w2
    return {"err": float(np.abs(out.numpy() - want).max() / np.abs(want).max()),
            "shapes": (tuple(m.ffn.fc1.weight.shape), tuple(m.ffn.fc2.weight.shape)),
            "specs": specs, "coords": mesh.coords}


def _port_model(cfg, variables):
    from bevformer_tensorrt_tpu_torch.models.detectors.bevformer import BEVFormer
    from bevformer_tensorrt_tpu_torch.weights import params_from_jax

    model = BEVFormer(cfg)
    model.load_state_dict(params_from_jax(variables), strict=True)
    return model.eval()


def sp_micro(workdir):
    """Sequence-parallel inference (dp2 x tp4) of the micro model against the
    JAX package's meshless forward, and at a 16 x 16 grid with the camera
    compaction against the port's own meshless forward, on a first frame and
    a temporal one."""
    from bevformer_tensorrt_tpu_torch.configs.bevformer import bevformer_micro
    from bevformer_tensorrt_tpu_torch.parallel import make_mesh
    from bevformer_tensorrt_tpu_torch.parallel.ops import set_mesh

    from bevformer_tensorrt_tpu_torch.parallel.ops import maybe_shard, sequence_rows

    case = _load(workdir, "sp_case.pkl")
    mesh = make_mesh(dp=2, tp=4)
    out = {}
    x = torch.arange(64.0).reshape(1, 64, 1).expand(1, 64, 3)
    with set_mesh(mesh):  # the hooks: this rank's rows, or the tensor whole
        out["hooks"] = (tuple(maybe_shard(x, None, "tp", None)[0, :, 0].tolist()),
                        tuple(maybe_shard(x[:, :6], None, "tp", None).shape),
                        tuple(maybe_shard(x, None, "pp", None).shape),
                        sequence_rows(64), sequence_rows(66))
    out["hooks_no_mesh"] = (tuple(maybe_shard(x, None, "tp", None).shape), sequence_rows(64))
    model = _port_model(bevformer_micro(**case["over"]), case["variables"])
    args = [torch.from_numpy(np.asarray(a)) for a in case["args"]]
    with torch.no_grad(), set_mesh(mesh):
        got = model(*args)
    for name, g, w in zip(("bev_embed", "classes", "coords"), got, case["want"]):
        out[name] = max_err(g.numpy(), w)
    big = case["compaction"]
    model = _port_model(bevformer_micro(**big["over"]), big["variables"])
    for k, frame in enumerate(big["frames"]):
        a = [torch.from_numpy(np.asarray(v)) for v in frame]
        with torch.no_grad():
            with set_mesh(mesh):
                got = model(*a)
            if mesh.rank == 0:  # every rank holds the gathered outputs
                for name, g, w in zip(("bev_embed", "classes", "coords"), got, model(*a)):
                    out[f"compaction_frame{k}_{name}"] = max_err(g, w)
    return out


def _stages(S, C, rng, bias=True):
    out = []
    for _ in range(S):
        st = {"w": torch.from_numpy((rng.standard_normal((C, C)) * 0.3).astype(np.float32))}
        if bias:
            st["b"] = torch.from_numpy((rng.standard_normal(C) * 0.1).astype(np.float32))
        out.append(st)
    return out


def pipeline(workdir):
    """`pipeline_apply` against sequential application (S 4 of M 6; the
    LN + FFN blocks of S 4, M 4) and its gradients (S 2, M 3), the JAX
    tests' shapes; the stacked form's and the consts' errors."""
    from bevformer_tensorrt_tpu_torch.parallel import (make_mesh, pipeline_apply,
                                                       stack_stage_params)

    out = {}
    mesh = make_mesh(dp=2, tp=1, pp=4)
    rng = np.random.default_rng(0)
    S, M, B, C = 4, 6, 2, 16
    stages = _stages(S, C, rng)
    x = torch.from_numpy(rng.standard_normal((M, B, C)).astype(np.float32))

    def fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    with torch.no_grad():
        got = pipeline_apply(fn, stack_stage_params(stages), x, mesh)
        want = x
        for p in stages:
            want = fn(p, want)
    out["forward"] = max_err(got, want)

    def block(p, h):
        y = torch.relu(h @ p["w1"]) @ p["w2"] + h
        mu = y.mean(-1, keepdim=True)
        var = ((y - mu) ** 2).mean(-1, keepdim=True)
        return (y - mu) / torch.sqrt(var + 1e-5)

    nq, C2 = 64, 32
    blocks = [{"w1": torch.from_numpy((rng.standard_normal((C2, 2 * C2)) * 0.2).astype(np.float32)),
               "w2": torch.from_numpy((rng.standard_normal((2 * C2, C2)) * 0.2).astype(np.float32))}
              for _ in range(4)]
    xb = torch.from_numpy(rng.standard_normal((4, nq, C2)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((4, nq, C2)).astype(np.float32))
    with torch.no_grad():
        got = pipeline_apply(lambda p, h, k: block(p, h + k), blocks[mesh.axis_index("pp")], xb,
                             mesh, consts=c)
        want = xb
        for p in blocks:
            want = block(p, want + c)
    out["blocks_consts"] = max_err(got, want)

    mesh2 = make_mesh(dp=4, tp=1, pp=2)
    S, M, C = 2, 3, 8
    stages = _stages(S, C, rng, bias=False)
    x = torch.from_numpy(rng.standard_normal((M, 2, C)).astype(np.float32))
    mine = {"w": stages[mesh2.axis_index("pp")]["w"].clone().requires_grad_(True)}
    (pipeline_apply(lambda p, h: torch.tanh(h @ p["w"]), mine, x, mesh2) ** 2).sum().backward()
    seq = [{"w": s["w"].clone().requires_grad_(True)} for s in stages]
    h = x
    for p in seq:
        h = torch.tanh(h @ p["w"])
    (h ** 2).sum().backward()
    out["grad"] = max_err(mine["w"].grad, seq[mesh2.axis_index("pp")]["w"].grad)
    # the input's gradient on every rank, through the consts too
    xg = x.clone().requires_grad_(True)
    cg = torch.zeros_like(x).requires_grad_(True)
    (pipeline_apply(lambda p, h, k: torch.tanh((h + k) @ p["w"]),
                    {"w": stages[mesh2.axis_index("pp")]["w"]}, xg, mesh2, consts=cg) ** 2
     ).sum().backward()
    xs, cs = x.clone().requires_grad_(True), torch.zeros_like(x).requires_grad_(True)
    h = xs
    for p in stages:
        h = torch.tanh((h + cs) @ p["w"])
    (h ** 2).sum().backward()
    out["grad_x"] = max_err(xg.grad, xs.grad)
    out["grad_consts"] = max_err(cg.grad, cs.grad)
    errors = []
    for bad in (lambda: pipeline_apply(fn, stack_stage_params(stages[:1] * 3), x, mesh2),
                lambda: pipeline_apply(lambda p, h, k: h, stages[0], x, mesh2, consts=x[:2])):
        try:
            bad()
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    return out


def pp_encoder(workdir):
    """`encoder_pp_forward` on dp2 x tp2 x pp2 against the JAX sequential
    encoder at use_prev_bev 1."""
    from bevformer_tensorrt_tpu_torch.configs.bevformer import bevformer_micro
    from bevformer_tensorrt_tpu_torch.models.modules.encoder import BEVFormerEncoder
    from bevformer_tensorrt_tpu_torch.parallel import make_mesh
    from bevformer_tensorrt_tpu_torch.parallel.pp_encoder import encoder_pp_forward, stage_layers
    from bevformer_tensorrt_tpu_torch.weights import params_from_jax

    case = _load(workdir, "pp_encoder_case.pkl")
    cfg = bevformer_micro(**case["over"])
    enc = BEVFormerEncoder(cfg)
    enc.load_state_dict(params_from_jax(case["variables"]), strict=True)
    mesh = make_mesh(dp=2, tp=2, pp=2)
    a = {k: torch.from_numpy(np.asarray(v)) for k, v in case["args"].items()}
    with torch.no_grad():
        got = encoder_pp_forward(cfg, stage_layers(enc, mesh), a["bev_query"], a["value"],
                                 a["bev_pos"], a["lidar2img"], a["prev_bev"], a["shift"],
                                 case["spatial_shapes"], mesh, microbatches=4)
    return {"err": max_err(got, case["want"]), "shape": tuple(got.shape)}


def pp_decoder(workdir):
    """`decoder_pp_forward` on dp2 x tp2 x pp2 against the JAX sequential
    decoder with its reg branches, frame by frame."""
    from bevformer_tensorrt_tpu_torch.configs.bevformer import bevformer_micro
    from bevformer_tensorrt_tpu_torch.models.heads.bevformer_head import RegBranch
    from bevformer_tensorrt_tpu_torch.models.modules.decoder import DetectionTransformerDecoder
    from bevformer_tensorrt_tpu_torch.parallel import make_mesh
    from bevformer_tensorrt_tpu_torch.parallel.pp_decoder import decoder_pp_forward
    from bevformer_tensorrt_tpu_torch.weights import params_from_jax

    case = _load(workdir, "pp_decoder_case.pkl")
    cfg = bevformer_micro(**case["over"])
    dec = DetectionTransformerDecoder(cfg)
    dec.load_state_dict(params_from_jax(case["variables"]), strict=True)
    regs = []
    for i in range(cfg.decoder_layers):
        r = RegBranch(cfg)
        r.load_state_dict(params_from_jax({"params": case["reg_params"][f"reg_branch{i}"]}),
                          strict=True)
        regs.append(r)
    mesh = make_mesh(dp=2, tp=2, pp=2)
    per = cfg.decoder_layers // mesh.axis_size("pp")
    s = mesh.axis_index("pp")
    mine = range(s * per, (s + 1) * per)
    a = {k: torch.from_numpy(np.asarray(v)) for k, v in case["args"].items()}
    with torch.no_grad():
        states, refs = decoder_pp_forward(
            cfg, [getattr(dec, f"layer{i}") for i in mine], [regs[i] for i in mine],
            a["query"], a["query_pos"], a["values"], a["ref"], mesh)
    return {"states": max_err(states, case["want_states"]),
            "refs": max_err(refs, case["want_refs"]), "shape": tuple(states.shape)}


def _train_batch(cfg, rng, B=2, G=6, valid=4):
    from bevformer_tensorrt_tpu_torch.runtime.synthetic import camera_rig

    boxes = np.zeros((B, G, 9), np.float32)
    boxes[:, :valid, :2] = rng.uniform(-40, 40, (B, valid, 2))
    boxes[:, :valid, 2] = rng.uniform(-3, 1, (B, valid))
    boxes[:, :valid, 3:6] = rng.uniform(0.5, 4, (B, valid, 3))
    boxes[:, :valid, 6] = rng.uniform(-np.pi, np.pi, (B, valid))
    labels = np.full((B, G), -1, np.int64)
    labels[:, :valid] = rng.integers(0, cfg.num_classes, (B, valid))
    labels[1, valid - 1] = -1  # the two samples' positive counts differ
    rig = camera_rig(cfg.num_cams, cfg.img_h, cfg.img_w, rng)
    return {"image": rng.standard_normal((B, cfg.num_cams, 3, cfg.img_h, cfg.img_w)).astype(
                np.float32),
            "can_bus": (rng.standard_normal((B, cfg.can_bus_dims)) * 0.5).astype(np.float32),
            "lidar2img": np.stack([rig] * B), "gt_boxes": boxes, "gt_labels": labels}


# A key projection's bias adds q.b to every logit of a query, which the
# softmax ignores: its gradient is 0, and both runs give float noise
# (tests/test_torch_train_step.py holds it the same way).
ZERO_GRADIENT = ("self_attn.k_proj.bias",)


def train_step_tp(workdir):
    """The dp2 x tp2 micro train step (the JAX dryrun) against the
    one-process step on the global batch of 2: loss and num_pos, and every
    gradient after the global-norm clip (a clip of 1.0, so the norm over
    the shards decides it), each rank's shard against the same slice of the
    one-process gradient.  Then the QDQ tier's forward (weights fake-quantized
    per output channel) under tp against one process."""
    from bevformer_tensorrt_tpu_torch.configs.bevformer import bevformer_micro
    from bevformer_tensorrt_tpu_torch.models.detectors.bevformer import BEVFormer
    from bevformer_tensorrt_tpu_torch.parallel import comm, make_mesh, shard_parameters
    from bevformer_tensorrt_tpu_torch.parallel.mesh import batch_sharding
    from bevformer_tensorrt_tpu_torch.train import Optimizer, train_step
    from bevformer_tensorrt_tpu_torch.weights import init_weights

    cfg = bevformer_micro()
    batch = {k: torch.from_numpy(v) for k, v in _train_batch(cfg, np.random.default_rng(5)).items()}
    kw = dict(learning_rate=1e-3, total_steps=None, grad_clip=1.0)

    def fresh():
        return init_weights(BEVFormer(cfg), torch.Generator().manual_seed(0)).train()

    mesh = make_mesh(dp=2, tp=2)
    model = fresh()
    specs = shard_parameters(model, mesh)
    opt = Optimizer(model, mesh=mesh, specs=specs, **kw)
    mine = {k: v[batch_sharding(mesh, 2)] for k, v in batch.items()}
    got = train_step(model, opt, mine, mesh)
    # every gradient whole (the shards all-gathered over tp), held on rank 0
    grads = {}
    for name, p in model.named_parameters():
        g = p.grad
        if any(specs[name]):
            g = comm.all_gather(g.contiguous(), mesh, "tp", specs[name].index("tp"))
        grads[name] = g
    out = {"n_sharded": sum(bool(any(s)) for s in specs.values()), "loss_here": float(got["loss"])}
    if mesh.rank == 0:
        ref = fresh()
        want = train_step(ref, Optimizer(ref, **kw), batch)
        ref_grads = {n: p.grad for n, p in ref.named_parameters()}
        top = max(float(g.abs().max()) for g in ref_grads.values())
        grad_err, zero = {}, {}
        for name, g in grads.items():
            w = ref_grads[name]
            if name.endswith(ZERO_GRADIENT):  # float noise on both sides
                zero[name] = max(float(g.abs().max()), float(w.abs().max())) / top
            else:
                grad_err[name] = rel_l2(g, w)
        out.update(loss=abs(float(got["loss"]) - float(want["loss"])),
                   num_pos=(float(got["num_pos"]), float(want["num_pos"])),
                   grad_rel_l2=grad_err, zero_grad=zero,
                   params_moved=rel_l2(model.pts_bbox_head.cls_branch0.out.bias.detach(),
                                       ref.pts_bbox_head.cls_branch0.out.bias.detach()))

    qcfg = bevformer_micro(quant=True, encoder_layers=1, decoder_layers=1)
    rng = np.random.default_rng(6)
    img = torch.from_numpy(rng.standard_normal((1, qcfg.num_cams, 3, qcfg.img_h, qcfg.img_w))
                           .astype(np.float32))
    args = (img, torch.zeros(qcfg.bev_h * qcfg.bev_w, 1, qcfg.embed_dims), 0.0,
            torch.zeros(qcfg.can_bus_dims), batch["lidar2img"][0])
    q_tp = init_weights(BEVFormer(qcfg), torch.Generator().manual_seed(1)).eval()
    shard_parameters(q_tp, mesh)
    with torch.no_grad():
        g = q_tp(*args)
        if mesh.rank == 0:
            w = init_weights(BEVFormer(qcfg), torch.Generator().manual_seed(1)).eval()(*args)
            out["qdq"] = {name: max_err(a, b)
                          for name, a, b in zip(("bev", "classes", "coords"), g, w)}
    return out


def serving_dp(workdir):
    """The serving engine's lanes split over dp (dp2 x tp2: the tp ranks of
    a dp group run the same lanes) against the one-process engine: every
    step's results and the pools, on 3 scenes x 2 frames at batch 4 over 4
    slots."""
    from bevformer_tensorrt_tpu_torch.configs.bevformer import bevformer_micro
    from bevformer_tensorrt_tpu_torch.parallel import make_mesh
    from bevformer_tensorrt_tpu_torch.runtime.serving import (ContinuousBatchingEngine,
                                                              FrameRequest)
    from bevformer_tensorrt_tpu_torch.runtime.synthetic import camera_rig

    cfg = bevformer_micro(encoder_layers=1, decoder_layers=1)
    rng = np.random.default_rng(11)
    rig = camera_rig(cfg.num_cams, cfg.img_h, cfg.img_w, rng)
    reqs = []
    for t in range(2):
        for s in range(3):
            cb = rng.standard_normal(cfg.can_bus_dims).astype(np.float32)
            reqs.append(dict(scene_id=s, scene_token=f"scene{s}", tag=(s, t), can_bus=cb,
                             lidar2img=rig, image=rng.standard_normal(
                                 (1, cfg.num_cams, 3, cfg.img_h, cfg.img_w)).astype(np.float32)))
    mesh = make_mesh(dp=2, tp=2)
    engines = [ContinuousBatchingEngine(cfg, device="cpu", max_scenes=4, batch=4, mesh=m)
               for m in ((mesh, None) if mesh.rank == 0 else (mesh,))]
    steps = []
    for e in engines:
        for r in reqs:
            e.submit(FrameRequest(**r))
        got = []
        while any(e.queues.values()):
            got.append(e.step())
        steps.append(got)
    out = {"steps": [len(s) for s in steps], "lanes": (engines[0].lanes.start, engines[0].lanes.stop)}
    if mesh.rank == 0:
        errs = []
        for a, b in zip(*steps):
            assert [t for t, _, _ in a] == [t for t, _, _ in b]
            errs += [max_err(x[k], y[k]) for x, y in zip(a, b) for k in (1, 2)]
        out.update(max_err=max(errs), pool=max_err(engines[0].pool, engines[1].pool))
    return out


def rank_main(workdir, rank, world, port, scenarios):
    import torch.distributed as dist

    from bevformer_tensorrt_tpu_torch.parallel import init_distributed

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    init_distributed("cpu")
    for name in scenarios:
        res = globals()[name](workdir)
        (Path(workdir) / f"{name}_{rank}.pkl").write_bytes(pickle.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


def launch(workdir, world, port, scenarios):
    """Import what the ranks share, fork them, and wait: exit 0 when all
    do, else kill the rest (their collectives would wait on the lost peer)."""
    import bevformer_tensorrt_tpu_torch.models.detectors.bevformer  # noqa: F401
    import bevformer_tensorrt_tpu_torch.parallel.pp_decoder  # noqa: F401
    import bevformer_tensorrt_tpu_torch.parallel.pp_encoder  # noqa: F401
    import bevformer_tensorrt_tpu_torch.runtime.serving  # noqa: F401
    import bevformer_tensorrt_tpu_torch.train  # noqa: F401

    torch.set_num_threads(1)
    pids = []
    for rank in range(world):
        pid = os.fork()
        if pid == 0:
            code = 0
            try:
                rank_main(workdir, rank, world, port, scenarios)
            except BaseException:
                traceback.print_exc()
                code = 1
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(code)
        pids.append(pid)
    failed = False
    while pids:
        pid, status = os.wait()
        pids.remove(pid)
        if status != 0 and not failed:
            failed = True
            for other in pids:
                os.kill(other, 9)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    workdir, world, port, *scenarios = sys.argv[1:]
    launch(workdir, int(world), int(port), scenarios)
