"""Training on the card: every kernel op's gradient through its autograd
Function against the plain version's own autograd, and one tiny step on the
kernel path whose backward reaches every parameter feeding an MSDA or a
flash launch.

Marked `cuda`: each test skips without a CUDA device.  On a machine with a
card (which need not have JAX) run them with

    python -m pytest tests/test_torch_train_cuda.py -m cuda --noconftest -q

The Function's backward recomputes the plain version from the saved inputs,
so the gradients differ from the plain version's own only by the order of
the atomic adds in its gather's backward: 1e-5 relative in float32, one
bfloat16 rounding (1e-2) for the fused DCN kernel's bfloat16 inputs.
"""
import numpy as np
import pytest
import torch

from bevformer_tensorrt_tpu_torch import ops
from bevformer_tensorrt_tpu_torch.configs.bevformer import bevformer_tiny
from bevformer_tensorrt_tpu_torch.runtime.synthetic import camera_rig
from bevformer_tensorrt_tpu_torch.tools import kernel_cases as kc
from bevformer_tensorrt_tpu_torch.train import init_train_state, loss_fn

pytestmark = pytest.mark.cuda

# small rows with the columns of the kernel_cases tables
SMALL = {
    "msda": (2, ((15, 25),), 300, 8, 4),
    "flash": (8, 200, 200, 32),
    "dcn": (2, 64, 23, 31, 64, 1, 1, 0, 0, 1),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("op", sorted(kc.GRAD_OPS))
def test_op_gradient_is_the_plain_vjp(op, cuda):
    wrapper, table = kc.GRAD_OPS[op]
    gen = torch.Generator().manual_seed(0)
    kernel, plain, inputs, dtype = kc.grad_case(op, SMALL[table], gen, cuda)
    ops.reset_launch_counts()
    out, errs = kc.grad_check(kernel, plain, inputs, gen)
    torch.cuda.synchronize()
    launched = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}[wrapper]
    assert launched >= 1, f"{op}: {wrapper} was not launched"
    assert out.dtype == dtype
    assert max(errs) <= kc.GRAD_TOL[dtype], (op, errs)


def test_tiny_step_reaches_every_kernel_input(cuda):
    """One tiny step at full width on the kernel path: 12 MSDA and 6 flash
    launches, finite loss, and a non-zero gradient on every projection that
    feeds a launch, and on the backbone through the value of the spatial
    cross-attention."""
    cfg = bevformer_tiny()
    rng = np.random.default_rng(0)
    model, opt = init_train_state(cfg, cuda, learning_rate=2e-4, total_steps=10, warmup_steps=2)
    gt = np.zeros((1, 8, 9), np.float32)
    gt[0, :, :2] = rng.uniform(-40, 40, (8, 2))
    gt[0, :, 3:6] = 2.0
    batch = {
        "image": torch.randn(1, cfg.num_cams, 3, cfg.img_h, cfg.img_w, device=cuda),
        "can_bus": torch.zeros(1, 18, device=cuda),
        "lidar2img": torch.from_numpy(camera_rig(cfg.num_cams, cfg.img_h, cfg.img_w, rng))[None]
        .to(cuda),
        "gt_boxes": torch.from_numpy(gt).to(cuda),
        "gt_labels": torch.tensor([[0, 1, 2, 3, 4, -1, -1, -1]], device=cuda),
    }
    ops.reset_launch_counts()
    opt.zero_grad()
    loss, _ = loss_fn(model, batch)
    loss.backward()
    torch.cuda.synchronize()
    assert ops.multi_scale_deformable_attn.launches == 12
    assert ops.flash_attention.launches == 6
    assert torch.isfinite(loss)
    fed = ("value_proj.weight", "sampling_offsets.weight", "attention_weights.weight",
           "q_proj.weight", "k_proj.weight", "v_proj.weight")
    names = [n for n, _ in model.named_parameters() if n.endswith(fed)]
    assert len(names) == 3 * (3 + 3) + 6 * (3 + 3)  # TSA + SCA x 3 layers, decoder x 6
    params = dict(model.named_parameters())
    for n in names + ["img_backbone.stem_conv.weight", "img_neck.lateral0.weight"]:
        g = params[n].grad
        assert g is not None and torch.isfinite(g).all() and g.abs().max() > 0, n
    opt.step()
