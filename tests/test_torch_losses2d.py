"""The port's 2D training criteria against the JAX package's on the CPU
(`train/losses2d.py`): YOLOX's SimOTA assignment and losses and CenterNet's
targets and losses on seeded head maps (three levels at 64 px, 8 classes,
8 GT rows with padding), each term within 1e-5 relative and each term's
gradient with respect to the maps within 1e-5 of its largest magnitude.

The JAX function returns only the loss terms; its assignment is read off
its own calls, run eagerly: the argument of `jnp.argmin` is SimOTA's
`best_gt`, and the target of the second `_bce_logits` call its foreground
mask."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevformer_tensorrt_tpu.train import losses2d as jax_losses
from bevformer_tensorrt_tpu_torch.train import losses2d

torch.set_num_threads(2)

C = 8
SIZE = 64
STRIDES = (8, 16, 32)
YOLOX_TERMS = ("loss_cls", "loss_obj", "loss_bbox", "loss")
CENTERNET_TERMS = ("loss_heatmap", "loss_wh", "loss_offset", "loss")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _yolox_maps(rng, n=2):
    """Per level {cls, reg, obj} NHWC for `n` images: box centres near their
    priors, sizes around e x stride."""
    outs = []
    for s in STRIDES:
        h = w = SIZE // s
        reg = np.concatenate([rng.normal(0.5, 0.3, (n, h, w, 2)),
                              rng.normal(1.0, 0.6, (n, h, w, 2))], -1)
        outs.append({"cls": rng.standard_normal((n, h, w, C)).astype(np.float32),
                     "reg": reg.astype(np.float32),
                     "obj": rng.standard_normal((n, h, w, 1)).astype(np.float32)})
    return outs


def _gt(rng, plateau: bool):
    """8 GT rows: random boxes, two identical rows (the same box and label),
    the same box under another label, padding rows holding junk; with
    `plateau`, a 2-px box between every level's prior centres, so that none
    of its candidates is strong and each costs 1e8 plus less than float32's
    step there."""
    boxes = np.zeros((8, 4), np.float32)
    xy = rng.uniform(0, 40, (8, 2))
    wh = rng.uniform(6, 30, (8, 2))
    boxes[:] = np.concatenate([xy, np.minimum(xy + wh, SIZE)], -1)
    labels = rng.integers(0, C, 8).astype(np.int32)
    boxes[1], labels[1] = boxes[0], labels[0]
    boxes[2], labels[2] = boxes[0], (labels[0] + 1) % C
    if plateau:
        boxes[3], labels[3] = (13, 13, 15, 15), 5
    boxes[6:] = rng.normal(0, 50, (2, 4))
    labels[6:] = -1
    return boxes, labels


def _jax_yolox(outs, boxes, labels, img_idx, monkeypatch):
    """(terms, fg, best_gt, gradients {term: per-level {cls, reg, obj}})."""
    def term(maps, k):
        return jax_losses.yolox_loss_single(maps, jnp.asarray(boxes), jnp.asarray(labels), C,
                                            img_idx=img_idx)[k]

    grads = jax.jit(lambda m: {k: jax.grad(term)(m, k) for k in YOLOX_TERMS})(outs)
    seen = {"argmin": [], "bce": []}
    bce = jax_losses._bce_logits

    def recording_bce(logits, targets):
        seen["bce"].append(np.asarray(targets))
        return bce(logits, targets)

    class Jnp:
        def __getattr__(self, name):
            return getattr(jnp, name)

        def argmin(self, *a, **k):
            out = jnp.argmin(*a, **k)
            seen["argmin"].append(np.asarray(out))
            return out

    with monkeypatch.context() as m:
        m.setattr(jax_losses, "_bce_logits", recording_bce)
        m.setattr(jax_losses, "jnp", Jnp())
        terms = jax_losses.yolox_loss_single(outs, jnp.asarray(boxes), jnp.asarray(labels), C,
                                             img_idx=img_idx)
    assert len(seen["argmin"]) == 1 and len(seen["bce"]) == 2
    return terms, seen["bce"][1] > 0.5, seen["argmin"][0], grads


def _port_yolox(outs, boxes, labels, img_idx):
    maps = [{k: torch.from_numpy(v).requires_grad_() for k, v in o.items()} for o in outs]
    terms = losses2d.yolox_loss_single(maps, torch.from_numpy(boxes), torch.from_numpy(labels),
                                       C, img_idx=img_idx)
    flat = [t for o in maps for t in o.values()]
    grads = {}
    for k in YOLOX_TERMS:
        g = torch.autograd.grad(terms[k], flat, retain_graph=True, allow_unused=True)
        it = iter(g)
        grads[k] = [{kk: next(it) for kk in o} for o in maps]
    return terms, grads


@pytest.mark.parametrize("plateau", [False, True])
def test_yolox_loss_and_assignment_match_jax(plateau, monkeypatch):
    """Both images of a seeded batch: SimOTA's foreground mask and best_gt
    identical to the JAX package's (on the 1e8 plateau too: a GT none of
    whose candidates is strong, two identical GT), each term within 1e-5
    relative, each gradient within 1e-5 of its largest magnitude.  The
    gradient of loss_cls with respect to the box regression exists only
    through the matched IoU in the soft class target: it must be there and
    match (a detached target gives zero)."""
    rng = np.random.default_rng(7 + plateau)
    outs = _yolox_maps(rng)
    boxes, labels = _gt(rng, plateau)
    for img in range(2):
        want, fg, best_gt, wgrads = _jax_yolox(outs, boxes, labels, img, monkeypatch)
        got, ggrads = _port_yolox(outs, boxes, labels, img)
        np.testing.assert_array_equal(got["fg"].numpy(), fg)
        np.testing.assert_array_equal(got["best_gt"].numpy(), best_gt)
        assert fg.sum() > 3 and float(got["num_pos"]) == float(want["num_pos"]) == fg.sum()
        if plateau:  # the plateau GT holds foreground priors of its own
            assert (best_gt[fg] == 3).any()
        for k in YOLOX_TERMS:
            assert _rel(got[k].detach(), want[k]) < 1e-5, (img, k)
            for lvl in range(3):
                for kk in ("cls", "reg", "obj"):
                    w = np.asarray(wgrads[k][lvl][kk])
                    g = ggrads[k][lvl][kk]
                    g = np.zeros_like(w) if g is None else g.numpy()
                    if np.abs(w).max() == 0:
                        assert np.abs(g).max() == 0, (img, k, lvl, kk)
                    else:
                        assert _rel(g, w) < 1e-5, (img, k, lvl, kk)
        reg_grad = sum(np.abs(np.asarray(wgrads["loss_cls"][lvl]["reg"])).max() for lvl in range(3))
        assert reg_grad > 0


def test_yolox_assignment_replay():
    """`assigned` replaces SimOTA's result: replaying the function's own
    assignment gives the same terms; another mask gives other terms."""
    rng = np.random.default_rng(3)
    outs = [{k: torch.from_numpy(v) for k, v in o.items()} for o in _yolox_maps(rng, 1)]
    boxes, labels = (torch.from_numpy(a) for a in _gt(rng, True))
    free = losses2d.yolox_loss_single(outs, boxes, labels, C)
    held = losses2d.yolox_loss_single(outs, boxes, labels, C,
                                      assigned=(free["fg"], free["best_gt"]))
    for k in YOLOX_TERMS:
        assert torch.equal(free[k], held[k])
    other = losses2d.yolox_loss_single(outs, boxes, labels, C,
                                       assigned=(~free["fg"], free["best_gt"]))
    assert not torch.equal(other["loss"], free["loss"])


def _centernet_case(rng):
    H = W = SIZE // 4
    heads = {"heatmap": rng.normal(-2, 1.5, (2, H, W, C)).astype(np.float32),
             "wh": rng.normal(4, 2, (2, H, W, 2)).astype(np.float32),
             "offset": rng.random((2, H, W, 2)).astype(np.float32)}
    boxes, labels = _gt(rng, False)
    boxes[4] = (58, 60, 70, 72)  # the centre past the map: masked
    return heads, boxes, labels


def test_centernet_targets_and_radius_match_jax():
    """`centernet_targets` (heatmap, centres, cells, sizes, mask) and
    `_gaussian_radius` within 1e-6; the off-map and padding rows masked."""
    rng = np.random.default_rng(11)
    _, boxes, labels = _centernet_case(rng)
    want = jax_losses.centernet_targets(jnp.asarray(boxes), jnp.asarray(labels), C, 16, 16)
    got = losses2d.centernet_targets(torch.from_numpy(boxes), torch.from_numpy(labels), C, 16, 16)
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.shape(w)
        np.testing.assert_allclose(g.numpy().astype(np.float64), np.asarray(w), rtol=0, atol=1e-6)
    ok = got[5].numpy()
    assert not ok[4] and not ok[6:].any() and ok[:4].all()
    assert float(got[0].max()) == 1.0
    h = rng.uniform(0.1, 40, 64).astype(np.float32)
    w = rng.uniform(0.1, 40, 64).astype(np.float32)
    np.testing.assert_allclose(
        losses2d._gaussian_radius(torch.from_numpy(h), torch.from_numpy(w)).numpy(),
        np.asarray(jax_losses._gaussian_radius(jnp.asarray(h), jnp.asarray(w))), rtol=0, atol=1e-6)


def test_centernet_loss_matches_jax():
    """Both images: each term within 1e-5 relative and its gradient with
    respect to each map within 1e-5 of the largest magnitude."""
    rng = np.random.default_rng(13)
    heads, boxes, labels = _centernet_case(rng)
    for img in range(2):
        def term(h, k, img=img):
            return jax_losses.centernet_loss_single(h, jnp.asarray(boxes), jnp.asarray(labels), C,
                                                    img_idx=img)[k]

        want = jax_losses.centernet_loss_single(heads, jnp.asarray(boxes), jnp.asarray(labels), C,
                                                img_idx=img)
        maps = {k: torch.from_numpy(v).requires_grad_() for k, v in heads.items()}
        got = losses2d.centernet_loss_single(maps, torch.from_numpy(boxes),
                                             torch.from_numpy(labels), C, img_idx=img)
        assert float(got["num_pos"]) == float(want["num_pos"]) == 5
        wgrads = jax.jit(lambda h: {k: jax.grad(term)(h, k) for k in CENTERNET_TERMS})(heads)
        for k in CENTERNET_TERMS:
            assert _rel(got[k].detach(), want[k]) < 1e-5, (img, k)
            wg = wgrads[k]
            gg = torch.autograd.grad(got[k], list(maps.values()), retain_graph=True,
                                     allow_unused=True)
            for name, g in zip(maps, gg):
                w = np.asarray(wg[name])
                g = np.zeros_like(w) if g is None else g.numpy()
                if np.abs(w).max() == 0:
                    assert np.abs(g).max() == 0, (img, k, name)
                else:
                    assert _rel(g, w) < 1e-5, (img, k, name)
