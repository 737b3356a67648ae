"""BEVFormer's forward in plain PyTorch and float32: the benchmark's reference.

It reads the weights under the upstream checkpoint's keys (mmdet / mmcv
names, `weights.py`) and the sizes from the configuration file's "model"
section, and follows the published model: ResNet (caffe style at depth 101,
DCNv2 in the stages that `dcn_stages` marks), FPN, the encoder of temporal
self-attention and spatial cross-attention, the decoder with iterative box
refinement, and the classification and regression branches.  It imports
nothing of the program under test.

Where the program takes a shortcut the reference does not: spatial
cross-attention runs over every BEV query of every camera (no compaction
budget), and every deformable sampling is `F.grid_sample` (mmcv's
`multi_scale_deformable_attn_pytorch`; DCNv2's bilinear sampling with zero
outside the map).  Run it under `exact_float32()` on the card, so that no
float32 product takes TF32.

`Counter` counts the products' FLOPs (2 a multiply-add of every
convolution, dense layer, DCN product and attention product); the
samplings, norms and elementwise work are not counted.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
BN_EPS = 1e-5
LN_EPS = 1e-5


class Counter:
    """FLOPs of the products by kind, added to while a forward runs."""

    def __init__(self):
        self.flops = {"conv": 0, "dense": 0, "dcn": 0, "attention": 0}

    @property
    def total(self) -> int:
        return sum(self.flops.values())


@contextlib.contextmanager
def exact_float32():
    """float32 products and convolutions without TF32 for the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Reference:
    """The plain model over a dict of upstream-keyed float32 tensors `w`
    and the configuration's "model" section `m`."""

    def __init__(self, w: Dict[str, torch.Tensor], m: dict, counter: Optional[Counter] = None):
        self.w, self.m = w, m
        self.counter = counter

    def _count(self, kind: str, flops: int) -> None:
        if self.counter is not None:
            self.counter.flops[kind] += int(flops)

    # ---- layers -----------------------------------------------------------

    def conv(self, x, key, stride=1, padding=0, bias=False):
        wt = self.w[f"{key}.weight"]
        out = F.conv2d(x, wt, self.w[f"{key}.bias"] if bias else None, stride, padding)
        self._count("conv", 2 * out.numel() * wt[0].numel())
        return out

    def linear(self, x, key, weight=None, bias=None):
        wt = self.w[f"{key}.weight"] if weight is None else weight
        b = self.w[f"{key}.bias"] if bias is None else bias
        out = F.linear(x, wt, b)
        self._count("dense", 2 * out.numel() * wt.shape[1])
        return out

    def bn(self, x, key):
        inv = self.w[f"{key}.weight"] / torch.sqrt(self.w[f"{key}.running_var"] + BN_EPS)
        shift = self.w[f"{key}.bias"] - self.w[f"{key}.running_mean"] * inv
        return x * inv[:, None, None] + shift[:, None, None]

    def ln(self, x, key):
        return F.layer_norm(x, (x.shape[-1],), self.w[f"{key}.weight"], self.w[f"{key}.bias"],
                            LN_EPS)

    def dcn(self, x, key, stride):
        """mmcv's ModulatedDeformConv2dPack, 3x3, padding 1, one deform
        group, no bias: `conv_offset` gives 18 offsets (tap t: 2t = y,
        2t + 1 = x) and 9 mask logits."""
        om = self.conv(x, f"{key}.conv_offset", stride, 1, bias=True)
        offset, mask = om[:, :18], torch.sigmoid(om[:, 18:])
        wt = self.w[f"{key}.weight"]
        N, Cin, H, W = x.shape
        Ho, Wo = om.shape[2:]
        oy = (torch.arange(Ho, device=x.device, dtype=torch.float32) * stride - 1)[:, None]
        ox = (torch.arange(Wo, device=x.device, dtype=torch.float32) * stride - 1)[None, :]
        out = x.new_zeros((N, wt.shape[0], Ho * Wo))
        for t in range(9):
            ky, kx = divmod(t, 3)
            py = oy + ky + offset[:, 2 * t]
            px = ox + kx + offset[:, 2 * t + 1]
            # align_corners=True maps -1 / 1 to the first / last pixel's centre
            grid = torch.stack([px / (W - 1) * 2 - 1, py / (H - 1) * 2 - 1], dim=-1)
            sampled = F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                                    align_corners=True) * mask[:, t:t + 1]
            out = out + torch.einsum("oc,ncs->nos", wt[:, :, ky, kx],
                                     sampled.reshape(N, Cin, Ho * Wo))
        self._count("dcn", 2 * N * wt.shape[0] * Ho * Wo * Cin * 9)
        return out.reshape(N, wt.shape[0], Ho, Wo)

    # ---- image features -----------------------------------------------------

    def backbone(self, x):
        m = self.m
        depth = m["backbone_depth"]
        caffe = depth == 101
        k = "img_backbone"
        x = F.relu(self.bn(self.conv(x, f"{k}.conv1", 2, 3), f"{k}.bn1"))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for stage, blocks in enumerate(STAGE_BLOCKS[depth]):
            for b in range(blocks):
                s = f"{k}.layer{stage + 1}.{b}"
                stride = 1 if stage == 0 or b > 0 else 2
                s1, s2 = (stride, 1) if caffe else (1, stride)
                out = F.relu(self.bn(self.conv(x, f"{s}.conv1", s1), f"{s}.bn1"))
                if m["dcn_stages"][stage]:
                    out = self.dcn(out, f"{s}.conv2", s2)
                else:
                    out = self.conv(out, f"{s}.conv2", s2, 1)
                out = F.relu(self.bn(out, f"{s}.bn2"))
                out = self.bn(self.conv(out, f"{s}.conv3"), f"{s}.bn3")
                identity = (self.bn(self.conv(x, f"{s}.downsample.0", stride), f"{s}.downsample.1")
                            if b == 0 else x)
                x = F.relu(out + identity)
            if stage in m["backbone_out_indices"]:
                outs.append(x)
        return outs

    def neck(self, inputs):
        """mmdet FPN, extra convs on the last output, ReLU before all but
        the first extra conv."""
        k = "img_neck"
        n_in = len(inputs)
        lat = [self.conv(x, f"{k}.lateral_convs.{i}.conv", bias=True)
               for i, x in enumerate(inputs)]
        for i in range(n_in - 1, 0, -1):
            up = F.interpolate(lat[i], scale_factor=2, mode="nearest")
            lat[i - 1] = lat[i - 1] + up[:, :, :lat[i - 1].shape[2], :lat[i - 1].shape[3]]
        outs = [self.conv(lat[i], f"{k}.fpn_convs.{i}.conv", 1, 1, bias=True)
                for i in range(n_in)]
        for i in range(n_in, self.m["num_levels"]):
            src = F.relu(outs[-1]) if i > n_in else outs[-1]
            outs.append(self.conv(src, f"{k}.fpn_convs.{i}.conv", 2, 1, bias=True))
        return outs

    # ---- attention ----------------------------------------------------------

    def msda(self, value, shapes, loc, logits):
        """mmcv's multi_scale_deformable_attn_pytorch.  value [bs, keys,
        heads, ch]; loc [bs, nq, heads, L, P, 2] normalised (x, y); logits
        [bs, nq, heads, L * P] before the softmax.  Returns [bs, nq,
        heads * ch]."""
        bs, _, H, ch = value.shape
        nq, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
        weights = torch.softmax(logits, dim=-1).reshape(bs, nq, H, L, P)
        out = value.new_zeros((bs * H, ch, nq))
        start = 0
        for lvl, (h, w) in enumerate(shapes):
            v = value[:, start:start + h * w].permute(0, 2, 3, 1).reshape(bs * H, ch, h, w)
            start += h * w
            grid = (2 * loc[:, :, :, lvl] - 1).permute(0, 2, 1, 3, 4).reshape(bs * H, nq, P, 2)
            s = F.grid_sample(v, grid, mode="bilinear", padding_mode="zeros",
                              align_corners=False)  # [bs*H, ch, nq, P]
            wl = weights[:, :, :, lvl].permute(0, 2, 1, 3).reshape(bs * H, 1, nq, P)
            out = out + (s * wl).sum(-1)
        return out.reshape(bs, H, ch, nq).permute(0, 3, 1, 2).reshape(bs, nq, H * ch)

    @staticmethod
    def locations(ref, off, shapes, H):
        """ref [bs, nq, 1, Z * 2] normalised; off [bs, nq, H, L * P * 2] in
        pixels of each level; point p takes anchor p % Z.  Returns
        [bs, nq, H, L, P, 2]."""
        bs, nq = ref.shape[:2]
        L, Z = len(shapes), ref.shape[-1] // 2
        off = off.reshape(bs, nq, H, L, -1, Z, 2)
        norm = torch.tensor([[w, h] for h, w in shapes], dtype=off.dtype,
                            device=off.device).reshape(1, 1, 1, L, 1, 1, 2)
        loc = ref.reshape(bs, nq, 1, 1, 1, Z, 2) + off / norm
        return loc.reshape(bs, nq, H, L, -1, 2)

    def temporal_self_attn(self, query, prev_queue, identity, pos, hybrid_ref, key):
        """TemporalSelfAttention over the queue [prev, current] (Q = 2)."""
        m = self.m
        C, H, P = m["embed_dims"], m["num_heads"], m["num_points_self"]
        nq = query.shape[1]
        q = query + pos
        qcat = torch.cat([prev_queue[0:1], q], dim=-1)
        off = self.linear(qcat, f"{key}.sampling_offsets").reshape(nq, H, 2, P * 2)
        logits = self.linear(qcat, f"{key}.attention_weights").reshape(nq, H, 2, P)
        off, logits = off.permute(2, 0, 1, 3), logits.permute(2, 0, 1, 3)
        v = self.linear(prev_queue, f"{key}.value_proj").reshape(2, nq, H, C // H)
        shapes = ((m["bev_h"], m["bev_w"]),)
        out = self.msda(v, shapes, self.locations(hybrid_ref, off, shapes, H), logits)
        out = self.linear(out.mean(dim=0, keepdim=True), f"{key}.output_proj")
        return out + identity

    def spatial_cross_attn(self, query, value, ref_cam, bev_mask, shapes, key):
        """SpatialCrossAttention: every camera over every BEV query, then
        the hits averaged over the cameras that see the query."""
        m = self.m
        C, H = m["embed_dims"], m["num_heads"]
        cams, nq = ref_cam.shape[:2]
        d = f"{key}.deformable_attention"
        off = self.linear(query, f"{d}.sampling_offsets").reshape(nq, H, -1)
        logits = self.linear(query, f"{d}.attention_weights").reshape(nq, H, -1)
        v = self.linear(value, f"{d}.value_proj").reshape(cams, -1, H, C // H)
        loc = self.locations(ref_cam.reshape(cams, nq, 1, -1),
                             off[None].expand(cams, -1, -1, -1), shapes, H)
        out = self.msda(v, shapes, loc, logits[None].expand(cams, -1, -1, -1))
        slots = (out * bev_mask).sum(dim=0, keepdim=True)
        return self.linear(slots, f"{key}.output_proj") + query

    def decoder_cross_attn(self, query, value, pos, ref_2d, key):
        m = self.m
        C, H = m["embed_dims"], m["num_heads"]
        nq = query.shape[1]
        q = query + pos
        off = self.linear(q, f"{key}.sampling_offsets").reshape(1, nq, H, -1)
        logits = self.linear(q, f"{key}.attention_weights").reshape(1, nq, H, -1)
        v = self.linear(value, f"{key}.value_proj").reshape(1, -1, H, C // H)
        shapes = ((m["bev_h"], m["bev_w"]),)
        out = self.msda(v, shapes, self.locations(ref_2d, off, shapes, H), logits)
        return self.linear(out, f"{key}.output_proj") + query

    def self_attn(self, query, pos, key):
        """nn.MultiheadAttention with `in_proj` (q, k, v rows), query and key
        with the positional embedding, value without."""
        C, H = self.m["embed_dims"], self.m["num_heads"]
        w, b = self.w[f"{key}.in_proj_weight"], self.w[f"{key}.in_proj_bias"]
        q = self.linear(query + pos, key, w[:C], b[:C])
        k = self.linear(query + pos, key, w[C:2 * C], b[C:2 * C])
        v = self.linear(query, key, w[2 * C:], b[2 * C:])
        B, Lq, _ = q.shape
        heads = [t.reshape(B, Lq, H, C // H).transpose(1, 2) for t in (q, k, v)]
        probs = torch.softmax(heads[0] @ heads[1].transpose(-1, -2) / math.sqrt(C // H), dim=-1)
        out = (probs @ heads[2]).transpose(1, 2).reshape(B, Lq, C)
        self._count("attention", 4 * B * H * Lq * Lq * (C // H))
        return self.linear(out, f"{key}.out_proj") + query

    def ffn(self, x, key):
        h = F.relu(self.linear(x, f"{key}.ffns.0.layers.0.0"))
        return x + self.linear(h, f"{key}.ffns.0.layers.1")

    # ---- geometry -----------------------------------------------------------

    def reference_points_3d(self, device):
        m = self.m
        Z, h, w = m["num_points_in_pillar"], m["bev_h"], m["bev_w"]
        zs = (np.linspace(0.5, Z - 0.5, Z) / Z)[:, None, None]
        xs = (np.linspace(0.5, w - 0.5, w) / w)[None, None, :]
        ys = (np.linspace(0.5, h - 0.5, h) / h)[None, :, None]
        zs, xs, ys = np.broadcast_arrays(zs, xs, ys)
        ref = np.stack([xs, ys, zs], axis=-1).reshape(Z, h * w, 3).astype(np.float32)
        return torch.from_numpy(ref).to(device)

    def point_sampling(self, ref_3d, lidar2img):
        """Pillar points into each camera: (ref_cam [cams, nq, Z * 2]
        normalised image coordinates, bev_mask [cams, nq, 1]: 1 / (cameras
        that see the query) where this camera sees it, else 0)."""
        m = self.m
        pc = m["pc_range"]
        cams = m["num_cams"]
        Z, nq = ref_3d.shape[:2]
        pts = torch.stack([ref_3d[..., i] * (pc[i + 3] - pc[i]) + pc[i] for i in range(3)]
                          + [torch.ones_like(ref_3d[..., 0])], dim=-1)
        cam = torch.einsum("pqd,ced->pcqe", pts, lidar2img.reshape(cams, 4, 4))
        eps = 1e-5
        z = cam[..., 2:3]
        xy = cam[..., 0:2] / torch.clamp(z, min=eps)
        xy = torch.stack([xy[..., 0] / m["img_w"], xy[..., 1] / m["img_h"]], dim=-1)
        inb = ((z > eps) & (xy[..., 1:2] > 0) & (xy[..., 1:2] < 1) & (xy[..., 0:1] > 0)
               & (xy[..., 0:1] < 1)).float()
        ref_cam = xy.permute(1, 2, 0, 3).reshape(cams, nq, Z * 2)
        mask = inb.amax(dim=0)  # [cams, nq, 1]: any pillar point seen
        mask = mask / torch.clamp(mask.sum(dim=0, keepdim=True), min=1.0)
        return ref_cam, mask

    @staticmethod
    def can_bus_shift(can_bus, m):
        dx, dy = can_bus[0], can_bus[1]
        ego_angle = can_bus[-2] / np.pi * 180.0
        length = torch.sqrt(dx ** 2 + dy ** 2)
        angle = (torch.arctan(dy / (dx + 1e-8))
                 + ((1.0 - torch.sign(dx)) / 2.0) * torch.sign(dy) * np.pi) / np.pi * 180.0
        bev_angle = ego_angle - angle
        gy, gx = m["real_h"] / m["bev_h"], m["real_w"] / m["bev_w"]
        shift_y = length * torch.cos(bev_angle / 180.0 * np.pi) / gy / m["bev_h"]
        shift_x = length * torch.sin(bev_angle / 180.0 * np.pi) / gx / m["bev_w"]
        return torch.stack([shift_x, shift_y])

    @staticmethod
    def rotate(img, angle, center):
        """torchvision's rotate of [C, H, W] by `angle` degrees about
        `center` (x, y), nearest, zeros outside."""
        C, H, W = img.shape
        cx, cy = float(center[0]) - 0.5 * W, float(center[1]) - 0.5 * H
        a = -angle * (math.pi / 180.0)
        cos, sin = torch.cos(a), torch.sin(a)
        t02 = -cx * cos - cy * sin + cx
        t12 = cx * sin - cy * cos + cy
        xs = torch.linspace(-0.5 * W + 0.5, 0.5 * W - 0.5, W, device=img.device)
        ys = torch.linspace(-0.5 * H + 0.5, 0.5 * H - 0.5, H, device=img.device)
        bx, by = xs[None, :].expand(H, W), ys[:, None].expand(H, W)
        gx = (bx * cos + by * sin + t02) * (2.0 / W)
        gy = (bx * -sin + by * cos + t12) * (2.0 / H)
        grid = torch.stack([gx, gy], dim=-1)[None]
        return F.grid_sample(img[None], grid, mode="nearest", padding_mode="zeros",
                             align_corners=False)[0]

    # ---- the frame ----------------------------------------------------------

    def frame(self, image, prev_bev, use_prev: float, can_bus, lidar2img, given=None,
              decode: bool = True):
        """One frame.  image [cams, 3, H, W]; prev_bev [nq, C] or None;
        use_prev 0 or 1; can_bus [18] with the position and angle as deltas
        to the previous frame; lidar2img [cams, 4, 4].  Returns (bev [nq, C],
        classes [layers, num_query, classes], coords [layers, num_query,
        code_size], refined [layers, num_query, 3] or None), or (bev, None,
        None, None) where `decode` is false.  `given`: see `decoder`."""
        m = self.m
        C = m["embed_dims"]
        bh, bw = m["bev_h"], m["bev_w"]
        nq = bh * bw
        dev = image.device
        feats = self.neck(self.backbone(image))

        h = "pts_bbox_head"
        t = f"{h}.transformer"
        shift = self.can_bus_shift(can_bus, m)
        if prev_bev is None:
            prev_bev = torch.zeros((nq, C), device=dev)
        pb = self.rotate(prev_bev.reshape(bh, bw, C).permute(2, 0, 1), can_bus[-1],
                         m["rotate_center"])
        prev_bev = pb.permute(1, 2, 0).reshape(1, nq, C)
        cb = F.relu(self.linear(can_bus[None], f"{t}.can_bus_mlp.0"))
        cb = self.ln(F.relu(self.linear(cb, f"{t}.can_bus_mlp.2")), f"{t}.can_bus_mlp.norm")
        bev_q = self.w[f"{h}.bev_embedding.weight"][None] + cb[:, None]
        row = self.w[f"{h}.positional_encoding.row_embed.weight"]
        col = self.w[f"{h}.positional_encoding.col_embed.weight"]
        half = row.shape[1]
        bev_pos = torch.cat([col[None].expand(bh, bw, half), row[:, None].expand(bh, bw, half)],
                            dim=-1).reshape(1, nq, C)

        flat, shapes = [], []
        for lvl, f in enumerate(feats):
            cams, c, fh, fw = f.shape
            f = f.reshape(cams, c, fh * fw).transpose(1, 2)
            flat.append(f + self.w[f"{t}.cams_embeds"][:, None] + self.w[f"{t}.level_embeds"][lvl])
            shapes.append((fh, fw))
        value = torch.cat(flat, dim=1)

        # encoder
        ref_3d = self.reference_points_3d(dev)
        ref_2d = ref_3d[0, :, :2].reshape(1, nq, 1, 2)
        hybrid_ref = torch.cat([ref_2d + shift.reshape(1, 1, 1, 2) * use_prev, ref_2d], dim=0)
        ref_cam, bev_mask = self.point_sampling(ref_3d, lidar2img)
        output = bev_q
        for i in range(m["encoder_layers"]):
            e = f"{t}.encoder.layers.{i}"
            queue = (torch.cat([prev_bev, bev_q], dim=0) if use_prev
                     else torch.cat([output, output], dim=0))
            x = self.temporal_self_attn(output, queue, output, bev_pos, hybrid_ref,
                                        f"{e}.attentions.0")
            x = self.ln(x, f"{e}.norms.0")
            x = self.spatial_cross_attn(x, value, ref_cam, bev_mask, shapes, f"{e}.attentions.1")
            x = self.ln(x, f"{e}.norms.1")
            output = self.ln(self.ffn(x, e), f"{e}.norms.2")
        bev = output
        if not decode:
            return bev[0], None, None, None
        return (bev[0], *self.decoder(bev, given))

    def decoder(self, bev, given=None):
        """The decoder with iterative box refinement and the head's branches
        over `bev` [1, nq, C]: (classes, coords, refined), each stacked over
        the layers.  Without `given` each layer takes the previous layer's
        output and refined reference points, and `refined` is None.  With
        `given` = (states, refs) of another run ([layers, num_query, C] and
        [layers, num_query, 3]: each layer's output and the reference points
        it hands on), layer i > 0 takes states[i - 1] and refs[i - 1] as its
        inputs, so each layer follows from the inputs that run gave it and
        a difference does not carry from layer to layer; `refined` is then
        the refinement of refs[i - 1] (layer 0: of the reference's own
        points) by the regression branch over states[i], for the run's
        refs[i]."""
        m = self.m
        C = m["embed_dims"]
        h = "pts_bbox_head"
        t = f"{h}.transformer"
        query_pos, query = torch.split(self.w[f"{h}.query_embedding.weight"][None], C, dim=-1)
        refs = torch.sigmoid(self.linear(query_pos, f"{t}.reference_points"))
        classes, coords, refined = [], [], []
        pc = m["pc_range"]
        for i in range(m["decoder_layers"]):
            d = f"{t}.decoder.layers.{i}"
            if given is not None and i > 0:
                query, refs = given[0][i - 1][None], given[1][i - 1][None]
            x = self.ln(self.self_attn(query, query_pos, f"{d}.attentions.0.attn"), f"{d}.norms.0")
            x = self.decoder_cross_attn(x, bev, query_pos, refs[..., :2].reshape(1, -1, 1, 2),
                                        f"{d}.attentions.1")
            x = self.ln(x, f"{d}.norms.1")
            query = self.ln(self.ffn(x, d), f"{d}.norms.2")
            classes.append(self.cls_branch(query, f"{h}.cls_branches.{i}")[0])
            inv = inverse_sigmoid(refs)
            tmp = self.reg_branch(query, f"{h}.reg_branches.{i}")
            xy = torch.sigmoid(tmp[..., 0:2] + inv[..., 0:2])
            z = torch.sigmoid(tmp[..., 4:5] + inv[..., 2:3])
            coords.append(torch.cat([xy[..., 0:1] * (pc[3] - pc[0]) + pc[0],
                                     xy[..., 1:2] * (pc[4] - pc[1]) + pc[1], tmp[..., 2:4],
                                     z * (pc[5] - pc[2]) + pc[2], tmp[..., 5:]], dim=-1)[0])
            if given is not None:
                tmp = self.reg_branch(given[0][i][None], f"{h}.reg_branches.{i}")
                refined.append(torch.sigmoid(torch.cat([tmp[..., 0:2] + inv[..., 0:2],
                                                        tmp[..., 4:5] + inv[..., 2:3]], dim=-1))[0])
            refs = torch.cat([xy, z], dim=-1)
        return (torch.stack(classes), torch.stack(coords),
                torch.stack(refined) if given is not None else None)

    def cls_branch(self, x, key):
        x = F.relu(self.ln(self.linear(x, f"{key}.0"), f"{key}.1"))
        x = F.relu(self.ln(self.linear(x, f"{key}.3"), f"{key}.4"))
        return self.linear(x, f"{key}.6")

    def reg_branch(self, x, key):
        x = F.relu(self.linear(x, f"{key}.0"))
        return self.linear(F.relu(self.linear(x, f"{key}.2")), f"{key}.4")


def inverse_sigmoid(x, eps: float = 1e-5):
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))
