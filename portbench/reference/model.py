"""The plain reference of EGTR's forward: float32 PyTorch, written from the
published description (Deformable DETR, arXiv:2010.04159; EGTR,
arXiv:2404.02072) over the parameter names of the port's state dict.

It shares no code with the program. MSDA is ``F.grid_sample`` per level
(bilinear, zero padding, ``align_corners=False``, the sample point at
``loc * size - 0.5``). The relation head forms the gated pair feature
``sum_l gate_l(i, j) [q_l(i); k_l(j)]`` over all Q x Q pairs as the paper
writes it, where the program factorises it. The frozen batch norms, the
sine position embedding with its pixel mask, the valid ratios and the
iterative reference points (none: no box refinement) follow the published
Deformable DETR.

``quant`` rounds the operands of every convolution, linear layer, attention
product and MSDA sampling (the control: ``fp8_e4m3``, per-tensor scaled);
``None`` computes in float32. Dropout takes its masks from ``generator`` in
the program's order of sites, shape by shape, so that a CUDA generator at
the program's offset draws the program's masks.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]
STAGES = (3, 4, 6, 3)
FP8_MAX = 448.0


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the tensor (amax to
    448), back in float32; the gradient passes straight through."""
    scale = FP8_MAX / t.detach().abs().amax().clamp(min=1e-30)
    q = (t.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return t + (q - t).detach()


def level_shapes(hw: Tuple[int, int], levels: int) -> List[Tuple[int, int]]:
    H, W = hw
    shapes = [(math.ceil(H / s), math.ceil(W / s)) for s in (8, 16, 32)]
    while len(shapes) < levels:
        h, w = shapes[-1]
        shapes.append((math.ceil(h / 2), math.ceil(w / 2)))
    return shapes[:levels]


class Reference:
    """EGTR's forward on the parameters ``p`` (name -> float32 tensor) of
    the model fields ``m`` of a configuration file."""

    def __init__(self, p: Dict[str, torch.Tensor], m: dict,
                 quant: Quant = None):
        self.p, self.m = p, m
        self.q = quant if quant is not None else (lambda t: t)

    # -- layers ------------------------------------------------------------
    def lin(self, x, name):
        b = self.p.get(name + ".bias")
        return F.linear(self.q(x), self.q(self.p[name + ".weight"]), b)

    def conv(self, x, name, stride=1, padding=0):
        return F.conv2d(self.q(x), self.q(self.p[name + ".weight"]),
                        self.p.get(name + ".bias"), stride, padding)

    def frozen_bn(self, x, name):
        w, b = self.p[name + ".weight"], self.p[name + ".bias"]
        mean, var = self.p[name + ".running_mean"], self.p[name + ".running_var"]
        scale = w / torch.sqrt(var + 1e-5)
        return x * scale[:, None, None] + (b - mean * scale)[:, None, None]

    def layer_norm(self, x, name):
        """LayerNorm; its output is the hidden state a layer hands on, held
        in the compute precision (rounded by ``quant`` in the control)."""
        return self.q(F.layer_norm(x, x.shape[-1:], self.p[name + ".weight"],
                                   self.p[name + ".bias"], 1e-5))

    def drop(self, x, train, gen):
        rate = self.m["dropout"]
        if not train or rate == 0.0:
            return x
        keep = torch.rand(x.shape, device=x.device, generator=gen) >= rate
        return x * keep.float() / (1.0 - rate)

    # -- backbone ----------------------------------------------------------
    def trunk(self, x):
        pre = "model.backbone."
        x = F.relu(self.frozen_bn(self.conv(x, pre + "conv1", 2, 3),
                                  pre + "bn1"))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for s, n in enumerate(STAGES):
            for b in range(n):
                blk = f"{pre}layer{s + 1}_{b}."
                stride = 2 if (b == 0 and s > 0) else 1
                y = F.relu(self.frozen_bn(self.conv(x, blk + "conv1"),
                                          blk + "bn1"))
                y = F.relu(self.frozen_bn(self.conv(y, blk + "conv2", stride,
                                                    1), blk + "bn2"))
                y = self.frozen_bn(self.conv(y, blk + "conv3"), blk + "bn3")
                if b == 0:
                    x = self.frozen_bn(self.conv(x, blk + "downsample_conv",
                                                 stride), blk + "downsample_bn")
                x = F.relu(y + x)
            if s >= 1:
                outs.append(x)
        return outs

    # -- embeddings --------------------------------------------------------
    @staticmethod
    def sine_embed(mask, dim):
        """DETR's sine embedding of a [B,h,w] mask: [B,h,w,2*dim]."""
        m = mask.float()
        y = m.cumsum(1)
        x = m.cumsum(2)
        y = (y - 0.5) / (y[:, -1:, :] + 1e-6) * 2 * math.pi
        x = (x - 0.5) / (x[:, :, -1:] + 1e-6) * 2 * math.pi
        i = torch.arange(dim, device=mask.device, dtype=torch.float32)
        dim_t = 10000.0 ** (2 * (i // 2) / dim)

        def enc(e):
            pos = e[..., None] / dim_t
            return torch.stack([pos[..., 0::2].sin(), pos[..., 1::2].cos()],
                               -1).flatten(-2)

        return torch.cat([enc(y), enc(x)], -1)

    # -- MSDA ----------------------------------------------------------------
    def msda(self, value, shapes, loc, aw):
        """value [B,S,H,D], loc [B,Q,H,L,P,2], aw [B,Q,H,L,P] -> [B,Q,H*D]."""
        B, S, H, D = value.shape
        Q, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
        value = self.q(value)
        out = torch.zeros((B * H, D, Q), device=value.device)
        start = 0
        for lvl, (h, w) in enumerate(shapes):
            v = value[:, start:start + h * w].permute(0, 2, 3, 1).reshape(
                B * H, D, h, w)
            start += h * w
            grid = 2 * loc[:, :, :, lvl] - 1                  # [B,Q,H,P,2]
            grid = grid.permute(0, 2, 1, 3, 4).reshape(B * H, Q, P, 2)
            s = F.grid_sample(v, grid, mode="bilinear", padding_mode="zeros",
                              align_corners=False)             # [BH,D,Q,P]
            a = aw[:, :, :, lvl].permute(0, 2, 1, 3).reshape(B * H, 1, Q, P)
            out = out + (s * a).sum(-1)
        return out.reshape(B, H * D, Q).transpose(1, 2)

    def msda_layer(self, name, query, memory, ref, shapes, mask_flat, wh):
        m = self.m
        H, L, P = m["encoder_attention_heads"], m["num_feature_levels"], \
            m["encoder_n_points"]
        B, Q, E = query.shape
        value = self.lin(memory, name + ".value_proj")
        if mask_flat is not None:
            value = value.masked_fill(~mask_flat[..., None], 0.0)
        value = value.reshape(B, -1, H, E // H)
        off = self.lin(query, name + ".sampling_offsets").reshape(
            B, Q, H, L, P, 2)
        aw = self.lin(query, name + ".attention_weights").reshape(
            B, Q, H, L * P).softmax(-1).reshape(B, Q, H, L, P)
        loc = ref[:, :, None, :, None, :] + off / wh[None, None, None, :,
                                                     None, :]
        return self.msda(value, shapes, loc, aw)

    # -- the model -------------------------------------------------------------
    def forward(self, pixels, mask, train: bool = False,
                gen: Optional[torch.Generator] = None,
                classes: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """pixels [B,H,W,3], mask [B,H,W] bool. ``classes`` [B,Q]: the object
        classes the frequency bias looks up (by default the forward's own
        best class of each query); judging an answer, the classes it
        served."""
        m, p = self.m, self.p
        E, L = m["d_model"], m["num_feature_levels"]
        Hh = m["decoder_attention_heads"]
        Dh = E // Hh
        B, Himg, Wimg, _ = pixels.shape
        shapes = level_shapes((Himg, Wimg), L)
        dev = pixels.device
        feats = self.trunk(pixels.permute(0, 3, 1, 2).float())
        srcs, masks, poses = [], [], []
        for lvl in range(L):
            name = f"model.input_proj_{lvl}_"
            if lvl < 3:
                x = self.conv(feats[lvl], name + "conv")
            else:
                x = self.conv(feats[-1] if lvl == 3 else prev, name + "conv",
                              2, 1)
            x = prev = self.q(F.group_norm(x, 32, p[name + "norm.weight"],
                                           p[name + "norm.bias"], 1e-5))
            h, w = shapes[lvl]
            ri = torch.arange(h, device=dev) * Himg // h
            ci = torch.arange(w, device=dev) * Wimg // w
            ml = mask[:, ri][:, :, ci]
            srcs.append(x.flatten(2).transpose(1, 2))
            masks.append(ml)
            poses.append(self.sine_embed(ml, E // 2).reshape(B, h * w, E)
                         + p["model.level_embed"][lvl])
        src = torch.cat(srcs, 1)
        mask_flat = torch.cat([ml.reshape(B, -1) for ml in masks], 1)
        pos = torch.cat(poses, 1)
        ratios = torch.stack([torch.stack(
            [ml[:, 0, :].sum(1).float() / ml.shape[2],
             ml[:, :, 0].sum(1).float() / ml.shape[1]], -1) for ml in masks],
            1)                                                  # [B,L,2]
        wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                          device=dev)
        refs = []
        for lvl, (h, w) in enumerate(shapes):
            yy, xx = torch.meshgrid(
                torch.arange(h, device=dev, dtype=torch.float32) + 0.5,
                torch.arange(w, device=dev, dtype=torch.float32) + 0.5,
                indexing="ij")
            r = torch.stack([xx.reshape(-1), yy.reshape(-1)], -1)[None]
            refs.append(r / (ratios[:, None, lvl] * wh[lvl]))
        enc_ref = torch.cat(refs, 1)[:, :, None] * ratios[:, None]

        hidden = self.drop(src, train, gen)
        for i in range(m["encoder_layers"]):
            n = f"model.encoder_layer_{i}."
            attn = self.msda_layer(n + "self_attn", hidden + pos, hidden,
                                   enc_ref, shapes, mask_flat, wh)
            attn = self.drop(self.lin(attn, n + "self_attn.output_proj"),
                             train, gen)
            hidden = self.layer_norm(hidden + attn, n + "self_attn_layer_norm")
            ff = self.drop(self.lin(F.relu(self.lin(hidden, n + "fc1")),
                                    n + "fc2"), train, gen)
            hidden = self.layer_norm(hidden + ff, n + "final_layer_norm")
        memory = hidden

        qpe = p["model.query_position_embeddings"]
        query_pos = qpe[None, :, :E].expand(B, -1, -1)
        hidden = qpe[None, :, E:].expand(B, -1, -1)
        ref_pts = torch.sigmoid(self.lin(query_pos, "model.reference_points"))
        dec_ref = ref_pts[:, :, None] * ratios[:, None]
        outs, qs, ks = [], [], []
        Q = hidden.shape[1]
        for i in range(m["decoder_layers"]):
            n = f"model.decoder_layer_{i}."
            qk_in = hidden + query_pos
            qh = self.lin(qk_in, n + "self_attn.q_proj").reshape(
                B, Q, Hh, Dh).transpose(1, 2) * Dh ** -0.5
            kh = self.lin(qk_in, n + "self_attn.k_proj").reshape(
                B, Q, Hh, Dh).transpose(1, 2)
            vh = self.lin(hidden, n + "self_attn.v_proj").reshape(
                B, Q, Hh, Dh).transpose(1, 2)
            att = (self.q(qh) @ self.q(kh).transpose(-1, -2)).softmax(-1)
            sa = (self.q(att) @ self.q(vh)).transpose(1, 2).reshape(B, Q, E)
            sa = self.drop(self.lin(sa, n + "self_attn.out_proj"), train, gen)
            hidden = self.layer_norm(hidden + sa, n + "self_attn_layer_norm")
            ca = self.msda_layer(n + "encoder_attn", hidden + query_pos,
                                 memory, dec_ref, shapes, mask_flat, wh)
            ca = self.drop(self.lin(ca, n + "encoder_attn.output_proj"),
                           train, gen)
            hidden = self.layer_norm(hidden + ca,
                                     n + "encoder_attn_layer_norm")
            ff = self.drop(self.lin(F.relu(self.lin(hidden, n + "fc1")),
                                    n + "fc2"), train, gen)
            hidden = self.layer_norm(hidden + ff, n + "final_layer_norm")
            outs.append(hidden)
            qs.append(qh)
            ks.append(kh)

        ref_logit = torch.log(ref_pts.clamp(min=1e-5)
                              / (1 - ref_pts).clamp(min=1e-5))
        logits, boxes = [], []
        for h in outs:
            logits.append(self.lin(h, "model.class_embed_0"))
            d = F.relu(self.lin(h, "model.bbox_embed_0.layers_0"))
            d = F.relu(self.lin(d, "model.bbox_embed_0.layers_1"))
            d = self.lin(d, "model.bbox_embed_0.layers_2")
            boxes.append(torch.cat([d[..., :2] + ref_logit, d[..., 2:]],
                                   -1).sigmoid())
        rel, conn, gate_mean = self.relation_head(
            qs, ks, outs[-1],
            logits[-1].argmax(-1) if classes is None else classes)
        return {"logits": logits[-1], "pred_boxes": boxes[-1],
                "all_logits": torch.stack(logits, 1),
                "all_pred_boxes": torch.stack(boxes, 1),
                "pred_rel_logits": rel, "pred_connectivity_logits": conn,
                "rel_gate_mean": gate_mean}

    def relation_head(self, qs, ks, last, node):
        m, p = self.m, self.p
        E, Ld = m["d_model"], m["decoder_layers"]
        B, Hh, Q, Dh = qs[0].shape
        pre = "relation_head."

        def merge(t):
            return t.transpose(1, 2).reshape(B, Q, E)

        Qs = torch.stack([self.lin(merge(qs[l]) * Dh ** 0.5,
                                   f"{pre}proj_q_{l}") for l in range(Ld)]
                         + [self.lin(last, pre + "final_sub_proj")], 2)
        Ks = torch.stack([self.lin(merge(ks[l]), f"{pre}proj_k_{l}")
                          for l in range(Ld)]
                         + [self.lin(last, pre + "final_obj_proj")], 2)
        wg = p[pre + "rel_predictor_gate_kernel"][:, 0]
        gate = torch.sigmoid((Qs @ wg[:E])[:, :, None, :]
                             + (Ks @ wg[E:])[:, None, :, :]
                             + p[pre + "rel_predictor_gate_bias"][0])
        gq = self.q(gate)
        pair = torch.cat([torch.einsum("bijl,bile->bije", gq, self.q(Qs)),
                          torch.einsum("bijl,bjle->bije", gq, self.q(Ks))],
                         -1)                                    # [B,Q,Q,2E]

        def mlp(first, second, third):
            h = F.relu(self.q(pair) @ self.q(p[pre + first + "_kernel"])
                       + p[pre + first + "_bias"])
            h = F.relu(self.lin(h, pre + second))
            return self.lin(h, pre + third)

        rel = mlp("rel_predictor_layers_0", "rel_predictor_layers_1",
                  "rel_predictor_layers_2")
        if m.get("use_freq_bias", True):
            table = p["triplet_dist"]
            n_cls, R = table.shape[0], table.shape[2]
            idx = node[:, :, None] * n_cls + node[:, None, :]
            rel = rel + table.reshape(n_cls * n_cls, R)[idx]
        conn = mlp("connectivity_layers_0", "connectivity_layers_1",
                   "connectivity_layers_2")
        return rel, conn, gate.mean(dim=(0, 1, 2))


def postprocess(out: Dict[str, torch.Tensor], b: int, num_labels: int
                ) -> Dict[str, torch.Tensor]:
    """One image's scores as the reference's evaluation forms them
    (train_egtr.py:56-94): object scores, the triplet scores over Q x Q x R
    and the pair scores (each pair's best predicate) over Q x Q."""
    probs = out["logits"][b].softmax(-1)[:, :num_labels]
    obj, cls = probs.max(-1)
    Q = obj.shape[0]
    sub_ob = obj[:, None] * obj[None, :]
    sub_ob = sub_ob * (1 - torch.eye(Q, device=obj.device))
    rel = (out["pred_rel_logits"][b].sigmoid().clamp(0, 1)
           * out["pred_connectivity_logits"][b].sigmoid().clamp(0, 1))
    return {"obj_scores": obj, "pred_classes": cls,
            "pred_boxes": out["pred_boxes"][b], "rel": rel,
            "trip": (rel * sub_ob[..., None]).reshape(-1),
            "pair": (rel.amax(-1) * sub_ob).reshape(-1)}
