"""The plain reference of two-stage, box-refined EGTR: float32 PyTorch,
written from Deformable DETR's "++ two-stage" variant (Zhu et al.,
arXiv:2010.04159, §3 "two-stage Deformable DETR" and iterative bounding-box
refinement; the published script passes ``--with_box_refine --two_stage``)
and EGTR's code of both options (naver-ai/egtr ``model/deformable_detr.py``:
the proposals at 2098-2159 and 2306-2337, the refinement at 1902-1918, the
proposals' binary-class loss at 2848-2859), over the parameter names of the
port's state dict. It builds on ``model.Reference`` and ``train.Step`` and
shares no code with the program.

- *Proposals.* Every encoder token is a proposal: a box centred on its
  cell, in the valid area's coordinates, ``0.05 * 2**level`` wide and high,
  as logits; a token that is padded, or whose box leaves (0.01, 0.99), has
  its memory zeroed and its box at +inf. The memory goes through
  ``enc_output`` and its LayerNorm, then the extra class head (index
  ``decoder_layers``) and box MLP, whose output adds to the box logits. The
  top ``two_stage_num_proposals`` tokens by the first class logit, the
  lower index first among equal scores (a stable descending sort), become
  the queries: their box logits, detached, are the 4-d reference points
  (sigmoid), and ``pos_trans`` with its LayerNorm on their sine embedding
  (128 frequencies a coordinate) gives the query position and content.
- *Decoder.* Each layer samples at the reference box's centre plus the
  offsets over the points, times half the box's size, each coordinate
  scaled by the level's valid ratio; after the layer, its own box head
  refines the box (logit plus delta) and the result, detached, is the next
  layer's. The six layers' class and box heads are separate.
- *Loss.* EGTR's loss (``train.loss``) plus the proposals' focal, L1 and
  GIoU terms at the detection weights, every target labelled class 0, the
  assignment by ``scipy.optimize.linear_sum_assignment`` over all S
  proposals at the matcher's costs.

Departures from the published code, on purpose:

- The forward can take the selection and the proposals' assignment from
  outside (``proposals``, ``enc_assign``): the output check makes the
  reference continue from the program's discrete choices (a top-300 over
  22,323 near-tied scores and an assignment at Q = S flip under bfloat16),
  and judges the choices apart (``proposal_gap``, ``enc_match_gap``). No
  gradient flows through an index, so the continuous parts are compared as
  they are.
- The frozen frequency bias looks up each query's best class of the last
  layer, as ``model.Reference`` does; the program does the same.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment

from .model import Reference, level_shapes
from .train import (ALPHA, GAMMA, Step, detection_terms, draws, giou, loss,
                    param_label, xyxy)


def inverse_sigmoid(x, eps=1e-5):
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def proposal_pos_embed(logits, feats: int, temperature=10000.0):
    """Sine embedding of box logits [B,k,4] -> [B,k,4*feats]."""
    i = torch.arange(feats, dtype=torch.float32, device=logits.device)
    dim_t = temperature ** (2 * (i // 2) / feats)
    pos = logits.sigmoid()[..., None] * (2 * math.pi) / dim_t
    pos = torch.stack([pos[..., 0::2].sin(), pos[..., 1::2].cos()], -1)
    return pos.reshape(*pos.shape[:2], -1)


def top_indices(scores, k: int):
    """[B,k]: the ``k`` best scores a row, the lower index first on ties."""
    return torch.sort(scores, dim=1, descending=True, stable=True)[1][:, :k]


class TwoStageReference(Reference):
    """Two-stage, box-refined EGTR's forward on the parameters ``p``."""

    def msda_layer4(self, name, query, memory, ref, shapes, mask_flat):
        """Cross-attention at 4-d reference boxes ref [B,Q,L,4]."""
        m = self.m
        H, L, P = (m["decoder_attention_heads"], m["num_feature_levels"],
                   m["decoder_n_points"])
        B, Q, E = query.shape
        value = self.lin(memory, name + ".value_proj")
        value = value.masked_fill(~mask_flat[..., None], 0.0)
        value = value.reshape(B, -1, H, E // H)
        off = self.lin(query, name + ".sampling_offsets").reshape(
            B, Q, H, L, P, 2)
        aw = self.lin(query, name + ".attention_weights").reshape(
            B, Q, H, L * P).softmax(-1).reshape(B, Q, H, L, P)
        r = ref[:, :, None, :, None, :]
        loc = r[..., :2] + off / P * r[..., 2:] * 0.5
        return self.msda(value, shapes, loc, aw)

    def box_delta(self, h, i):
        d = F.relu(self.lin(h, f"model.bbox_embed_{i}.layers_0"))
        d = F.relu(self.lin(d, f"model.bbox_embed_{i}.layers_1"))
        return self.lin(d, f"model.bbox_embed_{i}.layers_2")

    def encode(self, pixels, mask, train, gen):
        """The trunk, the projections and the encoder: (memory, mask_flat,
        masks by level, valid ratios, shapes)."""
        m, p = self.m, self.p
        E, L = m["d_model"], m["num_feature_levels"]
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
        return hidden, mask_flat, masks, ratios, shapes

    def propose(self, memory, mask_flat, masks):
        """Every token's proposal: (class logits [B,S,C], box logits
        [B,S,4], +inf where invalid)."""
        dev = memory.device
        B = memory.shape[0]
        boxes = []
        for lvl, ml in enumerate(masks):
            h, w = ml.shape[1:]
            valid_h = ml[:, :, 0].sum(1).float()
            valid_w = ml[:, 0, :].sum(1).float()
            gy, gx = torch.meshgrid(
                torch.arange(h, dtype=torch.float32, device=dev),
                torch.arange(w, dtype=torch.float32, device=dev),
                indexing="ij")
            grid = (torch.stack([gx, gy], -1)[None] + 0.5) / torch.stack(
                [valid_w, valid_h], -1)[:, None, None]
            size = torch.full_like(grid, 0.05 * 2.0 ** lvl)
            boxes.append(torch.cat([grid, size], -1).reshape(B, -1, 4))
        prop = torch.cat(boxes, 1)
        keep = (((prop > 0.01) & (prop < 0.99)).all(-1, keepdim=True)
                & mask_flat[..., None])
        prop = torch.log(prop / (1 - prop)).masked_fill(~keep, float("inf"))
        query = memory.masked_fill(~keep, 0.0)
        query = self.layer_norm(self.lin(query, "model.enc_output"),
                                "model.enc_output_norm")
        i = self.m["decoder_layers"]
        return (self.lin(query, f"model.class_embed_{i}"),
                self.box_delta(query, i) + prop)

    def forward(self, pixels, mask, train: bool = False,
                gen: Optional[torch.Generator] = None,
                classes: Optional[torch.Tensor] = None,
                proposals: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """As ``Reference.forward``; ``proposals`` [B,k]: the tokens the
        queries come from (default: this forward's own top k)."""
        m, p = self.m, self.p
        E = m["d_model"]
        Hh = m["decoder_attention_heads"]
        Dh = E // Hh
        k = m["two_stage_num_proposals"]
        memory, mask_flat, masks, ratios, shapes = self.encode(
            pixels, mask, train, gen)
        B = memory.shape[0]
        enc_class, enc_coord = self.propose(memory, mask_flat, masks)
        scores = enc_class[..., 0]
        own = top_indices(scores, k)
        idx = own if proposals is None else proposals.to(own.device)
        coords = torch.gather(enc_coord, 1,
                              idx[..., None].expand(-1, -1, 4)).detach()
        ref = coords.sigmoid()
        init_ref = ref
        pt = self.layer_norm(self.lin(proposal_pos_embed(coords, E // 2),
                                      "model.pos_trans"),
                             "model.pos_trans_norm")
        query_pos, hidden = pt[..., :E], pt[..., E:]
        scale = torch.cat([ratios, ratios], -1)[:, None]       # [B,1,L,4]
        outs, qs, ks, refs = [], [], [], []
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
            ca = self.msda_layer4(n + "encoder_attn", hidden + query_pos,
                                  memory, ref[:, :, None] * scale, shapes,
                                  mask_flat)
            ca = self.drop(self.lin(ca, n + "encoder_attn.output_proj"),
                           train, gen)
            hidden = self.layer_norm(hidden + ca,
                                     n + "encoder_attn_layer_norm")
            ff = self.drop(self.lin(F.relu(self.lin(hidden, n + "fc1")),
                                    n + "fc2"), train, gen)
            hidden = self.layer_norm(hidden + ff, n + "final_layer_norm")
            ref = (self.box_delta(hidden, i)
                   + inverse_sigmoid(ref)).sigmoid().detach()
            outs.append(hidden)
            qs.append(qh)
            ks.append(kh)
            refs.append(ref)
        logits, boxes = [], []
        for i, h in enumerate(outs):
            r = init_ref if i == 0 else refs[i - 1]
            logits.append(self.lin(h, f"model.class_embed_{i}"))
            boxes.append((self.box_delta(h, i) + inverse_sigmoid(r))
                         .sigmoid())
        rel, conn, gate_mean = self.relation_head(
            qs, ks, outs[-1],
            logits[-1].argmax(-1) if classes is None else classes)
        return {"logits": logits[-1], "pred_boxes": boxes[-1],
                "all_logits": torch.stack(logits, 1),
                "all_pred_boxes": torch.stack(boxes, 1),
                "pred_rel_logits": rel, "pred_connectivity_logits": conn,
                "rel_gate_mean": gate_mean,
                "enc_outputs_class": enc_class,
                "enc_outputs_coord_logits": enc_coord,
                "proposal_indices": idx, "own_proposal_indices": own,
                "init_reference_points": init_ref,
                "intermediate_reference_points": torch.stack(refs, 1)}


def proposal_gap(scores, chosen, k: int) -> float:
    """How far below the reference's k-th best score the worst of the
    chosen tokens lies, over the spread of the scores (0 where the chosen
    ones are the reference's top k), the worst image. scores [B,S]."""
    worst = 0.0
    for s, idx in zip(scores.detach().double(), chosen):
        kth = torch.sort(s, descending=True)[0][k - 1]
        gap = float((kth - s[idx.to(s.device)].min()).clamp(min=0.0))
        worst = max(worst, gap / max(float(s.max() - s.min()), 1e-30))
    return worst


def cost_matrix(logits, boxes, labels, tboxes, m):
    """The matcher's cost [N, n] of ``train.match`` (focal class cost, L1,
    GIoU, the smoothing shift)."""
    p = torch.sigmoid(logits)
    neg = (1 - ALPHA) * p ** GAMMA * -torch.log(1 - p + 1e-8)
    pos = ALPHA * (1 - p) ** GAMMA * -torch.log(p + 1e-8)
    cc, bc, gc = m["ce_loss_coefficient"], m["bbox_cost"], m["giou_cost"]
    cost = (bc * torch.cdist(boxes, tboxes, p=1) + cc * (pos - neg)[:, labels]
            - gc * giou(xyxy(boxes), xyxy(tboxes)))
    cost_min = cc * (1 - ALPHA) * math.log(1e-8) - gc
    return cost - cost_min - math.log(1.0 / m["smoothing"] - 1.0)


def enc_terms(out, targets: List[dict], m: dict, nb: int,
              assign: Optional[Sequence] = None):
    """The proposals' weighted focal, L1 and GIoU terms over ``nb`` boxes;
    the assignment's gap: how much more the used assignment costs than the
    optimum at the reference's costs, over the boxes times the spread of
    the costs, the worst image; and per image the assignment used.
    ``assign``: per image the (proposal, target) indices to use (default:
    the optimum)."""
    total, gap, used = 0.0, 0.0, []
    for b, tg in enumerate(targets):
        logits = out["enc_outputs_class"][b]
        boxes = torch.sigmoid(out["enc_outputs_coord_logits"][b])
        zeros = torch.zeros_like(tg["labels"])
        with torch.no_grad():
            c = cost_matrix(logits, boxes, zeros, tg["boxes"], m).double()
            qi, ti = linear_sum_assignment(c.cpu().numpy())
            q = torch.as_tensor(qi, device=logits.device)
            t = torch.as_tensor(ti, device=logits.device)
            if assign is not None:
                used_q, used_t = (torch.as_tensor(np.asarray(x),
                                                  device=logits.device)
                                  for x in assign[b])
                n = max(len(ti), 1)
                spread = max(float(c.max() - c.min()), 1e-30)
                extra = float(c[used_q, used_t].sum() - c[q, t].sum())
                gap = max(gap, max(extra, 0.0) / n / spread)
                q, t = used_q, used_t
        used.append((q.cpu().numpy(), t.cpu().numpy()))
        ce, l1, gi = detection_terms(
            logits, boxes, {"labels": zeros, "boxes": tg["boxes"]}, q, t)
        total = total + (ce * m["ce_loss_coefficient"]
                         + l1 * m["bbox_loss_coefficient"]
                         + gi * m["giou_loss_coefficient"]) / nb
    return total, gap, used


def two_stage_loss(out, targets: List[dict], m: dict,
                   assign: Optional[Sequence] = None):
    """(EGTR's loss with the proposals' terms, the assignment's gap, the
    assignment used)."""
    nb = max(sum(int(tg["labels"].numel()) for tg in targets), 1)
    enc, gap, used = enc_terms(out, targets, m, nb, assign)
    return loss(out, targets, m) + enc, gap, used


def adamw_update(step: Step, grads: Dict[str, torch.Tensor]):
    """``train.Step``'s clip and update of averaged gradients ``grads``;
    returns (the clipped gradients, the norm before the clip)."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    clip = step.train["gradient_clip_val"]
    if float(norm) >= clip:
        grads = {n: g / norm.float() * clip for n, g in grads.items()}
    step.t += 1
    b1, b2, eps = 0.9, 0.999, 1e-8
    wd = step.train["weight_decay"]
    with torch.no_grad():
        for n, p in step.params.items():
            group = param_label(n)
            if group == "frozen":
                continue
            lr = step.train[group]
            st = step.state.setdefault(n, {"m": torch.zeros_like(p),
                                           "v": torch.zeros_like(p)})
            g = grads[n]
            p.mul_(1 - lr * wd)
            st["m"].mul_(b1).add_(g, alpha=1 - b1)
            st["v"].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (st["v"].sqrt() / math.sqrt(1 - b2 ** step.t)) + eps
            p.addcdiv_(st["m"], denom, value=-lr / (1 - b1 ** step.t))
    return grads, float(norm)


class TwoStageStep(Step):
    """``train.Step`` over the two-stage forward and loss. A microbatch may
    carry ``proposals`` ([B,k], the selection to continue from) and
    ``enc_assign`` (per image the proposals' assignment); the step returns,
    besides, the worst ``proposal_gap`` and ``enc_match_gap`` of its
    microbatches and ``choices``, each microbatch's selection and
    assignment as it followed them (in the form it takes)."""

    def __init__(self, params, m, train, quant=None):
        super().__init__(params, m, train, quant)
        self.model = TwoStageReference(self.params, m, quant)

    def __call__(self, microbatches: Sequence[dict],
                 gen: Optional[torch.Generator] = None,
                 seek: Optional[Callable[[int, int], None]] = None
                 ) -> Dict[str, object]:
        for p in self.params.values():
            p.grad = None
        total, per = 0.0, -1
        gaps = {"proposal_gap": 0.0, "enc_match_gap": 0.0}
        choices = []
        k = self.m["two_stage_num_proposals"]
        for a, mb in enumerate(microbatches):
            if seek is not None:
                seek(a, per)
            start = draws(gen)
            out = self.model.forward(mb["pixel_values"], mb["pixel_mask"],
                                     train=True, gen=gen,
                                     proposals=mb.get("proposals"))
            per = draws(gen) - start
            if mb.get("proposals") is not None:
                gaps["proposal_gap"] = max(
                    gaps["proposal_gap"],
                    proposal_gap(out["enc_outputs_class"][..., 0],
                                 mb["proposals"], k))
            lo, gap, used = two_stage_loss(out, mb["targets"], self.m,
                                           mb.get("enc_assign"))
            gaps["enc_match_gap"] = max(gaps["enc_match_gap"], gap)
            choices.append({"proposals": out["proposal_indices"].cpu(),
                            "enc_assign": used})
            lo.backward()
            total += float(lo.detach())
            del out, lo
        A = len(microbatches)
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 / A for n, p in self.params.items()}
        grads, norm = adamw_update(self, grads)
        return {"loss": total / A, "grads": grads, "grad_norm": norm,
                "choices": choices, **gaps}
