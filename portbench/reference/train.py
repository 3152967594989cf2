"""The plain reference of EGTR's training step: the loss, the gradient, the
clip and the AdamW update, float32, image by image with index lists where
the program works on padded, masked tensors.

The loss is the published one (EGTR train_egtr.py and model/egtr.py;
Deformable DETR's focal, L1 and GIoU terms with Hungarian matching): the
assignment by ``scipy.optimize.linear_sum_assignment`` on the focal class
cost, L1 and GIoU, shifted so that a perfect match sits at the logit of
``smoothing``; the relation loss over every true entry plus the hardest 80
negatives per true entry among matched pairs and 80 among the other pairs
(at most 80 x ``max_gt_rels`` each, the fixed top-k size of the JAX
package),
targets weighted by the pair's matching uncertainty; connectivity BCE over
all pairs; the auxiliary detection losses of every earlier decoder layer
with their own matching. The step is the program's recipe: the microbatch
gradients averaged, the global-norm clip over every leaf (the frozen ones
too) in optax's form, then AdamW in torch's form (decay, then the Adam
step) on three learning-rate groups, the frozen leaves untouched.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
from scipy.optimize import linear_sum_assignment

from .model import Reference

ALPHA, GAMMA = 0.25, 2.0
WEIGHTS = {"loss_ce": "ce_loss_coefficient",
           "loss_bbox": "bbox_loss_coefficient",
           "loss_giou": "giou_loss_coefficient",
           "loss_rel": "rel_loss_coefficient",
           "loss_connectivity": "connectivity_loss_coefficient"}


def xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def giou(a, b):
    """Pairwise GIoU of xyxy boxes [N,4] x [M,4]."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.max(a[:, None, :2], b[None, :, :2])
    rb = torch.min(a[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    union = area_a[:, None] + area_b[None] - inter
    lt2 = torch.min(a[:, None, :2], b[None, :, :2])
    rb2 = torch.max(a[:, None, 2:], b[None, :, 2:])
    hull = (rb2 - lt2).clamp(min=0).prod(-1)
    return inter / union - (hull - union) / hull


def bce(x, z):
    return x.clamp(min=0) - x * z + torch.log1p(torch.exp(-x.abs()))


def focal(x, z):
    p = torch.sigmoid(x)
    p_t = p * z + (1 - p) * (1 - z)
    a_t = ALPHA * z + (1 - ALPHA) * (1 - z)
    return a_t * bce(x, z) * (1 - p_t) ** GAMMA


def match(logits, boxes, labels, tboxes, m):
    """(query, target, cost) of the assignment of one image's ``n`` targets."""
    with torch.no_grad():
        p = torch.sigmoid(logits)
        neg = (1 - ALPHA) * p ** GAMMA * -torch.log(1 - p + 1e-8)
        pos = ALPHA * (1 - p) ** GAMMA * -torch.log(p + 1e-8)
        cls = (pos - neg)[:, labels]
        l1 = torch.cdist(boxes, tboxes, p=1)
        cc, bc, gc = (m["ce_loss_coefficient"], m["bbox_cost"],
                      m["giou_cost"])
        cost = bc * l1 + cc * cls - gc * giou(xyxy(boxes), xyxy(tboxes))
        cost_min = cc * (1 - ALPHA) * math.log(1e-8) - gc
        cost = cost - cost_min - math.log(1.0 / m["smoothing"] - 1.0)
        c = cost.double().cpu().numpy()
        qi, ti = linear_sum_assignment(c)
        q = torch.as_tensor(qi, device=logits.device)
        t = torch.as_tensor(ti, device=logits.device)
        return q, t, cost[q, t]


def nonmatching_cost(m) -> float:
    return (-math.log(1e-8) * m["ce_loss_coefficient"] + 4 * m["bbox_cost"]
            + 2 * m["giou_cost"] - math.log(1.0 / m["smoothing"] - 1.0))


def detection_terms(logits, boxes, target, q, t):
    """Summed focal, L1 and 1 - GIoU of one image (not yet normalised)."""
    onehot = torch.zeros_like(logits)
    onehot[q, target["labels"][t]] = 1.0
    ce = focal(logits, onehot).sum()
    l1 = (boxes[q] - target["boxes"][t]).abs().sum()
    g = torch.diagonal(giou(xyxy(boxes[q]), xyxy(target["boxes"][t])))
    return ce, l1, (1 - g).sum()


def relation_terms(rel_logits, conn_logits, target, q, t, cost, m):
    """(BCE summed over the sampled entries, their count, the image's mean
    connectivity BCE) of one image."""
    Q = rel_logits.shape[0]
    R = rel_logits.shape[-1]
    dev = rel_logits.device
    gt_of_q = torch.full((Q,), -1, dtype=torch.long, device=dev)
    gt_of_q[q] = t
    cost_q = torch.full((Q,), nonmatching_cost(m), device=dev)
    cost_q[q] = cost
    w = 1 - torch.sigmoid(cost_q)
    matched = gt_of_q >= 0
    tq = torch.zeros((Q, Q, R), device=dev)
    mi = torch.nonzero(matched)[:, 0]
    tq[mi[:, None], mi[None, :]] = target["rel"][gt_of_q[mi][:, None],
                                                 gt_of_q[mi][None, :]]
    conn_t = (tq.amax(-1, keepdim=True) > 0).float()
    conn = bce(conn_logits, conn_t).mean()
    smoothed = tq * (w[:, None] * w[None, :])[..., None]
    true = tq == 1.0
    n_true = int(true.sum())
    total = bce(rel_logits, smoothed)[true].sum()
    count = n_true
    if n_true:
        pm = matched[:, None] & matched[None, :]
        flat = rel_logits.reshape(-1)
        for cand, per in ((pm[..., None] & ~true, m["rel_sample_negatives"]),
                          ((~pm)[..., None].expand_as(tq),
                           m["rel_sample_nonmatching"])):
            K = min(int(per * m["max_gt_rels"]), Q * Q * R)
            cand = cand.reshape(-1)
            k = min(per * n_true, int(cand.sum()), K)
            idx = torch.nonzero(cand)[:, 0]
            top = torch.topk(flat.detach()[idx], k).indices
            x = flat[idx[top]]
            total = total + (x.clamp(min=0)
                             + torch.log1p(torch.exp(-x.abs()))).sum()
            count += k
    return total, count, conn


def loss(out: Dict[str, torch.Tensor], targets: List[dict], m: dict
         ) -> torch.Tensor:
    """The total training loss of one microbatch."""
    B = len(targets)
    nb = max(sum(int(tg["labels"].numel()) for tg in targets), 1)
    terms = {k: 0.0 for k in WEIGHTS}
    aux = [{k: 0.0 for k in ("loss_ce", "loss_bbox", "loss_giou")}
           for _ in range(m["decoder_layers"] - 1)]
    rel_total, rel_count = 0.0, 0
    for b, tg in enumerate(targets):
        q, t, cost = match(out["logits"][b], out["pred_boxes"][b],
                           tg["labels"], tg["boxes"], m)
        ce, l1, gi = detection_terms(out["logits"][b], out["pred_boxes"][b],
                                     tg, q, t)
        terms["loss_ce"] += ce / nb
        terms["loss_bbox"] += l1 / nb
        terms["loss_giou"] += gi / nb
        tot, cnt, conn = relation_terms(out["pred_rel_logits"][b],
                                        out["pred_connectivity_logits"][b],
                                        tg, q, t, cost, m)
        rel_total = rel_total + tot
        rel_count += cnt
        terms["loss_connectivity"] += conn / B
        if m.get("auxiliary_loss"):
            for i, a in enumerate(aux):
                lg = out["all_logits"][b, i]
                bx = out["all_pred_boxes"][b, i]
                qa, ta, _ = match(lg, bx, tg["labels"], tg["boxes"], m)
                ce, l1, gi = detection_terms(lg, bx, tg, qa, ta)
                a["loss_ce"] += ce / nb
                a["loss_bbox"] += l1 / nb
                a["loss_giou"] += gi / nb
    terms["loss_rel"] = rel_total / max(rel_count, 1)
    total = sum(terms[k] * m[c] for k, c in WEIGHTS.items())
    for a in aux:
        total = total + sum(a[k] * m[WEIGHTS[k]] for k in a)
    return total


def param_label(name: str) -> str:
    """The learning-rate group of a leaf: the recipe's groups (backbone,
    reference points and sampling offsets at ``lr_backbone``; the relation
    head, fresh when EGTR is fine-tuned from a detector, at
    ``lr_initialized``; the rest at ``lr``) and the frozen set: the
    frequency-bias tables, the trunk's stem and first stage, every
    bottleneck's first convolution and norm, its frozen norms."""
    keys = name.split(".")
    if "rel_dist" in keys or "triplet_dist" in keys:
        return "frozen"
    if "backbone" in keys:
        if ("conv1" in keys or "bn1" in keys
                or any(k.startswith("layer1_") for k in keys)):
            return "frozen"
        if keys[-1] in ("running_mean", "running_var"):
            return "frozen"
        if keys[-1] in ("weight", "bias") and any("bn" in k for k in keys):
            return "frozen"
        return "lr_backbone"
    if any(k in ("reference_points", "sampling_offsets") for k in keys):
        return "lr_backbone"
    if "relation_head" in keys:
        return "lr_initialized"
    return "lr"


def draws(gen: Optional[torch.Generator]) -> int:
    """The position of a CUDA generator's stream (0 elsewhere)."""
    if gen is None or gen.device.type != "cuda":
        return 0
    return gen.get_offset()


class Step:
    """The training step over float32 leaves ``params`` (name -> tensor,
    updated in place) with the recipe ``train`` of a configuration file."""

    def __init__(self, params: Dict[str, torch.Tensor], m: dict, train: dict,
                 quant=None):
        self.params = {n: p.detach().clone().requires_grad_()
                       for n, p in params.items()}
        self.m, self.train = m, train
        self.model = Reference(self.params, m, quant)
        self.state: Dict[str, dict] = {}
        self.t = 0

    def __call__(self, microbatches: Sequence[dict],
                 gen: Optional[torch.Generator] = None,
                 seek: Optional[Callable[[int, int], None]] = None
                 ) -> Dict[str, object]:
        """One step. ``seek(a, per)`` positions ``gen`` before microbatch
        ``a``'s dropout masks, ``per`` being the draws of one microbatch
        (known once the first has drawn; -1 before)."""
        for p in self.params.values():
            p.grad = None
        total, per = 0.0, -1
        for a, mb in enumerate(microbatches):
            if seek is not None:
                seek(a, per)
            start = draws(gen)
            out = self.model.forward(mb["pixel_values"], mb["pixel_mask"],
                                     train=True, gen=gen)
            per = draws(gen) - start
            lo = loss(out, mb["targets"], self.m)
            lo.backward()
            total += float(lo.detach())
            del out, lo
        A = len(microbatches)
        grads = {}
        for n, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads[n] = g / A
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        clip = self.train["gradient_clip_val"]
        if float(norm) >= clip:
            grads = {n: g / norm.float() * clip for n, g in grads.items()}
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        wd = self.train["weight_decay"]
        with torch.no_grad():
            for n, p in self.params.items():
                group = param_label(n)
                if group == "frozen":
                    continue
                lr = self.train[group]
                st = self.state.setdefault(n, {"m": torch.zeros_like(p),
                                               "v": torch.zeros_like(p)})
                g = grads[n]
                p.mul_(1 - lr * wd)
                st["m"].mul_(b1).add_(g, alpha=1 - b1)
                st["v"].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (st["v"].sqrt() / math.sqrt(1 - b2 ** self.t)) + eps
                p.addcdiv_(st["m"], denom, value=-lr / (1 - b1 ** self.t))
        # the gradients as the update takes them: averaged and clipped
        return {"loss": total / A, "grads": grads,
                "grad_norm": float(norm)}
