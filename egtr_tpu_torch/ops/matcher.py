"""Hungarian matching (PyTorch port of ``egtr_tpu/ops/matcher.py``).

The cost matrix is built on the device, and the assignment is solved there
too, as the JAX package solves it inside ``jit`` with no host round trip:
on CUDA tensors by the hand-written kernel ``msda_cuda.lsap``
(``csrc/lsap.cu``), on CPU tensors by its plain version :func:`lsap_plain`.
Both are the JAX package's Jonker-Volgenant shortest-augmenting-path solver
(``_lsa_single``, vmapped over the batch), with its float32 operations in
its order and ``jnp.argmin``'s first index on ties, so the port returns the
JAX assignment bit for bit, ties included (scipy's ``linear_sum_assignment``
finds an assignment of the same total cost, but breaks ties its own way).

Padded-target convention, as in the JAX package: each image has ``max_gt``
target slots; slot j is real iff ``j < num_boxes``. Only the real rows are
solved; pad slots get ``query_index = -1`` and never appear in ``gt_index``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .boxes import box_cxcywh_to_xyxy, generalized_box_iou

_PAD_COST = 1e5  # constant cost of padded gt columns; >> any real cost


class MatchResult(NamedTuple):
    # per gt slot j: index of the query assigned to it (-1 on pad slots)
    query_index: torch.Tensor    # [B, G] int64
    # per gt slot j: the (smoothing-shifted) matching cost at the assignment;
    # meaningless on pad slots
    matching_cost: torch.Tensor  # [B, G] float32
    # per query q: matched gt slot, or -1
    gt_index: torch.Tensor       # [B, Q] int64


def compute_cost_matrix(logits, pred_boxes, tgt_ids, tgt_boxes, tgt_valid,
                        class_cost: float, bbox_cost: float, giou_cost: float,
                        smoothing: float, focal_alpha: float = 0.25,
                        focal_gamma: float = 2.0) -> torch.Tensor:
    """Cost matrix [B, Q, G], float32. Reference:
    deformable_detr.py:2949-2996. Padded target columns (``~tgt_valid``) are
    overwritten with ``_PAD_COST``."""
    out_prob = torch.sigmoid(logits.float())                  # [B,Q,C]
    alpha, gamma = focal_alpha, focal_gamma
    neg = (1 - alpha) * (out_prob ** gamma) * (-torch.log(1 - out_prob + 1e-8))
    pos = alpha * ((1 - out_prob) ** gamma) * (-torch.log(out_prob + 1e-8))
    safe_ids = tgt_ids.clamp(min=0).long()
    B, Q, _ = out_prob.shape
    cls = torch.gather(pos - neg, 2,
                       safe_ids[:, None, :].expand(B, Q, safe_ids.shape[1]))

    pred_boxes, tgt_boxes = pred_boxes.float(), tgt_boxes.float()
    bbox = (pred_boxes[:, :, None, :] - tgt_boxes[:, None, :, :]).abs().sum(-1)
    giou = generalized_box_iou(box_cxcywh_to_xyxy(pred_boxes),
                               box_cxcywh_to_xyxy(tgt_boxes))  # [B,Q,G]

    cost = bbox_cost * bbox + class_cost * cls + giou_cost * (-giou)
    if smoothing:
        # shift so a perfect match sits at inverse_sigmoid(smoothing)
        # (deformable_detr.py:2987-2996)
        bias_eps = math.log(1e-8)
        cost_min = class_cost * (1 - alpha) * bias_eps - giou_cost
        inv_sig = -math.log(1.0 / smoothing - 1.0)
        cost = cost - cost_min + inv_sig
    return torch.where(tgt_valid[:, None, :], cost,
                       torch.full_like(cost, _PAD_COST))


def _takes_kernel(cost: torch.Tensor) -> bool:
    """Whether the assignment launches the kernel: never for a CPU tensor,
    always for any other."""
    return cost.device.type != "cpu"


@torch.no_grad()
def lsap_plain(cost: torch.Tensor, num_boxes: torch.Tensor,
               stats: Optional[dict] = None):
    """The kernel's plain version (JAX ``_lsa_single`` vmapped, written out
    over the batch): ``(query_index [B, G] int64, matching_cost [B, G]
    float32, gt_index [B, Q] int64)`` for cost [B, Q, G] on the CPU.
    ``stats``, where given, gets ``steps``: the search steps the images
    took, summed (each relaxes Q columns; chip_smoke.py counts the work
    from it), and ``image_steps``: each image's (the kernel searches the
    images side by side, so the longest is its chain of steps).

    The rows (gt slots) are solved in turn; each search step relaxes every
    column of the images still searching, takes the first minimum of the
    columns not yet done, and follows ``row4col`` to the next row until a
    free column ends the path. The images whose ``num_boxes`` the row
    passes skip it, as JAX's pad rows enter their loops in the exit
    state."""
    if cost.device.type != "cpu":
        raise ValueError("lsap_plain is the CPU version; a CUDA tensor "
                         "takes the kernel (msda_cuda.lsap)")
    B, Q, G = cost.shape
    if G > Q:
        raise ValueError("need at least as many queries as (padded) targets")
    cost_t = cost.detach().float().transpose(1, 2)            # [B, G, Q]
    nb = num_boxes.long().clamp(0, G)
    batch = torch.arange(B)
    cols = torch.arange(Q)
    rows = torch.arange(G)
    inf = torch.tensor(float("inf"))
    u = torch.zeros((B, G))
    v = torch.zeros((B, Q))
    row4col = torch.full((B, Q), -1, dtype=torch.long)
    col4row = torch.full((B, G), -1, dtype=torch.long)
    for cur in range(G):
        active = cur < nb                                     # [B]
        if not bool(active.any()):
            break  # the rows after the longest image's last are all pads
        spc = torch.full((B, Q), float("inf"))
        path = torch.full((B, Q), -1, dtype=torch.long)
        done = torch.zeros((B, Q), dtype=torch.bool)
        visited = torch.zeros((B, G), dtype=torch.bool)
        i = torch.full((B,), cur, dtype=torch.long)
        min_val = torch.zeros((B,))
        sink = torch.where(active, -1, 0)
        while True:
            going = sink < 0
            if not bool(going.any()):
                break
            if stats is not None:
                stats["steps"] = stats.get("steps", 0) + int(going.sum())
                steps = stats.setdefault("image_steps", [0] * B)
                for b in going.nonzero()[:, 0].tolist():
                    steps[b] += 1
            visited |= going[:, None] & (rows[None] == i[:, None])
            r = ((min_val[:, None] + cost_t[batch, i])
                 - u[batch, i][:, None]) - v                  # [B, Q]
            upd = going[:, None] & ~done & (r < spc)
            spc = torch.where(upd, r, spc)
            path = torch.where(upd, i[:, None], path)
            masked = torch.where(done, inf, spc)
            q_min = masked.argmin(1)                          # first index
            min_val = torch.where(going, masked[batch, q_min], min_val)
            done |= going[:, None] & (cols[None] == q_min[:, None])
            nxt = row4col[batch, q_min]
            sink = torch.where(going & (nxt < 0), q_min, sink)
            i = torch.where(going & (nxt >= 0), nxt, i)
        # dual updates (rectangular_lsap semantics), active images only
        others = visited & (rows[None] != cur)
        spc_at = torch.where(col4row >= 0,
                             spc.gather(1, col4row.clamp(min=0)),
                             torch.zeros(()))
        u_cur = u[:, cur] + min_val
        u = torch.where(others, (u + min_val[:, None]) - spc_at, u)
        u[:, cur] = torch.where(active, u_cur, u[:, cur])
        v = torch.where(done, v - (min_val[:, None] - spc), v)
        # augment along the alternating path from the sink back to cur
        j = sink
        walking = active.clone()
        while bool(walking.any()):
            w = walking.nonzero()[:, 0]
            ii = path[w, j[w]]
            row4col[w, j[w]] = ii
            j_next = col4row[w, ii]
            col4row[w, ii] = j[w]
            j = j.clone()
            j[w] = j_next
            walking[w] = ii != cur
    matching_cost = cost_t.gather(2, col4row.clamp(min=0)[:, :, None])[..., 0]
    # every assigned column holds a solved slot, so row4col is the inverse
    # map of the real slots
    return col4row, matching_cost, row4col


@torch.no_grad()
def hungarian_match(cost: torch.Tensor, num_boxes: torch.Tensor
                    ) -> MatchResult:
    """Batched assignment. cost: [B, Q, G]; num_boxes: [B].

    On the device where ``cost`` lies, with no copy to the host: the kernel
    for a CUDA tensor, :func:`lsap_plain` for a CPU one. Callers mask pad
    slots with ``j < num_boxes``, as in the JAX package."""
    B, Q, G = cost.shape
    if G > Q:
        raise ValueError("need at least as many queries as (padded) targets")
    if _takes_kernel(cost):
        from . import msda_cuda

        solved = msda_cuda.lsap(
            cost.detach().float().contiguous(),
            num_boxes.to(device=cost.device, dtype=torch.int32).contiguous())
    else:
        solved = lsap_plain(cost, num_boxes)
    return MatchResult(*solved)
