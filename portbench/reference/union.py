"""The plain reference of a data-parallel training step: ``train.Step`` over
the union of the ranks' microbatches, float32.

A data-parallel step's loss is the loss of the global batch (the port's
``ops/criterion.py:_denominators`` sums the boxes, the images and the
relation entries over the data group): microbatch ``a`` of the step is the
union of every rank's microbatch ``a``, each term summed over its images and
divided by the union's count. The reference forms the union one rank's
share at a time, so that its memory is one share's: the terms that divide
by counts known from the targets (boxes, images) are backpropagated at
once; the relation term, whose count of sampled entries is known only once
every share's matching is done, is backpropagated as a sum into gradients
of its own and divided by the union's count at the end. Each share draws its
dropout masks from its rank's generator (``seek``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from .train import (WEIGHTS, Step, detection_terms, match, relation_terms)
from .two_stage import adamw_update


def share_terms(out, targets: List[dict], m: dict, nb: int, n_img: int):
    """One share of a union microbatch: (its terms with known
    denominators, weighted; its relation sum; its relation count), the
    denominators ``nb`` boxes and ``n_img`` images of the union (the rest
    as ``train.loss``)."""
    rest, rel_total, rel_count = 0.0, 0.0, 0
    for b, tg in enumerate(targets):
        q, t, cost = match(out["logits"][b], out["pred_boxes"][b],
                           tg["labels"], tg["boxes"], m)
        ce, l1, gi = detection_terms(out["logits"][b], out["pred_boxes"][b],
                                     tg, q, t)
        rest = rest + (ce * m[WEIGHTS["loss_ce"]]
                       + l1 * m[WEIGHTS["loss_bbox"]]
                       + gi * m[WEIGHTS["loss_giou"]]) / nb
        tot, cnt, conn = relation_terms(out["pred_rel_logits"][b],
                                        out["pred_connectivity_logits"][b],
                                        tg, q, t, cost, m)
        rel_total = rel_total + tot
        rel_count += cnt
        rest = rest + conn * m[WEIGHTS["loss_connectivity"]] / n_img
        if m.get("auxiliary_loss"):
            for i in range(m["decoder_layers"] - 1):
                lg = out["all_logits"][b, i]
                bx = out["all_pred_boxes"][b, i]
                qa, ta, _ = match(lg, bx, tg["labels"], tg["boxes"], m)
                ce, l1, gi = detection_terms(lg, bx, tg, qa, ta)
                rest = rest + (ce * m[WEIGHTS["loss_ce"]]
                               + l1 * m[WEIGHTS["loss_bbox"]]
                               + gi * m[WEIGHTS["loss_giou"]]) / nb
    return rest, rel_total, rel_count


class UnionStep(Step):
    """The step over union microbatches: ``microbatches[a][r]`` is rank
    ``r``'s share of microbatch ``a`` (``pixel_values``, ``pixel_mask``,
    ``targets``); ``seek(a, r, per)`` returns rank ``r``'s generator placed
    where its microbatch ``a`` began (``per``: the draws of one share, -1
    before the first)."""

    def __call__(self, microbatches: Sequence[Sequence[dict]],
                 seek: Callable[[int, int, int], torch.Generator]
                 ) -> Dict[str, object]:
        params = list(self.params.items())
        acc = {n: torch.zeros_like(p) for n, p in params}
        total, per = 0.0, -1
        w_rel = self.m[WEIGHTS["loss_rel"]]
        for a, shares in enumerate(microbatches):
            nb = max(sum(int(tg["labels"].numel()) for mb in shares
                         for tg in mb["targets"]), 1)
            n_img = sum(len(mb["targets"]) for mb in shares)
            rel_grads = {n: torch.zeros_like(p) for n, p in params}
            rel_sum, rel_count = 0.0, 0
            for r, mb in enumerate(shares):
                gen = seek(a, r, per)
                start = gen.get_offset() if gen.device.type == "cuda" else 0
                out = self.model.forward(mb["pixel_values"],
                                         mb["pixel_mask"], train=True,
                                         gen=gen)
                if gen.device.type == "cuda":
                    per = gen.get_offset() - start
                rest, rel, cnt = share_terms(out, mb["targets"], self.m, nb,
                                             n_img)
                for p in self.params.values():
                    p.grad = None
                if torch.is_tensor(rel) and rel.requires_grad:
                    rel.backward(retain_graph=True)
                    for n, p in params:
                        if p.grad is not None:
                            rel_grads[n] += p.grad
                            p.grad = None
                rest.backward()
                for n, p in params:
                    if p.grad is not None:
                        acc[n] += p.grad
                total += float(rest.detach())
                rel_sum += float(rel.detach()) if torch.is_tensor(rel) else 0.0
                rel_count += cnt
                del out, rest, rel
            scale = w_rel / max(rel_count, 1)
            for n, _ in params:
                acc[n] += rel_grads[n] * scale
            total += rel_sum * scale
        A = len(microbatches)
        for p in self.params.values():
            p.grad = None
        grads = {n: g / A for n, g in acc.items()}
        grads, norm = adamw_update(self, grads)
        return {"loss": total / A, "grads": grads, "grad_norm": norm}
