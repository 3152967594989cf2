"""What the serving modes share: the model built on the card from the seed,
the pool of host images, the request's packed answer unpacked, and the
output check against the plain reference.

The check covers every distinct answer of the window (one pool image's
answers repeat bit for bit). The reference runs on each answer's image
(float32, TF32 off) after the program's state is freed, its frequency bias
looked up at the classes the answer served (a bf16 near-tie may pick
another class than float32 would; the class is judged by its own number):

- ``boxes``: the largest gap of a query's box (normalised cxcywh);
- ``obj_scores``: the largest gap of a query's object score, over the
  reference's best;
- ``class_gap``: how far the reference's probability of the served class
  lies below its best class's, over its best score;
- ``triplet_gap`` / ``pair_gap``: at the answer's own object scores, how far
  the reference's score of the k-th served triplet / pair lies below its
  own k-th best, at the worst k, over its best (a served triplet that is
  not among the best shows here, whatever the order of near-ties);
- ``triplet_score`` / ``pair_vector``: the largest gap of a served
  triplet's score over the reference's best, and of a served pair's
  relation scores.

A traffic mix's ``limits`` name the numbers it compares.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from .reference.model import Reference, postprocess

TOP_K = 100
CHECKS = ("boxes", "obj_scores", "class_gap", "triplet_gap", "triplet_score",
          "pair_gap", "pair_vector")


def sub_seed(seed: int, what: str) -> int:
    """A 63-bit seed for one use (``what``) of the run's seed."""
    ss = np.random.SeedSequence([abs(int(seed)), sum(map(ord, what))])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


@contextlib.contextmanager
def float32_exact():
    """TF32 off for the reference; the switches restored afterwards (the
    program's captured signatures hold them)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def egtr_config(config: dict):
    from egtr_tpu_torch.config import EgtrConfig

    return EgtrConfig(**config["model"])


def build_model(config: dict, seed: int, device, setup, scheme: str):
    """The program's model in eval mode on ``device``, its parameters
    filled from ``seed`` on the device; and the float32 state handed to the
    reference (kept on the host)."""
    from egtr_tpu_torch.models.egtr import EgtrModel

    from .weights import fill_model

    cfg = egtr_config(config)
    with setup.part("weights"):
        with torch.device(device):
            model = EgtrModel(cfg)
        state = fill_model(model, sub_seed(seed, "weights"), cfg, scheme)
        if device.type == "cuda":
            torch.cuda.synchronize()
    with setup.exclude():
        host = {n: t.detach().to("cpu", copy=True) for n, t in state.items()}
    del state
    return cfg, model, host


def make_images(n: int, hw: Tuple[int, int], valid: Tuple[int, int],
                seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` images [n,H,W,3] of normal pixels in their valid area
    (``valid``, top-left) and zeros in the padding, with their masks, made
    on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    H, W = hw
    x = torch.randn((n, H, W, 3), generator=g, device=device)
    mask = torch.zeros((n, H, W), dtype=torch.bool, device=device)
    mask[:, :valid[0], :valid[1]] = True
    x.mul_(mask[..., None])
    return x, mask


def unpack(packed: torch.Tensor, B: int, Q: int, R: int, k: int = TOP_K
           ) -> Dict[str, torch.Tensor]:
    """``infer``'s packed float32 vector, as its docstring lays it out."""
    sizes = [("mult_inds", (B, k, 3)), ("mult_trip_scores", (B, k)),
             ("single_inds", (B, k, 2)), ("single_rel_vec", (B, k, R)),
             ("obj_scores", (B, Q)), ("pred_classes", (B, Q)),
             ("pred_boxes", (B, Q, 4))]
    out, at = {}, 0
    for name, shape in sizes:
        n = int(np.prod(shape))
        out[name] = packed[at:at + n].reshape(shape)
        at += n
    if at != packed.numel():
        raise ValueError(f"packed answer of {packed.numel()} values, "
                         f"expected {at}")
    return out


def reference_of(model: Reference, image, mask, classes, num_labels
                 ) -> Dict[str, torch.Tensor]:
    """The reference's boxes, class probabilities and relation scores of
    one image, its frequency bias looked up at ``classes`` [Q]."""
    o = model.forward(image, mask, classes=classes[None])
    rel = (o["pred_rel_logits"][0].sigmoid().clamp(0, 1)
           * o["pred_connectivity_logits"][0].sigmoid().clamp(0, 1))
    return {"boxes": o["pred_boxes"][0],
            "probs": o["logits"][0].softmax(-1)[:, :num_labels], "rel": rel}


def answer_of(model: Reference, image, mask, num_labels, k: int = TOP_K
              ) -> Dict[str, torch.Tensor]:
    """A reference's own answer to one image (the control's), as
    ``infer`` serves it: ``unpack``'s layout for a batch of one."""
    o = model.forward(image, mask)
    pp = postprocess(o, 0, num_labels)
    Q, R = pp["rel"].shape[0], pp["rel"].shape[-1]
    ts, ti = torch.topk(pp["trip"], k)
    _, pi = torch.topk(pp["pair"], k)
    return {"mult_inds": torch.stack([ti // (Q * R), (ti // R) % Q, ti % R],
                                     -1)[None].float(),
            "mult_trip_scores": ts[None],
            "single_inds": torch.stack([pi // Q, pi % Q], -1)[None].float(),
            "single_rel_vec": pp["rel"].reshape(-1, R)[pi][None],
            "obj_scores": pp["obj_scores"][None],
            "pred_classes": pp["pred_classes"][None].float(),
            "pred_boxes": pp["pred_boxes"][None]}


def compare(ans: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]
            ) -> Dict[str, float]:
    """The check's numbers for one image's answer (``unpack``'s layout, a
    batch of one) against the reference at the classes it served. The
    triplets and pairs are judged at the answer's own object scores (judged
    on their own by ``obj_scores``): the reference's relation scores times
    them rank the candidates."""
    a = {k: v[0].to(ref["rel"].device) for k, v in ans.items()}
    Q, R = ref["rel"].shape[0], ref["rel"].shape[-1]
    obj_ref = ref["probs"].max(-1).values
    cls = a["pred_classes"].long().clamp(0, ref["probs"].shape[1] - 1)
    served_prob = ref["probs"][torch.arange(Q, device=cls.device), cls]
    so = a["obj_scores"][:, None] * a["obj_scores"][None, :]
    so = so * (1 - torch.eye(Q, device=so.device))
    trip = (ref["rel"] * so[..., None]).reshape(-1)
    pair = (ref["rel"].amax(-1) * so).reshape(-1)
    k = a["mult_trip_scores"].shape[0]
    top = torch.topk(trip, k).values
    ptop = torch.topk(pair, k).values
    mi = a["mult_inds"].long()
    tidx = ((mi[:, 0] * Q + mi[:, 1]) * R + mi[:, 2]).clamp(0, Q * Q * R - 1)
    si = a["single_inds"].long()
    pidx = (si[:, 0] * Q + si[:, 1]).clamp(0, Q * Q - 1)
    best, pbest = float(top[0]), float(ptop[0])
    return {
        "boxes": float((a["pred_boxes"] - ref["boxes"]).abs().max()),
        "obj_scores": float((a["obj_scores"] - obj_ref).abs().max()
                            / obj_ref.max()),
        "class_gap": float((obj_ref - served_prob).max() / obj_ref.max()),
        "triplet_gap": float((top - trip[tidx]).max() / best),
        "triplet_score": float((a["mult_trip_scores"] - trip[tidx])
                               .abs().max() / best),
        "pair_gap": float((ptop - pair[pidx]).max() / pbest),
        "pair_vector": float((a["single_rel_vec"]
                              - ref["rel"].reshape(-1, R)[pidx]).abs().max()),
    }


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(r[k] for r in readings) for k in CHECKS}


def distinct_answers(runner) -> List[Tuple[int, Dict[str, torch.Tensor]]]:
    """(image, answer) of every distinct answer of the window, per image of
    each batch (equal answers are judged once)."""
    m = runner.spec.config["model"]
    Q, R = m["num_queries"], m["num_rel_labels"]
    seen, out = set(), []
    for i, packed in runner.answers:
        key = (i, packed.numpy().tobytes())
        if key in seen:
            continue
        seen.add(key)
        un = unpack(packed, runner.batch, Q, R)
        for b in range(runner.batch):
            out.append((i * runner.batch + b,
                        {k: v[b:b + 1] for k, v in un.items()}))
    return out


def judge(state, model_fields, images, masks, device, answers
          ) -> List[Dict[str, float]]:
    """Each (image, answer) judged by the float32 reference at the classes
    the answer served."""
    params = {n: t.to(device) for n, t in state.items()}
    model = Reference(params, model_fields)
    readings, cache = [], {}
    with float32_exact(), torch.no_grad():
        for i, ans in answers:
            classes = ans["pred_classes"][0].long().to(device)
            key = (i, classes.cpu().numpy().tobytes())
            if key not in cache:
                cache.clear()
                cache[key] = reference_of(model, images[i:i + 1].to(device),
                                          masks[i:i + 1].to(device), classes,
                                          model_fields["num_labels"])
            readings.append(compare(ans, cache[key]))
    return readings


def check_answers(runner) -> List[Tuple[str, float, float]]:
    """Every answer of the window against the reference: the worst reading
    of each number, beside its limit."""
    m = runner.spec.config["model"]
    readings = judge(runner.state, m, runner.host_x, runner.host_m,
                     runner.device, distinct_answers(runner))
    limits = runner.spec.traffic["limits"]
    w = worst(readings)
    return [(name, w[name], float(limits[name])) for name in limits]


def control_readings(state, model_fields, images, masks, device, quant
                     ) -> Dict[str, float]:
    """The control: the reference computed with ``quant`` in the program's
    place, its own answers judged as the program's are."""
    params = {n: t.to(device) for n, t in state.items()}
    low = Reference(params, model_fields, quant)
    with float32_exact(), torch.no_grad():
        answers = [(i, {k: v.cpu() for k, v in answer_of(
            low, images[i:i + 1].to(device), masks[i:i + 1].to(device),
            model_fields["num_labels"]).items()})
            for i in range(images.shape[0])]
    del low, params
    return worst(judge(state, model_fields, images, masks, device, answers))
