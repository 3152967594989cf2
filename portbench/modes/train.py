"""Training: the optimizer step of ``egtr_tpu_torch.train.train_step.
make_train_step`` (its captured microbatch and apply programs) on one
card's share of the published job, batch ``batch`` x ``accum``.

Set-up makes ``pool`` distinct batches on the card from the seed (images of
normal pixels in a valid area drawn with the recipe's resize, its mask, and
VG150-like targets padded to ``max_gt_boxes`` / ``max_gt_rels``), builds the
model, its optimizer and the step once, and drives that step through its
first ``warm_steps`` steps on batches 0, 1, 2 (the warm-up and the captures;
the steps the output check follows). The window then cycles the batches;
each step's metrics are read back to the host. Traffic parameters
(``workloads/<name>.json``): ``batch``, ``accum``, ``bucket_hw``,
``shortest``, ``longest``, ``aspect``, ``boxes``, ``rels``, ``pool``,
``warm_steps``, ``trace_units``, ``limits``.

The output check: the reference (``reference/train.py``, float32, TF32
off) follows the same three steps from the same weights, batches and
dropout masks (its CUDA generator set, for each microbatch, to the offset
at which the program's generator began it). It compares each step's loss,
the first gradient as the optimizer got it (from AdamW's first moment
after step 1: the clipped gradient times 1 - beta1), and each leaf's
change over the three steps; the two leaf numbers by the worst leaf, the
gap of the norms over the larger of the reference's norm of that leaf and
of the median leaf. Leaves whose reference gradient is under a thousandth
of the median leaf's move by round-off alone and are left out of the
change.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from portbench import serving
from portbench.reference.train import Step, param_label

BETA1 = 0.9


def draw_targets(rng, n_img: int, m: dict, boxes, rels) -> List[dict]:
    """Per image: class labels, normalised cxcywh boxes and a set of
    (subject, object, predicate) triples among them."""
    C, R = m["num_labels"], m["num_rel_labels"]
    out = []
    for _ in range(n_img):
        n = int(rng.integers(boxes[0], boxes[1] + 1))
        wh = rng.uniform(0.05, 0.4, (n, 2))
        cxy = rng.uniform(wh / 2, 1 - wh / 2)
        rel = np.zeros((n, n, R), np.float32)
        k = int(rng.integers(rels[0], min(rels[1], n * (n - 1)) + 1))
        pairs = set()
        while len(pairs) < k:
            s, o = rng.integers(0, n, 2)
            if s != o:
                pairs.add((int(s), int(o), int(rng.integers(0, R))))
        for s, o, p in pairs:
            rel[s, o, p] = 1.0
        out.append({"labels": rng.integers(0, C, n).astype(np.int64),
                    "boxes": np.concatenate([cxy, wh], 1).astype(np.float32),
                    "rel": rel})
    return out


def valid_size(rng, t: dict):
    """The recipe's resize of an image of a drawn aspect (landscape: the
    bucket's orientation): the short side to ``shortest`` unless the long
    side would pass ``longest``."""
    a = rng.uniform(*t["aspect"])
    h, w = t["shortest"], t["shortest"] * a
    if w > t["longest"]:
        h, w = t["longest"] / a, t["longest"]
    return int(round(h)), int(round(w))


def position(gen: torch.Generator):
    """A generator's place: its Philox offset on the card, its whole state
    elsewhere."""
    return gen.get_offset() if gen.device.type == "cuda" else gen.get_state()


class Runner:
    def __init__(self, spec, seed, device, setup):
        self.spec, self.seed, self.device, self.timer = spec, seed, device, setup
        t = spec.traffic
        self.B, self.A = int(t["batch"]), int(t["accum"])
        self.bucket = tuple(t["bucket_hw"])
        self.pool = int(t["pool"])
        self.warm = int(t["warm_steps"])
        self.m = spec.config["model"]
        self.recipe = spec.config["train"]
        self.program_state = {}
        self.k = 0
        self.losses: List[float] = []

    # -- inputs ------------------------------------------------------------
    def make_batches(self):
        t = self.spec.traffic
        m = self.m
        rng = np.random.default_rng(serving.sub_seed(self.seed, "targets"))
        n = self.pool * self.A * self.B
        sizes = [valid_size(rng, t) for _ in range(n)]
        targets = draw_targets(rng, n, m, t["boxes"], t["rels"])
        g = torch.Generator(device=self.device).manual_seed(
            serving.sub_seed(self.seed, "images"))
        H, W = self.bucket
        x = torch.randn((n, H, W, 3), generator=g, device=self.device)
        hs = torch.tensor([s[0] for s in sizes], device=self.device)
        ws = torch.tensor([s[1] for s in sizes], device=self.device)
        mask = ((torch.arange(H, device=self.device)[None, :, None]
                 < hs[:, None, None])
                & (torch.arange(W, device=self.device)[None, None, :]
                   < ws[:, None, None]))
        x.mul_(mask[..., None])
        G, Gr = m["max_gt_boxes"], m["num_rel_labels"]
        labels = np.zeros((n, G), np.int64)
        boxes = np.tile(np.array([0.5, 0.5, 1.0, 1.0], np.float32), (n, G, 1))
        nb = np.zeros((n,), np.int64)
        rel = np.zeros((n, G, G, Gr), np.float32)
        for i, tg in enumerate(targets):
            k = len(tg["labels"])
            labels[i, :k], boxes[i, :k], nb[i] = tg["labels"], tg["boxes"], k
            rel[i, :k, :k] = tg["rel"]
        dev = self.device
        lab = {"class_labels": torch.from_numpy(labels).to(dev),
               "boxes": torch.from_numpy(boxes).to(dev),
               "num_boxes": torch.from_numpy(nb).to(dev),
               "rel": torch.from_numpy(rel).to(dev)}
        self.batches, self.ref_batches = [], []
        per = self.A * self.B
        for b in range(self.pool):
            mbs, refs = [], []
            for a in range(self.A):
                # microbatch a of a step takes rows a::A, the program's split
                rows = [b * per + a + j * self.A for j in range(self.B)]
                idx = torch.tensor(rows, device=dev)
                mbs.append({"pixel_values": x[idx], "pixel_mask": mask[idx],
                            "labels": {k: v[idx] for k, v in lab.items()}})
                refs.append({"rows": rows,
                             "targets": [targets[r] for r in rows]})
            self.batches.append(mbs)
            self.ref_batches.append(refs)
        self.images, self.masks = x, mask

    # -- the step ----------------------------------------------------------
    def setup(self):
        from egtr_tpu_torch.models.egtr import EgtrModel
        from egtr_tpu_torch.ops import msda_cuda
        from egtr_tpu_torch.train.optim import make_optimizer
        from egtr_tpu_torch.train.train_step import make_train_step

        from portbench.weights import fill_model

        if self.device.type == "cuda":
            with self.timer.part("kernels"):
                msda_cuda.build()
        cfg = serving.egtr_config(self.spec.config)
        r = self.recipe
        with self.timer.part("weights"):
            with torch.device(self.device):
                model = EgtrModel(cfg)
            state = fill_model(model, serving.sub_seed(self.seed, "weights"),
                               cfg, self.spec.traffic["weights"])
        with self.timer.exclude():
            self.p0 = {n: t.detach().to("cpu", copy=True)
                       for n, t in state.items()}
        del state
        with self.timer.part("inputs"):
            self.make_batches()
        with self.timer.part("optimizer"):
            opt = make_optimizer(model, lr=r["lr"], lr_backbone=r["lr_backbone"],
                                 lr_initialized=r["lr_initialized"],
                                 weight_decay=r["weight_decay"],
                                 grad_clip=r["gradient_clip_val"])
        with self.timer.part("make_train_step"):
            step = make_train_step(model, cfg, opt, task="sgg",
                                   accum_steps=self.A)
            self.dropout_seed = serving.sub_seed(self.seed, "dropout")
            gen = torch.Generator(device=self.device).manual_seed(
                self.dropout_seed)
        self.program_state = {"model": model, "opt": opt, "step": step,
                              "gen": gen}
        self.offsets, self.warm_losses = [], []
        for s in range(self.warm):
            with self.timer.part("first_step" if s == 0 else "warm_steps"):
                before = position(gen)
                loss = self.step_once(record=False)
                after = position(gen)
            with self.timer.exclude():
                self.offsets.append((before, after))
                self.warm_losses.append(loss)
                if s == 0:
                    # a leaf the optimizer holds no moment for (it took no
                    # step) reads as a zero gradient
                    self.g1 = {}
                    for group in opt.adamw.param_groups:
                        for p in group["params"]:
                            st = opt.adamw.state.get(p)
                            self.g1[id(p)] = ((st["exp_avg"] / (1 - BETA1))
                                              .cpu() if st and "exp_avg" in st
                                              else torch.zeros(p.shape))
                    self.g1 = {n: self.g1[id(p)]
                               for n, p in model.named_parameters()
                               if id(p) in self.g1}
        with self.timer.exclude():
            self.p3 = {n: p.detach().to("cpu", copy=True)
                       for n, p in model.named_parameters()}

    def step_once(self, record=True):
        step, gen = self.program_state["step"], self.program_state["gen"]
        batch = self.batches[self.k % self.pool]
        self.k += 1
        rf = torch.profiler.record_function
        with rf("replay"):
            metrics = step(batch, gen)
        with rf("metrics_readback"):
            keys = sorted(metrics)
            values = torch.stack([metrics[k].float() for k in keys]).cpu()
        loss = float(values[keys.index("total_loss")])
        if record:
            self.losses.append(loss)
        return loss

    def unit(self):
        self.step_once()
        return self.A * self.B

    def drain(self):
        return 0

    def end_to_end(self, window_s, images, units):
        return {"train_images_per_s": images / window_s}

    def slice_info(self):
        from portbench import flops

        return {"batch": self.B, "hw": self.bucket, "train": True,
                "steps_per_unit": 1, "forwards_per_unit": self.A,
                "images_per_unit": self.A * self.B,
                "flops_per_image": flops.step_flops(self.m, self.bucket, 1,
                                                    True),
                "model": self.m}

    def failed(self):
        return sum(1 for x in self.losses if not math.isfinite(x))

    # -- the output check --------------------------------------------------
    def reference_steps(self, quant=None, transform=None):
        """The reference's three steps: (losses, first gradient by leaf,
        change by leaf). ``quant``: the control's rounding; ``transform``:
        a fault planted in the microbatches."""
        dev = self.device
        gen = torch.Generator(device=dev)
        params = {n: t.to(dev) for n, t in self.p0.items()}
        step = Step(params, self.m, self.recipe, quant)
        del params
        losses, g1 = [], None
        with serving.float32_exact():
            for s in range(self.warm):
                mbs = []
                for ref in self.ref_batches[s]:
                    rows = ref["rows"]
                    mbs.append({
                        "pixel_values": self.images[rows],
                        "pixel_mask": self.masks[rows],
                        "targets": [{k: torch.as_tensor(v, device=dev)
                                     for k, v in tg.items()}
                                    for tg in ref["targets"]]})
                if transform is not None:
                    mbs = transform(mbs)
                out = step(mbs, gen, self.seeker(s, gen, transform is None))
                losses.append(out["loss"])
                if s == 0:
                    # the gradient as the optimizer got it, after the clip
                    g1 = {n: g.cpu() for n, g in out["grads"].items()
                          if param_label(n) != "frozen"}
        change = {n: (p.detach().cpu() - self.p0[n])
                  for n, p in step.params.items()}
        return losses, g1, change

    def seeker(self, s, gen, strict=True):
        """Positions the reference's generator where the program's stood as
        each microbatch of step ``s`` began. On the card (Philox, counted
        by offsets): the first at the step's start, each later one its
        draws before the step's end, since a capture between them may move
        the generator; a step without a capture must have moved it by its
        microbatches' draws alone. On the CPU (every call eager): the
        step's starting state, the microbatches drawing in turn."""
        before, after = self.offsets[s]

        def seek(a, per):
            if gen.device.type != "cuda":
                if a == 0:
                    gen.set_state(before)
                return
            if a == 0:
                gen.manual_seed(self.dropout_seed)
                gen.set_offset(before)
                return
            if strict and s > 0 and after - before != per * self.A:
                raise RuntimeError(
                    f"step {s + 1}: the program's generator moved "
                    f"{after - before}, the reference draws {per} a "
                    "microbatch")
            gen.set_offset(after - per * (self.A - a))

        return seek

    def check(self):
        losses, g1, change = self.reference_steps()
        prog_change = {n: self.p3[n] - self.p0[n] for n in self.p0}
        return compare_steps(self.spec.traffic["limits"],
                             (self.warm_losses, self.g1, prog_change),
                             (losses, g1, change))


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              names) -> np.ndarray:
    """Each leaf's gap of norms over the larger of the reference's norm of
    that leaf and of the median leaf."""
    pn = np.array([float(prog[n].double().norm()) for n in names])
    rn = np.array([float(ref[n].double().norm()) for n in names])
    return np.abs(pn - rn) / np.maximum(rn, np.median(rn))


def step_numbers(side, ref) -> Dict[str, float]:
    """The numbers of ``side`` (the program, or the control in its place)
    against the reference, each given as (losses of the steps, first
    gradient by trainable leaf, change by leaf): ``loss`` (largest relative
    gap of a step's loss) and ``loss1`` (the first step's), ``grad1`` and
    ``change3`` by the worst leaf, ``grad1_median`` and ``change3_median``
    by the median leaf."""
    losses, g1, change = side
    ref_losses, ref_g1, ref_change = ref
    if set(g1) != set(ref_g1):
        raise RuntimeError("the program's trainable leaves are not the "
                           f"reference's: {sorted(set(g1) ^ set(ref_g1))}")
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    names = sorted(ref_g1)
    grad = leaf_gaps(g1, ref_g1, names)
    norms = np.array([float(ref_g1[n].double().norm()) for n in names])
    moved = [n for n, v in zip(names, norms) if v >= 1e-3 * np.median(norms)]
    change3 = leaf_gaps(change, ref_change, moved)
    return {"loss": max(gaps), "loss1": gaps[0],
            "grad1": float(grad.max()), "grad1_median": float(np.median(grad)),
            "change3": float(change3.max()),
            "change3_median": float(np.median(change3))}


def compare_steps(limits, side, ref):
    """The numbers a traffic mix's ``limits`` name, beside their limits."""
    got = step_numbers(side, ref)
    return [(name, got[name], float(lim)) for name, lim in limits.items()]
