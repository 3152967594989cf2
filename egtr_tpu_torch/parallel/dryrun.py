"""``dryrun_multichip``: one training step in several ranks on the JAX dry
run's mesh (the port's counterpart of ``__graft_entry__.dryrun_multichip``
and ``_check_multihost_pipeline``).

    python -m egtr_tpu_torch.parallel.dryrun 2 [--device cpu]

It starts ``n`` ranks (``launch.spawn``: torchrun, with a timeout) and
takes one full training step at the JAX dry run's tiny config (d_model 64,
2+2 layers, 16 queries, 12/6 labels, dropout 0.1) and layout: ``mp = 2``
where ``n`` is even, else 1, and ``dp = n / mp`` (``__graft_entry__.py``),
so 2 ranks are dp 1 x mp 2 and 4 are dp 2 x mp 2, each data rank with two
64x64 images of a seeded global batch and the ranks of a model group
splitting its relation grid. Then, in the same ranks, it checks the
multi-process contracts: the loaders' per-rank slices concatenate to the
one-process loader's global batch, and the SGG evaluator merged across the
ranks (``runner._merge_across_hosts``) aggregates to what one evaluator of
every image does. It prints ``total_loss`` and ``grad_norm`` and returns
rank 0's result (also its backend and MSDA kernel launches). It runs on the
card unless ``device="cpu"``, under NCCL where every rank has a card of its
own, else under gloo (the ranks share the cards). One rank that fails fails
the call.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Optional

import numpy as np
import torch

from ..config import EgtrConfig
from . import dist
from .launch import spawn

TIMEOUT_S = 600.0


def tiny_config() -> EgtrConfig:
    """``__graft_entry__.dryrun_multichip``'s model."""
    return EgtrConfig(
        d_model=64, encoder_layers=2, decoder_layers=2, encoder_ffn_dim=128,
        decoder_ffn_dim=128, num_queries=16, num_labels=12, num_rel_labels=6,
        max_gt_boxes=4, max_gt_rels=8, dropout=0.1)


def global_batch(cfg: EgtrConfig, B: int, H: int = 64, W: int = 64) -> dict:
    """The JAX dry run's batch: numpy draws from seed 0."""
    rng = np.random.default_rng(0)
    G, R = cfg.max_gt_boxes, cfg.num_rel_labels
    return {
        "pixel_values": rng.standard_normal((B, H, W, 3)).astype(np.float32),
        "pixel_mask": np.ones((B, H, W), bool),
        "labels": {
            "class_labels": rng.integers(0, cfg.num_labels,
                                         (B, G)).astype(np.int32),
            "boxes": rng.uniform(0.3, 0.6, (B, G, 4)).astype(np.float32),
            "num_boxes": np.full((B,), 3, np.int32),
            "rel": (rng.uniform(size=(B, G, G, R)) < 0.02).astype(
                np.float32),
        },
    }


def _slice(tree, lo: int, hi: int):
    if isinstance(tree, dict):
        return {k: _slice(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi]


def _step(device) -> dict:
    from ..models.egtr import EgtrModel
    from ..models.layers import init_params
    from ..ops import msda_cuda
    from ..train.optim import make_optimizer
    from ..train.trainer import to_device
    from ..train.train_step import make_train_step
    from .mesh import make_mesh

    rank, world = dist.process_index(), dist.process_count()
    mp = 2 if world % 2 == 0 else 1
    mesh = make_mesh(world // mp, mp)
    d = mesh.data_index
    cfg = tiny_config()
    model = EgtrModel(cfg, mesh=mesh)
    init_params(model, torch.Generator().manual_seed(0))
    model.to(device)
    optimizer = make_optimizer(model, lr=2e-6, lr_backbone=2e-7,
                               lr_initialized=2e-4)
    step = make_train_step(model, cfg, optimizer, task="sgg")
    batch = _slice(global_batch(cfg, 2 * mesh.dp), 2 * d, 2 * d + 2)
    generator = torch.Generator(device=device).manual_seed(1 + d)
    msda_cuda.reset_launches()
    metrics = {k: float(v) for k, v in
               step(to_device(batch, device), generator).items()}
    launches = dict(msda_cuda.launches)
    if not (np.isfinite(metrics["total_loss"])
            and np.isfinite(metrics["grad_norm"])):
        raise RuntimeError(f"rank {rank}: non-finite metrics {metrics}")
    params = torch.cat([p.detach().flatten().double().cpu()
                        for p in model.parameters()])
    return {"metrics": metrics, "param_sum": float(params.sum()),
            "param_abs_sum": float(params.abs().sum()),
            "backend": torch.distributed.get_backend(), "launches": launches,
            "mesh": [mesh.dp, mesh.mp]}


class _Images:
    """Four 32x48 noise images with one box each (the JAX check's set)."""

    def __len__(self):
        return 4

    def __getitem__(self, i):
        from ..data.transforms import Sample

        rng = np.random.default_rng(i)
        return Sample(
            image=rng.standard_normal((32, 48, 3)).astype(np.float32),
            boxes=np.array([[0.4, 0.4, 0.2, 0.2]], np.float32),
            class_labels=np.array([1], np.int32),
            rel=np.zeros((0, 3), np.int32),
            orig_size=(32, 48), size=(32, 48), image_id=i)

    def nominal_size(self, i):
        return (32, 48)


def _pipeline() -> dict:
    """The loader shards and the evaluator merge, across the ranks."""
    from ..data.loader import Loader
    from ..evaluation.runner import _merge_across_hosts
    from ..evaluation.sg_eval import SceneGraphEvaluator

    rank, world = dist.process_index(), dist.process_count()
    kw = dict(batch_size=2 * world, shuffle=True, max_gt=2,
              num_rel_labels=3, buckets=((32, 48),), seed=0, prefetch=0)
    full = [b["image_id"].tolist() for b in Loader(_Images(), **kw)]
    mine = [b["image_id"].tolist() for b in Loader(
        _Images(), process_index=rank, process_count=world, **kw)]
    parts = dist.all_gather_objects(mine)
    shards_ok = all(sum((p[b] for p in parts), []) == full[b]
                    for b in range(len(full)))

    # image i is rank (i % world)'s, as a one-image-a-rank loader deals
    everyone, merged = SceneGraphEvaluator(), SceneGraphEvaluator()
    marks = [[]]
    rng = np.random.default_rng(0)
    for i in range(6 * world):
        b = rng.uniform(0, 20, (2, 4))
        b[:, 2:] = b[:, :2] + 10
        gt = {"gt_relations": np.array([[0, 1, 0]]), "gt_boxes": b,
              "gt_classes": np.array([1, 2])}
        pred = {"pred_boxes": b, "pred_classes": np.array([1, 2]),
                "obj_scores": np.array([0.9, 0.8]),
                "pred_rel_inds": np.array([[0, 1]]),
                "rel_scores": rng.uniform(0, 1, (1, 3))}
        everyone.evaluate_entry(gt, pred, image_id=i)
        if i % world == rank:
            merged.evaluate_entry(gt, pred, image_id=i)
        if i % world == world - 1:
            marks[0].append(merged.num_images())
    _merge_across_hosts([merged], marks)
    merge_ok = (merged.state() == everyone.state()
                and merged.aggregate() == everyone.aggregate())
    return {"shards_ok": shards_ok, "merge_ok": merge_ok}


def rank_main(device) -> dict:
    """One rank of the dry run (``launch.spawn``'s target)."""
    return {**_step(device), **_pipeline()}


def dryrun_multichip(n_devices: int, device=None,
                     timeout: float = TIMEOUT_S) -> dict:
    """Run the dry run in ``n_devices`` ranks; returns rank 0's result.
    Raises where a rank fails or the ranks disagree."""
    from ..infer import resolve_device

    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as work:
        results = spawn("egtr_tpu_torch.parallel.dryrun:rank_main",
                        n_devices, workdir=work, device=dev.type,
                        timeout=timeout,
                        threads=1 if dev.type == "cpu" else None)
    first = results[0]
    if any(r != first for r in results[1:]):
        raise RuntimeError(f"dryrun_multichip: the ranks disagree: "
                           f"{results}")
    if not (first["shards_ok"] and first["merge_ok"]):
        raise RuntimeError(f"dryrun_multichip: {first}")
    m = first["metrics"]
    dp, mp = first["mesh"]
    print(f"dryrun_multichip({n_devices}): world={n_devices} (data="
          f"{dp}, model={mp}) on {dev.type} ({first['backend']}) "
          f"total_loss={m['total_loss']:.4f} "
          f"grad_norm={m['grad_norm']:.4f} OK")
    print("multi-process loader shard + metric merge OK")
    return first


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("n_devices", type=int, nargs="?", default=2)
    p.add_argument("--device", default=None,
                   help="default: cuda (raises where CUDA is absent)")
    args = p.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    main()
