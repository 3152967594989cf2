"""Deformable-DETR detector pretraining driver (PyTorch port of the repo's
``scripts/pretrain_detr.py``, the reference's ``pretrain_detr.py``).

Visual Genome detection-only training of ``DeformableDetrBase`` with the crop
augmentor, at lr 1e-4 / 1e-5 with the auxiliary per-layer losses, a main and
a finetune (0.1x) phase (pretrain_detr.py:202-260); then the artifact,
exported under the EGTR model's scope so that ``train_egtr --pretrained``
merges it, and the COCO detection evaluation of the test split into
``metrics_test.json``.

    python -m egtr_tpu_torch.scripts.pretrain_detr --data_path DIR \
        --output_path DIR [--batch_size 4] [--accumulate 1] \
        [--max_epochs 150] [--backbone_dirpath DIR] [--device cpu] ...

It runs on the GPU unless ``--device cpu`` is given (and raises where CUDA
is absent); ``--precompile`` is accepted and does nothing (the port
captures each program at its first call, ``utils/aot.py``). Under ``torchrun --nproc_per_node N -m
egtr_tpu_torch.scripts.pretrain_detr`` it trains data-parallel, as
``train_egtr`` does (``--dp``, ``--mp`` and the loaders there). ``--dataset open_images`` pretrains on
Open Images V6 (no crop augmentation, as in the JAX driver) and evaluates
its test split's detections with the COCO protocol.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import torch

from ..parallel import dist
from .train_egtr import add_parallel_args, start_ranks, str2bool


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", required=True)
    p.add_argument("--dataset", choices=["visual_genome", "open_images"],
                   default="visual_genome")
    p.add_argument("--output_path", required=True)
    p.add_argument("--num_queries", type=int, default=200)
    p.add_argument("--backbone_dirpath", default=None,
                   help="dir holding {backbone}.pt — a raw timm ResNet-50 "
                        "state dict loaded into the backbone before "
                        "pretraining (reference pretrain_detr.py:72-74)")
    p.add_argument("--auxiliary_loss", type=str2bool, default=True)
    p.add_argument("--ce_loss_coefficient", type=float, default=2.0)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--accumulate", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr_backbone", type=float, default=1e-5)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--gradient_clip_val", type=float, default=0.1)
    p.add_argument("--max_epochs", type=int, default=150)
    p.add_argument("--max_epochs_finetune", type=int, default=50)
    p.add_argument("--patience", type=int, default=15)
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--use_remat", type=str2bool, default=False)
    p.add_argument("--remat_policy", default="dots",
                   choices=["full", "dots"])
    p.add_argument("--max_gt_boxes", type=int, default=64)
    add_parallel_args(p)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--debug", type=str2bool, default=False)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--precompile", type=str2bool, default=True,
                   help="accepted for the JAX driver's surface; the port "
                        "captures each program at its first call")
    # the port's own
    p.add_argument("--device", default=None,
                   help="default: cuda (raises where CUDA is absent)")
    p.add_argument("--log_every", type=int, default=50,
                   help="write a train record every N steps")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None):
    """Pretrain, export the artifact, evaluate the test split; returns the
    trained detector (in eval mode, on its device)."""
    from ..config import EgtrConfig
    from ..data.loader import Loader
    from ..data.open_images import OIDataset
    from ..data.visual_genome import VGDataset
    from ..evaluation.runner import evaluate_detection, write_metrics
    from ..models.detr import DeformableDetrBase
    from ..models.layers import init_params
    from ..train.checkpoint import merge_pretrained, save_pretrained
    from ..train.trainer import two_phase_fit
    from ..utils.convert import backbone_state_dict_from_timm

    args = parse_args(argv)
    device, mesh = start_ranks(args, "pretrain_detr")
    # the loaders' slices are the data ranks'; the detector has no relation
    # grid, so the ranks of a model group compute the same (as JAX's mesh)
    rank, world = mesh.data_index, mesh.dp

    if args.dataset == "visual_genome":
        # detector pretraining uses the crop augmentor (pretrain_detr.py:267)
        train_ds = VGDataset(args.data_path, "train", train_aug=True,
                             use_crop=True, debug=args.debug, seed=args.seed)
        val_ds = VGDataset(args.data_path, "val")
    else:
        train_ds = OIDataset(args.data_path, "train", train_aug=True,
                             num_object_queries=args.num_queries,
                             debug=args.debug, seed=args.seed)
        val_ds = OIDataset(args.data_path, "val")
    num_rel = len(train_ds.rel_categories)
    cfg = EgtrConfig(
        num_queries=args.num_queries, num_labels=train_ds.num_classes(),
        num_rel_labels=num_rel, auxiliary_loss=args.auxiliary_loss,
        ce_loss_coefficient=args.ce_loss_coefficient,
        max_gt_boxes=args.max_gt_boxes, compute_dtype=args.compute_dtype,
        use_remat=args.use_remat, remat_policy=args.remat_policy)

    global_bs = args.batch_size * mesh.dp * args.accumulate
    train_loader = Loader(train_ds, global_bs, shuffle=True,
                          max_gt=cfg.max_gt_boxes, num_rel_labels=num_rel,
                          drop_last=True, seed=args.seed,
                          num_workers=args.num_workers, process_index=rank,
                          process_count=world)
    val_loader = Loader(val_ds, global_bs // args.accumulate, shuffle=False,
                        max_gt=cfg.max_gt_boxes, num_rel_labels=num_rel,
                        process_index=rank, process_count=world)

    model = DeformableDetrBase(cfg)
    params = None
    if args.backbone_dirpath:
        # ImageNet backbone bootstrap (reference pretrain_detr.py:72-74)
        init_params(model, torch.Generator().manual_seed(args.seed))
        sd = torch.load(os.path.join(args.backbone_dirpath,
                                     f"{cfg.backbone}.pt"),
                        map_location="cpu", weights_only=True)
        params, _ = merge_pretrained(
            dict(model.state_dict()),
            backbone_state_dict_from_timm(sd, root="backbone"))
        print("[pretrain_detr] loaded backbone weights from "
              f"{args.backbone_dirpath}")

    model = two_phase_fit(
        model, cfg, log_dir=args.output_path,
        train_loader=train_loader, val_loader=val_loader,
        init_params=params, lr=args.lr, lr_backbone=args.lr_backbone,
        lr_initialized=None, weight_decay=args.weight_decay,
        grad_clip=args.gradient_clip_val, max_epochs=args.max_epochs,
        max_epochs_finetune=args.max_epochs_finetune,
        patience=args.patience, accum_steps=args.accumulate, seed=args.seed,
        task="detection", log_every=args.log_every, device=device,
        mesh=mesh)

    # export for train_egtr --pretrained (pretrain_detr.py:480-490), under
    # the EGTR model's scope so that merge_pretrained aligns the names
    save_pretrained(os.path.join(args.output_path, "artifact"), cfg,
                    {f"model.{k}": v for k, v in model.state_dict().items()})
    if dist.is_primary():
        print("[pretrain_detr] artifact saved")

    # end-of-pretraining detection evaluation (pretrain_detr.py:500-542);
    # eval mode turns dropout off
    if args.dataset == "visual_genome":
        test_ds = VGDataset(args.data_path, "test", size=800, max_size=1333)
        categories = sorted(test_ds.categories.keys())
    else:
        test_ds = OIDataset(args.data_path, "test", size=800, max_size=1333)
        categories = None
    test_loader = Loader(test_ds, world, shuffle=False,
                         max_gt=cfg.max_gt_boxes, num_rel_labels=num_rel,
                         process_index=rank, process_count=world)
    metrics = evaluate_detection(model, cfg, test_loader,
                                 categories=categories, mesh=mesh)
    write_metrics(metrics,
                  os.path.join(args.output_path, "metrics_test.json"))
    if dist.is_primary():
        print("[pretrain_detr] done; test metrics written")
    return model


if __name__ == "__main__":
    main()
    dist.shutdown()
