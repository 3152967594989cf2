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
is absent), in one process on one device, so ``--dp`` and ``--mp`` other
than 1 are refused; ``--precompile`` is accepted and does nothing (the port
runs eager and compiles no program); ``--use_remat true`` is refused by the
model and ``--dataset open_images`` until its dataset is ported.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import torch

from .train_egtr import str2bool


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
    p.add_argument("--dp", type=int, default=None,
                   help="data-parallel devices: one here (DDP is not "
                        "ported)")
    p.add_argument("--mp", type=int, default=1,
                   help="model-parallel devices: one here")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--debug", type=str2bool, default=False)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--precompile", type=str2bool, default=True,
                   help="accepted for the JAX driver's surface; the port "
                        "compiles nothing ahead of time")
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
    from ..data.visual_genome import VGDataset
    from ..evaluation.runner import evaluate_detection, write_metrics
    from ..infer import resolve_device
    from ..models.detr import DeformableDetrBase
    from ..models.layers import init_params
    from ..train.checkpoint import merge_pretrained, save_pretrained
    from ..train.trainer import two_phase_fit
    from ..utils.convert import backbone_state_dict_from_timm

    args = parse_args(argv)
    if args.dataset != "visual_genome":
        raise NotImplementedError(
            "--dataset open_images needs data/open_images.py, which is not "
            "ported yet")
    if args.dp not in (None, 1) or args.mp != 1:
        raise NotImplementedError(
            f"--dp {args.dp} --mp {args.mp}: the port trains in one process "
            "on one device (multi-process training is not ported yet)")
    device = resolve_device(args.device)

    # detector pretraining uses the crop augmentor (pretrain_detr.py:267)
    train_ds = VGDataset(args.data_path, "train", train_aug=True,
                         use_crop=True, debug=args.debug, seed=args.seed)
    val_ds = VGDataset(args.data_path, "val")
    num_rel = len(train_ds.rel_categories)
    cfg = EgtrConfig(
        num_queries=args.num_queries, num_labels=train_ds.num_classes(),
        num_rel_labels=num_rel, auxiliary_loss=args.auxiliary_loss,
        ce_loss_coefficient=args.ce_loss_coefficient,
        max_gt_boxes=args.max_gt_boxes, compute_dtype=args.compute_dtype,
        use_remat=args.use_remat, remat_policy=args.remat_policy)

    train_loader = Loader(train_ds, args.batch_size * args.accumulate,
                          shuffle=True, max_gt=cfg.max_gt_boxes,
                          num_rel_labels=num_rel, drop_last=True,
                          seed=args.seed, num_workers=args.num_workers)
    val_loader = Loader(val_ds, args.batch_size, shuffle=False,
                        max_gt=cfg.max_gt_boxes, num_rel_labels=num_rel)

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
        task="detection", log_every=args.log_every, device=device)

    # export for train_egtr --pretrained (pretrain_detr.py:480-490), under
    # the EGTR model's scope so that merge_pretrained aligns the names
    save_pretrained(os.path.join(args.output_path, "artifact"), cfg,
                    {f"model.{k}": v for k, v in model.state_dict().items()})
    print("[pretrain_detr] artifact saved")

    # end-of-pretraining detection evaluation (pretrain_detr.py:500-542);
    # eval mode turns dropout off
    test_ds = VGDataset(args.data_path, "test", size=800, max_size=1333)
    test_loader = Loader(test_ds, 1, shuffle=False, max_gt=cfg.max_gt_boxes,
                         num_rel_labels=num_rel)
    metrics = evaluate_detection(
        model, cfg, test_loader,
        categories=sorted(test_ds.categories.keys()))
    write_metrics(metrics,
                  os.path.join(args.output_path, "metrics_test.json"))
    print("[pretrain_detr] done; test metrics written")
    return model


if __name__ == "__main__":
    main()
