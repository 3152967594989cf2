"""EGTR scene-graph training driver (PyTorch port of the repo's
``scripts/train_egtr.py``).

The argparse surface, defaults and flow of the reference ``train_egtr.py``
(train_egtr.py:488-569, 762-877): dataset + fg_matrix -> detector weights ->
EGTR fine-tune at lr 2e-6 / 2e-7 / 2e-4 with gradient accumulation and early
stopping, then a finetune phase at 0.1x, ``save_pretrained``, and the
end-of-training SGG + COCO evaluation of the test split into
``metrics_test.json``.

    python -m egtr_tpu_torch.scripts.train_egtr --data_path DIR \
        --output_path DIR [--from_scratch true] [--batch_size 4] \
        [--accumulate 2] [--max_epochs 50] [--device cpu] ...

It runs on the GPU unless ``--device cpu`` is given (and raises where CUDA
is absent), in one process on one device. ``--dataset open_images`` is
refused until its dataset and evaluator are ported; ``--use_remat true`` is
refused by the model. ``EGTR_MSDA_BATCH_P=1`` sends every exact MSDA forward
through the batched-P kernel, as in the JAX package.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import torch


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser()
    # architecture / data (train_egtr.py:489-528)
    p.add_argument("--data_path", required=True)
    p.add_argument("--dataset", choices=["visual_genome", "open_images"],
                   default="visual_genome")
    p.add_argument("--output_path", required=True)
    p.add_argument("--pretrained", default=None,
                   help="path to a save_pretrained detector artifact")
    p.add_argument("--from_scratch", type=str2bool, default=False)
    p.add_argument("--backbone_dirpath", default=None,
                   help="dir holding {backbone}.pt — a raw timm ResNet-50 "
                        "state dict loaded into model.backbone when "
                        "training from scratch (reference "
                        "train_egtr.py:255-260)")
    p.add_argument("--num_queries", type=int, default=200)
    p.add_argument("--auxiliary_loss", type=str2bool, default=False)
    # loss coefficients (train_egtr.py:514-527)
    p.add_argument("--ce_loss_coefficient", type=float, default=2.0)
    p.add_argument("--rel_loss_coefficient", type=float, default=15.0)
    p.add_argument("--connectivity_loss_coefficient", type=float, default=30.0)
    p.add_argument("--smoothing", type=float, default=1e-14)
    p.add_argument("--rel_sample_negatives", type=int, default=80)
    p.add_argument("--rel_sample_nonmatching", type=int, default=80)
    p.add_argument("--rel_sample_negatives_largest", type=str2bool,
                   default=True)
    p.add_argument("--rel_sample_nonmatching_largest", type=str2bool,
                   default=True)
    p.add_argument("--use_freq_bias", type=str2bool, default=True)
    p.add_argument("--use_log_softmax", type=str2bool, default=False)
    p.add_argument("--freq_bias_eps", type=float, default=1e-12)
    p.add_argument("--logit_adjustment", type=str2bool, default=False)
    p.add_argument("--logit_adj_tau", type=float, default=0.3)
    p.add_argument("--filter_duplicate_rels", type=str2bool, default=True)
    p.add_argument("--filter_multiple_rels", type=str2bool, default=True)
    # optimization (train_egtr.py:529-539)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--accumulate", type=int, default=2)
    p.add_argument("--lr", type=float, default=2e-6)
    p.add_argument("--lr_backbone", type=float, default=2e-7)
    p.add_argument("--lr_initialized", type=float, default=2e-4)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--gradient_clip_val", type=float, default=0.1)
    p.add_argument("--max_epochs", type=int, default=50)
    p.add_argument("--max_epochs_finetune", type=int, default=25)
    p.add_argument("--patience", type=int, default=15)
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--use_remat", type=str2bool, default=False)
    p.add_argument("--remat_policy", default="dots",
                   choices=["full", "dots"])
    # opt-in approximate MSDA (exact by default)
    p.add_argument("--msda_window", type=int, default=0,
                   help="banded MSDA window (0 = exact)")
    p.add_argument("--msda_band", default="tile",
                   choices=["tile", "point"],
                   help="band granularity: per query tile or per "
                        "sampling point")
    p.add_argument("--msda_int8", type=str2bool, default=False)
    p.add_argument("--max_gt_boxes", type=int, default=64)
    p.add_argument("--max_gt_rels", type=int, default=192)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--debug", type=str2bool, default=False)
    p.add_argument("--seed", type=int, default=42)
    # the port's own
    p.add_argument("--device", default=None,
                   help="default: cuda (raises where CUDA is absent)")
    p.add_argument("--log_every", type=int, default=50,
                   help="write a train record every N steps")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None):
    """Train, save the artifact, evaluate the test split; returns the
    trained model (in eval mode, on its device)."""
    from ..config import EgtrConfig
    from ..data.loader import Loader
    from ..data.visual_genome import VGDataset, vg_get_statistics
    from ..evaluation.runner import evaluate_sgg, write_metrics
    from ..infer import resolve_device
    from ..models.egtr import EgtrModel, compute_freq_dists
    from ..models.layers import init_params
    from ..train.checkpoint import (load_pretrained, merge_pretrained,
                                    save_pretrained)
    from ..train.trainer import two_phase_fit
    from ..utils.convert import backbone_state_dict_from_timm

    args = parse_args(argv)
    if args.dataset != "visual_genome":
        raise NotImplementedError(
            "--dataset open_images needs data/open_images.py and "
            "evaluation/oi_eval.py, which are not ported yet")
    device = resolve_device(args.device)

    train_ds = VGDataset(args.data_path, "train", train_aug=True,
                         debug=args.debug, seed=args.seed)
    val_ds = VGDataset(args.data_path, "val")
    fg_matrix = vg_get_statistics(train_ds)
    num_labels = train_ds.num_classes()
    num_rel = len(train_ds.rel_categories)

    cfg = EgtrConfig(
        num_queries=args.num_queries, num_labels=num_labels,
        num_rel_labels=num_rel, auxiliary_loss=args.auxiliary_loss,
        ce_loss_coefficient=args.ce_loss_coefficient,
        rel_loss_coefficient=args.rel_loss_coefficient,
        connectivity_loss_coefficient=args.connectivity_loss_coefficient,
        smoothing=args.smoothing,
        rel_sample_negatives=args.rel_sample_negatives,
        rel_sample_nonmatching=args.rel_sample_nonmatching,
        rel_sample_negatives_largest=args.rel_sample_negatives_largest,
        rel_sample_nonmatching_largest=args.rel_sample_nonmatching_largest,
        use_freq_bias=args.use_freq_bias,
        use_log_softmax=args.use_log_softmax,
        freq_bias_eps=args.freq_bias_eps,
        logit_adjustment=args.logit_adjustment,
        logit_adj_tau=args.logit_adj_tau,
        max_gt_boxes=args.max_gt_boxes, max_gt_rels=args.max_gt_rels,
        compute_dtype=args.compute_dtype, use_remat=args.use_remat,
        remat_policy=args.remat_policy, msda_window=args.msda_window,
        msda_band=args.msda_band, msda_int8=args.msda_int8)

    global_bs = args.batch_size * args.accumulate
    train_loader = Loader(train_ds, global_bs, shuffle=True,
                          max_gt=cfg.max_gt_boxes, drop_last=True,
                          num_rel_labels=num_rel, seed=args.seed,
                          num_workers=args.num_workers)
    val_loader = Loader(val_ds, args.batch_size, shuffle=False,
                        max_gt=cfg.max_gt_boxes, num_rel_labels=num_rel)

    model = EgtrModel(cfg)
    init_params(model, torch.Generator().manual_seed(args.seed))
    params = dict(model.state_dict())
    # frequency-bias buffers from train statistics (egtr.py:169-194)
    params["rel_dist"], params["triplet_dist"] = compute_freq_dists(
        fg_matrix, cfg.freq_bias_eps, cfg.use_log_softmax)

    # the lr_initialized optimizer group is exactly the set of freshly
    # initialized paths from the pretrained merge (reference
    # train_egtr.py:263-272,426-467); from scratch there is no such group
    initialized: List[str] = []
    if args.from_scratch:
        if args.backbone_dirpath:
            sd = torch.load(os.path.join(args.backbone_dirpath,
                                         f"{cfg.backbone}.pt"),
                            map_location="cpu", weights_only=True)
            params, _ = merge_pretrained(params,
                                         backbone_state_dict_from_timm(sd))
            print("[train_egtr] loaded backbone weights from "
                  f"{args.backbone_dirpath}")
    elif args.pretrained:
        _, loaded = load_pretrained(args.pretrained)
        params, initialized = merge_pretrained(params, loaded)
        print(f"[train_egtr] loaded pretrained detector; "
              f"{len(initialized)} freshly initialized param paths")

    model = two_phase_fit(
        model, cfg, log_dir=args.output_path,
        train_loader=train_loader, val_loader=val_loader,
        lr=args.lr, lr_backbone=args.lr_backbone,
        lr_initialized=args.lr_initialized,
        weight_decay=args.weight_decay, grad_clip=args.gradient_clip_val,
        max_epochs=args.max_epochs,
        max_epochs_finetune=args.max_epochs_finetune,
        patience=args.patience, accum_steps=args.accumulate,
        init_params=params, seed=args.seed, task="sgg",
        initialized_paths=initialized, log_every=args.log_every,
        device=device)

    save_pretrained(os.path.join(args.output_path, "artifact"), cfg,
                    model.state_dict())
    print("[train_egtr] artifact saved")

    # end-of-training test evaluation + metrics JSON next to the artifact
    # (reference train_egtr.py:879-935); eval mode turns dropout off
    test_ds = VGDataset(args.data_path, "test", size=800, max_size=1333)
    test_loader = Loader(test_ds, 1, shuffle=False,
                         max_gt=cfg.max_gt_boxes, num_rel_labels=num_rel)
    metrics = evaluate_sgg(model, cfg, test_loader, test_ds.rel_categories,
                           coco_eval=True,
                           categories=sorted(test_ds.categories.keys()))
    write_metrics(metrics,
                  os.path.join(args.output_path, "metrics_test.json"))
    print("[train_egtr] done; test metrics written")
    return model


if __name__ == "__main__":
    main()
