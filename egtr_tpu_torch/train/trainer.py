"""Training loop: epochs, validation, early stopping, the two-phase schedule,
resume (PyTorch port of ``egtr_tpu/train/trainer.py``; the reference's
PyTorch-Lightning Trainer wiring, train_egtr.py:762-877).

- metrics stream to JSONL (the TensorBoardLogger analog);
- ``validation_loss`` = epoch mean of the eval step's total loss
  (train_egtr.py:339-348) drives checkpointing + early stopping (patience);
- the finetune phase re-runs the loop at 0.1x learning rates from the best
  main-phase checkpoint (train_egtr.py:790-870);
- relaunching with the same log_dir resumes from the latest checkpoint,
  with the optimizer's moments, the loop state and the generator's state.

The model is initialised from a ``torch.Generator`` seeded with ``seed``;
every train step draws its dropout masks from one generator on the model's
device, seeded with ``seed`` too, whose state the checkpoints carry. On the
card the train and eval steps run as captured programs, one per batch
signature (``train_step``, ``utils/aot.py``), as the JAX loop runs compiled
ones; each ``fit`` makes its own optimizer and steps, so the finetune phase
captures its own programs and never replays one that holds the main phase's
optimizer state, and a resume restores the checkpoint before the first step
captures. What the JAX loop has only for the TPU is left out: the warm-up
thread that compiles the eval program ahead (the first validation batch
captures it). The device mesh is the ranks' ``parallel.mesh.Mesh``
(``fit``'s ``mesh``).

Inside a process group (``parallel.dist``; the loaders hand each rank its
slice) the steps are data-parallel (``train_step``), and as in the JAX loop
only the primary rank writes ``metrics.jsonl`` and checkpoints; the others
wait at a barrier after each save and resume from the same checkpoint. The
validation losses are summed over the data group like the training losses,
so every rank takes the same best-checkpoint and early-stopping decision.
Each rank seeds its step generator with ``seed + data_index`` (the first:
``seed``, as one process does; ``parallel.mesh``), so the data ranks draw
different dropout masks and the ranks of a model group, which compute one
batch slice together, draw the same masks and relation samples; a
checkpoint carries every rank's generator state.
"""

from __future__ import annotations

import json
import os
import time
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from ..config import EgtrConfig
from ..infer import resolve_device
from ..models.layers import init_params as init_model_params
from ..parallel import dist
from .checkpoint import CheckpointManager
from .optim import make_optimizer
from .train_step import make_eval_step, make_train_step, resolve_mesh


class MetricLogger:
    """Append-only JSONL metric stream (``<log_dir>/metrics.jsonl``),
    written by the primary rank only: every rank holds the same metrics."""

    def __init__(self, log_dir: str):
        self.primary = dist.is_primary()
        self.path = os.path.join(log_dir, "metrics.jsonl")
        if self.primary:
            os.makedirs(log_dir, exist_ok=True)

    def log(self, record: Dict) -> None:
        if not self.primary:
            return
        rec = {k: (float(v) if hasattr(v, "item") or isinstance(
            v, (int, float, np.floating)) else v) for k, v in record.items()}
        rec["time"] = time.time()
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def to_device(batch, device) -> dict:
    """A loader batch (a nested dict of numpy arrays) as tensors on
    ``device``."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    return torch.from_numpy(np.asarray(batch)).to(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _payload(model, optimizer, generator, best_val: float,
             epochs_no_improve: int, step: int) -> dict:
    """Checkpoint payload: the weights, the AdamW moments, and the loop
    state (``egtr_tpu/train/trainer.py:_payload``) with the generator's: one
    state, or in a process group the list of every rank's. Every rank calls
    it (the list is gathered); the primary saves it."""
    state = generator.get_state()
    return {"model": model.state_dict(),
            "optimizer": optimizer.adamw.state_dict()["state"],
            "loop": {"best_val": float(best_val),
                     "epochs_no_improve": int(epochs_no_improve),
                     "step": int(step)},
            "generator": (dist.all_gather_objects(state)
                          if dist.is_distributed() else state)}


def _reduced_mean(sums: Dict[str, float], n: int, device, mesh
                  ) -> Dict[str, float]:
    """Per-key sums over ``n`` batches as means, the sums first added over
    the data group (each data rank holds its share of every batch's
    loss)."""
    if mesh is None or mesh.dp == 1:
        return {k: v / max(n, 1) for k, v in sums.items()}
    total = dist.all_reduce_sum(torch.tensor(
        list(sums.values()), dtype=torch.float64, device=device),
        mesh.data_group)
    return {k: v / max(n, 1) for k, v in zip(sums, total.tolist())}


def fit(model, cfg: EgtrConfig, *, train_loader, val_loader, log_dir: str,
        task: str = "sgg", lr: float = 2e-6, lr_backbone: float = 2e-7,
        lr_initialized: Optional[float] = 2e-4, weight_decay: float = 1e-4,
        grad_clip: float = 0.1, max_epochs: int = 50, patience: int = 15,
        accum_steps: int = 1, init_params=None, seed: int = 42,
        log_every: int = 50, lr_scale: float = 1.0, initialized_paths=None,
        device=None, mesh=None):
    """Run one training phase on ``device`` (default: the card); returns
    the model with the last state's weights (the best is on disk).

    ``init_params``: a ``state_dict`` to start from; None initialises the
    model from ``torch.Generator().manual_seed(seed)``.
    ``initialized_paths``: freshly initialized parameter paths from
    ``merge_pretrained``; they form the ``lr_initialized`` group (reference
    train_egtr.py:426-467); None keeps the relation-head heuristic
    (``optim.param_label``). Train records carry ``step_seconds``, the host
    time of the step until its metrics reached the host. In a process group
    ``device`` is the rank's (``dist.init_from_env``) and every rank calls
    ``fit`` with its own loaders (its data rank's slices); ``mesh``: the
    ranks' layout (``train_step.resolve_mesh``)."""
    device = resolve_device(device)
    logger = MetricLogger(log_dir)
    if init_params is None:
        init_model_params(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(init_params, strict=True)
    model.to(device)
    optimizer = make_optimizer(model, lr, lr_backbone, lr_initialized,
                               weight_decay, grad_clip,
                               initialized_paths=initialized_paths)
    rank = dist.process_index()
    mesh = resolve_mesh(model, mesh)
    generator = torch.Generator(device=device).manual_seed(
        seed + (mesh.data_index if mesh is not None else 0))
    ckpt = CheckpointManager(os.path.join(log_dir, "checkpoints"))
    train_step = make_train_step(model, cfg, optimizer, task=task,
                                 accum_steps=accum_steps, mesh=mesh)
    eval_step = make_eval_step(model, cfg, task=task, mesh=mesh)

    best_val = float("inf")
    epochs_no_improve = 0
    start_epoch = 0
    step = 0
    latest = ckpt.latest_step()
    if latest is not None:
        payload = ckpt.restore(latest, map_location=device)
        model.load_state_dict(payload["model"], strict=True)
        state = optimizer.adamw.state_dict()
        state["state"] = payload["optimizer"]
        optimizer.adamw.load_state_dict(state)
        state = payload["generator"]
        if isinstance(state, list):  # saved by a data-parallel run
            state = state[rank % len(state)]
        generator.set_state(state.cpu())
        best_val = payload["loop"]["best_val"]
        epochs_no_improve = payload["loop"]["epochs_no_improve"]
        step = payload["loop"]["step"]
        start_epoch = latest
        if dist.is_primary():
            print(f"[trainer] resumed from epoch {latest} "
                  f"(best_val={best_val:.4f}, "
                  f"epochs_no_improve={epochs_no_improve})")

    for epoch in range(start_epoch, max_epochs):
        t0 = time.time()
        n_steps = 0
        for batch in train_loader:
            t_step = time.perf_counter()
            metrics = train_step(to_device(batch, device), generator,
                                 lr_scale)
            n_steps += 1
            step += 1
            if n_steps % log_every == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                logger.log({"phase": "train", "epoch": epoch, "step": step,
                            **metrics,
                            "step_seconds": time.perf_counter() - t_step})

        # validation: epoch-mean losses (train_egtr.py:339-348)
        val_sums: Dict[str, float] = {}
        val_n = 0
        for batch in val_loader:
            _, losses = eval_step(to_device(batch, device))
            for k, v in losses.items():
                val_sums[k] = val_sums.get(k, 0.0) + float(v)
            val_n += 1
        val = {f"validation_{k}": v for k, v in
               _reduced_mean(val_sums, val_n, device, mesh).items()}
        val_loss = val.get("validation_total_loss", float("inf"))
        _sync(device)
        logger.log({"phase": "val", "epoch": epoch, **val,
                    "train_steps": n_steps,
                    "epoch_seconds": time.time() - t0})
        if dist.is_primary():
            print(f"[trainer] epoch {epoch}: validation_loss={val_loss:.4f} "
                  f"({time.time() - t0:.0f}s, {n_steps} steps)")

        if val_loss < best_val:
            best_val = val_loss
            epochs_no_improve = 0
        else:
            epochs_no_improve += 1

        ckpt.save(epoch + 1, _payload(model, optimizer, generator, best_val,
                                      epochs_no_improve, step),
                  metrics={"validation_loss": val_loss})

        if epochs_no_improve >= patience:
            if dist.is_primary():
                print(f"[trainer] early stop at epoch {epoch} "
                      f"(patience {patience})")
            break

    return model


def two_phase_fit(model, cfg: EgtrConfig, *, log_dir: str,
                  lr: float, lr_backbone: float,
                  lr_initialized: Optional[float],
                  max_epochs: int, max_epochs_finetune: int,
                  finetune_scale: float = 0.1, **kw):
    """Main phase then finetune at scaled learning rates from the best main
    checkpoint, with a fresh optimizer (train_egtr.py:790-870)."""
    init_params = kw.pop("init_params", None)
    model = fit(model, cfg, log_dir=os.path.join(log_dir, "main"),
                lr=lr, lr_backbone=lr_backbone,
                lr_initialized=lr_initialized, max_epochs=max_epochs,
                init_params=init_params, **kw)

    # restore the best main-phase weights
    main_ckpt = CheckpointManager(os.path.join(log_dir, "main",
                                               "checkpoints"))
    best = main_ckpt.best_step()
    if best is not None:
        params = main_ckpt.restore(best, map_location="cpu")["model"]
        if dist.is_primary():
            print(f"[trainer] finetune from best main epoch {best}")
    else:
        warnings.warn(
            "two_phase_fit: no best main-phase checkpoint found (metrics "
            "missing from the checkpoint manager?); finetuning from the "
            "LAST main-phase state instead of the best one")
        params = {k: v.detach().clone() for k, v in model.state_dict().items()}

    return fit(model, cfg, log_dir=os.path.join(log_dir, "finetune"),
               lr=lr, lr_backbone=lr_backbone,
               lr_initialized=lr_initialized, max_epochs=max_epochs_finetune,
               init_params=params, lr_scale=finetune_scale, **kw)
