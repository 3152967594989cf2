"""Checkpoints and artifacts (PyTorch port of ``egtr_tpu/train/checkpoint.py``).

The format is the port's own: ``torch.save`` of plain dicts of tensors. A
training checkpoint is a directory ``<directory>/<step>/`` with the payload
(``payload.pt``: the model's ``state_dict``, the optimizer's AdamW moments
and step counts, the loop state and the ``torch.Generator`` state) and its
metrics (``metrics.json``). An artifact is ``config.json`` beside the
model's ``state_dict`` (``weights.pt``), the counterpart of HF's
``save_pretrained``.

Retention is orbax's, as the JAX package configures it
(``CheckpointManagerOptions(max_to_keep=3, best_fn=-validation_loss,
keep_checkpoints_without_metrics=True)``, orbax's ``BestN`` policy): after
each save the checkpoints are ranked by ``best_fn`` (a stable sort in step
order, so the later of two equal metrics ranks higher) and all but the
``max_to_keep`` best are deleted, the newest among them if it ranks low;
``latest_step`` is the highest step kept and ``best_step`` the best-ranked.
So after epochs without improvement the latest kept step can lie behind the
last epoch run, and a relaunch resumes from there, as the JAX package does.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from ..config import EgtrConfig

PAYLOAD = "payload.pt"
METRICS = "metrics.json"
WEIGHTS = "weights.pt"


def _best_fn(metrics: Mapping[str, float]) -> float:
    """The JAX package's ``best_fn``: higher is better."""
    return -metrics.get("validation_loss", float("inf"))


class CheckpointManager:
    """Numbered checkpoints under ``directory`` with orbax's retention."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.exists(
                          os.path.join(self.directory, name, METRICS)))

    def _metrics(self, step: int) -> Dict[str, float]:
        with open(os.path.join(self.directory, str(step), METRICS)) as f:
            return json.load(f)

    def _ranked(self) -> List[int]:
        """Steps from worst to best by ``best_fn``, stable in step order."""
        return sorted(self.all_steps(),
                      key=lambda s: _best_fn(self._metrics(s)))

    def save(self, step: int, payload: Dict[str, Any],
             metrics: Optional[dict] = None) -> None:
        """Write ``payload`` as step ``step`` with its metrics, then delete
        what the retention rule drops. Steps must rise."""
        latest = self.latest_step()
        if latest is not None and step <= latest:
            raise ValueError(f"step {step} is not above the latest "
                             f"checkpoint, step {latest}")
        final = os.path.join(self.directory, str(step))
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, PAYLOAD))
        # the metrics file marks a complete checkpoint: written last
        with open(os.path.join(tmp, METRICS), "w") as f:
            json.dump({k: float(v) for k, v in (metrics or {}).items()}, f)
        os.replace(tmp, final)
        ranked = self._ranked()
        for old in ranked[:max(len(ranked) - self.max_to_keep, 0)]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore(self, step: Optional[int] = None,
                map_location=None) -> Optional[Dict[str, Any]]:
        """The payload of ``step`` (the latest by default), or None when
        there is no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(os.path.join(self.directory, str(step), PAYLOAD),
                          map_location=map_location, weights_only=True)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        ranked = self._ranked()
        return ranked[-1] if ranked else None


def save_pretrained(directory: str, cfg: EgtrConfig,
                    state_dict: Mapping[str, torch.Tensor]) -> None:
    """config.json + the model's weights (pretrain_detr.py:480-490)."""
    os.makedirs(directory, exist_ok=True)
    cfg.save(os.path.join(directory, "config.json"))
    torch.save({k: v.detach() for k, v in state_dict.items()},
               os.path.join(directory, WEIGHTS))


def load_pretrained(directory: str, map_location="cpu"
                    ) -> Tuple[EgtrConfig, Dict[str, torch.Tensor]]:
    """Returns (cfg, state_dict), the tensors on ``map_location``."""
    cfg = EgtrConfig.load(os.path.join(directory, "config.json"))
    state_dict = torch.load(os.path.join(directory, WEIGHTS),
                            map_location=map_location, weights_only=True)
    return cfg, state_dict


def merge_pretrained(init: Mapping[str, torch.Tensor],
                     loaded: Mapping[str, torch.Tensor]
                     ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """from_pretrained with ignore_mismatched_sizes semantics
    (train_egtr.py:263-272): copy every entry whose name and shape match,
    cast to the fresh entry's dtype; keep the fresh init elsewhere. Returns
    (merged state_dict, initialized paths): the names of the entries kept
    fresh, "/"-joined, as ``optim.make_optimizer(initialized_paths=)``
    takes them."""
    merged, initialized = {}, []
    for name, fresh in init.items():
        load = loaded.get(name)
        if load is not None and tuple(load.shape) == tuple(fresh.shape):
            merged[name] = load.to(device=fresh.device, dtype=fresh.dtype)
        else:
            merged[name] = fresh
            initialized.append(name.replace(".", "/"))
    return merged, initialized
