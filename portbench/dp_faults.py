"""Faults a data-parallel run can have, planted in the port (not in the
harness or the reference) in every rank: the readings that set
``vg-train-dp4``'s limits (``readings_train --fault``) and the CPU tests
that hold its check to them.

- ``no_exchange``: the gradient all-reduce left out
  (``train_step.GradientReduction`` does nothing), so each rank steps on
  its own share;
- ``half_batch``: half of each rank's microbatch left out of the loss
  (the criterion sees its first half of the images);
- ``unchanged``: the optimizer takes no step.

    python3 -m portbench.dp_faults FAULT <train_dp's rank arguments>

runs a rank other than 0 with FAULT planted; ``faulty(runner, FAULT)``
plants it in rank 0's process and has its ranks started so.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict


def no_exchange(put) -> None:
    from egtr_tpu_torch.train import train_step as ts

    put(ts.GradientReduction, "__call__", lambda self: None)


def half_batch(put) -> None:
    from egtr_tpu_torch.train import train_step as ts

    real = ts.sgg_criterion

    def half(out, labels, cfg, **kw):
        h = labels["num_boxes"].shape[0] // 2
        cut = {k: v[:h] if v.dim() and v.shape[0] == 2 * h else v
               for k, v in out.items()}
        return real(cut, {k: v[:h] for k, v in labels.items()}, cfg, **kw)

    put(ts, "sgg_criterion", half)


def unchanged(put) -> None:
    import torch

    from egtr_tpu_torch.train import optim

    def no_update(self, lr_scale=1.0):
        return torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(self.grads())))

    put(optim.Optimizer, "step", no_update)


FAULTS: Dict[str, Callable] = {"no_exchange": no_exchange,
                               "half_batch": half_batch,
                               "unchanged": unchanged}


def faulty(runner, name: str, put=setattr) -> None:
    """``name`` planted in this process (through ``put``, ``setattr``'s
    signature: a test's ``monkeypatch.setattr`` undoes it) and in the ranks
    that ``runner`` starts."""
    FAULTS[name](put)
    runner.worker = ("-m", __name__, name)


def main(argv=None) -> int:
    from portbench.modes import train_dp

    argv = sys.argv[1:] if argv is None else argv
    FAULTS[argv[0]](setattr)
    return train_dp.worker_main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
