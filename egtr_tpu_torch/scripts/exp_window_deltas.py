"""Full-model windowed-MSDA output deltas at the FPS-protocol shape
(608x1008) on seeded random weights: the port's counterpart of the repo's
``scripts/exp_window_deltas_cpu.py``.

One exact forward and one per windowed variant (``win16_tile``,
``win16_point``, ``win8_point``) of the same bf16 model with 200 queries on
the same input, and per output (logits, pred_rel, pred_boxes,
pred_connectivity) the largest absolute difference to the exact forward and
that difference over the exact output's largest magnitude. The input image
is ``np.random.default_rng(0)``'s, as in the JAX script; the weights are the
port's init seeded with 0, which cannot replay JAX's ``PRNGKey(0)`` init,
so the numbers are not those of
``experiments/win_deltas_random_init_cpu.json``.

    python -m egtr_tpu_torch.scripts.exp_window_deltas [OUT.json] \
        [--device cpu]

It runs on the GPU (through the MSDA kernels) unless ``--device cpu`` is
given, and raises where CUDA is absent.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import numpy as np
import torch

HW = (608, 1008)
SEED = 0  # the weights' init
KEYS = ("logits", "pred_rel", "pred_boxes", "pred_connectivity")
VARIANTS = (
    ("win16_tile", dict(msda_window=16)),
    ("win16_point", dict(msda_window=16, msda_band="point")),
    ("win8_point", dict(msda_window=8, msda_band="point")),
)


def base_config(**kw):
    from ..config import EgtrConfig

    return EgtrConfig(**{**dict(num_queries=200, num_labels=150,
                                num_rel_labels=50, dropout=0.0,
                                compute_dtype="bfloat16"), **kw})


def run(base, state, x, device, **kw):
    """The four outputs of one forward of ``base.replace(**kw)`` with
    ``state``'s weights, as float64 numpy."""
    from ..models.egtr import EgtrModel

    model = EgtrModel(base.replace(**kw))
    model.load_state_dict(state, strict=True)
    model = model.to(device).eval()
    with torch.inference_mode():
        out = model(x)
    return {k: out[k].double().cpu().numpy() for k in KEYS}


def deltas(base, state, x, device):
    """{variant: {output: {max_abs, max_rel_of_scale}}}."""
    t0 = time.time()
    exact = run(base, state, x, device)
    print(f"exact done {time.time() - t0:.0f}s", flush=True)
    report = {}
    for name, kw in VARIANTS:
        t0 = time.time()
        out = run(base, state, x, device, **kw)
        row = {}
        for k in KEYS:
            d = np.abs(out[k] - exact[k])
            scale = float(np.abs(exact[k]).max()) or 1.0
            row[k] = {"max_abs": float(d.max()),
                      "max_rel_of_scale": float(d.max() / scale)}
        report[name] = row
        print(name, json.dumps(row), f"({time.time() - t0:.0f}s)",
              flush=True)
    return report


def main(argv: Optional[List[str]] = None):
    from ..infer import resolve_device
    from ..models.egtr import EgtrModel
    from ..models.layers import init_params

    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default="win_deltas.json")
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises where CUDA is absent)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (1, *HW, 3)).astype(np.float32)).to(device)
    base = base_config()
    model = EgtrModel(base)
    init_params(model, torch.Generator().manual_seed(SEED))
    state = model.state_dict()
    report = deltas(base, state, x, device)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print("done ->", args.out, flush=True)
    return report


if __name__ == "__main__":
    main()
