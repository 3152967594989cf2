"""Shared helpers of the benchmark's CPU tests: a tiny copy of a cell."""

from __future__ import annotations

import copy

from portbench import harness

TINY_MODEL = dict(d_model=64, encoder_layers=2, decoder_layers=2,
                  encoder_ffn_dim=128, decoder_ffn_dim=128, num_queries=20,
                  num_labels=7, num_rel_labels=8, max_gt_boxes=16,
                  max_gt_rels=8, compute_dtype="float32")
TINY_TRAFFIC = {
    "vg-serve-b1": dict(bucket_hw=[96, 160], image_hw=[90, 150], pool=2,
                        warm_requests=1, trace_units=3),
    "oi-offline-b8": dict(bucket_hw=[96, 160], image_hw=[96, 150], batch=2,
                          pool=2, warm_requests=1, trace_units=2),
    "vg-train-b4a2": dict(bucket_hw=[96, 160], shortest=96, longest=150,
                          batch=2, pool=3, trace_units=1, boxes=[2, 5],
                          rels=[1, 4]),
}


def tiny_spec(cell: str, **model) -> harness.Spec:
    """The cell as ``BENCHMARK.json`` has it, at a size the CPU runs in
    seconds, in float32 (its limits as the files give them)."""
    spec = harness.load_spec(cell)
    spec.config = copy.deepcopy(spec.config)
    spec.traffic = copy.deepcopy(spec.traffic)
    spec.config["model"].update(TINY_MODEL, **model)
    spec.traffic.update(TINY_TRAFFIC[cell])
    return spec
