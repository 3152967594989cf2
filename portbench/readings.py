"""Readings for the output check's limits, many seeds in one process: the
program's numbers as a run gives them (set-up, a short window at the cell's
own load, the check), and the control's, the reference computed in float8
(e4m3, per-tensor scaled operands) in the program's place, on the same
weights and inputs; and a fault's: for a training cell "half of each
microbatch left out, the mean taken over the rest", planted in the
reference put in the program's place; for a serving cell each answer
judged against another image's reference (the answer of an image left
out).

    python3 -m portbench.readings --workload vg-serve-b1 --seeds 1,2,3 \
        --control-seeds 1,2,3 --seconds 2

prints one JSON line a reading. It runs on the card only, like ``run``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np
import torch

from portbench import harness, serving
from portbench.reference.model import fp8_e4m3


def half_batch(mbs):
    """Each microbatch cut to its first half: the fault's input."""
    out = []
    for mb in mbs:
        h = len(mb["targets"]) // 2
        out.append({"pixel_values": mb["pixel_values"][:h],
                    "pixel_mask": mb["pixel_mask"][:h],
                    "targets": mb["targets"][:h]})
    return out


def one_seed(spec, seed, seconds, device, control, faults):
    cell = spec.name
    mode = harness.load_module("modes", spec.traffic["mode"])
    runner = mode.Runner(spec, seed, device, harness.Setup())
    runner.setup()
    stats, _ = harness.run_window(runner, seconds, False, device.type, 0)
    del runner.program_state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    if spec.traffic["mode"] == "train":
        from portbench.modes.train import leaf_gaps, step_numbers

        ref = runner.reference_steps()
        prog_change = {n: runner.p3[n] - runner.p0[n] for n in runner.p0}
        numbers = step_numbers((runner.warm_losses, runner.g1, prog_change),
                               ref)
        # the look behind a worst-leaf reading: the leaves that set it
        names = sorted(ref[1])
        gaps = leaf_gaps(runner.g1, ref[1], names)
        norms = np.array([float(ref[1][n].norm()) for n in names])
        numbers["grad1_worst_leaves"] = [
            [names[i], float(gaps[i]), float(norms[i] / np.median(norms))]
            for i in np.argsort(-gaps)[:3]]
    else:
        numbers = {n: v for n, v, _ in runner.check()}
    out = {"cell": cell, "seed": seed, "side": "program",
           "units": stats.units, "check_s": time.perf_counter() - t0,
           "numbers": numbers}
    print(json.dumps(out), flush=True)
    if not control:
        return
    m = spec.config["model"]
    if spec.traffic["mode"] == "train":
        low = runner.reference_steps(quant=fp8_e4m3)
        sides = {"control": low}
        if faults:
            sides["fault_half_batch"] = runner.reference_steps(
                transform=half_batch)
        for side, got in sides.items():
            numbers = step_numbers(got, ref)
            print(json.dumps({"cell": cell, "seed": seed, "side": side,
                              "numbers": numbers}), flush=True)
    else:
        numbers = serving.control_readings(runner.state, m, runner.host_x,
                                           runner.host_m, device, fp8_e4m3)
        print(json.dumps({"cell": cell, "seed": seed, "side": "control",
                          "numbers": numbers}), flush=True)
        if faults:
            # every answer judged against the next image's reference: the
            # fault of an answer computed on another image of the batch
            n = runner.host_x.shape[0]
            moved = [((i + 1) % n, a)
                     for i, a in serving.distinct_answers(runner)]
            numbers = serving.worst(serving.judge(
                runner.state, m, runner.host_x, runner.host_m, device, moved))
            print(json.dumps({"cell": cell, "seed": seed,
                              "side": "fault_other_image",
                              "numbers": numbers}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--faults", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: CUDA is not available", file=sys.stderr)
        return 3
    device = torch.device("cuda")
    control = {int(s) for s in args.control_seeds.split(",") if s}
    spec = harness.load_spec(args.workload)
    for s in args.seeds.split(","):
        one_seed(spec, int(s), args.seconds, device,
                 int(s) in control, bool(args.faults))
    return 0


if __name__ == "__main__":
    sys.exit(main())
