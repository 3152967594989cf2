"""Readings for the output check's limits of the training modes that
``readings.py`` does not drive (``train_two_stage``, ``train_dp``): for
each seed the program's compared numbers as a run gives them (set-up, a
short window, the check), and on the control seeds the control's, the
reference computed in float8 (e4m3, per-tensor scaled operands) in the
program's place, on the same weights and inputs.

Two stages: the control makes its own choices (selection, assignment),
and the float32 reference continues from them, as it does from the
program's; ``program_free`` (on the free seeds) is the program against a
float32 reference that chose for itself (what the check would read
without following the program's choices).

    python3 -m portbench.readings_train --workload vg-train-twostage \\
        --seeds 1,2,3 --control-seeds 1 --seconds 2

prints one JSON line a reading. It runs on the card only, like ``run``.
A data-parallel cell takes one seed a process (its ranks are started anew
for each); ``--fault`` plants one of ``dp_faults``' faults in every rank,
and the program's reading is then that fault's (side ``fault:<name>``);
``--control-only`` reads its control on one card without its ranks
(``dp_control``).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np
import torch

from portbench import dp_faults, harness
from portbench.modes.train import leaf_gaps, step_numbers
from portbench.reference.model import fp8_e4m3


def worst_leaves(g1, ref_g1):
    names = sorted(ref_g1)
    gaps = leaf_gaps(g1, ref_g1, names)
    norms = np.array([float(ref_g1[n].norm()) for n in names])
    return [[names[i], float(gaps[i]), float(norms[i] / np.median(norms))]
            for i in np.argsort(-gaps)[:3]]


def emit(cell, seed, side, numbers, **extra):
    print(json.dumps({"cell": cell, "seed": seed, "side": side, **extra,
                      "numbers": numbers}), flush=True)


def one_seed(spec, seed, seconds, device, control, free, fault=None):
    cell, mode = spec.name, spec.traffic["mode"]
    runner = harness.load_module("modes", mode).Runner(
        spec, seed, device, harness.Setup())
    if fault:
        dp_faults.faulty(runner, fault)
    runner.setup()
    stats, _ = harness.run_window(runner, seconds, False, device.type, 0)
    del runner.program_state
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    prog_change = {n: runner.p3[n] - runner.p0[n] for n in runner.p0}
    prog = (runner.warm_losses, runner.g1, prog_change)
    if mode == "train_two_stage":
        ref = runner.reference_steps(choices=runner.program_choices())
        numbers = runner.numbers(prog, ref)
        numbers["replay_gap"] = runner.replay_gap(runner.warm_losses)
    elif mode == "train_dp":
        offsets = runner.check_offsets()
        runner.stop_workers()
        ref = runner.union_reference_steps(offsets)
        numbers = step_numbers(prog, ref)
    else:
        raise SystemExit(f"readings_train: mode {mode!r} is readings.py's")
    numbers["grad1_worst_leaves"] = worst_leaves(runner.g1, ref[1])
    emit(cell, seed, f"fault:{fault}" if fault else "program", numbers,
         units=stats.units,
         check_s=time.perf_counter() - t0)
    if free and mode == "train_two_stage":
        own = runner.reference_steps()
        emit(cell, seed, "program_free", runner.numbers(prog, own))
    if not control:
        return
    if mode == "train_two_stage":
        low = runner.reference_steps(quant=fp8_e4m3)
        ref_low = runner.reference_steps(choices=low[4])
        numbers = runner.numbers(low, ref_low)
        # the control in the program's place: its losses against the
        # program's recomputed forwards
        numbers["replay_gap"] = runner.replay_gap(low[0])
        emit(cell, seed, "control", numbers)
    else:
        low = runner.union_reference_steps(offsets, quant=fp8_e4m3)
        emit(cell, seed, "control", step_numbers(low, ref))


def dp_control(spec, seed, device):
    """A data-parallel cell's control on one card, without its ranks or its
    program: the union reference in float8 against it in float32, from the
    seed's weights and every rank's batches, each rank's dropout masks drawn
    at places of its generator that both sides share (not the program's,
    which only a run of the ranks knows)."""
    from egtr_tpu_torch.models.egtr import EgtrModel

    from portbench import serving
    from portbench.modes import train_dp
    from portbench.weights import fill_model

    runner = train_dp.Runner(spec, seed, device, harness.Setup())
    cfg = serving.egtr_config(spec.config)
    with torch.device(device):
        model = EgtrModel(cfg)
    state = fill_model(model, serving.sub_seed(seed, "weights"), cfg,
                       spec.traffic["weights"])
    runner.p0 = {n: t.detach().to("cpu", copy=True) for n, t in state.items()}
    del model, state
    span = 1 << 24   # Philox offsets: a step's draws lie far inside
    places = ([(s * span, (s + 1) * span) for s in range(runner.warm)]
              if device.type == "cuda"    # elsewhere a generator's state
              else [(torch.Generator().get_state(), None)] * runner.warm)
    offsets = [places] * runner.world
    ref = runner.union_reference_steps(offsets)
    low = runner.union_reference_steps(offsets, quant=fp8_e4m3)
    emit(spec.name, seed, "control", step_numbers(low, ref), ranks="none")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--free-seeds", default="",
                    help="two stages: seeds read against a reference that "
                    "chose for itself too")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--world", type=int, default=0,
                    help="a data-parallel cell's ranks (default: its own)")
    ap.add_argument("--fault", choices=sorted(dp_faults.FAULTS),
                    help="a data-parallel cell: the fault planted in every "
                    "rank (one invocation a fault)")
    ap.add_argument("--control-only", action="store_true",
                    help="a data-parallel cell: the control alone on one "
                    "card, for each of --seeds")
    args = ap.parse_args(argv)
    spec = harness.load_spec(args.workload)
    if ((args.fault or args.control_only)
            and spec.traffic["mode"] != "train_dp"):
        ap.error("--fault and --control-only are for a data-parallel cell")
    if not torch.cuda.is_available():
        print("readings_train: CUDA is not available", file=sys.stderr)
        return 3
    device = torch.device("cuda")
    control = {int(s) for s in args.control_seeds.split(",") if s}
    free = {int(s) for s in args.free_seeds.split(",") if s}
    if args.world:
        spec.traffic["world"] = spec.chips = args.world
    for s in args.seeds.split(","):
        if args.control_only:
            dp_control(spec, int(s), device)
            continue
        one_seed(spec, int(s), args.seconds, device, int(s) in control,
                 int(s) in free, args.fault)
    return 0


if __name__ == "__main__":
    sys.exit(main())
