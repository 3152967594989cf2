"""The control comes out not correct: the reference computed in float8
(e4m3, per-tensor scaled operands), the precision below the configuration's
bfloat16, put in the program's place. On the CPU at a tiny size with the
cells' own limits; on the card (skipped without one) at each cell's own
size, on three seeds."""

from __future__ import annotations

import pytest
import torch

from portbench import harness, serving
from portbench.reference.model import fp8_e4m3
from portbench.tests.tiny import tiny_spec


def fails(checks, limits):
    return any(v > limits[n] for n, v in checks.items())


def serving_control(spec, seed, device, seconds=0.5):
    mode = harness.load_module("modes", spec.traffic["mode"])
    runner = mode.Runner(spec, seed, device, harness.Setup())
    runner.setup()
    del runner.program_state
    return serving.control_readings(runner.state, spec.config["model"],
                                    runner.host_x, runner.host_m, device,
                                    fp8_e4m3)


def train_control(spec, seed, device):
    from portbench.modes.train import Runner, compare_steps

    runner = Runner(spec, seed, device, harness.Setup())
    runner.setup()
    del runner.program_state
    ref = runner.reference_steps()
    low = runner.reference_steps(quant=fp8_e4m3)
    return {n: v for n, v, _ in compare_steps(spec.traffic["limits"], low,
                                              ref)}


@pytest.mark.parametrize("cell", ["vg-serve-b1", "oi-offline-b8"])
def test_serving_control_fails_on_the_cpu(cell):
    spec = tiny_spec(cell)
    got = serving_control(spec, 2**31 + 9, torch.device("cpu"))
    assert fails(got, spec.traffic["limits"]), got


def test_training_control_fails_on_the_cpu():
    spec = tiny_spec("vg-train-b4a2")
    got = train_control(spec, 2**31 + 9, torch.device("cpu"))
    assert fails(got, spec.traffic["limits"]), got


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control at the cell's own size")
    return torch.device("cuda")


@pytest.mark.parametrize("cell", ["vg-serve-b1", "oi-offline-b8",
                                  "vg-train-b4a2"])
def test_control_fails_at_the_cells_size(cell, cuda):
    spec = harness.load_spec(cell)
    for seed in (2**31 + 101, 2**31 + 202, 2**31 + 303):
        if spec.traffic["mode"] == "train":
            got = train_control(spec, seed, cuda)
        else:
            got = serving_control(spec, seed, cuda)
        assert fails(got, spec.traffic["limits"]), (seed, got)
