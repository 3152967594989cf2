"""The data-parallel cell's mode (``portbench/modes/train_dp.py``) and its
reference (``portbench/reference/union.py``) on the CPU: the union step
against the plain step on the same images as one batch, and two gloo ranks
of the port's step (a worker process beside this one, as the mode starts
it) against the union reference, at a tiny size in float32."""

from __future__ import annotations

import copy
import os

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.modes.train import step_numbers
from portbench.reference.train import Step
from portbench.reference.union import UnionStep
from portbench.tests.tiny import TINY_MODEL, TINY_TRAFFIC
from portbench.weights import make_state

torch.set_num_threads(2)

CELL = "vg-train-dp4"


def tiny_spec(world):
    spec = harness.load_spec(CELL)
    spec.config = copy.deepcopy(spec.config)
    spec.traffic = copy.deepcopy(spec.traffic)
    spec.config["model"].update(TINY_MODEL)
    spec.traffic.update(TINY_TRAFFIC["vg-train-b4a2"], world=world)
    spec.chips = world
    return spec


def images_and_targets(m, n, seed):
    from portbench.modes.train import draw_targets

    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, 96, 160, 3, generator=g)
    mask = torch.ones(n, 96, 160, dtype=torch.bool)
    mask[1::2, 80:] = False
    targets = [{k: torch.as_tensor(v) for k, v in tg.items()}
               for tg in draw_targets(rng, n, m, [2, 5], [1, 4])]
    return x * mask[..., None], mask, targets


def test_union_step_is_the_step_over_the_union():
    """Two microbatches, each the union of two shares of two images: the
    union step (shares one at a time, the relation term's count taken over
    the union) against ``train.Step`` on the four images as one batch;
    float32 sums in another order (1e-5 of the loss, 1e-4 of a leaf's
    norm)."""
    from egtr_tpu_torch.config import EgtrConfig
    from egtr_tpu_torch.models.egtr import EgtrModel

    spec = tiny_spec(2)
    m = dict(spec.config["model"], dropout=0.0)
    model = EgtrModel(EgtrConfig(**m))
    state = make_state(list(model.named_parameters()), 7, "cpu", 8, 4, 4,
                       "published")
    recipe = spec.config["train"]
    whole, shares = [], []
    for a in range(2):
        x, mask, targets = images_and_targets(m, 4, 10 + a)
        whole.append({"pixel_values": x, "pixel_mask": mask,
                      "targets": targets})
        shares.append([{"pixel_values": x[r::2], "pixel_mask": mask[r::2],
                        "targets": targets[r::2]} for r in range(2)])
    one = Step(state, m, recipe)(whole)
    gen = torch.Generator()
    union = UnionStep(state, m, recipe)(shares, lambda a, r, per: gen)
    assert abs(one["loss"] - union["loss"]) <= 1e-5 * abs(one["loss"])
    norms = {n: float(g.norm()) for n, g in one["grads"].items()}
    scale = np.median([v for v in norms.values() if v > 0])
    for n, g in one["grads"].items():
        gap = float((g - union["grads"][n]).norm())
        assert gap <= 1e-4 * max(norms[n], scale), n


def test_two_gloo_ranks_match_the_union_reference(monkeypatch):
    """The mode at world 2 on the CPU (gloo; the port's step runs eagerly
    there): rank 0 here, rank 1 a process of the mode; set-up, a unit, the
    window's end, the check. The gradient the step applies, the mean of the
    ranks' gradients, is the union reference's at float32 round-off: the
    first gradient and the change within the one-process cell's round-off
    (``test_portbench_reference.ROUND_OFF``)."""
    from portbench.modes import train_dp

    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_PORT")
    env = {k: os.environ.get(k) for k in keys}
    spec = tiny_spec(2)
    runner = train_dp.Runner(spec, 2**31 + 123, torch.device("cpu"),
                             harness.Setup())
    try:
        runner.setup()
        assert runner.unit() == 4
        assert runner.drain() == 0
        assert runner.end_to_end(2.0, 4, 1) == {"train_images_per_s": 4.0}
        offsets = runner.check_offsets()
        # the ranks draw their own dropout masks: other streams
        assert len(offsets) == 2 and len(offsets[0]) == runner.warm
        runner.stop_workers()
        ref = runner.union_reference_steps(offsets)
    finally:
        runner.kill_workers()
    prog_change = {n: runner.p3[n] - runner.p0[n] for n in runner.p0}
    got = step_numbers((runner.warm_losses, runner.g1, prog_change), ref)
    bounds = {"loss": 1e-5, "loss1": 1e-5, "grad1": 1e-4, "change3": 1e-3,
              "grad1_median": 1e-5, "change3_median": 1e-5}
    for name, value in got.items():
        assert value <= bounds[name], (name, value)
    # the group left and the process's environment as it was
    assert {k: os.environ.get(k) for k in keys} == env


@pytest.mark.parametrize("world", [1, 4])
def test_world_comes_from_the_traffic(world):
    from portbench.modes import train_dp

    spec = tiny_spec(world)
    runner = train_dp.Runner(spec, 5, torch.device("cpu"), harness.Setup())
    assert runner.world == world
    assert runner.end_to_end(4.0, 8, 2) == {
        "train_images_per_s": 2 * world * 4 / 4.0}
    info_keys = {"world", "flops_per_image", "images_per_unit"}
    runner.A, runner.B = 2, 2
    assert info_keys <= set(runner.slice_info())
    assert runner.slice_info()["images_per_unit"] == 4


@pytest.mark.parametrize("fault", ["no_exchange", "half_batch", "unchanged"])
def test_a_fault_in_every_rank_is_not_correct(fault, monkeypatch):
    """The mode at world 2 on the CPU with a fault planted in the port in
    both ranks (``portbench/dp_faults.py``: the gradient exchange between
    the ranks left out, half of each rank's microbatch left out of the loss,
    no optimizer step), through ``Runner.check`` with the cell's own limits:
    a number past its limit, so the run is not correct."""
    from portbench import dp_faults
    from portbench.modes import train_dp

    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    runner = train_dp.Runner(tiny_spec(2), 2**31 + 321, torch.device("cpu"),
                             harness.Setup())
    dp_faults.faulty(runner, fault, monkeypatch.setattr)
    assert runner.worker == ("-m", "portbench.dp_faults", fault)
    try:
        runner.setup()
        runner.unit()
        runner.drain()
        checks = {name: (value, limit) for name, value, limit in runner.check()}
    finally:
        runner.kill_workers()
    assert set(checks) == set(runner.spec.traffic["limits"])
    assert any(value > limit for value, limit in checks.values()), checks
    if fault == "unchanged":
        assert checks["change3"][0] == pytest.approx(1.0)
