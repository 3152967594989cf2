"""The plain reference against ``egtr_tpu_torch`` at a tiny size on the CPU
in float32: a whole run of each cell (set-up, window, the output check)
whose compared numbers sit at round-off, and the forward's outputs side by
side. The test imports both; the reference imports nothing of the port."""

from __future__ import annotations

import json
import time

import pytest
import torch

from portbench import harness
from portbench.reference.model import Reference
from portbench.tests.tiny import tiny_spec
from portbench.weights import fill_model

# float32 on both sides: sums in another order, and (training) Adam's sign
# of gradients at round-off
ROUND_OFF = {"boxes": 1e-5, "obj_scores": 1e-5, "class_gap": 1e-5,
             "triplet_gap": 1e-5,
             "triplet_score": 1e-5, "pair_gap": 1e-5, "pair_vector": 1e-5,
             "loss": 1e-5, "grad1": 1e-4, "change3": 1e-3,
             "grad1_median": 1e-5, "change3_median": 1e-5}


def run_numbers(cell, capsys):
    spec = tiny_spec(cell)
    rc = harness.run_cell(cell, 2**31 + 77, 0.5, False, time.perf_counter(),
                          device="cpu", spec=spec)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["vg-serve-b1", "oi-offline-b8",
                                  "vg-train-b4a2"])
def test_run_agrees_at_round_off(cell, capsys):
    line = run_numbers(cell, capsys)
    assert line["correct"] is True
    assert line["failed"] == 0
    for name, c in line["checks"].items():
        assert c["value"] <= ROUND_OFF[name], (name, c)
    assert list(line)[-1] == "checks"


def test_forward_outputs_side_by_side():
    from egtr_tpu_torch.config import EgtrConfig
    from egtr_tpu_torch.models.egtr import EgtrModel

    m = tiny_spec("vg-serve-b1").config["model"]
    model = EgtrModel(EgtrConfig(**m)).eval()
    state = {n: t.clone() for n, t in fill_model(model, 3, model.config,
                                                  "fan_in").items()}
    x = torch.randn(2, 96, 160, 3)
    mask = torch.zeros(2, 96, 160, dtype=torch.bool)
    mask[0, :96, :160] = True
    mask[1, :80, :120] = True
    with torch.no_grad():
        got = model(x, mask)
        ref = Reference(state, m).forward(x, mask)
    for key in ("logits", "pred_boxes", "pred_rel_logits",
                "pred_connectivity_logits", "all_logits", "all_pred_boxes"):
        assert torch.allclose(got[key], ref[key], atol=1e-4, rtol=1e-4), key
