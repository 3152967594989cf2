"""A run with the timed path broken underneath comes out not correct: for
each fault a cell can have, planted in the program (the port) while the
harness drives the rest of a run, at a tiny size on the CPU with the
cell's own limits. The chip's presence is not looked for here (the run is
given the CPU). One card per cell: no exchange between chips to leave
out."""

from __future__ import annotations

import json
import time

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import tiny_spec


def run(cell, capsys):
    rc = harness.run_cell(cell, 2**31 + 5, 0.5, False, time.perf_counter(),
                          device="cpu", spec=tiny_spec(cell))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_unbroken_runs_are_correct(capsys):
    for cell in ("vg-serve-b1", "oi-offline-b8", "vg-train-b4a2"):
        assert run(cell, capsys)["correct"] is True, cell


@pytest.mark.parametrize("cell", ["vg-serve-b1", "oi-offline-b8"])
def test_an_answer_altered_where_it_is_produced(cell, monkeypatch, capsys):
    import egtr_tpu_torch.infer as infer_mod

    real = infer_mod.sgg_postprocess

    def altered(*a, **k):
        post = real(*a, **k)
        inds = post["mult_inds"].clone()
        inds[:, 0] = 0      # the best triplet becomes a self-relation
        post["mult_inds"] = inds
        return post

    monkeypatch.setattr(infer_mod, "sgg_postprocess", altered)
    assert run(cell, capsys)["correct"] is False


def test_half_of_the_batch_left_out(monkeypatch, capsys):
    from egtr_tpu_torch.models.egtr import EgtrModel

    real = EgtrModel.forward

    def half(self, x, mask=None, generator=None):
        h = x.shape[0] // 2
        out = real(self, x[:h], None if mask is None else mask[:h], generator)
        return {k: torch.cat([v, v]) if v.dim() and v.shape[0] == h else v
                for k, v in out.items()}

    monkeypatch.setattr(EgtrModel, "forward", half)
    assert run("oi-offline-b8", capsys)["correct"] is False


def test_a_step_that_leaves_the_state_unchanged(monkeypatch, capsys):
    from egtr_tpu_torch.train import optim

    def no_update(self, lr_scale=1.0):
        return torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(self.grads())))

    monkeypatch.setattr(optim.Optimizer, "step", no_update)
    line = run("vg-train-b4a2", capsys)
    assert line["correct"] is False
    assert line["checks"]["change3"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out_of_the_mean(monkeypatch, capsys):
    import egtr_tpu_torch.train.train_step as ts

    real = ts.sgg_criterion

    def half(out, labels, cfg, **kw):
        h = labels["num_boxes"].shape[0] // 2
        cut = {k: v[:h] if v.dim() and v.shape[0] == 2 * h else v
               for k, v in out.items()}
        return real(cut, {k: v[:h] for k, v in labels.items()}, cfg, **kw)

    monkeypatch.setattr(ts, "sgg_criterion", half)
    assert run("vg-train-b4a2", capsys)["correct"] is False
