"""chip_smoke.py's control flow, rehearsed on the CPU at a tiny size.

The script needs a CUDA card, so here the card is faked: each CUDA kernel is
replaced by a counting call of its plain version, CUDA events by host
clocks, the 608x1008 and 800x1344 buckets and the bench and train models by
a 272x96 image (levels of 34, 17, 9 and 5 rows, so that a window of 16 bands
two levels and leaves two exact, as at 608x1008) and 2+2-layer models. What
this checks is the script itself:
its phases run in order, the launch counts it demands match what the model
and the train step make, and it ends with the result line. The kernels' own
checks run only on the card.
"""

import json
import time
from pathlib import Path

import pytest
import torch

import chip_smoke
from egtr_tpu_torch import infer
from egtr_tpu_torch.ops import msda, msda_cuda
from egtr_tpu_torch.scripts import perf_train_step

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

TINY = dict(d_model=64, encoder_layers=2, decoder_layers=2,
            encoder_ffn_dim=128, decoder_ffn_dim=128, num_queries=12,
            num_labels=7, num_rel_labels=5)


class HostEvent:
    def __init__(self, enable_timing=True):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


@pytest.fixture
def fake_card(monkeypatch, tmp_path):
    def kernel(value, shapes, loc, aw, levels=None, out_dtype=None):
        msda_cuda.check_inputs(value, tuple(shapes), loc, aw)
        msda_cuda.launches += 1
        return msda.ms_deform_attn_plain(value, shapes, loc, aw, levels,
                                         out_dtype)

    def fwd_q(vq, scale, shapes, loc, aw, levels=None):
        msda_cuda.check_inputs_q(vq, scale, tuple(shapes), loc, aw)
        msda_cuda.fwd_q_launches += 1
        return msda.msda_fwd_q_plain(vq, scale, shapes, loc, aw, levels)

    def fwd_win(*args):
        msda_cuda.check_inputs_win(*args, per_point=False)
        msda_cuda.fwd_win_launches += 1
        return msda.msda_fwd_win_plain(*args)

    def fwd_win_pp(*args):
        msda_cuda.check_inputs_win(*args, per_point=True)
        msda_cuda.fwd_win_pp_launches += 1
        return msda.msda_fwd_win_plain(*args)

    def bwd_rows(value, shapes, loc, aw, g):
        msda_cuda.check_inputs(value, tuple(shapes), loc, aw)
        msda_cuda.check_grad_output(value, loc, g)
        msda_cuda.bwd_rows_launches += 1
        return msda.ms_deform_attn_plain_bwd(value, shapes, loc, aw, g)[1:]

    def bwd_value(value, shapes, loc, aw, g):
        msda_cuda.check_grad_output(value, loc, g)
        msda_cuda.bwd_value_launches += 1
        return msda.ms_deform_attn_plain_bwd(value, shapes, loc, aw, g)[0]

    bench_config = infer.bench_config
    train_config = perf_train_step.train_config
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", HostEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "host")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(msda_cuda, "msda_fwd", kernel)
    monkeypatch.setattr(msda_cuda, "msda_bwd_rows", bwd_rows)
    monkeypatch.setattr(msda_cuda, "msda_bwd_value", bwd_value)
    monkeypatch.setattr(msda_cuda, "msda_fwd_q", fwd_q)
    monkeypatch.setattr(msda_cuda, "msda_fwd_win", fwd_win)
    monkeypatch.setattr(msda_cuda, "msda_fwd_win_pp", fwd_win_pp)
    # the dispatch takes the (faked) kernels for these CPU tensors, as it
    # does for CUDA tensors on the card
    monkeypatch.setattr(msda, "_takes_kernels",
                        lambda impl, value: impl in ("auto", "pallas"))
    monkeypatch.setattr(msda_cuda, "build", lambda: {
        name: tmp_path / f"lib{name}.so" for name in msda_cuda.sources()})
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "Host, 0.00 W")
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "SIDE_BY_SIDE_ROUNDS", 2)
    monkeypatch.setattr(chip_smoke, "cuda_ms",
                        lambda fn, iters, warmup=0: (fn(), 0.0)[1])
    monkeypatch.setattr(infer, "BUCKET_HW", (272, 96))
    monkeypatch.setattr(infer, "bench_config",
                        lambda **kw: bench_config(**{**TINY, **kw}))
    monkeypatch.setattr(infer, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    monkeypatch.setattr(perf_train_step, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    monkeypatch.setattr(perf_train_step, "BUCKET_HW", (64, 96))
    monkeypatch.setattr(
        perf_train_step, "train_config",
        lambda **kw: train_config(**{**perf_train_step.TINY, **kw}))
    # the float32 phase turns TF32 off; restore both flags afterwards
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                        torch.backends.cudnn.allow_tf32)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        torch.backends.cuda.matmul.allow_tf32)


def test_chip_smoke_runs_its_phases(fake_card, capsys):
    assert chip_smoke.main() == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "Host, 0.00 W"
    assert json.loads(lines[-1]) == {
        "ok": True, "device": {"platform": "gpu", "kind": "host",
                               "count": 1}}
    kernels = json.loads(lines[-3])["kernels"]
    assert [k["name"] for k in kernels] == [
        "msda_fwd", "msda_bwd_rows", "msda_bwd_value", "msda_fwd_q",
        "msda_fwd_win", "msda_fwd_win_pp"]
    required = {"name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"}
    for k in kernels:
        assert required <= set(k), k["name"]
        assert k["route"] == "cuda" and k["library_ms"] is None
        assert k["bound_by"] in ("bytes", "operations") and k["bound_ms"] > 0
        assert isinstance(k["max_abs_err"], float)
        path, line = k["replaces"].split(":")
        assert path == "egtr_tpu/ops/msda_pallas.py" and int(line) > 0
        assert (REPO / k["source"]).exists()
        assert k["launches"] > 0
    fwd, rows, value, fwd_q, win, win_pp = kernels
    # exact serving: 4 timed + 2 warm-up requests + 1 checked forward, 2+2
    # MSDA layers each; training: 3 steps + 2 microbatches of the
    # accumulated one
    assert fwd["launches_serving"] == 7 * 4
    assert fwd["launches_training"] == 5 * 4
    assert rows["launches"] == value["launches"] == 5 * 4
    # served (window 16, one band per point, int8), 7 forwards: each of the 2
    # encoder layers launches K6 on the 2 banded levels and K4 once on the 2
    # exact ones, each of the 2 decoder layers K4 once; K1 never
    assert win_pp["launches"] == 7 * 2 * 2 and win_pp["form"] == "int8"
    assert fwd_q["launches"] == 7 * (2 + 2)
    assert fwd["launches_serving_served"] == 0
    # one band per tile without int8, 2 timed + 2 warm-up + 1 checked
    # forward: K5 on the banded levels, K1 on the exact ones and the decoder
    assert win["launches"] == 5 * 2 * 2 and win["form"] == "bfloat16"
    assert fwd["launches_serving_tile"] == 5 * (2 + 2)
    assert fwd["launches"] == (7 + 5 + 5) * 4
    assert fwd_q["int8_grad_launches"] == {
        "msda_fwd_q": 1, "msda_bwd_rows": 1, "msda_bwd_value": 1}
    # K4: three calls x two weight dtypes; K5, K6: three value types each
    assert len(fwd_q["calls"]) == 6
    assert [c["dtype"] for c in win["calls"]] == ["float32", "bfloat16",
                                                  "int8"]
    assert win_pp["calls"][0]["levels"] == [0, 1]
    assert fwd_q["served_model_f32_max_abs_err"]["band_indices"] > 0
    # forward: both buckets x (encoder, decoder) x (float32, bfloat16)
    assert len(fwd["calls"]) == 8
    assert len(rows["calls"]) == 4
    out = "\n".join(lines)
    for phase in ("kernel build:", "msda_fwd serving encoder",
                  "msda_fwd training decoder", "msda_bwd training encoder",
                  "msda_fwd_q serving encoder_served",
                  "msda_fwd_q serving decoder batch 2",
                  "msda_fwd_win serving encoder window 16",
                  "msda_fwd_win_pp serving encoder batch 2",
                  "serve exact", "serve served", "serve tile",
                  "ms/request, exact | served | tile, 2 rounds in turns",
                  "model f32 exact kernels vs plain MSDA",
                  "model f32 served kernels vs plain MSDA",
                  "int8 op without a window, forward + backward",
                  "train bfloat16", "frozen leaves bit-identical",
                  "train f32 kernels vs plain op"):
        assert phase in out, phase


def test_chip_smoke_fails_when_a_kernel_is_bypassed(fake_card, monkeypatch):
    """The launch counts are the proof that the main path ran the kernels:
    a backward that skips one must fail the run."""
    real = msda_cuda.msda_bwd_value

    def uncounted(*args):
        out = real(*args)
        msda_cuda.bwd_value_launches -= 1
        return out

    monkeypatch.setattr(msda_cuda, "msda_bwd_value", uncounted)
    # the int8 op's forward + backward is the first phase to run it
    with pytest.raises(SystemExit, match="expected .*'msda_bwd_value': 1"):
        chip_smoke.main()


def test_chip_smoke_fails_when_the_served_path_bypasses_a_kernel(
        fake_card, monkeypatch):
    """K1 must not run on the served path, and K6 must: a dispatch that
    sends the banded levels elsewhere fails the run."""
    real = msda_cuda.msda_fwd_win_pp

    def uncounted(*args):
        out = real(*args)
        msda_cuda.fwd_win_pp_launches -= 1
        return out

    monkeypatch.setattr(msda_cuda, "msda_fwd_win_pp", uncounted)
    with pytest.raises(SystemExit, match="msda_fwd_win_pp launched 0"):
        chip_smoke.main()


def test_forward_counts_at_the_serving_bucket():
    """The launch counts chip_smoke demands per forward at full depth, from
    how the dispatch splits a call: 608x1008 has three levels taller than the
    window of 16 and one below it."""
    from egtr_tpu_torch.models.detr import level_shapes

    shapes = level_shapes((608, 1008), 4)
    assert shapes == ((76, 126), (38, 63), (19, 32), (10, 16))
    zero = dict.fromkeys(chip_smoke.KERNEL_COUNTERS, 0)
    assert chip_smoke.forward_counts(infer.bench_config(), shapes) == {
        **zero, "msda_fwd": 12}
    assert chip_smoke.forward_counts(infer.serving_config(), shapes) == {
        **zero, "msda_fwd_q": 12, "msda_fwd_win_pp": 18}
    assert chip_smoke.forward_counts(
        infer.bench_config(msda_window=16, msda_band="tile"), shapes) == {
            **zero, "msda_fwd": 12, "msda_fwd_win": 18}
    assert chip_smoke.forward_counts(
        infer.bench_config(msda_int8=True), shapes) == {
            **zero, "msda_fwd_q": 12}
    # a window above every level bands nothing
    assert chip_smoke.forward_counts(
        infer.bench_config(msda_window=128), shapes) == {
            **zero, "msda_fwd": 12}


def test_chip_smoke_refuses_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out
