"""chip_smoke.py's control flow, rehearsed on the CPU at a tiny size.

The script needs a CUDA card, so here the card is faked: each CUDA kernel is
replaced by a counting call of its plain version, CUDA events by host
clocks, the 608x1008 and 800x1344 buckets and the bench and train models by
a 64x96 image and 2+2-layer models. What this checks is the script itself:
its phases run in order, the launch counts it demands match what the model
and the train step make, and it ends with the result line. The kernels' own
checks run only on the card.
"""

import json
import time

import pytest
import torch

import chip_smoke
from egtr_tpu_torch import infer
from egtr_tpu_torch.models import layers
from egtr_tpu_torch.ops import msda, msda_cuda
from egtr_tpu_torch.scripts import perf_train_step

torch.set_num_threads(1)

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
    def kernel(value, shapes, loc, aw):
        msda_cuda.check_inputs(value, tuple(shapes), loc, aw)
        msda_cuda.launches += 1
        return msda.ms_deform_attn_plain(value, shapes, loc, aw)

    def bwd_rows(value, shapes, loc, aw, g):
        msda_cuda.check_inputs(value, tuple(shapes), loc, aw)
        msda_cuda.check_grad_output(value, loc, g)
        msda_cuda.bwd_rows_launches += 1
        return msda.ms_deform_attn_plain_bwd(value, shapes, loc, aw, g)[1:]

    def bwd_value(value, shapes, loc, aw, g):
        msda_cuda.check_grad_output(value, loc, g)
        msda_cuda.bwd_value_launches += 1
        return msda.ms_deform_attn_plain_bwd(value, shapes, loc, aw, g)[0]

    def dispatch(value, shapes, loc, aw, impl="auto"):
        """As msda.ms_deform_attn dispatches CUDA tensors: the kernels for
        "auto", through the autograd op where a gradient is needed."""
        if impl not in ("auto", "pallas"):
            return msda.ms_deform_attn(value, shapes, loc, aw, impl)
        shapes = tuple(shapes)
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (value, loc, aw)):
            return msda._MSDeformAttn.apply(value, loc, aw, shapes, True)
        return kernel(value, shapes, loc, aw)

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
    monkeypatch.setattr(msda_cuda, "build", lambda: {
        name: tmp_path / f"lib{name}.so" for name in msda_cuda.sources()})
    monkeypatch.setattr(layers, "ms_deform_attn", dispatch)
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "Host, 0.00 W")
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "cuda_ms",
                        lambda fn, iters, warmup=0: (fn(), 0.0)[1])
    monkeypatch.setattr(infer, "BUCKET_HW", (64, 96))
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
    assert [k["name"] for k in kernels] == ["msda_fwd", "msda_bwd_rows",
                                            "msda_bwd_value"]
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
    fwd, rows, value = kernels
    # serving: 4 timed + 2 warm-up requests + 1 checked forward, 2+2 MSDA
    # layers each; training: 3 steps + 2 microbatches of the accumulated one
    assert fwd["launches_serving"] == 7 * 4
    assert fwd["launches_training"] == 5 * 4
    assert fwd["launches"] == 12 * 4
    assert rows["launches"] == value["launches"] == 5 * 4
    # forward: both buckets x (encoder, decoder) x (float32, bfloat16)
    assert len(fwd["calls"]) == 8
    assert len(rows["calls"]) == 4
    out = "\n".join(lines)
    for phase in ("kernel build:", "msda_fwd serving encoder",
                  "msda_fwd training decoder", "msda_bwd training encoder",
                  "serve bfloat16", "model f32 kernel vs plain MSDA",
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
    with pytest.raises(SystemExit, match="msda_bwd_value launched"):
        chip_smoke.main()


def test_chip_smoke_refuses_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out
