"""chip_smoke.py's control flow, rehearsed on the CPU at a tiny size.

The script needs a CUDA card, so here the card is faked: the CUDA kernel is
replaced by a counting call of its plain version, CUDA events by host
clocks, the 608x1008 bucket and the bench model by a 64x96 image and a
2+2-layer model. What this checks is the script itself: its phases run in
order, the launch counts it demands match what the model makes, and it
ends with the result line. The kernel's own checks run only on the card.
"""

import json
import time

import pytest
import torch

import chip_smoke
from egtr_tpu_torch import infer
from egtr_tpu_torch.models import layers
from egtr_tpu_torch.ops import msda, msda_cuda

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

    def dispatch(value, shapes, loc, aw, impl="auto"):
        if impl in ("auto", "pallas"):
            return kernel(value, shapes, loc, aw)
        return msda.ms_deform_attn(value, shapes, loc, aw, impl)

    bench_config = infer.bench_config
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", HostEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "host")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(msda_cuda, "msda_fwd", kernel)
    monkeypatch.setattr(msda_cuda, "build", lambda: tmp_path / "lib.so")
    monkeypatch.setattr(layers, "ms_deform_attn", dispatch)
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "Host, 0.00 W")
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, iters: (fn(), 0.0)[1])
    monkeypatch.setattr(infer, "BUCKET_HW", (64, 96))
    monkeypatch.setattr(infer, "bench_config",
                        lambda **kw: bench_config(**{**TINY, **kw}))
    monkeypatch.setattr(infer, "resolve_device",
                        lambda device=None: torch.device("cpu"))
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
    assert [k["name"] for k in kernels] == ["msda_fwd"]
    k = kernels[0]
    required = {"name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"}
    assert required <= set(k)
    # 8 timed + 2 warm-up requests + 1 checked forward, 2+2 MSDA layers each
    assert k["launches"] == 11 * 4
    assert k["bound_by"] in ("bytes", "operations") and k["bound_ms"] > 0
    assert len(k["calls"]) == 4


def test_chip_smoke_refuses_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out
