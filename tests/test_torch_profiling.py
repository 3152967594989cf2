"""The port's profiling utilities (``egtr_tpu_torch/utils/profiling.py``):
``StepTimer`` against the JAX package's with the same patched clock, and
``summarize_trace`` of a CPU torch.profiler trace and of a hand-written
trace of the card's events; a trace of the card without a device event is
refused."""

import json
import time

import pytest
import torch
from torch.profiler import record_function

from egtr_tpu.utils import profiling as jax_profiling
from egtr_tpu_torch.utils import profiling


def test_step_timer_matches_jax(monkeypatch):
    """Steps of 10, 20, ... ms; the first two skipped as warm-up."""
    ticks = iter([t for i in range(1, 8) for t in (0.0, 0.01 * i)] * 2)
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    summaries = []
    for timer in (profiling.StepTimer(), jax_profiling.StepTimer()):
        assert timer.summary() == {} and timer.mean_ms == 0.0
        for _ in range(7):
            with timer:
                pass
        summaries.append((timer.mean_ms, timer.summary()))
    assert summaries[0] == summaries[1]
    mean_ms, summary = summaries[0]
    assert summary["steps"] == 5
    assert mean_ms == pytest.approx(50.0)


def test_summarize_cpu_trace(tmp_path):
    """On the CPU the device's work is the outermost ops of each thread;
    ``record_function`` scopes give ``by_module``, layer numbers folded."""
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    with profiling.device_trace(str(tmp_path)):
        for i in range(2):
            with record_function(f"encoder_layer_{i}/self_attn"):
                x = (a @ b).softmax(-1)
        x = x + 1
    events = profiling.load_trace_events(str(tmp_path))
    assert events and all(e["ph"] == "X" for e in events)
    summary = profiling.summarize_trace(str(tmp_path), iterations=2)
    assert summary["total_ms"] > 0
    assert sum(summary["by_op"].values()) == pytest.approx(
        summary["total_ms"])
    assert {"gemm", "softmax", "elementwise"} <= set(summary["by_op"])
    assert list(summary["by_module"]) == ["encoder_layer_N/self_attn"]
    assert summary["by_module"]["encoder_layer_N/self_attn"] <= summary[
        "total_ms"]


def test_summarize_card_trace(tmp_path):
    """Kernels, copies and fills count, on the card's stream, under the
    innermost ``gpu_user_annotation`` around their start; host ops and
    launches do not."""
    def ev(cat, name, ts, dur, tid=7):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "pid": 0, "tid": tid}

    trace = {"traceEvents": [
        ev("cpu_op", "aten::mm", 0, 500, tid=1),
        ev("cuda_runtime", "cudaLaunchKernel", 10, 5, tid=1),
        ev("gpu_user_annotation", "decoder_layer_1", 90, 400),
        ev("gpu_user_annotation", "decoder_layer_1/cross_attn", 95, 200),
        ev("kernel", "void msda_fwd_kernel<float>(...)", 100, 30),
        ev("kernel", "ampere_sgemm_128x64_tn", 300, 50),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 600, 20),
        ev("gpu_memset", "Memset (Device)", 700, 4),
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 5, "pid": 0,
         "tid": 7},
    ]}
    with open(tmp_path / "1.trace.json", "w") as f:
        json.dump(trace, f)
    summary = profiling.summarize_trace(str(tmp_path))
    assert summary["total_ms"] == pytest.approx(0.104)
    assert summary["by_op"] == pytest.approx({
        "msda_fwd_kernel": 0.03, "gemm": 0.05, "copy": 0.02, "fill": 0.004})
    assert summary["by_module"] == pytest.approx({
        "decoder_layer_N/cross_attn": 0.03, "decoder_layer_N": 0.05})


@pytest.mark.parametrize("card_sign", ["deviceProperties", "cuda_runtime"])
def test_summarize_refuses_a_card_trace_without_device_events(tmp_path,
                                                              card_sign):
    """A card's trace whose device events are missing (CUPTI recorded
    nothing, or only the CPU was traced around the card's work) is not
    summed from its host ops."""
    events = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
               "dur": 500, "pid": 0, "tid": 1}]
    trace = {"traceEvents": events}
    if card_sign == "deviceProperties":
        trace["deviceProperties"] = [{"id": 0, "name": "NVIDIA H100"}]
    else:
        events.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "ts": 10, "dur": 5,
                       "pid": 0, "tid": 1})
    with open(tmp_path / "1.trace.json", "w") as f:
        json.dump(trace, f)
    assert profiling.trace_device(trace) == "cuda"
    with pytest.raises(RuntimeError, match="no kernel, copy or fill"):
        profiling.summarize_trace(str(tmp_path))


def test_load_trace_events_without_a_trace(tmp_path):
    with pytest.raises(FileNotFoundError):
        profiling.load_trace_events(str(tmp_path))
