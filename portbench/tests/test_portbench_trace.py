"""The reading of a card's trace, on synthetic events: the profiled slice,
the device's busy time as the union of its events, the idle gaps labelled
by the host span open as each began, kernel time by name and kind, and the
breakdown's shape."""

from __future__ import annotations

import pytest

from portbench import tracing


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    ev(tracing.SLICE, "user_annotation", 100.0, 100.0),
    ev("input_copy", "user_annotation", 100.0, 10.0),
    ev("replay", "user_annotation", 110.0, 40.0),
    ev("wait", "user_annotation", 150.0, 50.0),
    ev("Memcpy HtoD", "gpu_memcpy", 105.0, 10.0),
    ev("void msda_fwd_kernel<float, 4>(int)", "kernel", 120.0, 20.0),
    ev("sm90_xmma_fprop_implicit_gemm_f32", "kernel", 130.0, 20.0),
    ev("void lsap_warp_kernel(float const*)", "kernel", 170.0, 10.0),
    ev("outside the slice", "kernel", 300.0, 10.0),
]


def test_busy_gaps_and_labels():
    t = tracing.Trace(EVENTS)
    assert t.window_us == 100.0
    assert t.busy_intervals() == [(105.0, 115.0), (120.0, 150.0),
                                  (170.0, 180.0)]
    assert t.busy_us() == 50.0
    assert t.gaps() == [(100.0, 105.0), (115.0, 120.0), (150.0, 170.0),
                        (180.0, 200.0)]
    b = t.breakdown()
    assert dict((k, v) for k, v in b["idle_gaps"]) == pytest.approx(
        {"input_copy": 5e-6, "replay": 5e-6, "wait": 40e-6})
    assert b["device_ops"][0][0] == "msda_fwd_kernel"


def test_kernels_by_name_and_kind():
    t = tracing.Trace(EVENTS)
    assert t.kernel_us(r"\bmsda_fwd(_q|_win|_bp)?_kernel\b") == (20.0, 1)
    assert t.kernel_us(r"\blsap_(warp|cluster)_kernel\b") == (10.0, 1)
    assert t.kind_us("conv") == 20.0
    assert tracing.op_kind("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n") == "gemm"


def test_a_trace_without_device_work_is_refused():
    with pytest.raises(RuntimeError):
        tracing.Trace(EVENTS[:4])
    with pytest.raises(RuntimeError):
        tracing.Trace(EVENTS[4:])
