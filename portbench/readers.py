"""The arithmetic of the per-layer metrics, shared by their readers
(``metrics/<name>.py``). Each takes a ``harness.MetricContext`` and returns
a number, or None where the slice holds nothing to read (the harness then
leaves the metric out of the line). A share of a peak or of a roofline is
never returned as 0 for want of data."""

from __future__ import annotations

from typing import Optional

from . import flops

MSDA_KERNELS = {
    "fwd": r"\bmsda_fwd(_q|_win|_bp)?_kernel\b",
    "rows": r"\bmsda_bwd(_win)?_rows_kernel\b",
    "value": r"\bmsda_bwd(_win)?_value_kernel\b",
}
MATCHER_KERNELS = r"\blsap_(warp|cluster)_kernel\b"


def idle_share(ctx) -> Optional[float]:
    """% of the profiled slice in which no kernel, copy or fill ran."""
    window = ctx.trace.window_us
    return 100.0 * (1.0 - ctx.trace.busy_us() / window) if window > 0 else None


def mfu(ctx) -> Optional[float]:
    """% of the bf16 peak that the model FLOPs of the images completed in
    the untraced part of the window make over its length."""
    s = ctx.stats
    if s.untraced_seconds <= 0 or s.untraced_images == 0:
        return None
    work = s.untraced_images * ctx.info["flops_per_image"]
    return 100.0 * work / (s.untraced_seconds * flops.PEAK_BF16_FLOPS)


def msda_roofline(ctx) -> Optional[float]:
    """% of the MSDA kernels' device time that their least time (the
    frozen bound of each call's shapes) would take. Each kernel kind's
    launches seen in the slice are given the mean bound of that kind's
    calls, so a row the profiler dropped drops its bound with it."""
    info = ctx.info
    bounds = flops.msda_bounds(info["model"], info["hw"], info["batch"])
    calls = len(flops.msda_calls(info["model"], info["hw"]))
    kinds = ("fwd", "rows", "value") if info["train"] else ("fwd",)
    least, spent = 0.0, 0.0
    for kind in kinds:
        us, n = ctx.trace.kernel_us(MSDA_KERNELS[kind])
        least += bounds[kind] / calls * n
        spent += us / 1e3
    return 100.0 * least / spent if spent > 0 else None


def conv_ms_per_image(ctx) -> Optional[float]:
    """Device ms of the convolution kernels per image of the slice."""
    images = ctx.info["slice_images"]
    us = ctx.trace.kind_us("conv")
    return us / 1e3 / images if images and us > 0 else None


def matcher_ms(ctx) -> Optional[float]:
    """Device ms of the matcher's kernels per optimizer step of the slice."""
    us, n = ctx.trace.kernel_us(MATCHER_KERNELS)
    steps = ctx.info["slice_steps"]
    return us / 1e3 / steps if n and steps else None
