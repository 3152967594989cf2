"""``enc_matcher_ms``: device ms of the matcher's cluster-route kernel (the
assignment at Q = S, the two-stage proposals') an optimizer step of the
slice."""

from typing import Optional

CLUSTER_KERNEL = r"\blsap_cluster_kernel\b"


def read(ctx) -> Optional[float]:
    us, n = ctx.trace.kernel_us(CLUSTER_KERNEL)
    steps = ctx.info["slice_steps"]
    return us / 1e3 / steps if n and steps else None
