"""``allreduce_ms``: device ms of NCCL's kernels (the gradient all-reduce
and the criterion's sums over the data group) an optimizer step of the
slice, in the traced rank's trace."""

from typing import Optional

NCCL_KERNELS = r"(?i)nccl"


def read(ctx) -> Optional[float]:
    us, n = ctx.trace.kernel_us(NCCL_KERNELS)
    steps = ctx.info["slice_steps"]
    return us / 1e3 / steps if n and steps else None
