"""The ResNet trunk's frozen-BN epilogue sites (``backbone.frozen_bn_act``)
and seeded inputs for them, for the tests, ``chip_smoke.py`` and
``scripts/time_msda_kernels.py``.

A site is one call of :func:`backbone.frozen_bn_act`: a FrozenBatchNorm of
a convolution's output with the ReLU and, at a bottleneck's last norm, the
residual (through the downsample's norm in a stage's first block). The
sites are read from a forward on the meta device, whose maps take PyTorch's
expression, by forward hooks on the norms that open a site.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from . import backbone

# the serving bucket (608x1008, batch 1) and the offline one (800x1344,
# batch 8): (pixels, batch)
BUCKETS = {"serving": ((608, 1008), 1), "offline": ((800, 1344), 8)}

# a site's forms: the ReLU alone, an identity residual, or a residual
# through the downsample's norm
FORMS = ("relu", "identity", "downsample")

Site = Tuple[Tuple[int, ...], torch.dtype, str]


def trunk_sites(hw, batch: int, blocks: Sequence[int] = (3, 4, 6, 3),
                dilation: bool = False,
                dtype: torch.dtype = torch.bfloat16) -> List[Site]:
    """The sites of one forward of ``batch`` images of ``hw`` pixels through
    a trunk of ``blocks`` (compute dtype ``dtype``), in order: each map's
    [N, C, H, W], its dtype and its form (``FORMS``)."""
    with torch.device("meta"):
        model = backbone.ResNet50(blocks, dtype=dtype, dilation=dilation)
        pixels = torch.empty((batch, *hw, 3))
    sites: List[Site] = []

    def opens(norm: nn.Module, form: str):
        def record(module, args, output):
            sites.append((tuple(args[0].shape), args[0].dtype, form))
        return norm.register_forward_hook(record)

    hooks = [opens(model.bn1, "relu")]
    for m in model.modules():
        if isinstance(m, backbone.Bottleneck):
            hooks += [opens(m.bn1, "relu"), opens(m.bn2, "relu"),
                      opens(m.bn3, "downsample" if m.has_downsample
                            else "identity")]
    try:
        with torch.no_grad():
            model(pixels)
    finally:
        for hook in hooks:
            hook.remove()
    return sites


def sites_per_forward(blocks: Sequence[int]) -> int:
    """The sites of one forward of a trunk of ``blocks``: its ``frozen_bn``
    launches a forward with grad mode off on the card."""
    return len(trunk_sites((64, 64), 1, blocks))


def random_norm(C: int, generator: torch.Generator,
                device) -> backbone.FrozenBatchNorm:
    """A FrozenBatchNorm of C channels on ``device`` with seeded statistics
    away from the init's (weight near 1, bias and mean near 0, variance in
    [0.05, 3.05))."""
    bn = backbone.FrozenBatchNorm(C).to(device)
    with torch.no_grad():
        for t, (mean, std) in ((bn.weight, (1.0, 0.5)), (bn.bias, (0, 0.5)),
                               (bn.running_mean, (0, 0.5))):
            t.copy_(torch.randn((C,), generator=generator, device=device)
                    * std + mean)
        bn.running_var.copy_(torch.rand((C,), generator=generator,
                                        device=device) * 3 + 0.05)
    return bn


def site_inputs(shape, dtype: torch.dtype, form: str, seed: int, device
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                           backbone.FrozenBatchNorm,
                           Optional[backbone.FrozenBatchNorm]]:
    """Seeded inputs of one site: x, the residual (None for "relu"), x's
    norm and the residual's (None unless "downsample"); maps
    channels_last."""
    g = torch.Generator(device=device).manual_seed(seed)

    def channels_last():
        return torch.randn(shape, generator=g, device=device).to(dtype) \
            .contiguous(memory_format=torch.channels_last)

    x = channels_last()
    residual = None if form == "relu" else channels_last()
    bn = random_norm(shape[1], g, device)
    residual_bn = random_norm(shape[1], g, device) if (
        form == "downsample") else None
    return x, residual, bn, residual_bn


def bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bits, as integers of its width."""
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])
