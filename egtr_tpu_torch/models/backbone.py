"""ResNet backbone with frozen BatchNorm (PyTorch port of
``egtr_tpu/models/backbone.py``).

Equivalent of the reference's timm backbone (``DeformableDetrTimmConvEncoder``,
model/deformable_detr.py:733-787) with ``DeformableDetrFrozenBatchNorm2d``
(:666-714). Takes NHWC pixels like the JAX package, runs NCHW inside and
returns the C3, C4, C5 maps (strides 8/16/32) as NCHW tensors.

Compute dtypes follow flax's promotion in the JAX module: the stem (conv,
frozen BN, max-pool) runs in the compute dtype, while the bottleneck convs
carry no dtype there, so a bf16 input against float32 weights is promoted
and C3-C5 come out float32 at any compute dtype.

The JAX stem computes the 7x7/s2 conv in a space-to-depth form for the TPU;
that is a relayout of the same sum, so the port uses the plain conv on the
same [7,7,3,64] weights.

Each frozen BN with what follows it (the ReLU; in a bottleneck's last one
the residual, through the downsample BN in a stage's first block) is one
epilogue, :func:`frozen_bn_act`: 49 sites in ResNet-50. XLA fuses it for the
JAX package; here an inference forward on the card (grad mode off) runs it
as one ``frozen_bn`` kernel a site, and the autograd path and the CPU run
PyTorch's expression (:func:`frozen_bn_act_plain`). Every activation is
channels_last, since the NHWC pixels are permuted and the convolutions keep
the format.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import msda_cuda
from .layers import Conv, Initialized, ones, zeros


class FrozenBatchNorm(Initialized):
    """BatchNorm with fixed statistics and affine params, in the input dtype.

    y = x * scale + bias, scale = weight * rsqrt(running_var + 1e-5),
    bias = bias - running_mean * scale (reference deformable_detr.py:704-714).
    """

    def __init__(self, features: int):
        super().__init__()
        for name, init in (("weight", ones), ("bias", zeros),
                           ("running_mean", zeros), ("running_var", ones)):
            self.param(name, (features,), init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * (self.running_var + 1e-5) ** -0.5
        shift = self.bias - self.running_mean * scale
        return (x * scale.to(x.dtype)[:, None, None]
                + shift.to(x.dtype)[:, None, None])

    def vectors(self) -> Tuple[torch.Tensor, ...]:
        """The four parameter vectors, in the ``frozen_bn`` kernel's order."""
        return self.weight, self.bias, self.running_mean, self.running_var


def frozen_bn_act_plain(x: torch.Tensor, bn: FrozenBatchNorm,
                        residual: Optional[torch.Tensor] = None,
                        residual_bn: Optional[FrozenBatchNorm] = None
                        ) -> torch.Tensor:
    """relu(bn(x) [+ residual_bn(residual) | + residual]) as PyTorch's
    kernels compute it: the autograd path, the CPU's, and what the kernel
    is held to."""
    out = bn(x)
    if residual is not None:
        out = out + (residual if residual_bn is None
                     else residual_bn(residual))
    return F.relu(out)


def _takes_kernel(x: torch.Tensor) -> bool:
    """Whether an inference map goes to the ``frozen_bn`` kernel: on a
    card, always (the kernel refuses a map in another layout than
    channels_last); on the CPU, never."""
    return x.device.type == "cuda"


def frozen_bn_act(x: torch.Tensor, bn: FrozenBatchNorm,
                  residual: Optional[torch.Tensor] = None,
                  residual_bn: Optional[FrozenBatchNorm] = None
                  ) -> torch.Tensor:
    """The epilogue of :func:`frozen_bn_act_plain`, bit for bit. With grad
    mode off, on a card, one ``frozen_bn`` launch that writes the result
    into x (a convolution's output, which nothing else reads); otherwise
    PyTorch's expression."""
    if not torch.is_grad_enabled() and _takes_kernel(x):
        return msda_cuda.frozen_bn(
            x, bn.vectors(), residual,
            None if residual_bn is None else residual_bn.vectors(), out=x)
    return frozen_bn_act_plain(x, bn, residual, residual_bn)


class Bottleneck(nn.Module):
    """torchvision/timm-style bottleneck v1.5 (stride on the 3x3 conv)."""

    def __init__(self, in_ch: int, width: int, stride: int = 1,
                 downsample: bool = False, expansion: int = 4,
                 dilation: int = 1):
        super().__init__()
        out_ch = width * expansion
        self.conv1 = Conv(in_ch, width, 1)
        self.bn1 = FrozenBatchNorm(width)
        self.conv2 = Conv(width, width, 3, stride=stride, padding=dilation,
                          dilation=dilation)
        self.bn2 = FrozenBatchNorm(width)
        self.conv3 = Conv(width, out_ch, 1)
        self.bn3 = FrozenBatchNorm(out_ch)
        self.has_downsample = downsample
        if downsample:
            self.downsample_conv = Conv(in_ch, out_ch, 1, stride=stride)
            self.downsample_bn = FrozenBatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = frozen_bn_act(self.conv1(x), self.bn1)
        out = frozen_bn_act(self.conv2(out), self.bn2)
        out = self.conv3(out)
        if self.has_downsample:
            return frozen_bn_act(out, self.bn3, self.downsample_conv(x),
                                 self.downsample_bn)
        return frozen_bn_act(out, self.bn3, x)


class ResNet50(nn.Module):
    """ResNet v1.5 trunk returning (C3, C4, C5) NCHW maps.

    ``blocks`` selects the depth (resnet50 3-4-6-3, resnet101 3-4-23-3).
    ``dilation=True`` is timm's ``output_stride=16``: layer4 keeps stride 16,
    its first block's stride moves into dilation (that block's 3x3 stays
    dilation 1; later blocks dilate by 2) and the downsample conv drops its
    stride. Same parameters either way.
    """

    def __init__(self, blocks: Sequence[int] = (3, 4, 6, 3),
                 widths: Sequence[int] = (64, 128, 256, 512),
                 out_stages: Sequence[int] = (2, 3, 4),
                 dtype: torch.dtype = torch.float32, dilation: bool = False):
        super().__init__()
        self.dtype = dtype
        self.out_stages = tuple(out_stages)
        self.blocks = tuple(blocks)
        self.conv1 = Conv(3, 64, 7, stride=2, padding=3, dtype=dtype)
        self.bn1 = FrozenBatchNorm(64)
        in_ch = 64
        for stage, (n_blocks, width) in enumerate(zip(blocks, widths)):
            dilate = dilation and stage == 3
            stride = 1 if stage == 0 or dilate else 2
            for b in range(n_blocks):
                self.add_module(f"layer{stage + 1}_{b}", Bottleneck(
                    in_ch, width, stride=stride if b == 0 else 1,
                    downsample=(b == 0),
                    dilation=2 if (dilate and b > 0) else 1))
                in_ch = width * 4

    def forward(self, pixel_values: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """pixel_values: [B, H, W, 3] (NHWC)."""
        x = pixel_values.to(self.dtype).permute(0, 3, 1, 2)
        x = frozen_bn_act(self.conv1(x), self.bn1)
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for stage, n_blocks in enumerate(self.blocks):
            for b in range(n_blocks):
                x = getattr(self, f"layer{stage + 1}_{b}")(x)
            if stage + 1 in self.out_stages:
                outs.append(x)
        return tuple(outs)
