"""Transformer building blocks (PyTorch port of ``egtr_tpu/models/layers.py``).

- :class:`Dense`, :class:`Conv` — flax ``nn.Dense``/``nn.Conv`` semantics:
  computed in ``dtype``, or, where it is None, in the promotion of the input
  and parameter dtypes (a bf16 input against float32 weights runs in float32,
  as flax promotes it).
- :class:`MLPHead`            — DeformableDetrMLPPredictionHead (deformable_detr.py:2865-2883)
- :class:`MultiheadAttention` — decoder self-attention exposing scaled Q / K
                                (deformable_detr.py:1107-1262)
- :class:`MSDeformableAttention` — linear sampling heads + the MSDA core
                                (deformable_detr.py:963-1104)
- :class:`EncoderLayer` / :class:`DecoderLayer` (deformable_detr.py:1265-1489)

Dropout (:func:`dropout`) is active only in ``train()`` mode (the JAX
modules' ``deterministic=False``), at the JAX package's sites, and draws its
masks from the ``torch.Generator`` handed down the forward call, never from
the global random state.

Submodules and parameters are named after the flax tree
(``self_attn.value_proj``, ``fc1``, ``layers_0``), so the weight bridge
(``utils/convert.py``) is a mechanical walk. Parameters are created empty;
:func:`init_params` fills them as the flax initializers would (with a
``torch.Generator``, so the numbers differ from JAX's).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.msda import ms_deform_attn

Init = Callable[[torch.Tensor, torch.Generator], None]


def normal_init(std: float) -> Init:
    def init(t, g):
        with torch.no_grad():
            t.normal_(0.0, std, generator=g)
    return init


def uniform_init(low: float, high: float) -> Init:
    def init(t, g):
        with torch.no_grad():
            t.uniform_(low, high, generator=g)
    return init


def constant_init(value) -> Init:
    """A scalar, or an array broadcast to the parameter's shape."""
    def init(t, g):
        with torch.no_grad():
            t.copy_(torch.as_tensor(value, dtype=t.dtype).expand(t.shape))
    return init


def xavier_uniform(t, g):
    nn.init.xavier_uniform_(t, generator=g)


def lecun_normal(t, g):
    """flax's default conv/dense kernel init: truncated normal (two standard
    deviations) with variance 1/fan_in."""
    fan_in = t[0].numel() if t.dim() > 1 else t.numel()
    # the std of a unit normal truncated at +-2 is 0.8796..., so scale up
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=g)


zeros = constant_init(0.0)
ones = constant_init(1.0)


class Initialized(nn.Module):
    """A module whose own parameters carry their flax init.

    ``self.inits`` maps a direct parameter name to its initializer;
    :func:`init_params` walks a model and applies them in module order.
    """

    def __init__(self):
        super().__init__()
        self.inits: Dict[str, Init] = {}

    def param(self, name: str, shape: Sequence[int], init: Init
              ) -> torch.Tensor:
        """Every flax param is an ``nn.Parameter`` here, the frozen ones too
        (frozen-BN statistics, the frequency-bias tables): the JAX package
        differentiates all of them and its clip norm covers their gradients,
        so the train step needs those gradients as well. The optimizer
        (``train/optim.py``) gives the frozen set no update."""
        setattr(self, name, nn.Parameter(
            torch.empty(tuple(shape), dtype=torch.float32)))
        self.inits[name] = init
        return getattr(self, name)


def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter of ``model`` with its flax-style init."""
    for module in model.modules():
        if isinstance(module, Initialized):
            for name, init in module.inits.items():
                init(getattr(module, name), generator)
    return model


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate`` and scale the
    kept values by ``1 / (1 - rate)``. Identity unless ``training`` and
    ``rate > 0``; then ``generator`` (on the tensor's device) is required."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError(
            "dropout in train() mode needs a torch.Generator: pass "
            "generator=... to the model's forward (or call model.eval())")
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, device=x.device, generator=generator) >= rate
    return x * keep.to(x.dtype) / (1.0 - rate)


def _promote(x: torch.Tensor, dtype: Optional[torch.dtype],
             w: torch.Tensor) -> torch.dtype:
    return dtype if dtype is not None else torch.promote_types(x.dtype, w.dtype)


class Dense(Initialized):
    """flax ``nn.Dense``: ``y = x @ W.T + b`` in the module's compute dtype."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: Optional[torch.dtype] = None,
                 kernel_init: Init = normal_init(0.02), bias_init: Init = zeros,
                 bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.param("weight", (out_features, in_features), kernel_init)
        if bias:
            self.param("bias", (out_features,), bias_init)
        else:
            self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _promote(x, self.dtype, self.weight)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Conv(Initialized):
    """flax ``nn.Conv`` on NCHW tensors, weights OIHW."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, bias: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 kernel_init: Init = lecun_normal):
        super().__init__()
        self.dtype = dtype
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.param("weight", (out_ch, in_ch, kernel, kernel), kernel_init)
        if bias:
            self.param("bias", (out_ch,), zeros)
        else:
            self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _promote(x, self.dtype, self.weight)
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), b, self.stride,
                        self.padding, self.dilation)


# FFN activation (the config's ``activation_function``; reference ACT2FN at
# deformable_detr.py:1297,1396). "gelu" is the exact erf form.
ACT_FN = {
    "relu": F.relu,
    "gelu": F.gelu,
    "silu": F.silu,
}


class LayerNorm(Initialized):
    """LayerNorm with float32 statistics (eps 1e-5); the output is cast to
    ``dtype`` or, where it is None, back to the input dtype."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.param("weight", (features,), ones)
        self.param("bias", (features,), zeros)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                         self.bias.float(), eps=1e-5)
        return y.to(self.dtype if self.dtype is not None else x.dtype)


class MLPHead(nn.Module):
    """n-layer ReLU MLP (bbox / relation / connectivity heads).

    ``final_kernel_zero``/``final_bias`` give the bbox-head init (last-layer
    weight zero, bias[2:] = -2; egtr.py:138-148)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 3, final_kernel_zero: bool = False,
                 final_bias: Optional[Tuple[float, ...]] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_layers = num_layers
        dims = [input_dim] + [hidden_dim] * (num_layers - 1)
        for i in range(num_layers - 1):
            self.add_module(f"layers_{i}", Dense(dims[i], hidden_dim, dtype))
        self.add_module(f"layers_{num_layers - 1}", Dense(
            dims[-1], output_dim, dtype,
            kernel_init=zeros if final_kernel_zero else normal_init(0.02),
            bias_init=zeros if final_bias is None else constant_init(
                np.asarray(final_bias, np.float32))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers - 1):
            x = F.relu(getattr(self, f"layers_{i}")(x))
        return getattr(self, f"layers_{self.num_layers - 1}")(x)


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of two tensors with float32 accumulation and result (JAX's
    ``preferred_element_type=float32``): low-precision inputs are upcast, so
    their products are exact."""
    return torch.matmul(a.float(), b.float())


class MultiheadAttention(nn.Module):
    """Self-attention over object queries, exposing per-head scaled Q and K.

    Q is post-scaling (q_proj(x) * d_h^-0.5), K the raw k_proj output, both
    [B, heads, Q, d_head] (deformable_detr.py:1179-1189). Plain matmul and
    softmax, so the captured Q/K are literally the attention operands."""

    def __init__(self, embed_dim: int, num_heads: int,
                 dtype: Optional[torch.dtype] = None, dropout: float = 0.0):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout = dropout  # on the attention probabilities
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, Dense(embed_dim, embed_dim, dtype))

    def forward(self, hidden_states, position_embeddings=None,
                generator=None):
        B, Q, E = hidden_states.shape
        H = self.num_heads
        Dh = E // H
        hs_pos = hidden_states if position_embeddings is None else (
            hidden_states + position_embeddings)
        q = self.q_proj(hs_pos) * Dh ** -0.5
        k = self.k_proj(hs_pos)
        v = self.v_proj(hidden_states)

        def heads(t):  # [B,Q,E] -> [B,H,Q,Dh]
            return t.reshape(B, Q, H, Dh).transpose(1, 2)

        qh, kh, vh = heads(q), heads(k), heads(v)
        attn = _matmul_f32(qh, kh.transpose(-1, -2)).softmax(-1).to(q.dtype)
        attn = dropout(attn, self.dropout, self.training, generator)
        out = _matmul_f32(attn, vh).to(q.dtype)
        out = out.transpose(1, 2).reshape(B, Q, E)
        return self.out_proj(out), qh, kh


def _msda_offset_bias(num_heads: int, n_levels: int, n_points: int):
    """Directional init of sampling offsets (deformable_detr.py:999-1019)."""
    thetas = np.arange(num_heads, dtype=np.float32) * (2.0 * math.pi / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)  # [H,2]
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid.reshape(num_heads, 1, 1, 2), (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1)


class MSDeformableAttention(nn.Module):
    """Multi-scale deformable attention module
    (DeformableDetrMultiscaleDeformableAttention, deformable_detr.py:963-1104).

    The sampling offsets and attention weights are computed in float32; the
    value and output projections in the compute dtype."""

    def __init__(self, d_model: int, num_heads: int, n_levels: int,
                 n_points: int, dtype: Optional[torch.dtype] = None,
                 msda_impl: str = "auto"):
        super().__init__()
        self.d_model, self.num_heads = d_model, num_heads
        self.n_levels, self.n_points = n_levels, n_points
        self.msda_impl = msda_impl
        H, L, P = num_heads, n_levels, n_points
        self.value_proj = Dense(d_model, d_model, dtype,
                                kernel_init=xavier_uniform)
        self.sampling_offsets = Dense(
            d_model, H * L * P * 2, torch.float32, kernel_init=zeros,
            bias_init=constant_init(_msda_offset_bias(H, L, P)))
        self.attention_weights = Dense(d_model, H * L * P, torch.float32,
                                       kernel_init=zeros)
        self.output_proj = Dense(d_model, d_model, dtype,
                                 kernel_init=xavier_uniform)

    def forward(self, hidden_states, encoder_hidden_states, reference_points,
                spatial_shapes, position_embeddings=None, value_mask=None):
        H, L, P = self.num_heads, self.n_levels, self.n_points
        E = self.d_model
        B, Q, _ = hidden_states.shape
        S = encoder_hidden_states.shape[1]
        hs = hidden_states if position_embeddings is None else (
            hidden_states + position_embeddings)

        value = self.value_proj(encoder_hidden_states)
        if value_mask is not None:
            value = value.masked_fill(~value_mask[..., None], 0.0)
        value = value.reshape(B, S, H, E // H)

        offsets = self.sampling_offsets(hs).reshape(B, Q, H, L, P, 2)
        weights = self.attention_weights(hs).reshape(B, Q, H, L * P)
        weights = weights.softmax(-1).reshape(B, Q, H, L, P)

        if reference_points.shape[-1] == 2:
            # normalize offsets by (w, h) per level (deformable_detr.py:1066-1073)
            wh = torch.tensor([[w, h] for (h, w) in spatial_shapes],
                              dtype=offsets.dtype, device=offsets.device)
            loc = (reference_points[:, :, None, :, None, :]
                   + offsets / wh[None, None, None, :, None, :])
        elif reference_points.shape[-1] == 4:
            loc = (reference_points[:, :, None, :, None, :2]
                   + offsets / P * reference_points[:, :, None, :, None, 2:]
                   * 0.5)
        else:
            raise ValueError("reference_points last dim must be 2 or 4")

        out = ms_deform_attn(value, spatial_shapes, loc.float().contiguous(),
                             weights.to(value.dtype), impl=self.msda_impl)
        return self.output_proj(out)


class EncoderLayer(nn.Module):
    """MSDA self-attention + FFN. Reference: deformable_detr.py:1265-1358."""

    def __init__(self, d_model: int, ffn_dim: int, num_heads: int,
                 n_levels: int, n_points: int, activation: str = "relu",
                 dtype: Optional[torch.dtype] = None, msda_impl: str = "auto",
                 dropout: float = 0.0, activation_dropout: float = 0.0):
        super().__init__()
        self.activation = ACT_FN[activation]
        self.dropout, self.activation_dropout = dropout, activation_dropout
        self.self_attn = MSDeformableAttention(d_model, num_heads, n_levels,
                                               n_points, dtype, msda_impl)
        self.self_attn_layer_norm = LayerNorm(d_model, dtype)
        self.fc1 = Dense(d_model, ffn_dim, dtype)
        self.fc2 = Dense(ffn_dim, d_model, dtype)
        self.final_layer_norm = LayerNorm(d_model, dtype)

    def forward(self, hidden_states, position_embeddings, reference_points,
                spatial_shapes, value_mask=None, generator=None):
        def drop(x, rate):
            return dropout(x, rate, self.training, generator)

        residual = hidden_states
        hidden_states = self.self_attn(
            hidden_states, hidden_states, reference_points, spatial_shapes,
            position_embeddings=position_embeddings, value_mask=value_mask)
        hidden_states = drop(hidden_states, self.dropout)
        hidden_states = self.self_attn_layer_norm(residual + hidden_states)
        residual = hidden_states
        hidden_states = drop(self.activation(self.fc1(hidden_states)),
                             self.activation_dropout)
        hidden_states = drop(self.fc2(hidden_states), self.dropout)
        return self.final_layer_norm(residual + hidden_states)


class DecoderLayer(nn.Module):
    """Query self-attention (with q/k capture) -> MSDA cross-attention -> FFN.

    Reference: deformable_detr.py:1361-1489. Returns (hidden, q, k) where
    q/k are the per-head attention states [B, H, Q, d_head]."""

    def __init__(self, d_model: int, ffn_dim: int, num_heads: int,
                 n_levels: int, n_points: int, activation: str = "relu",
                 dtype: Optional[torch.dtype] = None, msda_impl: str = "auto",
                 dropout: float = 0.0, attention_dropout: float = 0.0,
                 activation_dropout: float = 0.0):
        super().__init__()
        self.activation = ACT_FN[activation]
        self.dropout, self.activation_dropout = dropout, activation_dropout
        self.self_attn = MultiheadAttention(d_model, num_heads, dtype,
                                            attention_dropout)
        self.self_attn_layer_norm = LayerNorm(d_model, dtype)
        self.encoder_attn = MSDeformableAttention(
            d_model, num_heads, n_levels, n_points, dtype, msda_impl)
        self.encoder_attn_layer_norm = LayerNorm(d_model, dtype)
        self.fc1 = Dense(d_model, ffn_dim, dtype)
        self.fc2 = Dense(ffn_dim, d_model, dtype)
        self.final_layer_norm = LayerNorm(d_model, dtype)

    def forward(self, hidden_states, query_pos, encoder_hidden_states,
                reference_points, spatial_shapes, value_mask=None,
                generator=None):
        def drop(x, rate):
            return dropout(x, rate, self.training, generator)

        residual = hidden_states
        hidden_states, q, k = self.self_attn(
            hidden_states, position_embeddings=query_pos, generator=generator)
        hidden_states = drop(hidden_states, self.dropout)
        hidden_states = self.self_attn_layer_norm(residual + hidden_states)
        residual = hidden_states
        hidden_states = self.encoder_attn(
            hidden_states, encoder_hidden_states, reference_points,
            spatial_shapes, position_embeddings=query_pos,
            value_mask=value_mask)
        hidden_states = drop(hidden_states, self.dropout)
        hidden_states = self.encoder_attn_layer_norm(residual + hidden_states)
        residual = hidden_states
        hidden_states = drop(self.activation(self.fc1(hidden_states)),
                             self.activation_dropout)
        hidden_states = drop(self.fc2(hidden_states), self.dropout)
        hidden_states = self.final_layer_norm(residual + hidden_states)
        return hidden_states, q, k
