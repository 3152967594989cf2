"""The port's backbone and the small functions around it against the JAX
package, on the CPU (float32 unless stated; tolerance: summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egtr_tpu.models import backbone as jax_backbone
from egtr_tpu.models import detr as jax_detr
from egtr_tpu.ops import boxes as jax_boxes
from egtr_tpu.ops import posenc as jax_posenc
from egtr_tpu_torch.config import EgtrConfig
from egtr_tpu_torch.models import backbone, detr
from egtr_tpu_torch.ops import boxes, posenc
from test_torch_model import jax_apply, jax_params, port_from_jax

torch.set_num_threads(1)

ATOL, RTOL = 1e-4, 1e-4


def _nchw_to_nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("name,dilation", [("resnet50", False),
                                           ("resnet50", True),
                                           ("resnet101", False)])
def test_backbone_matches_jax(name, dilation):
    cfg = EgtrConfig(backbone=name, dilation=dilation)
    x = np.random.default_rng(1).standard_normal((2, 64, 96, 3)).astype(
        np.float32)
    jm = jax_backbone.ResNet50(blocks=cfg.backbone_blocks, dilation=dilation)
    params = jax_params(jm, 5, jnp.asarray(x))
    ref = jax_apply(jm, params, jnp.asarray(x))
    pm = port_from_jax(backbone.ResNet50(cfg.backbone_blocks,
                                         dilation=dilation), params, cfg)
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    assert len(out) == len(ref) == 3
    for o, r in zip(out, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(_nchw_to_nhwc(o), r,
                                   atol=ATOL * np.abs(r).max(), rtol=RTOL)


def test_backbone_bf16_promotes_like_flax():
    """At bf16 only the stem runs in bf16: flax promotes the bottleneck
    convs (no dtype) to float32, so C3-C5 are float32 in both packages."""
    x = np.random.default_rng(2).standard_normal((1, 32, 32, 3)).astype(
        np.float32)
    jm = jax_backbone.ResNet50(dtype=jnp.bfloat16)
    params = jax_params(jm, 6, jnp.asarray(x))
    ref = jax_apply(jm, params, jnp.asarray(x))
    pm = port_from_jax(backbone.ResNet50(dtype=torch.bfloat16), params,
                       EgtrConfig())
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
        stem = pm.bn1(pm.conv1(torch.from_numpy(x).bfloat16().permute(
            0, 3, 1, 2)))
    assert [r.dtype for r in ref] == [jnp.float32] * 3
    assert [o.dtype for o in out] == [torch.float32] * 3
    assert stem.dtype == torch.bfloat16


def test_plain_stem_conv_matches_space_to_depth():
    """The JAX stem's space-to-depth form and the port's plain 7x7/s2 conv
    compute the same sum on the same [7,7,3,64] weights."""
    x = np.random.default_rng(3).standard_normal((2, 64, 96, 3)).astype(
        np.float32)
    jm = jax_backbone.StemConv(64)
    params = jax_params(jm, 7, jnp.asarray(x))
    ref = np.asarray(jax_apply(jm, params, jnp.asarray(x)))
    conv = backbone.Conv(3, 64, 7, stride=2, padding=3)
    conv.load_state_dict({"weight": torch.from_numpy(np.ascontiguousarray(
        params["params"]["kernel"].transpose(3, 2, 0, 1)))})
    with torch.no_grad():
        out = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(_nchw_to_nhwc(out), ref, atol=1e-5, rtol=1e-5)


def test_frozen_batchnorm_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 6, 16)).astype(np.float32)
    jm = jax_backbone.FrozenBatchNorm(16)
    params = jax_params(jm, 8, jnp.asarray(x))
    ref = np.asarray(jax_apply(jm, params, jnp.asarray(x)))
    pm = port_from_jax(backbone.FrozenBatchNorm(16), params, EgtrConfig())
    with torch.no_grad():
        out = pm(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(_nchw_to_nhwc(out), ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dilation", [False, True])
def test_level_shapes_match_jax(dilation):
    for hw in ((600, 1000), (608, 1008), (64, 96), (801, 1333)):
        assert detr.level_shapes(hw, 4, dilation) == jax_detr.level_shapes(
            hw, 4, dilation)
        assert detr.level_shapes(hw, 5, dilation) == jax_detr.level_shapes(
            hw, 5, dilation)


def _padded_mask():
    mask = np.ones((2, 61, 90), bool)
    mask[1, 37:] = False
    mask[1, :, 55:] = False
    return mask


def test_resize_mask_and_reference_points_match_jax():
    mask = _padded_mask()
    shapes = jax_detr.level_shapes(mask.shape[1:], 4)
    vr = []
    for hw in shapes:
        m = detr._resize_mask(torch.from_numpy(mask), hw)
        jmask = np.asarray(jax_detr._resize_mask(jnp.asarray(mask), hw))
        np.testing.assert_array_equal(m.numpy(), jmask)
        vr.append(np.stack([jmask[:, 0].sum(1) / hw[1],
                            jmask[:, :, 0].sum(1) / hw[0]], -1))
    vr = np.stack(vr, 1).astype(np.float32)
    ref = np.asarray(jax_detr.encoder_reference_points(shapes,
                                                       jnp.asarray(vr)))
    out = detr.encoder_reference_points(shapes, torch.from_numpy(vr))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=1e-6)


def test_sine_position_embedding_matches_jax():
    mask = _padded_mask()
    ref = np.asarray(jax_posenc.sine_position_embedding(jnp.asarray(mask), 32))
    out = posenc.sine_position_embedding(torch.from_numpy(mask), 32)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
    ref = np.asarray(jax_posenc.sine_position_embedding_full((10, 16), 32))
    out = posenc.sine_position_embedding_full((10, 16), 32)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_box_ops_match_jax():
    rng = np.random.default_rng(9)
    b = rng.uniform(0.05, 0.95, (3, 7, 4)).astype(np.float32)
    np.testing.assert_allclose(
        boxes.box_cxcywh_to_xyxy(torch.from_numpy(b)).numpy(),
        np.asarray(jax_boxes.box_cxcywh_to_xyxy(jnp.asarray(b))), atol=1e-7)
    np.testing.assert_allclose(
        boxes.box_xyxy_to_cxcywh(torch.from_numpy(b)).numpy(),
        np.asarray(jax_boxes.box_xyxy_to_cxcywh(jnp.asarray(b))), atol=1e-7)
    x = np.concatenate([b.reshape(-1), [0.0, 1.0, -0.5, 1.5, 1e-7]]).astype(
        np.float32)
    np.testing.assert_allclose(
        boxes.inverse_sigmoid(torch.from_numpy(x)).numpy(),
        np.asarray(jax_boxes.inverse_sigmoid(jnp.asarray(x))), atol=1e-5,
        rtol=1e-6)
