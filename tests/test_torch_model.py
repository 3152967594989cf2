"""Parity of the PyTorch port (egtr_tpu_torch) with the JAX package, on the CPU.

The same seeded numpy inputs and the same weights go through the JAX module
and its port. Random flax init is degenerate for parity (the MSDA sampling
offsets, attention weights and the bbox head's last layer start at zero, so
sampling would not depend on the input), so every JAX parameter is first
overwritten with seeded numpy noise (``noisy_params``) and then bridged to
the port with ``state_dict_from_jax``.

Tolerances are stated per test; at float32 the two sides differ only in the
order of summation.
"""

import os
import re
import subprocess
import sys
from collections.abc import Mapping
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egtr_tpu.config import EgtrConfig as JaxConfig
from egtr_tpu.evaluation import postprocess as jax_post
from egtr_tpu.models import layers as jax_layers
from egtr_tpu.models.egtr import EgtrModel as JaxEgtrModel
from egtr_tpu.ops import msda_pallas as jax_pallas
from egtr_tpu.ops import msda_window as jax_window
from egtr_tpu_torch import infer as port_infer
from egtr_tpu_torch.config import EgtrConfig
from egtr_tpu_torch.evaluation import postprocess as port_post
from egtr_tpu_torch.models import layers as port_layers
from egtr_tpu_torch.models.egtr import EgtrModel
from egtr_tpu_torch.ops import msda as port_msda
from egtr_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

TINY = dict(
    d_model=64, encoder_layers=2, decoder_layers=2, encoder_ffn_dim=128,
    decoder_ffn_dim=128, encoder_attention_heads=8, decoder_attention_heads=8,
    num_queries=12, num_labels=7, num_rel_labels=5, num_feature_levels=4,
    dropout=0.0,
)

# float32, summation order only (a ResNet, 2+2 layers and the relation head)
ATOL, RTOL = 1e-4, 1e-4
COMPARED = ("logits", "pred_boxes", "pred_rel", "pred_connectivity",
            "pred_rel_logits", "attention_queries", "attention_keys")


def noisy_params(tree, seed: int):
    """Replace every leaf of a flax param tree with seeded numpy noise of a
    sane scale: kernels ~ N(0, 1/fan_in), norm and BN weights ~ 1, running
    variances in [0.5, 1.5], rel_dist > 0, everything else ~ N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def leaf(name, v):
        shape = np.shape(v)
        if name.endswith("kernel"):
            fan_in = int(np.prod(shape[:-1]))
            return rng.standard_normal(shape) / np.sqrt(fan_in)
        if name in ("scale", "weight"):
            return 1.0 + 0.1 * rng.standard_normal(shape)
        if name in ("running_var", "rel_dist"):
            return rng.uniform(0.5, 1.5, shape)
        if name in ("level_embed", "query_position_embeddings",
                    "row_embeddings", "column_embeddings", "triplet_dist"):
            return rng.standard_normal(shape)
        return 0.1 * rng.standard_normal(shape)

    def walk(node):
        return {k: walk(v) if isinstance(v, Mapping)
                else leaf(k, v).astype(np.float32) for k, v in node.items()}

    return walk(tree)


def jax_params(module, seed, *args):
    """Noise-filled params for a flax module. The tree's shapes come from
    jax.eval_shape, so nothing is initialized or compiled for them."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return {"params": noisy_params(shapes["params"], seed)}


def jax_apply(module, params, *args):
    """One jitted apply: a single compile instead of eager per-op ones."""
    return jax.jit(module.apply)(jax.tree_util.tree_map(jnp.asarray, params),
                                 *args)


def port_from_jax(module, params, cfg):
    module.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    return module.eval()


def to_np(t):
    return t.detach().float().numpy()


def _image(rng, B=1, H=64, W=96):
    return rng.standard_normal((B, H, W, 3)).astype(np.float32)


CASES = {
    # mask-free path, batch 1
    "unpadded": (dict(), False),
    # padded batch of 2: the second image is 48x64 inside the 64x96 bucket
    "padded": (dict(), True),
    # per-layer heads with box refinement, learned position embedding,
    # gelu FFNs and the logit-adjustment return quirk
    "refine_learned": (dict(with_box_refine=True,
                            position_embedding_type="learned",
                            activation_function="gelu",
                            logit_adjustment=True), False),
    # resnet101 block counts with C5 dilated (timm output_stride=16)
    "resnet101_dilation": (dict(backbone="resnet101", dilation=True), False),
    # the served approximations, on a 128x96 image: levels (16,12), (8,6),
    # (4,3), (2,2), so a window of 8 bands level 0 of the encoder's
    # self-attention and leaves the rest, and the decoder, exact. The JAX side
    # runs the Pallas kernels (interpret mode), so both run the banded
    # function and not its matmul oracle.
    "window8_tile": (dict(msda_window=8, msda_band="tile",
                          msda_impl="pallas"), False),
    "window8_point": (dict(msda_window=8, msda_band="point",
                           msda_impl="pallas"), False),
    "int8": (dict(msda_int8=True), False),
    "window8_point_int8": (dict(msda_window=8, msda_band="point",
                                msda_int8=True), False),
}

# int8: the two sides quantize values that differ in their last float32 bits
# (summation order), so a value within that distance of a rounding tie lands
# on the neighbouring int8 step, 1/127 of the level's largest value. The port
# alone shows it (test_int8_amplifies_round_off); with this test's noise-filled
# weights the two packages differ by up to 4e-3. A flipped band index would
# move the outputs further: it clamps a whole tile's samples to other rows.
INT8_ATOL = 1e-2
FLIPPED_BAND_ATOL = 5e-2


def _jax_band_indices(calls, window, band, D):
    """What the JAX functions choose on the inputs the port's windowed MSDA
    calls saw: [(level, bidx)] in the order of ``port_msda.band_index_log``."""
    out = []
    for shapes, loc, aw in calls:
        locT, awT = jax_pallas._rows_t(jnp.asarray(loc), jnp.asarray(aw))
        segs = jax_window.segment_bounds(loc.shape[1], shapes)
        for lid, (h, w) in enumerate(shapes):
            if h > window:
                out.append((lid, np.asarray(jax_pallas._win_level_rows(
                    locT[:, :, lid, 0], locT[:, :, lid, 1], awT[:, :, lid],
                    h, w, window, segs, jax_window.query_tile(window, D, w),
                    band == "point")[0])))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_matches_jax(case, monkeypatch):
    kw, padded = CASES[case]
    jcfg = JaxConfig(**TINY, **kw)
    cfg = EgtrConfig(**TINY, **kw)
    rng = np.random.default_rng(7)
    x = _image(rng, B=2 if padded else 1,
               H=128 if cfg.msda_window else 64)
    mask = None
    if padded:
        mask = np.ones(x.shape[:3], bool)
        mask[1, 48:] = False
        mask[1, :, 64:] = False
        x[1, 48:] = 0.0
        x[1, :, 64:] = 0.0
    jm = JaxEgtrModel(jcfg)
    params = jax_params(jm, 1, jnp.asarray(x[:1]))
    ref = jax_apply(jm, params, jnp.asarray(x),
                    None if mask is None else jnp.asarray(mask))

    # the inputs of the port's windowed MSDA calls, to count the band
    # indices on which the two packages disagree
    calls = []
    real = port_layers.ms_deform_attn

    def spy(value, shapes, loc, aw, **kwargs):
        if kwargs.get("window"):
            calls.append((shapes, loc.numpy(), aw.float().numpy()))
        return real(value, shapes, loc, aw, **kwargs)

    monkeypatch.setattr(port_layers, "ms_deform_attn", spy)
    monkeypatch.setattr(port_msda, "band_index_log", [])
    model = port_from_jax(EgtrModel(cfg), params, cfg)
    with torch.no_grad():
        out = model(torch.from_numpy(x),
                    None if mask is None else torch.from_numpy(mask))
    atol = INT8_ATOL if cfg.msda_int8 else ATOL
    if cfg.msda_window:
        ours = port_msda.band_index_log
        theirs = _jax_band_indices(calls, cfg.msda_window, cfg.msda_band,
                                   cfg.d_model // cfg.encoder_attention_heads)
        assert len(ours) == len(theirs) == cfg.encoder_layers  # level 0 each
        differing = sum(int((a.numpy() != b).sum())
                        for (_, a), (_, b) in zip(ours, theirs))
        total = sum(a.numel() for _, a in ours)
        print(f"{case}: {differing} of {total} band indices differ")
        if differing:
            atol = FLIPPED_BAND_ATOL
    else:
        assert not calls
    for key in COMPARED:
        assert out[key].shape == ref[key].shape, key
        np.testing.assert_allclose(to_np(out[key]), np.asarray(ref[key]),
                                   atol=atol, rtol=RTOL, err_msg=key)
    if kw.get("logit_adjustment"):
        # pred_rel is the sigmoid of the adjusted logits, pred_rel_logits
        # the unadjusted ones (egtr_tpu/models/egtr.py:194-203)
        assert not torch.allclose(out["pred_rel"],
                                  out["pred_rel_logits"].sigmoid())


def test_model_bf16_dtypes_match_jax():
    """At compute_dtype=bfloat16 every output has the JAX package's dtype
    (flax promotion mirrored module by module) and stays finite."""
    jcfg = JaxConfig(**TINY, compute_dtype="bfloat16")
    cfg = EgtrConfig(**TINY, compute_dtype="bfloat16")
    x = _image(np.random.default_rng(8))
    jm = JaxEgtrModel(jcfg)
    params = jax_params(jm, 2, jnp.asarray(x))
    ref = jax_apply(jm, params, jnp.asarray(x))
    model = port_from_jax(EgtrModel(cfg), params, cfg)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    for key, r in ref.items():
        if r is None:
            continue
        assert str(out[key].dtype).replace("torch.", "") == str(r.dtype), key
        assert torch.isfinite(out[key].float()).all(), key
    # bf16 rounds at different places in the two frameworks; the boxes stay
    # within a few bf16 ulps of the JAX ones
    np.testing.assert_allclose(to_np(out["pred_boxes"]),
                               np.asarray(ref["pred_boxes"]), atol=5e-2)


@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_layer_matches_jax(kind):
    """One encoder / decoder layer at d_model=64 against the flax module
    (float32; tolerance: summation order only)."""
    rng = np.random.default_rng(3)
    shapes = ((6, 9), (3, 5))
    S = sum(h * w for h, w in shapes)
    E, F, H, L, P = 64, 128, 8, 2, 4
    Q = S if kind == "encoder" else 10
    hidden = rng.standard_normal((2, Q, E)).astype(np.float32)
    pos = rng.standard_normal((2, Q, E)).astype(np.float32)
    ref_pts = rng.uniform(0.1, 0.9, (2, Q, L, 2)).astype(np.float32)
    memory = rng.standard_normal((2, S, E)).astype(np.float32)
    vmask = np.ones((2, S), bool)
    vmask[1, ::3] = False
    if kind == "encoder":
        jl = jax_layers.EncoderLayer(E, F, H, L, P, 0.0)
        args = (hidden, pos, ref_pts, shapes, vmask)
        pl = port_layers.EncoderLayer(E, F, H, L, P)
    else:
        jl = jax_layers.DecoderLayer(E, F, H, L, P, 0.0)
        args = (hidden, pos, memory, ref_pts, shapes, vmask)
        pl = port_layers.DecoderLayer(E, F, H, L, P)
    jargs = [a if isinstance(a, tuple) else jnp.asarray(a) for a in args]
    params = {"params": noisy_params(
        jl.init(jax.random.PRNGKey(0), *jargs)["params"], 4)}
    ref = jl.apply(jax.tree_util.tree_map(jnp.asarray, params), *jargs)
    pl = port_from_jax(pl, params, EgtrConfig())
    targs = [a if isinstance(a, tuple) else torch.from_numpy(a) for a in args]
    with torch.no_grad():
        out = pl(*targs)
    if kind == "encoder":
        ref, out = (ref,), (out,)
    for r, o in zip(ref, out):
        np.testing.assert_allclose(to_np(o), np.asarray(r), atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("use_log_softmax", [False, True])
def test_compute_freq_dists_matches_jax(use_log_softmax):
    """Including the reference's ``+ eps/(sum+eps)`` precedence quirk."""
    from egtr_tpu.models.egtr import compute_freq_dists as jax_freq
    from egtr_tpu_torch.models.egtr import compute_freq_dists

    fg = np.random.default_rng(6).integers(0, 5, (8, 8, 5)).astype(np.float32)
    fg[0, 0] = 0.0  # an all-zero row: log(eps/eps + 0) stays finite
    ref = jax_freq(fg, 1e-3, use_log_softmax)
    out = compute_freq_dists(fg, 1e-3, use_log_softmax)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6)


def test_sgg_postprocess_matches_jax():
    """Same model outputs through both postprocessors. Scores are
    continuous random values, so top-k has no ties to order differently."""
    rng = np.random.default_rng(5)
    B, Q, C, R = 2, 12, 8, 5
    logits = rng.standard_normal((B, Q, C)).astype(np.float32)
    boxes = rng.uniform(0, 1, (B, Q, 4)).astype(np.float32)
    rel = rng.uniform(0, 1, (B, Q, Q, R)).astype(np.float32)
    conn = rng.uniform(0, 1, (B, Q, Q, 1)).astype(np.float32)
    ref = jax_post.sgg_postprocess(*map(jnp.asarray, (logits, boxes, rel, conn)),
                                   num_labels=C - 1, top_k=50)
    out = port_post.sgg_postprocess(*map(torch.from_numpy,
                                         (logits, boxes, rel, conn)),
                                    num_labels=C - 1, top_k=50)
    assert set(out) == set(ref)
    for key in ref:
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-6, atol=1e-7, err_msg=key)

    sizes = np.array([[480, 640], [600, 800]], np.int32)
    dref = jax_post.detection_postprocess(jnp.asarray(logits),
                                          jnp.asarray(boxes),
                                          jnp.asarray(sizes), top_k=20)
    dout = port_post.detection_postprocess(torch.from_numpy(logits),
                                           torch.from_numpy(boxes),
                                           torch.from_numpy(sizes), top_k=20)
    for key in dref:
        np.testing.assert_allclose(dout[key].numpy(), np.asarray(dref[key]),
                                   rtol=1e-6, atol=1e-5, err_msg=key)


def _leaf_count(tree):
    return sum(_leaf_count(v) if isinstance(v, Mapping) else 1
               for v in tree.values())


@pytest.mark.parametrize("width", ["tiny", "full"])
def test_state_dict_covers_every_leaf(width):
    """Every JAX leaf lands on exactly one port tensor, and
    load_state_dict(strict=True) accepts the result. The full-width model is
    the bench config (R50, d_model 256, 6+6 layers, 200 queries); its JAX
    tree comes from jax.eval_shape and the port is built on the meta
    device, so nothing is computed."""
    kw = TINY if width == "tiny" else dict(num_queries=200, num_labels=150,
                                           num_rel_labels=50)
    x = jnp.zeros((1, 64, 96, 3), jnp.float32)
    shapes = jax.eval_shape(JaxEgtrModel(JaxConfig(**kw)).init,
                            jax.random.PRNGKey(0), x)["params"]
    tree = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    cfg = EgtrConfig(**kw)
    sd = state_dict_from_jax({"params": tree}, cfg)
    assert len(sd) == _leaf_count(tree)
    with torch.device("meta"):
        model = EgtrModel(cfg)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True, assign=True)
    with pytest.raises(RuntimeError, match="Missing key"):
        model.load_state_dict(
            {k: v for k, v in sd.items() if "triplet_dist" not in k},
            strict=True)


def test_state_dict_rejects_wrong_depth():
    cfg = EgtrConfig(**TINY)
    tree = {"model": {"backbone": {f"layer3_{b}": {} for b in range(23)}}}
    with pytest.raises(ValueError, match="block counts"):
        state_dict_from_jax({"params": tree}, cfg)


def test_config_mirrors_jax_config():
    """Same fields, defaults, validation and JSON round-trip as egtr_tpu's."""
    import dataclasses

    jd = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    pd = {f.name: f.default for f in dataclasses.fields(EgtrConfig)}
    assert jd == pd
    cfg = EgtrConfig(**TINY, compute_dtype="bfloat16")
    assert EgtrConfig.from_json(cfg.to_json()) == cfg
    assert JaxConfig.from_json(cfg.to_json()) == JaxConfig(
        **TINY, compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="backbone"):
        EgtrConfig(backbone="resnet18")


@pytest.mark.parametrize("option", ["msda_window", "msda_int8", "two_stage",
                                    "use_remat"])
def test_refused_options(option):
    """``two_stage`` and ``use_remat`` are refused at construction. The
    banded approximation and int8 stage 1 construct and run; the banded one
    also trains (forward and backward through a banded level). int8 is
    refused on the plain "matmul" path, as in the JAX package."""
    value = {"msda_window": 4, "msda_int8": True, "two_stage": True,
             "use_remat": True}[option]
    kw = {option: value}
    if option == "msda_int8":
        kw["msda_impl"] = "matmul"
    cfg = EgtrConfig(**TINY, **kw)
    if option in ("two_stage", "use_remat"):
        with pytest.raises(NotImplementedError, match=option):
            EgtrModel(cfg)
        return
    model, x = port_infer.build(cfg, 1, 64, 96, device="cpu", seed=0)
    if option == "msda_int8":
        with pytest.raises(ValueError, match="int8 stage-1"):
            port_infer.infer(model, x)
        return
    assert torch.isfinite(port_infer.infer(model, x)).all()
    out = model.train()(x)
    loss = out["logits"].float().square().mean() + out[
        "pred_boxes"].float().sum()
    loss.backward()
    grads = [p.grad for n, p in model.named_parameters()
             if "encoder_layer_0.self_attn.sampling_offsets" in n]
    assert grads and all(g is not None and torch.isfinite(g).all()
                         and g.abs().max() > 0 for g in grads)


def test_serving_config_constructs_and_runs():
    """The JAX package's serving default (bench.py:154-160) in the port."""
    cfg = port_infer.serving_config()
    assert (cfg.msda_window, cfg.msda_band, cfg.msda_int8) == (16, "point",
                                                               True)
    assert cfg == port_infer.bench_config(msda_window=16, msda_band="point",
                                          msda_int8=True)
    assert EgtrConfig(msda_window=16, msda_band="point", msda_int8=True)
    # at 272x96 level 0 has 34 rows (banded by a window of 16) and level 1
    # has 17 (banded too); levels 2 and 3 are exact
    tiny = port_infer.serving_config(**TINY)
    model, x = port_infer.build(tiny, 1, 272, 96, device="cpu", seed=1)
    port_msda.band_index_log = log = []
    try:
        packed = port_infer.infer(model, x)
    finally:
        port_msda.band_index_log = None
    assert torch.isfinite(packed).all()
    assert [lid for lid, _ in log] == [0, 1] * tiny.encoder_layers
    assert all(b.dim() == 4 for _, b in log)


def test_int8_amplifies_round_off():
    """Why whole-model comparisons of int8 configurations get a looser limit:
    float32 noise of 2e-7 (relative) on the input image moves the exact
    model's logits by a few 1e-7 and the int8 model's by two orders more,
    because a value on a quantization tie changes by a whole int8 step."""
    moved = {}
    for int8 in (False, True):
        cfg = EgtrConfig(**TINY, msda_int8=int8)
        model, x = port_infer.build(cfg, 1, 128, 96, device="cpu", seed=0)
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith(("sampling_offsets.weight",
                                  "attention_weights.weight")):
                    p.normal_(0.0, 0.1, generator=g)
            base = model(x)["logits"]
            moved[int8] = max(
                (model(x * (1 + 2e-7 * torch.randn(x.shape, generator=g)))
                 ["logits"] - base).abs().max().item() for _ in range(3))
    print(f"logits moved by {moved[False]:.2e} exact, {moved[True]:.2e} int8")
    assert moved[False] < 5e-6
    assert moved[True] > 20 * moved[False]


def test_served_flags_add_no_parameters():
    """The banded approximation and int8 stage 1 have no weights of their
    own: the flax tree, the bridged state dict and the port's parameters are
    the same with and without the three flags."""
    x = jnp.zeros((1, 64, 96, 3), jnp.float32)
    served = dict(msda_window=16, msda_band="point", msda_int8=True)

    def jax_tree(**kw):
        return jax.eval_shape(JaxEgtrModel(JaxConfig(**TINY, **kw)).init,
                              jax.random.PRNGKey(0), x)["params"]

    exact, approx = jax_tree(), jax_tree(**served)
    assert jax.tree_util.tree_structure(exact) == \
        jax.tree_util.tree_structure(approx)
    assert jax.tree_util.tree_leaves(exact) == jax.tree_util.tree_leaves(approx)
    tree = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), approx)
    cfg = EgtrConfig(**TINY, **served)
    sd = state_dict_from_jax({"params": tree}, cfg)
    assert set(sd) == set(state_dict_from_jax({"params": tree},
                                              EgtrConfig(**TINY)))
    with torch.device("meta"):
        a, b = EgtrModel(cfg), EgtrModel(EgtrConfig(**TINY))
    assert set(sd) == set(a.state_dict()) == set(b.state_dict())


def test_build_without_device_needs_cuda(monkeypatch):
    """No silent CPU: the entry point defaults to CUDA and raises without it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_infer.build(EgtrConfig(**TINY), 1, 64, 96)


def test_infer_packs_outputs_on_cpu():
    cfg = EgtrConfig(**TINY)
    model, x = port_infer.build(cfg, 1, 64, 96, device="cpu", seed=3)
    packed = port_infer.infer(model, x)
    k = min(100, cfg.num_queries ** 2)
    Q, R = cfg.num_queries, cfg.num_rel_labels
    assert packed.shape == (k * 3 + k + k * 2 + k * R + Q + Q + Q * 4,)
    assert torch.isfinite(packed).all()
    # the seed fixes the weights and the input
    model2, x2 = port_infer.build(cfg, 1, 64, 96, device="cpu", seed=3)
    assert torch.equal(x, x2)
    assert torch.equal(packed, port_infer.infer(model2, x2))


_IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|flax|egtr_tpu)(\.|\s|$)",
                        re.M)


def test_port_sources_import_no_jax():
    sources = sorted((REPO / "egtr_tpu_torch").rglob("*.py"))
    sources.append(REPO / "chip_smoke.py")
    assert len(sources) > 10
    for path in sources:
        text = path.read_text()
        assert not _IMPORT_RE.search(text), path


def test_importing_the_port_loads_no_jax():
    """Import every module of the port and chip_smoke in a fresh process:
    neither jax nor egtr_tpu may end up in sys.modules."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "egtr_tpu_torch").rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {modules + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'egtr_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
