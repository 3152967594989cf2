"""The port's optimizer and train step against the JAX package's, on the CPU.

A tiny float32 model (2+2 layers, d_model 64, dropout 0) with noise-filled
weights bridged from the JAX tree takes the same step on the same synthetic
batch in both frameworks. Compared: every loss term, ``grad_norm``, every
gradient (the JAX gradient tree goes through the same bridge as the
parameters), and the updated parameters. The JAX programs are jitted once,
in a module-scoped fixture.

Learning rates are 1000x the recipe's (2e-3 / 2e-4 / 2e-2) so that one
update is many float32 steps of a weight of order 1 and a wrong update
cannot hide in the rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from egtr_tpu.config import EgtrConfig as JaxConfig
from egtr_tpu.models.egtr import EgtrModel as JaxEgtrModel
from egtr_tpu.train import optim as jax_optim
from egtr_tpu.train import train_step as jax_train_step
from egtr_tpu_torch.config import EgtrConfig
from egtr_tpu_torch.models.egtr import EgtrModel
from egtr_tpu_torch.scripts import perf_train_step
from egtr_tpu_torch.train.optim import make_optimizer, param_label
from egtr_tpu_torch.train.train_step import (make_eval_step, make_train_step,
                                             split_microbatches)
from egtr_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_model import TINY, jax_params

torch.set_num_threads(1)

# the CPU backend cannot reuse the donated train state; irrelevant here
pytestmark = pytest.mark.filterwarnings("ignore:Some donated buffers")

CFG = dict(TINY, auxiliary_loss=True, max_gt_boxes=6, max_gt_rels=8)
LRS = dict(lr=2e-3, lr_backbone=2e-4, lr_initialized=2e-2)
GROUP_LR = {"main": 2e-3, "backbone": 2e-4, "initialized": 2e-2}
HW = (64, 96)


def make_batch(seed, B):
    rng = np.random.default_rng(seed)
    G, R, C = CFG["max_gt_boxes"], CFG["num_rel_labels"], CFG["num_labels"]
    rel = np.zeros((B, G, G, R), np.float32)
    rel[:, 0, 1, 1] = 1.0
    rel[:, 2, 3, 4] = 1.0
    cxcy = rng.uniform(0.3, 0.7, (B, G, 2))
    wh = rng.uniform(0.1, 0.4, (B, G, 2))
    return {
        "pixel_values": rng.standard_normal((B, *HW, 3)).astype(np.float32),
        "pixel_mask": np.ones((B, *HW), bool),
        "labels": {
            "class_labels": rng.integers(0, C, (B, G)).astype(np.int32),
            "boxes": np.concatenate([cxcy, wh], -1).astype(np.float32),
            "num_boxes": np.full((B,), 4, np.int32),
            "rel": rel,
        },
    }


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def to_np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


@pytest.fixture(scope="module")
def reference():
    """The JAX side, computed once: gradients and loss terms of microbatch 0
    (``grads_mb``), and one accumulated step (A=2) over a batch of 4."""
    jcfg = JaxConfig(**CFG)
    jm = JaxEgtrModel(jcfg)
    batch = make_batch(0, 4)
    params = jax_params(jm, 1, jnp.asarray(batch["pixel_values"][:1]))
    tx = jax_optim.make_optimizer(**LRS)
    step = jax_train_step.make_train_step(jm, jcfg, tx, accum_steps=2)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    rng = jax.random.PRNGKey(0)
    mb0, mb1 = jax_train_step.split_microbatches(batch, 2)
    grads, total, losses = step.grads_mb(jparams, mb0, rng)
    grads, total, losses = to_np_tree((grads, total, losses))
    grads1 = to_np_tree(step.grads_mb(jparams, mb1, rng)[0])
    accum_grads = jax.tree_util.tree_map(lambda a, b: 0.5 * (a + b), grads,
                                         grads1)
    labels = jax.tree_util.tree_map_with_path(
        lambda path, _: jax_optim.param_label(path), params)
    state = jax_train_step.create_state(jparams, tx)
    state, metrics = step(state, batch, rng)
    return {
        "cfg": EgtrConfig(**CFG), "batch": batch, "params": params,
        "mb0": mb0, "mb0_grads": grads, "mb0_total": total,
        "mb0_losses": losses, "labels": labels, "accum_grads": accum_grads,
        "accum_params": to_np_tree(state.params),
        "accum_metrics": to_np_tree(metrics),
    }


def port_model(ref):
    model = EgtrModel(ref["cfg"])
    model.load_state_dict(state_dict_from_jax(ref["params"], ref["cfg"]),
                          strict=True)
    return model


def test_jax_clip_norm_covers_frozen_leaves():
    """What the port is held to: in egtr_tpu the global-norm clip runs before
    the per-label transforms, so a frozen leaf's gradient shrinks the
    trainable leaves' clipped gradients, while it gets a zero update
    itself."""
    params = {"params": {"model": {
        "backbone": {"bn1": {"weight": jnp.ones((4,))}},
        "fc": {"kernel": jnp.ones((4,))}}}}
    grads = {"params": {"model": {
        "backbone": {"bn1": {"weight": jnp.full((4,), 3.0)}},
        "fc": {"kernel": jnp.full((4,), 4.0)}}}}
    norm = float(optax.global_norm(grads))
    assert norm == pytest.approx(10.0)  # sqrt(4*9 + 4*16): both leaves
    # plain SGD behind the same chain shows the clipped gradient directly
    tx = optax.chain(optax.clip_by_global_norm(0.1), optax.multi_transform(
        {"main": optax.sgd(1.0), "frozen": optax.set_to_zero()},
        lambda p: jax.tree_util.tree_map_with_path(
            lambda path, _: "frozen" if jax_optim.param_label(path) == "frozen"
            else "main", p)))
    updates, _ = tx.update(grads, tx.init(params), params)
    u = updates["params"]["model"]
    np.testing.assert_allclose(u["fc"]["kernel"], -4.0 / 10.0 * 0.1, rtol=1e-6)
    np.testing.assert_array_equal(u["backbone"]["bn1"]["weight"], 0.0)


def test_param_labels_match_jax(reference):
    """Same label for every parameter of a bridged model; the frozen set
    holds the frozen-BN leaves and the frequency-bias tables."""
    by_name = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                # the bridge's renames (utils/convert.py:_leaf)
                leaf = "weight" if k in ("kernel", "scale") else k
                by_name[".".join(prefix + (leaf,))] = v

    walk(reference["labels"]["params"], ())
    model = port_model(reference)
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(by_name)
    for name in names:
        assert param_label(name) == by_name[name], name
    labels = {n: param_label(n) for n in names}
    assert labels["rel_dist"] == labels["triplet_dist"] == "frozen"
    assert labels["model.backbone.layer3_0.bn2.running_var"] == "frozen"
    assert labels["model.backbone.layer2_0.conv2.weight"] == "backbone"
    assert labels["model.reference_points.weight"] == "backbone"
    assert labels["relation_head.proj_q_0.weight"] == "initialized"
    assert labels["model.class_embed_0.weight"] == "main"
    assert set(labels.values()) == {"main", "backbone", "initialized",
                                    "frozen"}


def test_param_label_initialized_paths():
    paths = ["params/model/class_embed_0", "relation_head/proj_q_0/weight"]
    assert param_label("model.class_embed_0.bias", paths) == "initialized"
    assert param_label("relation_head.proj_q_0.weight", paths) == "initialized"
    assert param_label("relation_head.proj_q_0.bias", paths) == "main"
    assert param_label("relation_head.proj_k_0.weight", paths) == "main"
    assert param_label("rel_dist", ["rel_dist"]) == "frozen"


def _old_params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _check_update(model, old, new_ref, grads_ref, labels, lr_scale=1.0):
    """Updated parameters against the JAX ones. The first Adam step is
    g/(|g|+eps) of the clipped gradient g: where |g| <= 1e-6 summation noise
    decides its size, so there the difference is only bounded by twice the
    learning rate; elsewhere the two updates agree to 2% of the learning rate
    plus a float32 step of the weight. (optax decays and steps at once, torch
    decays first: equal to first order in lr*wd = 2e-6.)"""
    norm = np.sqrt(sum(float((g.double() ** 2).sum())
                       for g in grads_ref.values()))
    clip = min(1.0, 0.1 / norm)
    n_big = n_all = 0
    for name, p in model.named_parameters():
        lr = GROUP_LR.get(labels[name])
        if lr is None:
            assert torch.equal(p, old[name]), f"frozen leaf moved: {name}"
            np.testing.assert_array_equal(new_ref[name].numpy(),
                                          old[name].numpy(), err_msg=name)
            continue
        lr *= lr_scale
        d_port = (p.detach() - old[name]).numpy()
        d_ref = (new_ref[name] - old[name]).numpy()
        big = np.abs(grads_ref[name].numpy()) * clip > 1e-6
        ulp = 2.0 ** -22 * np.maximum(1.0, np.abs(old[name].numpy()))
        diff = np.abs(d_port - d_ref)
        assert (diff[big] <= 0.02 * lr + ulp[big]).all(), name
        assert (diff[~big] <= 2.0 * lr + ulp[~big]).all(), name
        n_big += int(big.sum())
        n_all += big.size
    assert n_big > 0.25 * n_all  # millions of entries get the tight bound


def test_train_step_matches_jax(reference):
    """A single step on microbatch 0: loss terms and gradients against
    ``grads_mb``; the clip scale from the JAX gradient norm."""
    ref = reference
    cfg = ref["cfg"]
    model = port_model(ref)
    opt = make_optimizer(model, **LRS)
    step = make_train_step(model, cfg, opt)
    metrics = step(to_torch(ref["mb0"]))
    assert set(metrics) == set(ref["mb0_losses"]) | {"total_loss", "grad_norm"}
    # float32, a ResNet + 2+2 layers + the criterion: summation order
    for k, v in ref["mb0_losses"].items():
        np.testing.assert_allclose(metrics[k].numpy(), v, rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(metrics["total_loss"].numpy(),
                               ref["mb0_total"], rtol=1e-4)
    jgrads = state_dict_from_jax(ref["mb0_grads"], cfg)
    jnorm = np.sqrt(sum(float((g.double() ** 2).sum())
                        for g in jgrads.values()))
    np.testing.assert_allclose(metrics["grad_norm"].numpy(), jnorm, rtol=1e-4)
    assert jnorm > 0.1  # the clip is active
    frozen_sq = sum(float((jgrads[n].double() ** 2).sum())
                    for n, l in opt.labels.items() if l == "frozen")
    assert frozen_sq > 1e-3 * jnorm ** 2  # and the frozen leaves weigh in
    # .grad holds the clipped gradients: (g / norm) * 0.1
    worst = 0.0
    for name, p in model.named_parameters():
        expect = jgrads[name] / jnorm * 0.1
        scale = max(float(expect.abs().max()), 1e-6)
        err = float((p.grad - expect).abs().max()) / scale
        worst = max(worst, err)
        # backward through the whole model: 1e-3 of each leaf's largest entry
        assert err < 1e-3, (name, err)
    assert worst > 0.0


def test_accumulated_step_matches_jax(reference):
    """accum_steps=2 over a batch of 4: averaged metrics, grad_norm and the
    updated parameters against the JAX accumulated step."""
    ref = reference
    cfg = ref["cfg"]
    model = port_model(ref)
    old = _old_params(model)
    opt = make_optimizer(model, **LRS)
    step = make_train_step(model, cfg, opt, accum_steps=2)
    metrics = step(to_torch(ref["batch"]))
    assert set(metrics) == set(ref["accum_metrics"])
    for k, v in ref["accum_metrics"].items():
        np.testing.assert_allclose(metrics[k].numpy(), v, rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    new_ref = state_dict_from_jax(ref["accum_params"], cfg)
    grads_ref = state_dict_from_jax(ref["accum_grads"], cfg)
    _check_update(model, old, new_ref, grads_ref, opt.labels)
    moved = sum(not torch.equal(p, old[n])
                for n, p in model.named_parameters())
    assert moved == sum(l != "frozen" for l in opt.labels.values())


def test_accumulated_equals_single_and_lr_scale(reference):
    """Port only: the same microbatch twice (rows interleaved, stride
    split) accumulates to the single step's gradient, metrics and update;
    lr_scale scales the whole update."""
    ref = reference
    cfg = ref["cfg"]
    mb = to_torch(ref["mb0"])

    def doubled(x):
        return torch.stack([x, x], dim=1).reshape(-1, *x.shape[1:])

    twice = {k: ({kk: doubled(vv) for kk, vv in v.items()}
                 if isinstance(v, dict) else doubled(v))
             for k, v in mb.items()}
    results = []
    for accum, batch, scale in ((1, mb, 1.0), (2, twice, 1.0),
                                (1, mb, 0.1)):
        model = port_model(ref)
        old = _old_params(model)
        opt = make_optimizer(model, **LRS)
        m = make_train_step(model, cfg, opt, accum_steps=accum)(
            batch, lr_scale=scale)
        delta = {n: (p.detach() - old[n]) for n, p in model.named_parameters()}
        results.append((m, delta))
    (m1, d1), (m2, d2), (m3, d3) = results
    for k in m1:
        torch.testing.assert_close(m1[k], m2[k], rtol=1e-6, atol=1e-7)
    for n in d1:
        torch.testing.assert_close(d1[n], d2[n], rtol=1e-4, atol=1e-7)
        # a tenth of the learning rate: a tenth of the update, to the
        # rounding of the weight
        torch.testing.assert_close(d3[n], 0.1 * d1[n], rtol=1e-3, atol=3e-7)


def test_split_microbatches():
    batch = to_torch(make_batch(1, 4))
    batch["valid"] = torch.tensor([True, True, False, True])
    mbs = split_microbatches(batch, 2)
    assert len(mbs) == 2 and set(mbs[0]) == set(batch)
    assert torch.equal(mbs[1]["pixel_values"], batch["pixel_values"][1::2])
    assert torch.equal(mbs[1]["labels"]["rel"], batch["labels"]["rel"][1::2])
    assert mbs[1]["valid"].tolist() == [True, True]
    with pytest.raises(ValueError, match="cannot be split"):
        split_microbatches(batch, 3)
    with pytest.raises(ValueError, match="cannot be split"):
        split_microbatches({"step": torch.tensor(3)}, 2)


def test_eval_step_matches_jax(reference):
    ref = reference
    cfg = ref["cfg"]
    jcfg = JaxConfig(**CFG)
    jstep = jax_train_step.make_eval_step(JaxEgtrModel(jcfg), jcfg)
    batch = dict(ref["mb0"], valid=np.array([True, False]))
    _, jlosses = jstep(jax.tree_util.tree_map(jnp.asarray, ref["params"]),
                       batch)
    model = port_model(ref)
    out, losses = make_eval_step(model, cfg)(to_torch(batch))
    assert not model.training and not out["logits"].requires_grad
    assert set(losses) == set(jlosses)
    for k, v in jlosses.items():
        np.testing.assert_allclose(losses[k].numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_dropout_train_eval_and_seed(reference):
    """Dropout is live only in train() mode, needs the step's generator, and
    repeats under the same seed."""
    cfg = reference["cfg"].replace(dropout=0.1, attention_dropout=0.1,
                                   activation_dropout=0.1)
    model = EgtrModel(cfg)
    model.load_state_dict(state_dict_from_jax(reference["params"], cfg))
    x = to_torch(reference["mb0"])["pixel_values"]

    def run(seed):
        g = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return model(x, generator=g)["logits"]

    model.eval()
    base = run(None)
    assert torch.equal(base, run(3))  # eval ignores the generator
    model.train()
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        run(None)
    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, base)
    assert torch.isfinite(a).all()
    # rate 0 in train mode is the eval output
    plain = port_model(reference).train()
    with torch.no_grad():
        assert torch.equal(plain(x)["logits"], base)


def test_dropout_function_keeps_the_mean():
    from egtr_tpu_torch.models.layers import dropout
    x = torch.ones((200, 200))
    g = torch.Generator().manual_seed(0)
    y = dropout(x, 0.25, True, g)
    assert y.unique().tolist() == pytest.approx([0.0, 1 / 0.75])
    assert float((y == 0).float().mean()) == pytest.approx(0.25, abs=0.01)
    assert dropout(x, 0.25, False, None) is x
    assert dropout(x, 0.0, True, None) is x


@pytest.mark.parametrize("option", ["use_remat"])
def test_train_options_refused(option):
    with pytest.raises(NotImplementedError, match=option):
        EgtrModel(EgtrConfig(**TINY, **{option: True}))


def test_profile_kernel_kinds():
    """The train profile's grouping of device kernels by name."""
    kind = perf_train_step.kernel_kind
    assert kind("void msda_bwd_value_kernel<__nv_bfloat16>(float const*)") == "msda"
    assert kind("sm90_xmma_wgrad_indexed_implicit_gemm_f32f32_tf32f32") == "convolution"
    assert kind("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8") == "matmul"
    assert kind("nvjet_tst_128x232_64x4_1x2_h_bz_coopA_bias_TNT") == "matmul"
    assert kind("void (anonymous namespace)::indexing_backward_kernel<float, 4>") == "index_scatter_sort"
    assert kind("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float>") == "normalization"
    assert kind("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::FusedAdam>") == "optimizer_foreach"
    assert kind("void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float>>") == "reduction"
    assert kind("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>") == "elementwise_copy"
    assert kind("something_else") == "other"


def test_perf_train_step_on_cpu(capsys):
    """The probe's own path at a tiny size: three steps, finite metrics,
    and the JSON line."""
    import json
    perf_train_step.main([
        "--device", "cpu", "--batch", "2", "--height", "64", "--width", "96",
        "--iters", "2", "--accum", "1", "--tiny"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["batch"] == 2 and result["image_hw"] == [64, 96]
    assert len(result["ms_per_step"]) == 2
    assert np.isfinite(result["total_loss"]) and result["grad_norm"] > 0
    assert result["device"] == "cpu"


def test_perf_train_step_windowed_on_cpu(capsys):
    """The probe's windowed step at a tiny size (window 4 bands the 8-row
    level 0 of a 64x96 image): finite metrics and the settings in the JSON
    line."""
    import json
    perf_train_step.main([
        "--device", "cpu", "--batch", "1", "--height", "64", "--width", "96",
        "--iters", "1", "--tiny", "--window", "4", "--band", "point",
        "--int8"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (result["msda_window"], result["msda_band"],
            result["msda_int8"]) == (4, "point", True)
    assert np.isfinite(result["total_loss"]) and result["grad_norm"] > 0


def test_adapt_config_is_the_adaptation_run():
    """The probe's adaptation preset is the configuration the JAX package's
    adaptation run saved (experiments/trained_offsets/adapt_w16p)."""
    from pathlib import Path
    run = (Path(__file__).resolve().parents[1] / "experiments"
           / "trained_offsets" / "adapt_w16p")
    assert perf_train_step.adapt_config() == EgtrConfig.load(
        str(run / "artifact" / "config.json"))
    import json
    header = json.loads((run / "train_log.jsonl").read_text().splitlines()[0])
    args = header["args"]
    assert (args["batch"], args["lr"], args["lr_backbone"]) == (
        perf_train_step.ADAPT_BATCH, perf_train_step.ADAPT_LRS["lr"],
        perf_train_step.ADAPT_LRS["lr_backbone"])
    assert (args["window"], args["band"], args["int8"]) == (16, "point",
                                                            False)
    # size 600 / max 1000, padded to a multiple of 16
    assert perf_train_step.ADAPT_HW == (608, 1008)
