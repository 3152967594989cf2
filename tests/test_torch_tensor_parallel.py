"""The port's model axis (``--mp``: the relation grid's subject rows split
over the ranks of a model group, ``parallel/tensor_parallel.py``) on the
CPU: real ranks under gloo (``parallel.launch.spawn``, one thread a rank),
against the JAX package's step under the same ``(dp, mp)`` mesh on the
virtual CPU devices and against one process of the port.

Two calls of ranks serve every test (``ranks``): two ranks (dp 1 x mp 2)
take the parity step at dropout 0, the same step at dropout 0.1, and a step
at 9 queries (an uneven split: 5 + 4 rows); four ranks (dp 2 x mp 2) take
the parity step and run the SGG evaluation. A forward hook records each
rank's ``h1`` (the input of ``rel_predictor_layers_1``). The JAX steps run
here meanwhile. Tolerances are ``test_torch_parallel``'s.

The rank functions (``rank_*``) live here and import no JAX.
"""

import functools
import hashlib
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from egtr_tpu_torch.config import EgtrConfig
from egtr_tpu_torch.models.egtr import EgtrHead
from egtr_tpu_torch.parallel import dist
from egtr_tpu_torch.parallel.launch import spawn
from egtr_tpu_torch.parallel.mesh import make_mesh, mesh_ranks
from egtr_tpu_torch.parallel.tensor_parallel import RowSplit
from test_torch_parallel import (EVAL_CFG, GRAD_ATOL, GRAD_RTOL, LOSS_KEYS,
                                 LRS, PARITY_CFG, REL_CATEGORIES, RTOL, Scenes,
                                 assert_same_metrics, loader, seeded_weights)

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
RANK_TIMEOUT_S = 240
N, HW = 8, (48, 64)            # the parity step's global batch
DROPOUT_CFG = dict(PARITY_CFG, dropout=0.1)
UNEVEN_CFG = dict(PARITY_CFG, num_queries=9)
STEP_SEED = 3                  # the dropout step's generator (data rank 0)


def _digest(model) -> str:
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().numpy().tobytes())
    return h.hexdigest()


def mp_step(cfg_kw, weights, mesh=None, seed=None, device="cpu"):
    """One port step on the data rank's slice of the global batch of N
    (the whole batch in one process); returns (metrics, model, the h1
    shapes its forward hook saw)."""
    from egtr_tpu_torch.models.egtr import EgtrModel
    from egtr_tpu_torch.train.optim import make_optimizer
    from egtr_tpu_torch.train.train_step import make_train_step
    from egtr_tpu_torch.train.trainer import to_device

    cfg = EgtrConfig(**cfg_kw)
    model = EgtrModel(cfg, mesh=mesh)
    model.load_state_dict(torch.load(weights, weights_only=True), strict=True)
    model.to(device)
    shapes = []
    model.relation_head.rel_predictor_layers_1.register_forward_hook(
        lambda m, inputs, out: shapes.append(list(inputs[0].shape)))
    step = make_train_step(model, cfg, make_optimizer(model, **LRS),
                           mesh=mesh)
    d, dp = (mesh.data_index, mesh.dp) if mesh is not None else (0, 1)
    batch = next(iter(loader(N, HW, N, d, dp)))
    generator = (torch.Generator(device=device).manual_seed(seed + d)
                 if seed is not None else None)
    metrics = step(to_device(batch, device), generator)
    return {k: float(v) for k, v in metrics.items()}, model, shapes


def _save(model, out, name):
    """Rank 0 keeps its parameters and clipped gradients; every rank
    returns the digest of its parameters."""
    if dist.process_index() == 0:
        torch.save({n: (p.detach().clone(), p.grad)
                    for n, p in model.named_parameters()},
                   os.path.join(out, f"{name}.pt"))
    return _digest(model)


def mp_evaluate(weights, mesh=None):
    """The SGG evaluation (with COCO and the OI evaluator) of 7 images, one
    a data rank a step; returns the metrics and the image ids the merged
    SGG evaluator holds."""
    from egtr_tpu_torch.evaluation import runner
    from egtr_tpu_torch.evaluation.oi_eval import OIEvaluator
    from egtr_tpu_torch.models.egtr import EgtrModel

    cfg = EgtrConfig(**EVAL_CFG)
    model = EgtrModel(cfg, mesh=mesh)
    model.load_state_dict(torch.load(weights, weights_only=True), strict=True)
    d, dp = (mesh.data_index, mesh.dp) if mesh is not None else (0, 1)
    held = []
    merge = runner._merge_across_hosts

    def merged(evaluators, marks, mesh=None):
        merge(evaluators, marks, mesh)
        held.append(evaluators[0].state()["image_ids"])

    runner._merge_across_hosts = merged
    try:
        metrics = runner.evaluate_sgg(
            model, cfg, loader(7, HW, dp, d, dp), REL_CATEGORIES,
            coco_eval=True, oi_evaluator=OIEvaluator(
                REL_CATEGORIES, ["c0", "c1", "c2", "c3", "c4"]))
    finally:
        runner._merge_across_hosts = merge
    return metrics, [int(i) for i in held[0]]


def rank_two(device, weights, uneven_weights, out):
    """dp 1 x mp 2: the parity step at dropout 0 and 0.1, the uneven step."""
    mesh = make_mesh(1, 2)
    result = {"mesh": [mesh.data_index, mesh.model_index]}
    for name, cfg_kw, w, seed in (
            ("parity", PARITY_CFG, weights, None),
            ("dropout", DROPOUT_CFG, weights, STEP_SEED),
            ("uneven", UNEVEN_CFG, uneven_weights, None)):
        metrics, model, shapes = mp_step(cfg_kw, w, mesh, seed, device)
        result[name] = {"metrics": metrics, "h1": shapes,
                        "grid_params": len(model.grid_parameters()),
                        "digest": _save(model, out, f"two_{name}")}
    return result


def rank_four(device, weights, eval_weights, out):
    """dp 2 x mp 2: the parity step; the evaluation."""
    mesh = make_mesh(2, 2)
    metrics, model, shapes = mp_step(PARITY_CFG, weights, mesh, None, device)
    evaluated, image_ids = mp_evaluate(eval_weights, mesh)
    return {"mesh": [mesh.data_index, mesh.model_index],
            "parity": {"metrics": metrics, "h1": shapes,
                       "digest": _save(model, out, "four_parity")},
            "evaluate": evaluated, "image_ids": image_ids}


def _start(name, n, workdir, **kwargs):
    pool = ThreadPoolExecutor(1)
    future = pool.submit(spawn, f"test_torch_tensor_parallel:{name}", n,
                         workdir=workdir, kwargs=kwargs, device="cpu",
                         threads=1, timeout=RANK_TIMEOUT_S, path=[HERE])
    pool.shutdown(wait=False)
    return future


def _jax_steps(params, layouts):
    """The JAX step under each ``(dp, mp)`` mesh of the first ``dp * mp``
    virtual devices, on the global batch of N: (metrics, the updated
    parameters as the port's state dict) per layout."""
    import jax
    import jax.numpy as jnp

    from egtr_tpu.config import EgtrConfig as JaxConfig
    from egtr_tpu.data.loader import Loader as JaxLoader
    from egtr_tpu.data.transforms import Sample as JaxSample
    from egtr_tpu.models.egtr import EgtrModel as JaxEgtrModel
    from egtr_tpu.parallel.mesh import make_mesh as jax_mesh
    from egtr_tpu.parallel.mesh import replicated, shard_batch
    from egtr_tpu.train.optim import make_optimizer as jax_optimizer
    from egtr_tpu.train.train_step import create_state, make_train_step
    from egtr_tpu_torch.utils.convert import state_dict_from_jax

    jcfg = JaxConfig(**PARITY_CFG)
    model = JaxEgtrModel(jcfg)
    batch = next(iter(JaxLoader(Scenes(N, HW, JaxSample), N, shuffle=False,
                                max_gt=4, num_rel_labels=4, buckets=(HW,),
                                prefetch=0)))
    tx = jax_optimizer(**LRS)
    step = make_train_step(model, jcfg, tx)
    out = {}
    prev = jax.sharding.get_mesh()
    try:
        for dp, mp in layouts:
            mesh = jax_mesh(dp, mp, devices=jax.devices()[:dp * mp])
            jax.sharding.set_mesh(mesh)
            state = jax.device_put(create_state(jax.tree_util.tree_map(
                jnp.asarray, params), tx), replicated(mesh))
            # (the step donates the state)
            state, metrics = step(state, shard_batch(batch, mesh),
                                  jax.random.PRNGKey(1))
            out[(dp, mp)] = (
                {k: float(v) for k, v in metrics.items()},
                state_dict_from_jax(jax.tree_util.tree_map(
                    np.asarray, state.params), EgtrConfig(**PARITY_CFG)))
    finally:
        jax.sharding.set_mesh(prev)
    return out


def _off_the_kink(path, leaf):
    leaf = np.asarray(leaf)
    name = "/".join(str(getattr(k, "key", k)) for k in path)
    if "sampling_offsets" in name and name.endswith("kernel"):
        rng = np.random.default_rng(abs(hash(name)) % 2 ** 32)
        leaf = leaf + rng.normal(0.0, 1e-2, leaf.shape).astype(leaf.dtype)
    return leaf


def _one_process(weights, uneven, eval_weights):
    """The references of one process: the three steps, the evaluation."""
    ref = {}
    for name, cfg_kw, w, seed in (
            ("parity", PARITY_CFG, weights, None),
            ("dropout", DROPOUT_CFG, weights, STEP_SEED),
            ("uneven", UNEVEN_CFG, uneven, None)):
        metrics, model, shapes = mp_step(cfg_kw, w, seed=seed)
        ref[name] = {"metrics": metrics, "h1": shapes, "params": {
            n: (p.detach(), p.grad) for n, p in model.named_parameters()}}
    ref["evaluate"] = mp_evaluate(eval_weights)
    _lrs()
    return ref


def _driver_dirs(tmp):
    return {"data": str(tmp / "vg"), "train": str(tmp / "train_mp"),
            "pretrain": str(tmp / "pretrain_mp")}


def _start_drivers(tmp):
    """``train_egtr`` and ``pretrain_detr`` with ``--dp 1 --mp 2`` on two
    ranks at a tiny width (``test_torch_parallel.rank_drivers``), one after
    the other in the same ranks: global batch 1 x 1 x 2, two steps an
    epoch of 4 images."""
    from egtr_tpu_torch.scripts.make_synth_vg import make_synth_vg

    dirs = _driver_dirs(tmp)
    make_synth_vg(dirs["data"], n_train=4, n_val=2, n_test=3, height=48,
                  width=80, seed=0)
    common = ["--data_path", dirs["data"], "--device", "cpu",
              "--num_workers", "1", "--num_queries", "10", "--max_gt_boxes",
              "8", "--seed", "0", "--dp", "1", "--mp", "2", "--batch_size",
              "1", "--max_epochs", "1", "--max_epochs_finetune", "1",
              "--log_every", "1"]
    pool = ThreadPoolExecutor(1)
    future = pool.submit(
        spawn, "test_torch_parallel:rank_drivers", 2,
        workdir=str(tmp / "drivers"), device="cpu", threads=1,
        timeout=RANK_TIMEOUT_S, path=[HERE], kwargs={"runs": [
            ["train_egtr", [*common, "--output_path", dirs["train"],
                            "--from_scratch", "true", "--accumulate", "2",
                            "--max_gt_rels", "16"],
             os.path.join(dirs["train"], "metrics_test.json")],
            ["pretrain_detr", [*common, "--output_path", dirs["pretrain"],
                               "--accumulate", "2"], None]]})
    pool.shutdown(wait=False)
    return future


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both calls of ranks, the JAX steps and one process's references."""
    import jax
    import jax.numpy as jnp

    from egtr_tpu.config import EgtrConfig as JaxConfig
    from egtr_tpu.models.egtr import EgtrModel as JaxEgtrModel
    from egtr_tpu_torch.utils.convert import state_dict_from_jax

    tmp = tmp_path_factory.mktemp("tensor_parallel")
    # the JAX init, its sampling offsets' kernels nudged off zero: at zero
    # every sample sits on the bilinear hat's kink, where the offsets'
    # gradients are not decided to float32 round-off (ROADMAP watch-list)
    params = jax.tree_util.tree_map_with_path(_off_the_kink, jax.jit(
        JaxEgtrModel(JaxConfig(**PARITY_CFG)).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3), jnp.float32)))
    weights = str(tmp / "weights.pt")
    torch.save(state_dict_from_jax(params, EgtrConfig(**PARITY_CFG)),
               weights)
    uneven = seeded_weights(UNEVEN_CFG, tmp / "uneven.pt")
    eval_weights = seeded_weights(EVAL_CFG, tmp / "eval.pt")
    out = str(tmp)
    two = _start("rank_two", 2, str(tmp / "two"), weights=weights,
                 uneven_weights=uneven, out=out)
    four = _start("rank_four", 4, str(tmp / "four"), weights=weights,
                  eval_weights=eval_weights, out=out)
    drivers = _start_drivers(tmp)
    # one process's steps in a thread, beside the JAX compiles
    pool = ThreadPoolExecutor(1)
    one = pool.submit(_one_process, weights, uneven, eval_weights)
    pool.shutdown(wait=False)
    ref = {"jax": _jax_steps(params, [(1, 2), (2, 2)]), **one.result()}
    ref["two"], ref["four"] = two.result(), four.result()
    ref["drivers"] = drivers.result()
    ref["driver_dirs"] = _driver_dirs(tmp)
    ref["saved"] = {name: torch.load(tmp / f"{name}.pt")
                    for name in ("two_parity", "two_dropout", "two_uneven",
                                 "four_parity")}
    yield ref
    shutil.rmtree(tmp, ignore_errors=True)


@functools.lru_cache(maxsize=1)
def _lrs():
    """Each parameter's learning rate in the step (None: frozen)."""
    from egtr_tpu_torch.models.egtr import EgtrModel
    from egtr_tpu_torch.train.optim import make_optimizer

    labels = make_optimizer(EgtrModel(EgtrConfig(**PARITY_CFG)),
                            **LRS).labels
    group = {"main": LRS["lr"], "backbone": LRS["lr_backbone"],
             "initialized": LRS["lr_initialized"]}
    return {n: group.get(label) for n, label in labels.items()}


def _assert_params(saved, ref, lrs):
    """The updated parameters against ``ref``'s. The first AdamW step is
    lr * g / (|g| + eps) of the clipped gradient g: where |g| exceeds twice
    the gradients' tolerance (GRAD_ATOL of the largest entry) its sign is
    decided and the two updates agree to 2% of lr; elsewhere round-off can
    flip g's sign and only 2 lr bounds the difference (plus, everywhere, a
    float32 step of the weight). A fifth of the relation head's entries at
    least, the part that ``--mp`` splits, get the tight bound."""
    scale = max(float(g.abs().max()) for _, g in saved.values()
                if g is not None)
    decided = total = 0
    for name, want in ref.items():
        got, g = saved[name]
        lr = lrs[name]
        if lr is None:
            assert torch.equal(got, want), f"frozen leaf moved: {name}"
            continue
        big = g.abs() > 2 * GRAD_ATOL * scale
        ulp = 2.0 ** -22 * torch.clamp(want.abs(), min=1.0)
        diff = (got - want).abs()
        assert (diff[big] <= 0.02 * lr + ulp[big]).all(), name
        assert (diff[~big] <= 2.0 * lr + ulp[~big]).all(), name
        if name.startswith("relation_head."):
            decided += int(big.sum())
            total += big.numel()
    assert decided > 0.2 * total, (decided, total)


def _assert_step(results, saved, one, keys=LOSS_KEYS):
    """The ranks' metrics equal each other and one process's (RTOL), their
    parameters bit-equal, rank 0's clipped gradients one process's
    (GRAD_RTOL, GRAD_ATOL of the largest entry) and its updated parameters
    one process's (``_assert_params``)."""
    assert all(r["metrics"] == results[0]["metrics"] for r in results)
    assert len({r["digest"] for r in results}) == 1
    for k in keys:
        np.testing.assert_allclose(results[0]["metrics"][k],
                                   one["metrics"][k], rtol=RTOL, err_msg=k)
    scale = max(float(g.abs().max()) for _, g in one["params"].values())
    for name, (_, g) in one["params"].items():
        torch.testing.assert_close(saved[name][1], g, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale, msg=name)
    _assert_params(saved, {n: p for n, (p, _) in one["params"].items()},
                   _lrs())


@pytest.mark.parametrize("layout", [(1, 2), (2, 2)], ids=["dp1_mp2",
                                                          "dp2_mp2"])
def test_mp_step_matches_jax_mesh_and_one_process(ranks, layout):
    """The port's step on a (dp, mp) layout against the JAX step under the
    same mesh (the loss terms and grad_norm, the updated parameters) and
    against one process of the port (also the clipped gradients)."""
    dp, mp = layout
    results = [r["parity"] for r in ranks["two" if dp == 1 else "four"]]
    assert len(results) == dp * mp
    jax_metrics, jax_params = ranks["jax"][layout]
    for k in LOSS_KEYS:
        np.testing.assert_allclose(results[0]["metrics"][k], jax_metrics[k],
                                   rtol=RTOL, err_msg=k)
    saved = ranks["saved"]["two_parity" if dp == 1 else "four_parity"]
    _assert_params(saved, jax_params, _lrs())
    _assert_step(results, saved, ranks["parity"])


def test_mp_step_with_dropout_matches_one_process(ranks):
    """At dropout 0.1 the ranks of a model group draw the masks and the
    relation samples of one generator (seeded by the data index), so the
    step is one process's with the same generator."""
    results = [r["dropout"] for r in ranks["two"]]
    assert results[0]["metrics"] != ranks["parity"]["metrics"]
    _assert_step(results, ranks["saved"]["two_dropout"], ranks["dropout"])


def test_uneven_rows_match_one_process(ranks):
    """Q 9 over mp 2: 5 rows and 4 rows plus one of padding."""
    results = [r["uneven"] for r in ranks["two"]]
    _assert_step(results, ranks["saved"]["two_uneven"], ranks["uneven"])


def test_each_rank_holds_its_grid_rows(ranks):
    """The forward hook on ``rel_predictor_layers_1``: each rank's ``h1``
    is [B, ceil(Q/mp), Q, E], one process's [B, Q, Q, E]; the grid's
    parameters (the head's and ``triplet_dist``) are the step's to sum."""
    E = PARITY_CFG["d_model"]
    for layout, name, cfg_kw in (("two", "parity", PARITY_CFG),
                                 ("two", "uneven", UNEVEN_CFG),
                                 ("four", "parity", PARITY_CFG)):
        Q = cfg_kw["num_queries"]
        B = N // (1 if layout == "two" else 2)
        for r in ranks[layout]:
            assert r[name]["h1"] == [[B, -(-Q // 2), Q, E]], (layout, name)
        assert ranks[name]["h1"] == [[N, Q, Q, E]]
    head = EgtrHead(EgtrConfig(**PARITY_CFG))
    assert ranks["two"][0]["parity"]["grid_params"] == len(list(
        head.parameters())) + 1
    assert [r["mesh"] for r in ranks["four"]] == [[0, 0], [0, 1], [1, 0],
                                                 [1, 1]]


def test_evaluation_merges_each_image_once(ranks):
    """dp 2 x mp 2: the merge runs over the data group, so the 7 images
    are held once each, in one process's order, and every metric is one
    process's."""
    one, ids = ranks["evaluate"]
    assert ids == list(range(7))
    assert any(k.startswith("coco/") for k in one)
    assert any(k.startswith("oi/") for k in one)
    for r in ranks["four"]:
        assert r["image_ids"] == ids
        assert_same_metrics(r["evaluate"], one)


@pytest.mark.parametrize("Q,mp", [(8, 2), (9, 2), (300, 4), (300, 7),
                                  (4, 3)])
def test_row_split(Q, mp):
    """Every row on exactly one rank, ``ceil(Q/mp)`` rows a rank (the last
    padded), and ``take`` pads with zeros."""
    splits = [RowSplit(Q, mp, m) for m in range(mp)]
    assert {s.rows for s in splits} == {-(-Q // mp)}
    assert sum((list(range(s.lo, s.hi)) for s in splits), []) == list(
        range(Q))
    x = torch.arange(2 * Q, dtype=torch.float32).reshape(1, Q, 2)
    for s in splits:
        part = s.take(x)
        assert part.shape == (1, s.rows, 2)
        assert torch.equal(part[:, :s.real], x[:, s.lo:s.hi])
        assert not part[:, s.real:].any()


def test_mesh_ranks_lay_out_as_jax():
    """rank = d * mp + m, as ``np.asarray(devices).reshape(dp, mp)``."""
    data, model = mesh_ranks(2, 3)
    grid = np.arange(6).reshape(2, 3)
    assert data == [grid[:, m].tolist() for m in range(3)]
    assert model == [grid[d].tolist() for d in range(2)]


def test_drivers_run_under_mp(ranks):
    """``train_egtr`` and ``pretrain_detr`` with ``--dp 1 --mp 2``: the two
    ranks of the model group return the same test metrics, and rank 0
    alone writes one metrics stream a phase (two steps of the global batch
    of 2 on 4 images, then the validation), the artifact and
    metrics_test.json."""
    import json

    train, pre = ([r["metrics"] for r in runs]
                  for runs in zip(*ranks["drivers"]))
    dirs = ranks["driver_dirs"]
    assert_same_metrics(train[1], train[0])
    assert_same_metrics(ranks["drivers"][0][0]["read"], train[0])
    assert any(k.startswith("single/R@") for k in train[0])
    assert_same_metrics(pre[1], pre[0])
    assert np.isfinite(pre[0]["coco/AP"])
    for out in (dirs["train"], dirs["pretrain"]):
        for phase in ("main", "finetune"):
            with open(os.path.join(out, phase, "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            assert [r["phase"] for r in recs] == ["train", "train", "val"]
            assert all(np.isfinite(r["total_loss"]) for r in recs
                       if r["phase"] == "train")
        assert sorted(os.listdir(os.path.join(out, "artifact"))) == [
            "config.json", "weights.pt"]
