"""The port's data-parallel path (``egtr_tpu_torch.parallel``) on the CPU:
real ranks, each a process of its own (``parallel.launch.spawn``: torchrun
on localhost, gloo, one thread a rank, a timeout on every run), against the
JAX package and against one process of the port.

- The loaders' per-rank slices concatenate to the JAX ``Loader``'s global
  batch, bit for bit, the padded tail included, and the stride split of
  each slice keeps the single-process microbatches.
- One two-rank step equals the JAX single-device step on the same global
  batch (``tests/test_multiprocess.py``'s config, weights bridged), and the
  single-process port step; the ranks' parameters are bit-equal after it.
- Two ranks x accumulation 2 x window 16 per point (the composition of
  ``test_multiprocess.py:156-202``) equal one process's accumulated step.
- ``evaluate_sgg`` (with COCO and the OI evaluator) and
  ``evaluate_detection`` merged over two ranks equal one process's metrics.
- ``fit``: one metrics stream and one set of checkpoints, the same
  early-stop decision and resume on both ranks, and the single-process
  validation loss.
- ``train_egtr`` -> ``evaluate_egtr`` and ``pretrain_detr`` on two ranks at
  a tiny width; ``dryrun_multichip(2, device="cpu")``; the refusals; a
  failing or hanging rank fails the run and outlives it in no process.

The rank functions (``rank_*``) live here and import no JAX.
"""

import json
import math
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from egtr_tpu_torch.config import EgtrConfig
from egtr_tpu_torch.data.loader import Loader
from egtr_tpu_torch.data.transforms import Sample
from egtr_tpu_torch.parallel import dist
from egtr_tpu_torch.parallel.launch import spawn
from egtr_tpu_torch.parallel.mesh import make_mesh, mesh_ranks

# the ranks run one thread each; so does this process, whose CPU
# convolutions then add in the ranks' order
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
RANK_TIMEOUT_S = 240

# tests/test_multiprocess.py:126-131, its global batch and learning rates
PARITY_CFG = dict(
    d_model=64, encoder_layers=1, decoder_layers=2, encoder_ffn_dim=64,
    decoder_ffn_dim=64, num_queries=8, num_labels=5, num_rel_labels=4,
    max_gt_boxes=4, max_gt_rels=4, dropout=0.0)
WINDOWED_CFG = dict(PARITY_CFG, msda_window=16, msda_band="point",
                    msda_impl="pallas")   # mp_worker.accum_windowed_cfg
LRS = dict(lr=1e-3, lr_backbone=1e-4, lr_initialized=1e-3)
LOSS_KEYS = ("total_loss", "loss_ce", "loss_bbox", "loss_rel", "grad_norm")
RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def free_disk(tmp_path):
    """The ranks write gradients, checkpoints and artifacts of a model with
    a ResNet-50 backbone, hundreds of MB a test: remove them after it."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def run_ranks(name, tmp_path, **kwargs):
    return spawn(f"test_torch_parallel:{name}", 2,
                 workdir=str(tmp_path / name), kwargs=kwargs, device="cpu",
                 threads=1, timeout=RANK_TIMEOUT_S, path=[HERE])


def start_ranks(name, tmp_path, **kwargs):
    """``run_ranks`` from a thread, so that this process computes its
    reference meanwhile; ``.result()`` waits for the ranks' values."""
    pool = ThreadPoolExecutor(1)
    future = pool.submit(run_ranks, name, tmp_path, **kwargs)
    pool.shutdown(wait=False)
    return future


class Scenes:
    """``mp_worker.make_dataset`` with the port's ``Sample``: n images of
    about ``hw``, two boxes and one relation each."""

    def __init__(self, n=10, hw=(48, 64), sample_cls=Sample):
        self.n, self.hw, self.sample_cls = n, hw, sample_cls

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        h, w = self.hw
        rng = np.random.default_rng(1000 + i)
        return self.sample_cls(
            image=rng.standard_normal((h - i % 3, w - i % 5, 3))
            .astype(np.float32),
            boxes=np.array([[0.4, 0.4, 0.2, 0.2], [0.6, 0.6, 0.2, 0.2]],
                           np.float32),
            class_labels=np.array([i % 5, (i + 1) % 5], np.int32),
            rel=np.array([[0, 1, i % 4]], np.int32),
            orig_size=(h, w), size=(h - i % 3, w - i % 5), image_id=i)

    def nominal_size(self, i):
        h, w = self.hw
        return (h - i % 3, w - i % 5)


def loader(n, hw, batch_size, rank=0, world=1, **kw):
    kw = dict(dict(shuffle=False, max_gt=4, num_rel_labels=4, buckets=(hw,),
                   prefetch=0), **kw)
    return Loader(Scenes(n, hw), batch_size, process_index=rank,
                  process_count=world, **kw)


def tiny_model(cfg_kw, weights):
    from egtr_tpu_torch.models.egtr import EgtrModel

    model = EgtrModel(EgtrConfig(**cfg_kw))
    model.load_state_dict(torch.load(weights, weights_only=True), strict=True)
    return model


def port_step(cfg_kw, weights, n, hw, accum, rank=0, world=1,
              device="cpu"):
    """One step of the port on its slice of the global batch of ``n``;
    returns (metrics, model)."""
    from egtr_tpu_torch.train.optim import make_optimizer
    from egtr_tpu_torch.train.train_step import make_train_step
    from egtr_tpu_torch.train.trainer import to_device

    model = tiny_model(cfg_kw, weights).to(device)
    step = make_train_step(model, EgtrConfig(**cfg_kw),
                           make_optimizer(model, **LRS), accum_steps=accum)
    batch = next(iter(loader(n, hw, n, rank, world)))
    metrics = step(to_device(batch, device))
    return {k: float(v) for k, v in metrics.items()}, model


def params_of(model):
    """The parameters, flat, and each one's clipped gradient of the step."""
    return (torch.cat([p.detach().flatten() for p in model.parameters()]),
            {n: p.grad for n, p in model.named_parameters()})


def rank_step(device, cfg_kw, weights, n, hw, accum, out):
    metrics, model = port_step(cfg_kw, weights, n, tuple(hw), accum,
                               dist.process_index(), dist.process_count(),
                               device)
    torch.save(params_of(model), os.path.join(
        out, f"params{dist.process_index()}.pt"))
    return metrics


def seeded_weights(cfg_kw, path, seed=0):
    from egtr_tpu_torch.models.egtr import EgtrModel
    from egtr_tpu_torch.models.layers import init_params

    model = EgtrModel(EgtrConfig(**cfg_kw))
    init_params(model, torch.Generator().manual_seed(seed))
    torch.save(model.state_dict(), path)
    return str(path)


def assert_ranks_match(results, tmp_path, ref_metrics, ref_model, keys,
                       rtol=RTOL):
    assert results[0] == results[1]   # every rank, the same metrics
    (p0, g0), (p1, _) = (torch.load(tmp_path / f"params{r}.pt")
                         for r in (0, 1))
    assert torch.equal(p0, p1)        # the same parameters, bit for bit
    for k in keys:
        np.testing.assert_allclose(results[0][k], ref_metrics[k], rtol=rtol,
                                   err_msg=k)
    # the reduced gradient is one process's, to float32 summation order
    _, ref = params_of(ref_model)
    scale = max(float(g.abs().max()) for g in ref.values())
    worst = max(float(((g0[n] - g).abs() - GRAD_RTOL * g.abs()).max())
                for n, g in ref.items()) / scale
    print("largest gradient difference beyond rtol, over the largest "
          "entry", worst)
    for name, g in ref.items():
        torch.testing.assert_close(g0[name], g, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale, msg=name)


# --------------------------------------------------------------------------
# 1. the loaders' slices
# --------------------------------------------------------------------------


def test_rank_slices_concatenate_to_the_jax_global_batch():
    """tests/test_multiprocess.py:70-106 on the port's loader: the two
    ranks' slices of every global batch, concatenated, are the JAX loader's
    batch (10 images, batch 4, shuffled: two full batches and a tail padded
    with valid=False rows)."""
    from egtr_tpu.data.loader import Loader as JaxLoader
    from egtr_tpu.data.transforms import Sample as JaxSample
    from egtr_tpu_torch.train.train_step import split_microbatches

    kw = dict(shuffle=True, max_gt=4, num_rel_labels=4, buckets=((48, 64),),
              seed=11, prefetch=0)
    ref = list(JaxLoader(Scenes(sample_cls=JaxSample), 4, **kw))
    parts = [list(Loader(Scenes(), 4, process_index=r, process_count=2,
                         **kw)) for r in (0, 1)]
    assert len(ref) == len(parts[0]) == len(parts[1]) == 3
    for k, r in enumerate(ref):
        a, b = parts[0][k], parts[1][k]
        for key in ("pixel_values", "pixel_mask", "valid", "image_id"):
            np.testing.assert_array_equal(
                np.concatenate([a[key], b[key]]), r[key], err_msg=key)
        for key in r["labels"]:
            np.testing.assert_array_equal(
                np.concatenate([a["labels"][key], b["labels"][key]]),
                r["labels"][key], err_msg=key)
    assert parts[1][2]["valid"].tolist() == [False, False]
    # the stride split of each rank's slice: microbatch a over the ranks, in
    # rank order, is the single-process split's microbatch a
    full = Loader(Scenes(16, (144, 64)), 16, **dict(kw, buckets=((144, 64),)))
    whole = split_microbatches(next(iter(full)), 2)
    slices = [split_microbatches(next(iter(Loader(
        Scenes(16, (144, 64)), 16, process_index=r, process_count=2,
        **dict(kw, buckets=((144, 64),))))), 2) for r in (0, 1)]
    for a in range(2):
        np.testing.assert_array_equal(
            np.concatenate([s[a]["image_id"] for s in slices]),
            whole[a]["image_id"])
        np.testing.assert_array_equal(
            np.concatenate([s[a]["pixel_values"] for s in slices]),
            whole[a]["pixel_values"])


# --------------------------------------------------------------------------
# 2. one step against the JAX package; 3. the composition
# --------------------------------------------------------------------------


def test_two_rank_step_matches_jax_and_one_process(tmp_path):
    import jax
    import jax.numpy as jnp

    from egtr_tpu.config import EgtrConfig as JaxConfig
    from egtr_tpu.data.loader import Loader as JaxLoader
    from egtr_tpu.data.transforms import Sample as JaxSample
    from egtr_tpu.models.egtr import EgtrModel as JaxEgtrModel
    from egtr_tpu.train.optim import make_optimizer as jax_optimizer
    from egtr_tpu.train.train_step import create_state, make_train_step
    from egtr_tpu_torch.utils.convert import state_dict_from_jax

    jcfg = JaxConfig(**PARITY_CFG)
    model = JaxEgtrModel(jcfg)
    batch = next(iter(JaxLoader(Scenes(8, (48, 64), JaxSample), 8,
                                shuffle=False, max_gt=4, num_rel_labels=4,
                                buckets=((48, 64),), prefetch=0)))
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 48, 64, 3), jnp.float32))
    weights = tmp_path / "weights.pt"
    torch.save(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), EgtrConfig(**PARITY_CFG)),
        weights)
    ranks = start_ranks("rank_step", tmp_path, cfg_kw=PARITY_CFG,
                        weights=str(weights), n=8, hw=[48, 64], accum=1,
                        out=str(tmp_path))
    tx = jax_optimizer(**LRS)
    # (the step donates the state)
    _, jax_metrics = make_train_step(model, jcfg, tx)(
        create_state(params, tx), batch, jax.random.PRNGKey(1))
    jax_metrics = {k: float(v) for k, v in jax_metrics.items()}
    one, one_model = port_step(PARITY_CFG, weights, 8, (48, 64), 1)
    results = ranks.result()
    for k in LOSS_KEYS:
        np.testing.assert_allclose(results[0][k], jax_metrics[k], rtol=RTOL,
                                   err_msg=k)
    assert_ranks_match(results, tmp_path, one, one_model, one)


def test_two_rank_accumulated_windowed_step_matches_one_process(tmp_path):
    """2 ranks x accumulation 2 x window 16 with one band per point, at
    144x64 so that level 0 (18x8) is taller than the window and the banded
    path engages: the metrics and parameters of one process's accumulated
    step on the same global batch of 16."""
    weights = seeded_weights(WINDOWED_CFG, tmp_path / "weights.pt")
    ranks = start_ranks("rank_step", tmp_path, cfg_kw=WINDOWED_CFG,
                        weights=weights, n=16, hw=[144, 64], accum=2,
                        out=str(tmp_path))
    one, one_model = port_step(WINDOWED_CFG, weights, 16, (144, 64), 2)
    results = ranks.result()
    assert_ranks_match(results, tmp_path, one, one_model, one)


# --------------------------------------------------------------------------
# 4. the evaluators merged across the ranks
# --------------------------------------------------------------------------

EVAL_CFG = dict(PARITY_CFG, num_queries=10)
REL_CATEGORIES = ["r0", "r1", "r2", "r3"]
CLASSES = ["c0", "c1", "c2", "c3", "c4"]


def evaluate(weights, rank=0, world=1, out=None):
    """Both evaluation loops; returns their metrics and the evaluators'
    states after the merge (every image's record, in order)."""
    from egtr_tpu_torch.evaluation import runner
    from egtr_tpu_torch.evaluation.oi_eval import OIEvaluator

    model = tiny_model(EVAL_CFG, weights)
    cfg = EgtrConfig(**EVAL_CFG)
    states = []
    merge = runner._merge_across_hosts

    def merged(evaluators, marks, mesh=None):
        merge(evaluators, marks, mesh)
        states.append([e.state() for e in evaluators])

    runner._merge_across_hosts = merged
    try:
        # 7 images, one a rank a step: the last step's second row is padding
        sgg = runner.evaluate_sgg(
            model, cfg, loader(7, (48, 64), world, rank, world),
            REL_CATEGORIES, eval_multiple_preds=True, coco_eval=True,
            oi_evaluator=OIEvaluator(REL_CATEGORIES, CLASSES))
        det = runner.evaluate_detection(
            model, cfg, loader(7, (48, 64), 2 * world, rank, world))
    finally:
        runner._merge_across_hosts = merge
    if out is not None:
        runner.write_metrics(sgg, os.path.join(out, f"metrics{rank}.json"))
        torch.save(states, os.path.join(out, f"states{rank}.pt"))
    return {"sgg": sgg, "det": det}, states


def rank_evaluate(device, weights, out):
    return evaluate(weights, dist.process_index(), dist.process_count(),
                    out)[0]


def assert_same_state(got, want, where="state"):
    """Equal evaluator states: the same records in the same order."""
    assert type(got) is type(want), where
    if isinstance(want, dict):
        assert list(got) == list(want) or sorted(map(str, got)) == sorted(
            map(str, want)), where
        for k in want:
            assert_same_state(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same_state(a, b, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want or (got != got and want != want), where


def assert_same_metrics(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert (math.isnan(v) and math.isnan(got[k])) or math.isclose(
            got[k], v, rel_tol=1e-12, abs_tol=1e-12), (k, got[k], v)


def test_two_rank_evaluation_merges_to_one_process(tmp_path):
    """The merged evaluators hold one process's records, image for image
    in its order (the SGG recalls, the COCO detections with their scores,
    the OI evaluator's top triples), so every metric is one process's."""
    weights = seeded_weights(EVAL_CFG, tmp_path / "weights.pt")
    ranks = start_ranks("rank_evaluate", tmp_path, weights=weights,
                        out=str(tmp_path))
    one, one_states = evaluate(weights)
    results = ranks.result()
    assert any(k.startswith("coco/") for k in one["sgg"])
    assert any(k.startswith("oi/") for k in one["sgg"])
    for r in results:
        for part in ("sgg", "det"):
            assert_same_metrics(r[part], one[part])
    merged = torch.load(tmp_path / "states0.pt", weights_only=False)
    assert_same_state(merged, one_states)
    # 7 images: every one has relations and detections
    assert [len(s) for s in (one_states[0][2]["img_ids"],
                             one_states[0][3])] == [7, 7]
    # the primary alone writes
    assert os.path.exists(tmp_path / "metrics0.json")
    assert not os.path.exists(tmp_path / "metrics1.json")


# --------------------------------------------------------------------------
# 5. fit on two ranks
# --------------------------------------------------------------------------


class CountingLoader:
    """A loader that counts the epochs it was iterated."""

    def __init__(self, inner):
        self.inner, self.epochs = inner, 0

    def __iter__(self):
        self.epochs += 1
        return iter(self.inner)


def fit_epochs(weights, log_dir, max_epochs, rank=0, world=1,
               device="cpu"):
    """``fit`` at learning rate 0 and patience 1: the validation loss stays
    put, so the run stops after its second epoch."""
    from egtr_tpu_torch.models.egtr import EgtrModel
    from egtr_tpu_torch.train.trainer import fit

    train = CountingLoader(loader(8, (48, 64), 4, rank, world,
                                  shuffle=True, drop_last=True))
    val = loader(7, (48, 64), 4, rank, world)
    fit(EgtrModel(EgtrConfig(**PARITY_CFG)), EgtrConfig(**PARITY_CFG),
        train_loader=train, val_loader=val, log_dir=log_dir, lr=0.0,
        lr_backbone=0.0, lr_initialized=0.0, max_epochs=max_epochs,
        patience=1, init_params=torch.load(weights, weights_only=True),
        log_every=1, device=device)
    return train.epochs


def rank_fit(device, weights, log_dir):
    rank, world = dist.process_index(), dist.process_count()
    first = fit_epochs(weights, log_dir, 4, rank, world, device)
    again = fit_epochs(weights, log_dir, 4, rank, world, device)
    return {"epochs": first, "resumed_epochs": again}


def records(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_two_rank_fit_writes_once_and_decides_alike(tmp_path):
    weights = seeded_weights(PARITY_CFG, tmp_path / "weights.pt")
    log_dir = str(tmp_path / "run")
    ranks = start_ranks("rank_fit", tmp_path, weights=weights,
                        log_dir=log_dir)
    # one process over the same global batches, meanwhile
    one_dir = str(tmp_path / "one")
    assert fit_epochs(weights, one_dir, 1) == 1
    results = ranks.result()
    # both ranks stop after epoch 1 (no improvement at patience 1); the
    # relaunch resumes from checkpoint 2 on both and stops after epoch 2
    assert results == [{"epochs": 2, "resumed_epochs": 1}] * 2
    assert sorted(os.listdir(os.path.join(log_dir, "checkpoints"))) == [
        "1", "2", "3"]
    recs = records(log_dir)
    assert [r["epoch"] for r in recs if r["phase"] == "val"] == [0, 1, 2]
    # two steps an epoch (8 images, global batch 4)
    assert [r["phase"] for r in recs] == ["train", "train", "val"] * 3
    # one process over the same global batches: the same losses
    one = records(one_dir)
    assert len(one) == 3
    for got, want in zip(recs, one):
        assert got["phase"] == want["phase"]
        for k, v in want.items():
            if k.startswith(("loss_", "total_loss", "validation_")):
                np.testing.assert_allclose(got[k], v, rtol=RTOL, err_msg=k)


# --------------------------------------------------------------------------
# the drivers on two ranks at a tiny width
# --------------------------------------------------------------------------

DRIVER_TINY = dict(d_model=64, encoder_layers=2, decoder_layers=2,
                   encoder_ffn_dim=128, decoder_ffn_dim=128,
                   compute_dtype="float32")


def tiny_driver(setattr):
    """``test_torch_trainer.tiny_driver``'s patches through ``setattr``."""
    from egtr_tpu_torch import config as config_mod
    from egtr_tpu_torch.data import loader as loader_mod
    from egtr_tpu_torch.data import transforms as transforms_mod
    from egtr_tpu_torch.data import visual_genome as vg_mod

    real_cfg, real_ds = config_mod.EgtrConfig, vg_mod.VGDataset

    class SmallVG(real_ds):
        def __init__(self, *a, size=800, max_size=1333, **kw):
            super().__init__(*a, size=48, max_size=96, **kw)

    class TinyConfig(real_cfg):
        def __init__(self, **kw):
            super().__init__(**{**kw, **DRIVER_TINY})

    setattr(config_mod, "EgtrConfig", TinyConfig)
    setattr(vg_mod, "VGDataset", SmallVG)
    setattr(transforms_mod, "DETR_TRAIN_SCALES", (48, 64))
    setattr(loader_mod, "default_buckets",
            lambda max_size=1333: ((96, 160), (160, 96), (160, 160)))


def rank_drivers(device, runs):
    """The drivers one after another in one rank, in one process group;
    ``runs``: [driver, argv, path or None]. Per run, the metrics its
    evaluation returned and, on rank 0, the JSON at ``path`` as the run left
    it."""
    import importlib

    from egtr_tpu_torch.evaluation import runner

    tiny_driver(setattr)
    seen = {}
    for fn in ("evaluate_sgg", "evaluate_detection"):
        def capture(*a, _real=getattr(runner, fn), **kw):
            seen["metrics"] = _real(*a, **kw)
            return seen["metrics"]
        setattr(runner, fn, capture)
    results = []
    for driver, argv, path in runs:
        importlib.import_module(f"egtr_tpu_torch.scripts.{driver}").main(argv)
        run = {"metrics": seen.pop("metrics")}
        if path and dist.is_primary():
            with open(path) as f:
                run["read"] = json.load(f)
        results.append(run)
    return results


def test_drivers_on_two_ranks(tmp_path, monkeypatch):
    """``train_egtr`` (global batch 1 x 2 ranks x accumulation 2: one step
    an epoch of 4 images) writes one metrics stream, one artifact and one
    metrics_test.json, whose metrics both ranks returned; then, in the same
    ranks, ``evaluate_egtr`` of the artifact and an epoch of
    ``pretrain_detr``. One process's ``evaluate_egtr`` of the artifact
    reproduces both ranks' evaluations."""
    from egtr_tpu_torch.scripts import evaluate_egtr
    from egtr_tpu_torch.scripts.make_synth_vg import make_synth_vg

    data, out = str(tmp_path / "vg"), str(tmp_path / "run")
    pre_out = str(tmp_path / "pretrain")
    make_synth_vg(data, n_train=4, n_val=2, n_test=3, height=48, width=80,
                  seed=0)
    common = ["--data_path", data, "--device", "cpu", "--num_workers", "1",
              "--num_queries", "10", "--max_gt_boxes", "8", "--seed", "0"]
    eval_argv = ["--data_path", data, "--artifact_path",
                 os.path.join(out, "artifact"), "--device", "cpu",
                 "--coco_eval", "true", "--compute_dtype", "float32"]
    ranks = run_ranks("rank_drivers", tmp_path / "drivers", runs=[
        ["train_egtr", [*common, "--output_path", out, "--from_scratch",
                        "true", "--batch_size", "1", "--accumulate", "2",
                        "--max_epochs", "1", "--max_epochs_finetune", "1",
                        "--log_every", "1", "--max_gt_rels", "16"],
         os.path.join(out, "metrics_test.json")],
        ["evaluate_egtr", eval_argv, None],
        ["pretrain_detr", [*common, "--output_path", pre_out, "--batch_size",
                           "1", "--accumulate", "1", "--max_epochs", "1",
                           "--max_epochs_finetune", "1", "--log_every",
                           "1"], None]])
    train, two, pre = ([r["metrics"] for r in runs] for runs in zip(*ranks))
    assert train[0] == train[1]
    for phase in ("main", "finetune"):
        recs = records(os.path.join(out, phase))
        assert [r["phase"] for r in recs] == ["train", "val"]
    assert sorted(os.listdir(os.path.join(out, "artifact"))) == [
        "config.json", "weights.pt"]
    assert_same_metrics(ranks[0][0]["read"], train[0])

    tiny_driver(monkeypatch.setattr)
    one = evaluate_egtr.main(eval_argv)
    for k in train[0]:
        assert math.isclose(one[k], train[0][k], rel_tol=1e-12,
                            abs_tol=1e-12) or (
            math.isnan(one[k]) and math.isnan(train[0][k])), k
    for r in two:
        assert_same_metrics(r, one)

    assert pre[0] == pre[1] and np.isfinite(pre[0]["coco/AP"])
    assert [r["phase"] for r in records(os.path.join(pre_out, "main"))] == [
        "train"] * 2 + ["val"]


# --------------------------------------------------------------------------
# 6. the dry run; 7. the refusals
# --------------------------------------------------------------------------


def test_dryrun_multichip_on_cpu(capsys):
    from egtr_tpu_torch.parallel.dryrun import dryrun_multichip

    result = dryrun_multichip(2, device="cpu", timeout=RANK_TIMEOUT_S)
    assert result["shards_ok"] and result["merge_ok"]
    out = capsys.readouterr().out
    assert "dryrun_multichip(2)" in out and "total_loss=" in out
    assert "grad_norm=" in out and "merge OK" in out


@pytest.mark.parametrize("driver", ["train_egtr", "pretrain_detr"])
@pytest.mark.parametrize("argv,message", [
    (["--mp", "2"], r"dp\(1\) \* mp\(2\) != world size \(1\)"),
    (["--dp", "2"], r"dp\(2\) \* mp\(1\) != world size \(1\)"),
])
def test_driver_refuses_dp_and_mp(driver, argv, message, tmp_path):
    import importlib

    main = importlib.import_module(f"egtr_tpu_torch.scripts.{driver}").main
    with pytest.raises(SystemExit, match=message):
        main(["--data_path", str(tmp_path), "--output_path", str(tmp_path),
              "--device", "cpu", *argv])


def test_evaluate_refuses_infer_only_on_ranks(tmp_path, monkeypatch):
    """``--infer_only`` times one process: refused inside a group."""
    from egtr_tpu_torch.scripts import evaluate_egtr

    monkeypatch.setattr(dist, "process_count", lambda: 2)
    with pytest.raises(SystemExit, match="--infer_only times one process"):
        evaluate_egtr.main(["--data_path", str(tmp_path), "--artifact_path",
                            str(tmp_path), "--device", "cpu",
                            "--infer_only", "true"])


def test_make_mesh(monkeypatch):
    assert (make_mesh().dp, make_mesh().mp) == (1, 1)
    monkeypatch.setattr(dist, "process_count", lambda: 4)
    assert make_mesh().dp == 4 and make_mesh(4, 1).dp == 4
    with pytest.raises(ValueError, match="world size"):
        make_mesh(2)
    # dp 2 x mp 2 at world size 4, rank 3 = d 1 * mp + m 1 (JAX's
    # reshape(dp, mp)); without a process group no group is created
    monkeypatch.setattr(dist, "process_index", lambda: 3)
    mesh = make_mesh(2, 2)
    assert (mesh.dp, mesh.mp, mesh.data_index, mesh.model_index) == (
        2, 2, 1, 1)
    data, model = mesh_ranks(2, 2)
    assert (data[mesh.model_index], model[mesh.data_index]) == ([1, 3],
                                                                [2, 3])
    assert mesh.data_group is None and mesh.model_group is None
    assert make_mesh(mp=2).dp == 2


def rank_fault(device, fault):
    """Rank 1 exits with 5 or hangs; rank 0 waits for it at a barrier."""
    import time

    if dist.process_index() == 1:
        if fault == "exit":
            raise SystemExit(5)
        time.sleep(120)
    dist.barrier()
    return {}


def processes_naming(text):
    """The pids of the processes whose command line holds ``text``."""
    pids = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if text.encode() in f.read():
                    pids.append(int(pid))
        except OSError:     # gone meanwhile
            pass
    return pids


@pytest.mark.parametrize("fault,timeout,message", [
    ("exit", RANK_TIMEOUT_S,
     r"(?s)exited with 1.*Root Cause.*rank +: 1 .*exitcode +: 5"),
    ("hang", 10, "still running after 10 s")])
def test_spawn_fails_when_a_rank_fails_or_hangs(tmp_path, fault, timeout,
                                               message):
    """One failing or hanging rank fails the call (torchrun names the rank
    that failed first), and no process of the call outlives it: none names
    the call's work directory (torchrun's and the ranks' command lines hold
    its spec file)."""
    workdir = str(tmp_path / "ranks")
    with pytest.raises(RuntimeError, match=message):
        spawn("test_torch_parallel:rank_fault", 2, workdir=workdir,
              kwargs={"fault": fault}, device="cpu", threads=1,
              timeout=timeout, path=[HERE])
    assert processes_naming(workdir) == []


@pytest.mark.parametrize("device,backend,message", [
    ("cpu", "nccl", "needs the card"),
    ("cpu", "mpi", "nccl or gloo")])
def test_init_from_env_refuses(monkeypatch, device, backend, message):
    """A backend that cannot run raises before any process group forms;
    nothing falls back."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match=message):
        dist.init_from_env(device, backend)
    assert not dist.is_distributed()


def test_single_process_identity():
    """Without a process group every helper is the identity."""
    assert not dist.is_distributed()
    assert (dist.process_index(), dist.process_count()) == (0, 1)
    assert dist.is_primary() and dist.all_gather_objects("x") == ["x"]
    t = torch.ones(3)
    assert dist.all_reduce_sum(t) is t
    dist.barrier()
    assert dist.init_from_env("cpu") == torch.device("cpu")
