"""The data-parallel step's own gradient reduction and the collectives'
capturable forms (``parallel/dist.py``, ``train/train_step.py``), on the
CPU under gloo, where every function runs eagerly on the plain versions.

- The step makes exactly one gradient collective per optimizer step,
  whatever the accumulation depth: an all-reduce of one flat buffer that
  holds every leaf's gradient (counted by patching ``dist``).
- Two ranks that start from different parameters end bit-equal: the step
  broadcasts rank 0's when it is made.
- The collectives' capturable forms (``all_gather_into_tensor`` into one
  tensor, the in-place ``all_reduce_``, its mean) equal the list forms
  ``torch.distributed`` gives.
- Two ranks whose signatures differ raise in ``dist.agree``, each rank's
  signature named; ranks with equal ones pass.

The rank function lives here and imports no JAX.
"""

import os
import shutil

import pytest
import torch
import torch.distributed

from egtr_tpu_torch.config import EgtrConfig
from egtr_tpu_torch.parallel import dist
from egtr_tpu_torch.parallel.launch import spawn
from egtr_tpu_torch.utils import aot

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
RANK_TIMEOUT_S = 240
CFG = dict(d_model=64, encoder_layers=1, decoder_layers=1,
           encoder_ffn_dim=64, decoder_ffn_dim=64, num_queries=8,
           num_labels=5, num_rel_labels=4, max_gt_boxes=4, max_gt_rels=4,
           dropout=0.0)
LRS = dict(lr=1e-3, lr_backbone=1e-4, lr_initialized=1e-3)
HW = (32, 48)


def batch_of(n, seed=0):
    """The train probe's seeded batch of ``n`` images at ``HW``."""
    from egtr_tpu_torch.scripts.perf_train_step import synthetic_batch

    return synthetic_batch(EgtrConfig(**CFG), n, *HW, "cpu", seed=seed)


def seeded_model(seed):
    from egtr_tpu_torch.models.egtr import EgtrModel
    from egtr_tpu_torch.models.layers import init_params

    model = EgtrModel(EgtrConfig(**CFG))
    init_params(model, torch.Generator().manual_seed(seed))
    return model


def flat_params(model):
    return torch.cat([p.detach().flatten() for p in model.parameters()])


def rank_programs(device):
    """Each rank: its model seeded by its rank, the step made (the
    broadcast), one step; the collectives' two forms side by side; the
    agreement of equal and of differing signatures."""
    from egtr_tpu_torch.train.optim import make_optimizer
    from egtr_tpu_torch.train.train_step import make_train_step

    rank, world = dist.process_index(), dist.process_count()
    model = seeded_model(seed=rank)
    before = flat_params(model).clone()
    step = make_train_step(model, EgtrConfig(**CFG),
                           make_optimizer(model, **LRS))
    made = flat_params(model).clone()
    step(batch_of(2, seed=rank))
    after = flat_params(model)
    out = {"own_init_sum": float(before.double().sum()),
           "made_sum": float(made.double().sum()),
           "made": made.numpy().tobytes().hex()[:4096],
           "after_sum": float(after.double().sum())}
    torch.save(after, os.path.join(os.environ["RESULTS"], f"p{rank}.pt"))

    # the capturable forms against the list forms
    x = torch.arange(12, dtype=torch.float32).reshape(2, 3, 2) * (rank + 1.5)
    listed = [torch.empty_like(x) for _ in range(world)]
    torch.distributed.all_gather(listed, x)
    stacked = dist.all_gather(x)
    summed = x.clone()
    torch.distributed.all_reduce(summed)
    in_place = x.clone()
    returned = dist.all_reduce_(in_place)
    mean = dist.all_reduce_(x.clone(), mean=True)
    out["gather_equal"] = bool(torch.equal(stacked, torch.stack(listed)))
    out["gather_shape"] = list(stacked.shape)
    out["sum_equal"] = bool(torch.equal(in_place, summed)
                            and returned is in_place)
    out["copy_sum_equal"] = bool(torch.equal(dist.all_reduce_sum(x), summed))
    out["mean_equal"] = bool(torch.equal(mean, summed / world))

    # the agreement of signatures: equal ones pass, differing ones raise
    same = aot.portable_signature(({"x": torch.zeros(2, 3)}, 1.0))
    dist.agree(same, "equal")
    mine = aot.portable_signature(({"x": torch.zeros(2, 3 + rank)}, 1.0))
    try:
        dist.agree(mine, "aot t: the signature of a call that captures")
        out["disagreement"] = None
    except RuntimeError as e:
        out["disagreement"] = str(e)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("programs")
    os.environ["RESULTS"] = str(work)
    try:
        results = spawn("test_torch_dist_programs:rank_programs", 2,
                        workdir=str(work / "ranks"), device="cpu",
                        threads=1, timeout=RANK_TIMEOUT_S, path=[HERE])
        yield results, [torch.load(work / f"p{r}.pt") for r in (0, 1)]
    finally:
        os.environ.pop("RESULTS", None)
        shutil.rmtree(work, ignore_errors=True)


def test_broadcast_makes_ranks_that_started_apart_bit_equal(ranks):
    results, params = ranks
    # the ranks began from different parameters ...
    assert results[0]["own_init_sum"] != results[1]["own_init_sum"]
    # ... the step's making gave every rank rank 0's ...
    assert results[1]["made_sum"] == results[0]["own_init_sum"]
    assert results[0]["made"] == results[1]["made"]
    # ... and after a step on different batches they are bit-equal
    assert torch.equal(params[0], params[1])


def test_capturable_collective_forms_equal_the_list_forms(ranks):
    results, _ = ranks
    for r in results:
        assert r["gather_equal"] and r["gather_shape"] == [2, 2, 3, 2]
        assert r["sum_equal"] and r["copy_sum_equal"] and r["mean_equal"]


def test_ranks_whose_signatures_differ_raise_in_agree(ranks):
    results, _ = ranks
    for r in results:
        message = r["disagreement"]
        assert message is not None and "the ranks disagree" in message
        # each rank's shapes are named
        assert "rank 0: " in message and "(2, 3)" in message
        assert "rank 1: " in message and "(2, 4)" in message


@pytest.mark.parametrize("accum", [1, 2, 4])
def test_one_gradient_collective_per_optimizer_step(accum, tmp_path,
                                                    monkeypatch):
    """One rank of a gloo group: the data group is that rank, so the only
    collective of a step is the gradient reduction; it runs once per step,
    after the last microbatch, over a flat buffer of every leaf."""
    from egtr_tpu_torch.train.optim import make_optimizer
    from egtr_tpu_torch.train.train_step import make_train_step

    calls = []
    real = dist.all_reduce_

    def counted(tensor, group=None, mean=False):
        calls.append((tensor.numel(), mean, group))
        return real(tensor, group, mean)

    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1)
    try:
        monkeypatch.setattr(dist, "all_reduce_", counted)
        model = seeded_model(seed=0)
        step = make_train_step(model, EgtrConfig(**CFG),
                               make_optimizer(model, **LRS),
                               accum_steps=accum)
        for seed in range(2):
            step(batch_of(accum, seed=seed))
    finally:
        torch.distributed.destroy_process_group()
    n = sum(p.numel() for p in model.parameters())
    assert calls == [(n, True, None)] * 2


def test_capturable_by_backend(tmp_path, monkeypatch):
    assert dist.capturable()                     # no process group
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1)
    try:
        assert not dist.capturable()
        monkeypatch.setattr(torch.distributed, "get_backend",
                            lambda group=None: "nccl")
        assert dist.capturable()
    finally:
        monkeypatch.undo()
        torch.distributed.destroy_process_group()
