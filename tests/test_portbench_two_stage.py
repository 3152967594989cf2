"""Two-stage, box-refined EGTR in the port against the benchmark's plain
reference (``portbench/reference/two_stage.py``) on seeded weights at a
small size on the CPU, float32 on both sides; the cell ``vg-train-twostage``
and the data-parallel cell ``vg-train-dp4`` found from their files; the
model-FLOP count of the proposals; the new metrics' readers; the matcher's
launches by route; and the ``proposals`` layer scope.

The reference imports nothing of the port; both sides sum in other orders,
so the tolerances are float32 round-off, each given with its reason."""

from __future__ import annotations

import copy
import ctypes
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from egtr_tpu_torch.config import EgtrConfig
from egtr_tpu_torch.models.egtr import EgtrModel
from egtr_tpu_torch.ops import criterion, matcher, msda_cuda
from portbench import flops, flops_two_stage, harness
from portbench.modes.train import leaf_gaps
from portbench.reference.two_stage import (TwoStageReference,
                                           two_stage_loss)
from portbench.tests.tiny import TINY_MODEL, TINY_TRAFFIC
from portbench.weights import fill_model

torch.set_num_threads(2)

CELL = "vg-train-twostage"
PROPOSALS = 20
MODEL = dict(TINY_MODEL, two_stage_num_proposals=PROPOSALS, dropout=0.0)


def tiny_spec(cell=CELL, **traffic):
    spec = harness.load_spec(cell)
    spec.config = copy.deepcopy(spec.config)
    spec.traffic = copy.deepcopy(spec.traffic)
    spec.config["model"].update(TINY_MODEL, two_stage_num_proposals=PROPOSALS)
    spec.traffic.update(TINY_TRAFFIC["vg-train-b4a2"], **traffic)
    return spec


def model_and_state(seed=3, **kw):
    m = harness.load_spec(CELL).config["model"]
    m = {**m, **MODEL, **kw}
    model = EgtrModel(EgtrConfig(**m))
    state = {n: t.clone() for n, t in fill_model(model, seed, model.config,
                                                  "published").items()}
    return m, model, state


def padded_pair(seed=0):
    """Two 96x160 images, the second valid in its top-left 80x120."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 96, 160, 3, generator=g)
    mask = torch.zeros(2, 96, 160, dtype=torch.bool)
    mask[0] = True
    mask[1, :80, :120] = True
    return x * mask[..., None], mask


def labels_and_targets(m, seed=1, B=2):
    rng = np.random.default_rng(seed)
    G, C, R = m["max_gt_boxes"], m["num_labels"], m["num_rel_labels"]
    counts = [5, 3][:B]
    labels = np.zeros((B, G), np.int64)
    boxes = np.tile(np.array([0.5, 0.5, 1.0, 1.0], np.float32), (B, G, 1))
    rel = np.zeros((B, G, G, R), np.float32)
    targets = []
    for b, n in enumerate(counts):
        wh = rng.uniform(0.1, 0.4, (n, 2))
        cxy = rng.uniform(wh / 2, 1 - wh / 2)
        labels[b, :n] = rng.integers(0, C, n)
        boxes[b, :n] = np.concatenate([cxy, wh], 1)
        rel[b, 0, 1, rng.integers(0, R)] = 1.0
        rel[b, 2, 0, rng.integers(0, R)] = 1.0
        targets.append({"labels": torch.from_numpy(labels[b, :n]),
                        "boxes": torch.from_numpy(boxes[b, :n]),
                        "rel": torch.from_numpy(rel[b, :n, :n])})
    padded = {"class_labels": torch.from_numpy(labels),
              "boxes": torch.from_numpy(boxes),
              "num_boxes": torch.tensor(counts),
              "rel": torch.from_numpy(rel)}
    return padded, targets


# float32 on both sides, sums in another order
OUT_TOL = dict(atol=2e-4, rtol=2e-4)


def test_forward_matches_the_reference():
    """Proposal indices first (a tie or a flip there would move a whole
    query), then every output."""
    m, model, state = model_and_state()
    x, mask = padded_pair()
    model.eval()
    with torch.no_grad():
        got = model(x, mask)
        ref = TwoStageReference(state, m).forward(x, mask)
    assert torch.equal(got["proposal_indices"], ref["proposal_indices"])
    # the second image's masked tokens share one score: ties are met
    assert got["proposal_indices"].shape == (2, PROPOSALS)
    for key in ("init_reference_points", "intermediate_reference_points",
                "logits", "pred_boxes", "all_logits", "all_pred_boxes",
                "enc_outputs_class", "pred_rel_logits",
                "pred_connectivity_logits"):
        assert got[key].shape == ref[key].shape, key
        torch.testing.assert_close(got[key], ref[key], **OUT_TOL, msg=key)
    # masked and invalid proposals' boxes are +inf on both sides
    a, b = got["enc_outputs_coord_logits"], ref["enc_outputs_coord_logits"]
    assert torch.equal(torch.isinf(a), torch.isinf(b))
    assert torch.isinf(a).any()
    torch.testing.assert_close(a[~torch.isinf(a)], b[~torch.isinf(b)],
                               **OUT_TOL)
    # the refinement moves the boxes layer by layer
    refs = got["intermediate_reference_points"]
    assert not torch.allclose(refs[:, 0], refs[:, 1])


def reference_params(state):
    return {n: t.clone().requires_grad_() for n, t in state.items()}


def test_loss_and_every_gradient_match_the_reference():
    """The total loss with its ``_enc`` terms, then every leaf's gradient
    by the output check's measure (gap of norms over the larger of the
    leaf's and the median leaf's): float32 round-off, 1e-4."""
    m, model, state = model_and_state(seed=5)
    x, mask = padded_pair(2)
    padded, targets = labels_and_targets(m)
    model.train()
    out = model(x, mask)
    total, losses = criterion.sgg_criterion(out, padded, model.config,
                                            train=True)
    assert {"loss_ce_enc", "loss_bbox_enc", "loss_giou_enc"} <= set(losses)
    total.backward()
    params = reference_params(state)
    ref_out = TwoStageReference(params, m).forward(x, mask, train=True)
    ref_total, gap, _ = two_stage_loss(ref_out, targets, m)
    assert gap == 0.0
    assert math.isclose(float(total.detach()), float(ref_total.detach()),
                        rel_tol=1e-5)
    ref_total.backward()
    # the _enc terms alone: the proposals' share of the total
    enc = sum(float(losses[f"{k}_enc"]) * w for k, w in (
        ("loss_ce", m["ce_loss_coefficient"]),
        ("loss_bbox", m["bbox_loss_coefficient"]),
        ("loss_giou", m["giou_loss_coefficient"])))
    assert enc > 0.01 * float(total)
    # a leaf the loss does not reach (``rel_dist``) has no gradient on
    # either side
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    ref_grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in params.items()}
    assert set(grads) == set(ref_grads)
    names = sorted(grads)
    gaps = leaf_gaps(grads, ref_grads, names)
    worst = names[int(np.argmax(gaps))]
    assert gaps.max() <= 1e-4, (worst, gaps.max())
    for leaf in ("model.enc_output.weight", "model.pos_trans.weight",
                 f"model.class_embed_{m['decoder_layers']}.weight",
                 f"model.bbox_embed_{m['decoder_layers']}.layers_2.weight"):
        assert float(ref_grads[leaf].norm()) > 0, leaf


def test_the_cell_agrees_at_round_off():
    """A whole run of the cell at a tiny size: set-up, a unit, the output
    check (the program's choices recomputed and followed); every number at
    float32 round-off, the choices' gaps 0."""
    from portbench.modes import train_two_stage

    spec = tiny_spec()
    runner = train_two_stage.Runner(spec, 2**31 + 91, torch.device("cpu"),
                                     harness.Setup())
    runner.setup()
    assert len(runner.snapshots) == runner.warm - 1
    assert runner.unit() == 4 and runner.drain() == 0
    del runner.program_state
    checks = dict((n, v) for n, v, _ in runner.check())
    assert set(checks) == set(spec.traffic["limits"])
    # float32 both sides, Adam's sign at round-off for change3
    # the recomputed forwards' loss: the same eager ops, summed in another
    # order (replay_gap)
    bounds = {"loss": 1e-5, "grad1": 1e-3, "change3": 1e-2,
              "grad1_median": 1e-4, "change3_median": 1e-4,
              "proposal_gap": 0.0, "enc_match_gap": 0.0, "replay_gap": 1e-6}
    for name, value in checks.items():
        assert value <= bounds[name], (name, value)
    info = runner.slice_info()
    assert info["flops_per_image"] == flops_two_stage.step_flops(
        runner.m, runner.bucket, 1, True)


def test_the_control_in_the_programs_place_is_not_correct():
    """The float8 control (the reference with e4m3 operands) put in the
    program's place, its three steps' losses, first gradient and state,
    through ``Runner.check`` with the cell's own limits: its losses are not
    the program's recomputed forwards' (``replay_gap`` past its limit), so
    the run is not correct."""
    from portbench.modes import train_two_stage
    from portbench.reference.model import fp8_e4m3

    spec = tiny_spec()
    runner = train_two_stage.Runner(spec, 2**31 + 97, torch.device("cpu"),
                                     harness.Setup())
    runner.setup()
    del runner.program_state
    losses, g1, change, _, _ = runner.reference_steps(quant=fp8_e4m3)
    runner.warm_losses, runner.g1 = losses, g1
    runner.p3 = {n: runner.p0[n] + change[n] for n in runner.p0}
    checks = {name: (value, limit) for name, value, limit in runner.check()}
    value, limit = checks["replay_gap"]
    assert value > limit, checks


def test_proposal_flops_by_hand():
    m = {"d_model": 8, "num_labels": 3, "two_stage_num_proposals": 2,
         "num_feature_levels": 4}
    # levels of 64x64: 8x8, 4x4, 2x2, 1x1 -> S = 85
    S = 85
    hand = (2 * S * 8 * 8            # enc_output
            + 2 * S * 8 * 3          # the proposals' class head
            + 2 * S * (2 * 64 + 32)  # their box MLP
            + 2 * 2 * 16 * 16)       # pos_trans over the proposals
    assert flops_two_stage.proposal_flops(m, (64, 64)) == hand == 43184
    full = harness.load_spec(CELL).config["model"]
    parts = flops_two_stage.forward_flops(full, (800, 1344))
    base = flops.forward_flops(full, (800, 1344))
    assert {k: v for k, v in parts.items() if k != "proposals"} == base
    assert flops_two_stage.step_flops(full, (800, 1344), 4, True) == float(
        3 * 4 * sum(parts.values()))
    # the proposals' heads over 22,323 tokens: about 1.5% of the forward
    assert 0.005 < parts["proposals"] / sum(parts.values()) < 0.05


NEW_CELLS = {"vg-train-twostage": ("egtr-vg-r50-twostage", "train2s-b4a2",
                                   "train_two_stage", 1),
             "vg-train-dp4": ("egtr-vg-r50", "train-dp4-b4a2", "train_dp", 4)}
NEW_METRICS = {"proposals_ms_per_image.train": "vg-train-twostage",
               "enc_matcher_ms.train": "vg-train-twostage",
               "allreduce_ms.train": "vg-train-dp4"}


@pytest.mark.parametrize("cell", sorted(NEW_CELLS))
def test_new_cells_are_found_from_their_files(cell):
    bench = harness.benchmark_json()
    spec = harness.load_spec(cell, bench)
    config, traffic, mode, chips = NEW_CELLS[cell]
    assert (spec.config_name, spec.traffic_name, spec.chips) == (
        config, traffic, chips)
    assert spec.traffic["mode"] == mode
    harness.load_module("modes", mode)
    assert spec.end_to_end == ["train_images_per_s", "setup_s"]
    for name in spec.per_layer:
        assert callable(harness.load_module("metrics", name).read)
    base = harness.load_spec("vg-train-b4a2", bench)
    same = {k: v for k, v in base.traffic.items()
            if k not in ("mode", "limits", "assumed")}
    assert {k: spec.traffic[k] for k in same} == same
    if cell == "vg-train-dp4":
        assert spec.traffic["world"] == 4
        assert {"mfu.train", "allreduce_ms.train"} <= set(spec.per_layer)
        assert spec.config == base.config
    else:
        assert set(base.per_layer) <= set(spec.per_layer)
        m = spec.config["model"]
        assert (m["two_stage"], m["with_box_refine"],
                m["two_stage_num_proposals"], m["num_queries"]) == (
                    True, True, 300, 300)
        one = base.config["model"]
        assert {k for k in m if m[k] != one.get(k)} == {
            "two_stage", "with_box_refine", "num_queries",
            "two_stage_num_proposals"}
        assert spec.config["reduced"] == ["gpus"]
    for name in spec.traffic["limits"]:
        assert spec.traffic["limits"][name] > 0


def test_new_cells_keep_the_benchmark_shape():
    bench = harness.benchmark_json()
    cells = bench["workloads"]
    assert [w["name"] for w in cells[-2:]] == ["vg-train-twostage",
                                               "vg-train-dp4"]
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4)
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name, cell in NEW_METRICS.items():
        assert per_layer[name]["workloads"] == [cell]
        assert per_layer[name]["moves"] == "train_images_per_s"
    assert per_layer["mfu.train"]["workloads"][-1] == "vg-train-dp4"


def fake_trace(kernels):
    def kernel_us(pattern):
        import re
        found = [us for name, us in kernels if re.search(pattern, name)]
        return sum(found), len(found)
    return SimpleNamespace(kernel_us=kernel_us)


def test_new_readers():
    trace = fake_trace([("lsap_cluster_kernel", 900.0),
                        ("lsap_warp_kernel", 50.0),
                        ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 700.0),
                        ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 20.0)])
    spec = SimpleNamespace(chips=4)
    stats = SimpleNamespace(untraced_seconds=2.0, untraced_images=80)
    info = {"slice_steps": 3, "world": 4, "flops_per_image": 1e12}
    ctx = harness.MetricContext(spec, trace, stats, info)
    read = {n: harness.load_module("metrics", n).read for n in NEW_METRICS}
    assert read["enc_matcher_ms.train"](ctx) == pytest.approx(0.3)
    assert read["allreduce_ms.train"](ctx) == pytest.approx(0.24)
    # mfu.train on four ranks: rank 0's 80 images over one card's peak,
    # which is every rank's images over the four cards' peaks
    mfu = harness.load_module("metrics", "mfu.train").read
    assert mfu(ctx) == pytest.approx(100 * 80e12 / (2 * 989e12))
    assert mfu(ctx) == pytest.approx(100 * 4 * 80e12 / (2 * 4 * 989e12))
    empty = harness.MetricContext(spec, fake_trace([]), stats, info)
    assert read["enc_matcher_ms.train"](empty) is None
    assert read["allreduce_ms.train"](empty) is None
    # no programs in this process: the scope reader finds nothing
    nothing = harness.MetricContext(
        spec, type("Trace", (), {"spans": [], "device": []})(), stats,
        {"slice_images": 8})
    assert read["proposals_ms_per_image.train"](nothing) is None


def fake_lsap_card(monkeypatch):
    """``msda_cuda.lsap``, the wrapper itself, on CPU tensors: its C
    function answered by the plain solver through the pointers it is
    handed. Returns the list of the routes (``lsap_geometry``) of the
    launches, in order."""
    routes = []
    monkeypatch.setattr(matcher, "_takes_kernel", lambda cost: True)
    monkeypatch.setattr(msda_cuda, "_one_cuda_device", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: _Null())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)

    def view(ptr, ctype, shape):
        n = int(np.prod(shape))
        return np.ctypeslib.as_array((ctype * n).from_address(ptr)).reshape(
            shape)

    def fn(cost, nb, qi, mc, gi, B, Q, G, geom, stream):
        routes.append(msda_cuda.lsap_geometry(B, Q, G).route)
        c = torch.from_numpy(view(cost, ctypes.c_float, (B, Q, G)).copy())
        n = torch.from_numpy(view(nb, ctypes.c_int32, (B,)).copy())
        q, m, g = matcher.lsap_plain(c, n)
        view(qi, ctypes.c_int64, (B, G))[:] = q.numpy()
        view(mc, ctypes.c_float, (B, G))[:] = m.numpy()
        view(gi, ctypes.c_int64, (B, Q))[:] = g.numpy()
        return 0

    monkeypatch.setattr(msda_cuda, "_function", lambda name: fn)
    return routes


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_matcher_launches_by_route(monkeypatch):
    """A two-stage microbatch with auxiliary losses: the six decoder
    layers' matchings on the warp route, the proposals' (Q = S) on the
    cluster route; the routes add up to the kernel's count."""
    routes = fake_lsap_card(monkeypatch)
    m, model, _ = model_and_state(
        encoder_layers=1, decoder_layers=6, num_queries=64,
        two_stage_num_proposals=64, max_gt_boxes=64)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 256, 256, 3, generator=g)
    mask = torch.ones(2, 256, 256, dtype=torch.bool)
    padded, _ = labels_and_targets(m)
    S = 32 * 32 + 16 * 16 + 8 * 8 + 4 * 4
    assert msda_cuda.lsap_geometry(2, S, 64).route == "cluster"
    assert msda_cuda.lsap_geometry(2, 64, 64).route == "warp"
    with torch.no_grad():
        out = model(x, mask)
    msda_cuda.reset_launches()
    criterion.sgg_criterion(out, padded, model.config, train=True)
    assert msda_cuda.launches["lsap"] == 7
    assert sorted(routes) == ["cluster"] + ["warp"] * 6
    msda_cuda.reset_launches()


def top_spans(fn):
    """The forward's top-level ``record_function`` ranges, in order."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    names = {"backbone", "input_proj", "encoder", "proposals", "decoder",
             "relation_head"}
    events = sorted((e for e in prof.events() if e.name in names),
                    key=lambda e: e.time_range.start)
    top, end = [], -1
    for e in events:
        if e.time_range.start >= end:
            top.append(e.name)
            end = e.time_range.end
        else:
            assert e.time_range.end <= end, e.name
    return top, [e.name for e in events]


@pytest.mark.parametrize("two_stage", [False, True])
def test_proposals_scope(two_stage):
    """Only the two-stage forward enters ``proposals``, at the top level
    between the encoder and the decoder; the one-stage forward's scopes are
    the ones it always had, the query init inside ``decoder``."""
    kw = {} if two_stage else dict(two_stage=False, with_box_refine=False)
    _, model, _ = model_and_state(**kw)
    x, mask = padded_pair()
    model.eval()
    with torch.no_grad():
        top, every = top_spans(lambda: model(x, mask))
    want = ["backbone", "input_proj", "encoder", "decoder", "relation_head"]
    if two_stage:
        want.insert(3, "proposals")
    assert top == want
    assert every == want
