"""chip_smoke.py's control flow, rehearsed on the CPU at a tiny size.

The script needs a CUDA card, so here the card is faked: each CUDA kernel is
replaced by a counting call of its plain version, CUDA events by host
clocks, the 608x1008 and 800x1344 buckets and the bench and train models by
a 272x96 image (levels of 34, 17, 9 and 5 rows, so that a window of 16 bands
two levels and leaves two exact, as at 608x1008), the adaptation's bucket by
a 144x96 image (levels of 18, 9, 5 and 3 rows: one banded; no level one
pixel wide, where PyTorch's bfloat16 convolution on the CPU reads memory it
did not write), the experiment's by 144x224 landscape images (levels of
18, 9, 5 and 3 rows: a window of 16 bands one, a window of 8 two) and
2+2-layer models. What this checks is the script itself:
its phases run in order, the launch counts it demands match what the model
and the train step make, and it ends with the result line. The kernels' own
checks run only on the card.
"""

import importlib
import json
import shutil
import time
from pathlib import Path

import pytest
import torch

import chip_smoke
from egtr_tpu_torch import config as config_mod
from egtr_tpu_torch import infer
from egtr_tpu_torch.data import loader as loader_mod
from egtr_tpu_torch.data import open_images as oi_mod
from egtr_tpu_torch.data import transforms as transforms_mod
from egtr_tpu_torch.data import visual_genome as vg_mod
from egtr_tpu_torch.ops import matcher, msda, msda_cuda
from egtr_tpu_torch.parallel import dist, dryrun, launch
from egtr_tpu_torch.scripts import exp_window_deltas, perf_train_step
from egtr_tpu_torch.train import train_step as train_step_module
from egtr_tpu_torch.utils import aot

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

TINY = dict(d_model=64, encoder_layers=2, decoder_layers=2,
            encoder_ffn_dim=128, decoder_ffn_dim=128, num_queries=12,
            num_labels=7, num_rel_labels=5)
DRIVER_TINY = dict(d_model=64, encoder_layers=2, decoder_layers=2,
                   encoder_ffn_dim=128, decoder_ffn_dim=128)
# the experiment phase's image size and its --size / --max_size
EXP_SIZE = (144, 224)


@pytest.fixture(autouse=True)
def free_disk(tmp_path):
    """A test's checkpoints and artifacts hold a ResNet-50 backbone's
    weights (and moments), hundreds of MB: remove them after it."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


class HostEvent:
    def __init__(self, enable_timing=True):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


@pytest.fixture
def fake_card(monkeypatch, tmp_path):
    install_fake_card(monkeypatch.setattr, tmp_path)
    fake_ranks(monkeypatch, tmp_path)


def fake_ranks(monkeypatch, tmp_path, **faults):
    """The data-parallel phases' ranks are processes of their own: each one
    installs the same fake before it runs its part (``faked_rank``, with
    ``faults``)."""
    real_spawn = launch.spawn

    def spawn(target, nprocs, *, kwargs=None, **kw):
        kw.setdefault("threads", 1)
        return real_spawn(
            "test_torch_chip_smoke:faked_rank", nprocs,
            kwargs={"target": target, "kwargs": kwargs or {},
                    "fake_dir": str(tmp_path), **faults},
            path=[str(REPO / "tests")], **kw)

    monkeypatch.setattr(chip_smoke, "spawn", spawn)
    monkeypatch.setattr(dryrun, "spawn", spawn)


def faked_rank(device, target, kwargs, fake_dir, fail_rank=None,
               uncounted=None):
    """A rank of a data-parallel phase on the faked card; rank
    ``fail_rank`` exits with 3 before its part, and kernel ``uncounted``
    takes its launches back."""
    from egtr_tpu_torch.parallel import dist

    install_fake_card(setattr, Path(fake_dir))
    if dist.process_index() == fail_rank:
        raise SystemExit(3)
    if uncounted is not None:
        real = getattr(msda_cuda, uncounted)

        def kernel(*args, **kw):
            out = real(*args, **kw)
            msda_cuda.launches[uncounted] -= 1
            return out

        setattr(msda_cuda, uncounted, kernel)
    module, name = target.split(":")
    return getattr(importlib.import_module(module), name)(device=device,
                                                          **kwargs)


def install_fake_card(set_attr, tmp_path):
    """The fake, through ``set_attr`` (``monkeypatch.setattr`` in the test
    process, ``setattr`` in a rank's)."""
    def kernel(value, shapes, loc, aw, levels=None, out_dtype=None):
        msda_cuda.check_inputs(value, tuple(shapes), loc, aw)
        msda_cuda.launches["msda_fwd"] += 1
        return msda.ms_deform_attn_plain(value, shapes, loc, aw, levels,
                                         out_dtype)

    def fwd_bp(value, shapes, loc, aw, levels=None, out_dtype=None,
               scale=None):
        # each form computes what the kernel that serves it computes
        route = msda_cuda.check_inputs_bp(value, tuple(shapes), loc, aw,
                                          scale)
        msda_cuda.launches["msda_fwd_bp"] += 1
        if route == "msda_fwd":
            return msda.ms_deform_attn_plain(value, shapes, loc, aw, levels,
                                             out_dtype)
        if route == "msda_fwd_q":
            return msda.msda_fwd_q_plain(value, scale, shapes, loc, aw,
                                         levels)
        return msda.msda_fwd_bp_plain(value, shapes, loc, aw, levels,
                                      out_dtype, scale)

    def fwd_q(vq, scale, shapes, loc, aw, levels=None):
        msda_cuda.check_inputs_q(vq, scale, tuple(shapes), loc, aw)
        msda_cuda.launches["msda_fwd_q"] += 1
        return msda.msda_fwd_q_plain(vq, scale, shapes, loc, aw, levels)

    def fwd_win(name, per_point):
        def kernel(*args):
            msda_cuda.check_inputs_win(*args, per_point=per_point)
            # the launch the kernel would take at these shapes
            value_l, ix = args[0], args[2]
            msda_cuda.win_geometry(ix.shape[0] * ix.shape[1], args[-1],
                                   value_l.shape[3], ix.shape[2],
                                   value_l.element_size(), form="fwd")
            msda_cuda.launches[name] += 1
            return msda.msda_fwd_win_plain(*args)
        return kernel

    def bwd_rows(value, shapes, loc, aw, g, levels=None):
        msda_cuda.check_inputs(value, tuple(shapes), loc, aw)
        msda_cuda.check_grad_output(value, loc, g)
        msda_cuda.launches["msda_bwd_rows"] += 1
        return msda.ms_deform_attn_plain_bwd(value, shapes, loc, aw, g,
                                             levels)[1:]

    def bwd_value(value, shapes, loc, aw, g, levels=None, out_dtype=None):
        msda_cuda.check_grad_output(value, loc, g)
        # the launch the kernel would take at these shapes
        B, _, H, D = value.shape
        taken = range(len(shapes)) if levels is None else levels
        msda_cuda.value_geometry(B, loc.shape[1], H, D,
                                 tuple(tuple(shapes[l]) for l in taken),
                                 loc.shape[4], value.element_size())
        msda_cuda.launches["msda_bwd_value"] += 1
        return msda.ms_deform_attn_plain_bwd(value, shapes, loc, aw, g,
                                             levels, out_dtype)[0]

    def bwd_win(name, per_point, part):
        def kernel(*args, out=None):
            msda_cuda.check_inputs_bwd_win(*args, per_point=per_point)
            value_l, ix = args[0], args[2]
            msda_cuda.win_geometry(
                ix.shape[0] * ix.shape[1], args[-1], value_l.shape[3],
                ix.shape[2], value_l.element_size(), form=part)
            msda_cuda.launches[name] += 1
            grads = msda.msda_bwd_win_plain(*args)
            if part == "rows":
                return grads[1:]
            if out is None:
                return grads[0]
            # the value kernels add into the caller's slice of the layer's
            # gradient
            msda_cuda.check_value_out(out, value_l, args[6], args[7])
            return out.add_(grads[0])
        return kernel

    def lsap(cost, num_boxes):
        msda_cuda.check_inputs_lsap(cost, num_boxes)
        msda_cuda.lsap_geometry(*cost.shape)
        msda_cuda.launches["lsap"] += 1
        return matcher.lsap_plain(cost, num_boxes)

    def maybe_aot(fn, tag, device=None, collectives=False):
        """The train step's dispatch without the capture: its programs
        are keyed by signature as on the card, each call eager; a function
        with collectives under gloo is itself, as ``aot.maybe_aot``'s rule
        has it."""
        if collectives and not dist.capturable():
            return fn
        programs = {}

        def call(*args):
            programs.setdefault(aot.signature(args), tag)
            return fn(*args)

        call.programs = programs
        return call

    bench_config = infer.bench_config
    train_config = perf_train_step.train_config
    set_attr(torch.cuda, "is_available", lambda: True)
    set_attr(torch.cuda, "Event", HostEvent)
    set_attr(torch.cuda, "synchronize", lambda *a: None)
    set_attr(torch.cuda, "get_device_name", lambda i=0: "host")
    set_attr(torch.cuda, "device_count", lambda: 1)
    set_attr(torch.cuda, "reset_peak_memory_stats", lambda *a: None)
    set_attr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    set_attr(torch.cuda, "max_memory_reserved", lambda *a: 0)
    set_attr(torch.cuda, "memory_allocated", lambda *a: 0)
    set_attr(msda_cuda, "msda_fwd", kernel)
    set_attr(msda_cuda, "msda_bwd_rows", bwd_rows)
    set_attr(msda_cuda, "msda_bwd_value", bwd_value)
    set_attr(msda_cuda, "msda_fwd_q", fwd_q)
    set_attr(msda_cuda, "msda_fwd_win",
             fwd_win("msda_fwd_win", False))
    set_attr(msda_cuda, "msda_fwd_win_pp",
             fwd_win("msda_fwd_win_pp", True))
    set_attr(msda_cuda, "msda_fwd_bp", fwd_bp)
    for name, per_point in (("msda_bwd_win_rows", False),
                            ("msda_bwd_win_rows_pp", True),
                            ("msda_bwd_win_value", False),
                            ("msda_bwd_win_value_pp", True)):
        part = "value" if "value" in name else "rows"
        set_attr(msda_cuda, name, bwd_win(name, per_point, part))
    set_attr(msda_cuda, "lsap", lsap)
    set_attr(train_step_module, "maybe_aot", maybe_aot)
    # the dispatch takes the (faked) kernels for these CPU tensors, as it
    # does for CUDA tensors on the card
    set_attr(msda, "_takes_kernels",
             lambda impl, value: impl in ("auto", "pallas"))
    set_attr(matcher, "_takes_kernel", lambda cost: True)
    set_attr(msda_cuda, "build", lambda: {
        name: tmp_path / f"lib{name}.so" for name in msda_cuda.sources()})
    set_attr(chip_smoke, "card_line", lambda: "Host, 0.00 W")
    set_attr(chip_smoke, "DEVICE", "cpu")
    set_attr(chip_smoke, "SIDE_BY_SIDE_ROUNDS", 2)
    # one call each; a positive time, as a card's, for the rates
    set_attr(chip_smoke, "cuda_ms",
             lambda fn, iters, warmup=0: (fn(), 1.0)[1])
    set_attr(chip_smoke, "graph_ms", lambda fn, *a: (fn(), 1.0)[1])
    set_attr(infer, "BUCKET_HW", (272, 96))
    set_attr(infer, "bench_config",
             lambda **kw: bench_config(**{**TINY, **kw}))
    set_attr(infer, "resolve_device",
             lambda device=None: torch.device("cpu"))
    set_attr(perf_train_step, "resolve_device",
             lambda device=None: torch.device("cpu"))
    set_attr(perf_train_step, "BUCKET_HW", (64, 96))
    set_attr(
        perf_train_step, "train_config",
        lambda **kw: train_config(**{**perf_train_step.TINY, **kw}))
    adapt_config = perf_train_step.adapt_config
    set_attr(
        perf_train_step, "adapt_config",
        lambda **kw: adapt_config(**{**perf_train_step.TINY, **kw}))
    set_attr(perf_train_step, "ADAPT_HW", (144, 96))
    set_attr(perf_train_step, "ADAPT_BATCH", 1)
    set_attr(chip_smoke, "ADAPT_STEPS", 1)
    # the driver: 2+1+1 synthetic images of 144x96 that no resize changes
    # (the DETR scales and the test size set to their short side), one
    # bucket, a 2+2-layer model of the driver's bf16, 12 queries; batch 1
    # x accum 2: one optimizer step per phase
    real_cfg, real_ds = config_mod.EgtrConfig, vg_mod.VGDataset

    class SmallVG(real_ds):
        def __init__(self, *a, size=800, max_size=1333, **kw):
            if (size, max_size) != EXP_SIZE:  # the experiment's pass
                size, max_size = 96, 144
            super().__init__(*a, size=size, max_size=max_size, **kw)

    class TinyConfig(real_cfg):
        def __init__(self, **kw):
            super().__init__(**{**kw, **DRIVER_TINY})

    class SmallOI(oi_mod.OIDataset):
        def __init__(self, *a, size=800, max_size=1333, **kw):
            super().__init__(*a, size=96, max_size=144, **kw)

    set_attr(config_mod, "EgtrConfig", TinyConfig)
    set_attr(vg_mod, "VGDataset", SmallVG)
    set_attr(oi_mod, "OIDataset", SmallOI)
    # the same for Open Images: 2+1+1 images of 144x96; two stages with
    # 100 of the train bucket's 128 tokens as proposals (two steps: the
    # heads' zeroed last layers keep the layers before them still in the
    # first); one remat step and one evaluator replay each
    set_attr(chip_smoke, "SYNTH_OI", dict(
        n_train=2, n_val=1, n_test=1, height=144, width=96))
    set_attr(chip_smoke, "TWO_STAGE", dict(
        chip_smoke.TWO_STAGE, two_stage_num_proposals=100))
    set_attr(chip_smoke, "REMAT_STEPS", 1)
    set_attr(chip_smoke, "OI_EVAL_ROUNDS", 1)
    set_attr(transforms_mod, "DETR_TRAIN_SCALES", (96,))
    # the pretraining driver's crops may turn an image on its side
    set_attr(loader_mod, "default_buckets",
             lambda max_size=1333: ((144, 96), (96, 144),
                                    (144, 144)))
    set_attr(chip_smoke, "SYNTH_VG", dict(
        n_train=2, n_val=1, n_test=1, height=144, width=96))
    # the experiment: 2+1+1 landscape images of 144x224, its one bucket
    # (levels of 18, 9, 5 and 3 rows: a window of 16 bands one, a window of
    # 8 two), batch 1, one step a train command (a budget of 0 seconds), the
    # sweep's exact and served variants; the window deltas at that size
    set_attr(chip_smoke, "SYNTH_EXP", dict(
        n_train=2, n_val=1, n_test=1, height=EXP_SIZE[0], width=EXP_SIZE[1]))
    set_attr(chip_smoke, "EXP_ARGS", [
        "--size", str(EXP_SIZE[0]), "--max_size", str(EXP_SIZE[1]),
        "--batch", "1"])
    set_attr(chip_smoke, "EXP_TRAIN_SECONDS", dict.fromkeys(
        chip_smoke.EXP_TRAIN_SECONDS, 0))
    set_attr(chip_smoke, "EXP_SWEEP", ["--windows", "0,16p,16pi"])
    set_attr(exp_window_deltas, "HW", EXP_SIZE)
    args = list(chip_smoke.DRIVER_ARGS)
    for flag, value in (("--batch_size", "1"), ("--num_workers", "1")):
        args[args.index(flag) + 1] = value
    set_attr(chip_smoke, "DRIVER_ARGS", args + [
        "--num_queries", "12", "--max_gt_boxes", "8", "--max_gt_rels", "16"])
    # the pretraining driver: batch 1 x accum 2, one step per phase
    args = list(chip_smoke.PRETRAIN_ARGS)
    for flag, value in (("--batch_size", "1"), ("--num_workers", "1")):
        args[args.index(flag) + 1] = value
    set_attr(chip_smoke, "PRETRAIN_ARGS", args + [
        "--num_queries", "12", "--max_gt_boxes", "8"])
    # the float32 phase turns TF32 off; restore both flags afterwards
    set_attr(torch.backends.cudnn, "allow_tf32",
             torch.backends.cudnn.allow_tf32)
    set_attr(torch.backends.cuda.matmul, "allow_tf32",
             torch.backends.cuda.matmul.allow_tf32)
    # the data-parallel phases: one bf16 round a rank; the adaptation's two
    # ranks x two microbatches of one image; the dry run in one rank, (d)
    # (tests/test_torch_parallel.py runs it in two on the CPU)
    set_attr(chip_smoke, "DDP_STEPS", 1)
    # (i) and (j): the CPU's runs are bit-equal, so one eager pair holds
    # what three would; one round of the timed steps
    set_attr(chip_smoke, "TRAIN_GRAPH_EAGER_RUNS", 2)
    set_attr(chip_smoke, "TRAIN_GRAPH_TURNS", 1)
    set_attr(chip_smoke, "DDP_ADAPT_GLOBAL_BATCH", 4)
    set_attr(chip_smoke, "DRYRUN_WORLDS", (1,))
    # (f), the model axis: one bf16 round a rank
    set_attr(chip_smoke, "TP_STEPS", 1)
    # (g), the matcher kernel: the one-stage and two-stage microbatches of 2;
    # the parent commit's kernel, in turns, is the plain version here
    set_attr(chip_smoke, "LSAP_CASES", ((2, 200), (2, 300)))
    set_attr(chip_smoke, "build_parent_lsap",
             lambda: ("parent", "the plain version on the faked card"))
    set_attr(chip_smoke, "parent_lsap_call",
             lambda lib: lambda cost, nb: matcher.lsap_plain(cost, nb))


def test_chip_smoke_runs_its_phases(fake_card, capsys):
    assert chip_smoke.main() == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "Host, 0.00 W"
    assert json.loads(lines[-1]) == {
        "ok": True, "device": {"platform": "gpu", "kind": "host",
                               "count": 1}}
    result = json.loads(lines[-3])
    kernels = result["kernels"]
    assert [k["name"] for k in kernels] == [
        "msda_fwd", "msda_bwd_rows", "msda_bwd_value", "msda_fwd_q",
        "msda_fwd_win", "msda_fwd_win_pp", "msda_bwd_win_rows",
        "msda_bwd_win_rows_pp", "msda_bwd_win_value", "msda_bwd_win_value_pp",
        "msda_fwd_bp", "lsap"]
    required = {"name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"}
    for k in kernels:
        assert required <= set(k), k["name"]
        assert k["route"] == "cuda" and k["library_ms"] is None
        assert k["bound_by"] in ("bytes", "operations") and k["bound_ms"] > 0
        assert isinstance(k["max_abs_err"], float)
        path, line = k["replaces"].split(":")
        assert path == ("egtr_tpu/ops/matcher.py" if k["name"] == "lsap"
                        else "egtr_tpu/ops/msda_pallas.py") and int(line) > 0
        assert (REPO / k["source"]).exists()
        assert k["launches"] > 0
    fwd, rows, value, fwd_q, win, win_pp, *bwd_win, bp, lsap = kernels
    # the matcher kernel: bit-equal to its plain version, optimal; training
    # (auxiliary losses, 2 decoder layers: 2 matches a microbatch) 3 steps
    # + 2 microbatches of the accumulated one; the driver (no auxiliary
    # losses) per phase 2 microbatches and 1 validation batch
    assert lsap["bit_equal_to_plain"] and lsap["optimal_vs_scipy"]
    assert len(lsap["calls"]) == 8 and lsap["max_abs_err"] == 0.0
    # per case the route, the search steps and the parent's kernel in turns
    for call in lsap["calls"]:
        assert call["route"] == "warp" and call["cluster"] == 1
        assert call["longest_image_steps"] <= call["search_steps"]
        assert call["parent_bit_equal"] and call["parent_graph_ms"] > 0
        assert len(call["parent_graph_ms_in_turns"]) == 2
        assert len(call["graph_ms_in_turns"]) == 2
        assert call["us_per_step"] > 0
    assert lsap["route_main"] == "warp" and lsap["parent_graph_ms"] > 0
    assert lsap["launches_training"] == 5 * 2
    assert lsap["launches_driver"] == 3 * 2
    # the request and the train step as programs against eager (on the
    # faked card both run eagerly, so the outputs are equal)
    for label, r in result["request_graphs"].items():
        assert r["bit_equal"] and set(r["median_ms"]) == {"graph", "eager"}
        assert r["launches_per_forward"] == {
            **dict.fromkeys(msda_cuda.KERNELS, 0),
            **({"msda_fwd": 4} if label == "exact" else
               {"msda_fwd_q": 4, "msda_fwd_win_pp": 2 * 2})}
    graphs = result["train_graphs"]
    assert graphs["bf16_accum2"]["programs"] == {"whole": 0, "grads_mb": 1,
                                                 "apply": 1}
    assert len(set(graphs["dropout_replay_losses"][1:])) == 2
    # exact serving: 4 timed + 2 warm-up requests + 1 checked forward, 2+2
    # MSDA layers each; training: 3 steps + 2 microbatches of the
    # accumulated one
    assert fwd["launches_serving"] == 7 * 4
    assert fwd["launches_training"] == 5 * 4
    # pretraining: per phase one step of 2 microbatches and 1 validation
    # image, then 1 test image
    assert rows["launches_training"] == value["launches_training"] == 5 * 4
    assert rows["launches_pretrain"] == value["launches_pretrain"] == 4 * 4
    assert fwd["launches_pretrain"] == 7 * 4
    # launches: the training run's; the other paths' under their own keys
    assert rows["launches"] == value["launches"] == 5 * 4
    # the evaluation driver on the 1 test image: exact, served (144x96:
    # one banded level), and --infer_only's 1 + 1 + 2 x 10 forwards (on
    # the card a third loop of ten, under the profiler)
    assert fwd["launches_evaluate"] == 4
    assert fwd["launches_evaluate_infer_only"] == 22 * 4
    assert fwd_q["launches_evaluate_served"] == 2 + 2
    assert win_pp["launches_evaluate_served"] == 2
    # served (window 16, one band per point, int8), 7 forwards: each of the 2
    # encoder layers launches K6 on the 2 banded levels and K4 once on the 2
    # exact ones, each of the 2 decoder layers K4 once; K1 never
    assert win_pp["launches_serving_served"] == 7 * 2 * 2
    assert win_pp["launches"] == 7 * 2 * 2 and win_pp["form"] == "int8"
    assert fwd_q["launches_serving_served"] == 7 * (2 + 2)
    assert fwd_q["launches"] == 7 * (2 + 2)
    assert fwd["launches_serving_served"] == 0
    # Open Images through the three drivers, on 2+1+1 images as the VG
    # drivers: the same launches
    assert fwd["launches_oi_train"] == fwd["launches_oi_pretrain"] == 7 * 4
    assert rows["launches_oi_train"] == value["launches_oi_pretrain"] == 4 * 4
    assert fwd["launches_oi_evaluate"] == 4
    assert result["open_images"]["rel_full_bytes_per_image"] == (
        12 * 12 * 30 * 4)
    # two stages: one forward and two steps; remat: "full" recomputes each
    # layer's forward in the backward pass, "dots" none
    assert fwd["launches_two_stage_serving"] == 4
    assert fwd["launches_two_stage_training"] == rows[
        "launches_two_stage_training"] == 2 * 4
    assert len(fwd["calls_two_stage"]) == len(rows["calls_two_stage"]) == 3
    assert fwd["launches_remat_full_training"] == 2 * 4
    assert fwd["launches_remat_dots_training"] == 4
    assert rows["launches_remat_full_training"] == value[
        "launches_remat_dots_training"] == 4
    assert result["remat"]["k1_per_microbatch"] == {"off": 4, "full": 8,
                                                    "dots": 4}
    assert result["approx_topk"]["losses_bit_equal"]
    # one band per tile without int8, 2 timed + 2 warm-up + 1 checked
    # forward: K5 on the banded levels, K1 on the exact ones and the decoder
    assert win["launches"] == 5 * 2 * 2 and win["form"] == "bfloat16"
    assert fwd["launches_serving_tile"] == 5 * (2 + 2)
    assert fwd["launches"] == (7 + 5 + 5) * 4
    assert fwd_q["int8_grad_launches"] == {
        "msda_fwd_q": 1, "msda_bwd_rows": 1, "msda_bwd_value": 1}
    # K4: four calls (the served encoder call, the int8 encoder call, the
    # decoder call at batch 1 and 2) x two weight dtypes, bit-equal over two
    # runs and timed in a CUDA graph; K5, K6: three value types each
    assert [(c["call"], c["batch"]) for c in fwd_q["calls"][::2]] == [
        ("encoder_served", 1), ("encoder", 1), ("decoder", 1), ("decoder", 2)]
    assert len(fwd_q["calls"]) == 8
    # K4, K5 and K6 again at the evaluation's test bucket, 144x96 here
    assert [(c["bucket"], c["call"]) for c in fwd_q["calls_test_bucket"]
            ][::2] == [("test", "encoder_served"), ("test", "encoder"),
                       ("test", "decoder"), ("test", "decoder")]
    for k in (win, win_pp):
        assert [(c["bucket"], c["dtype"]) for c in k["calls_test_bucket"]
                ] == [("test", "float32"), ("test", "bfloat16"),
                      ("test", "int8")]
    assert result["evaluate_test_bucket"] == [144, 96]
    assert fwd_q["bit_equal_run_to_run"] and fwd_q["graph_ms"] > 0
    assert all(c["graph_ms"] > 0 and c["bit_equal_run_to_run"]
               for c in fwd_q["calls"])
    assert {"graph_ms_encoder", "graph_ms_decoder",
            "graph_ms_decoder_batch2"} <= set(fwd_q)
    assert [c["dtype"] for c in win["calls"]] == ["float32", "bfloat16",
                                                  "int8"]
    assert win_pp["calls"][0]["levels"] == [0, 1]
    assert fwd_q["served_model_f32_max_abs_err"]["band_indices"] > 0
    # forward: both buckets x (encoder, decoder, encoder with raster
    # locations, decoder at batch 2) x (float32, bfloat16); backward: the
    # training bucket's
    assert len(fwd["calls"]) == 16
    assert len(rows["calls"]) == 8
    assert [(c["call"], c["batch"]) for c in rows["calls"]] == [
        ("encoder", 1), ("encoder", 1), ("decoder", 1), ("decoder", 1),
        ("encoder_raster", 1), ("encoder_raster", 1), ("decoder", 2),
        ("decoder", 2)]
    assert "graph_ms_decoder_batch2" in rows
    # K1, K2 and K3: the grid_sample composite as a yardstick of several
    # calls beside library_ms (null); K1 and K2: the corner gathers, their
    # rate, the device time in a CUDA graph, bit-equal runs
    for k in (fwd, rows, value):
        assert "composite of several PyTorch calls" in k["library_composite"]
        assert k["library_composite_ms"] >= 0
    for k in (fwd, rows):
        assert k["gather_bytes"] > 0 and "gather_GBps_L2" in k
        assert "graph_ms" in k and "ms_encoder_raster" in k
    assert all(c["bit_equal_run_to_run"] for c in fwd["calls"])
    assert all(c["rows_bit_equal_run_to_run"] for c in rows["calls"])
    # K3 at every call of phase 4: CUDA events and a CUDA graph
    assert {"graph_ms", "ms_encoder_raster", "graph_ms_decoder",
            "graph_ms_decoder_batch2"} <= set(value)
    assert all("value_graph_ms" in c for c in value["calls"])
    # the adaptation (144x96: level 0 of 4 banded), one step of a batch of
    # 1, 2+2 layers: per microbatch K6 2, K1 2 + 2, K8 2, K10 2, K2 and K3
    # 2 + 2; its tile sibling K7, K9 2 each; its int8 sibling K4 4
    k7, k8, k9, k10 = bwd_win
    assert k8["launches"] == k10["launches"] == 2
    assert k7["launches"] == k9["launches"] == 2
    assert fwd["launches_adaptation"] == rows["launches_adaptation"] == 4
    assert fwd_q["launches_adaptation_int8"] == 4
    assert [k["replaces"].split(":")[1] for k in bwd_win] == [
        "836", "722", "877", "772"]
    assert all(k["source"] == "egtr_tpu_torch/csrc/msda_bwd_win.cu"
               for k in bwd_win)
    # K7-K10: float32 and bfloat16 per band, the adaptation's batch
    assert [c["dtype"] for c in k8["calls"]] == ["float32", "bfloat16"]
    assert k8["calls"][0]["levels"] == [0]
    assert "run_to_run_max_abs_diff" in k10
    # K7 and K8 bit-equal over two runs, timed in a CUDA graph too; K7
    # bit-equal to K8 given its tile bands broadcast over the points
    assert k8["bit_equal_run_to_run"] and k7["bit_equal_run_to_run"]
    assert k8["graph_ms"] > 0 and k7["graph_ms"] > 0
    assert k7["graph_ms_float32"] > 0
    assert k7["bit_equal_to_k8_broadcast"]
    assert all(c["rows_bit_equal_to_k8_broadcast"] for c in k7["calls"])
    # K9 and K10 in a CUDA graph too, both adding into a layer's gradient;
    # K9 beside K10 given its tile bands broadcast over the points
    for k in (k9, k10):
        assert k["graph_ms"] > 0 and k["graph_ms_float32"] > 0
    assert all(c["value_graph_ms"] > 0 for c in k9["calls"] + k10["calls"])
    assert k9["max_abs_diff_to_k10_broadcast"] == 0.0
    assert all("value_max_abs_diff_to_k10_broadcast" in c
               for c in k9["calls"])
    # K5 and K6: bit-equal over two runs, in a CUDA graph per value type;
    # K5 bit-equal to K6 given its tile bands broadcast over the points
    for k in (win, win_pp):
        assert k["bit_equal_run_to_run"] and k["graph_ms"] > 0
        assert {"graph_ms_float32", "graph_ms_bfloat16",
                "graph_ms_int8"} <= set(k)
    assert win["bit_equal_to_k6_broadcast"]
    assert all(c["bit_equal_to_k6_broadcast"] for c in win["calls"])
    assert set(result["train_adaptation"]) == {"point", "tile", "point_int8"}
    assert result["train_f32"]["adaptation"]["band_indices"] > 0
    assert "nudged_pixels_max_grad_rel_change" in result["train_f32"]["exact"]
    # K11: two forwards of each serving configuration with the flag on,
    # 2+2 layers each; the driver's 7 forwards (per phase 2 microbatches and
    # 1 validation batch, then 1 test image)
    assert bp["replaces"] == "egtr_tpu/ops/msda_pallas.py:180"
    # its main (bfloat16) form runs K1's kernel, int8 K4's, float32 its own
    assert bp["source"] == "egtr_tpu_torch/csrc/msda_fwd.cu"
    assert bp["sources_by_form"] == {
        "bfloat16": "egtr_tpu_torch/csrc/msda_fwd.cu",
        "int8": "egtr_tpu_torch/csrc/msda_fwd_q.cu",
        "float32": "egtr_tpu_torch/csrc/msda_fwd_bp.cu"}
    assert bp["routes_by_form"] == {"bfloat16": "msda_fwd",
                                    "int8": "msda_fwd_q",
                                    "float32": "msda_fwd_bp"}
    assert bp["bit_equal_where_routed"]
    assert all(bp["served_bf16_bit_equal_flag_off"].values())
    assert (bp["launches_exact"], bp["launches_served"],
            bp["launches_tile"], bp["launches_driver"]) == (8, 8, 8, 28)
    assert bp["launches"] == 8 * 3 + 28
    assert "ms_msda_fwd_same_call" in bp
    # both buckets x (encoder, decoder) x (f32, bf16), int8 x 2, windowed,
    # then bf16 and int8 at P = 3 and on unaligned values
    assert len(bp["calls"]) == 8 + 2 + 1 + 4
    assert [c["form"] for c in bp["calls"][-7:]] == [
        "int8", "int8", "bfloat16_f32_out", "bfloat16 P=3", "int8 P=3",
        "bfloat16 unaligned", "int8 unaligned"]
    assert [c["routed_to"] for c in bp["calls"][:4]] == [
        "msda_fwd_bp", "msda_fwd", "msda_fwd_bp", "msda_fwd"]
    assert set(bp["served_f32_max_abs_err"]) == {"exact", "served"}
    driver = result["driver"]
    # on the faked card the steps run eagerly: no program, no pool
    assert driver["program_memory_gb"] == [] and driver["peak_split_gb"] is None
    assert set(driver["phases"]) == {"main", "finetune"}
    assert all(len(p["step_ms"]) == 1 for p in driver["phases"].values())
    assert "single/R@20" in driver["test"] and "coco/AP" in driver["test"]
    evaluate = result["evaluate"]
    assert set(evaluate) == {"exact", "served", "infer_only"}
    assert {k: evaluate["exact"]["result"][k] for k in chip_smoke.RECALL_KEYS
            } == {k: driver["test"][k] for k in chip_smoke.RECALL_KEYS}
    assert evaluate["infer_only"]["result"]["images"] == 1
    assert evaluate["exact"]["top_k_bit_equal_to_driver"]
    assert all(r["seconds"] > 0 for r in evaluate.values())
    fps = evaluate["infer_only"]["result"]
    assert fps["chained_ms_per_image"] > 0 and fps["device_ms_per_image"] > 0
    # the exact run's SGG-evaluator calls: the single evaluator's and one
    # per predicate in the image's ground truth
    matching = result["sg_eval_host_ms"]
    assert matching["calls"] >= 2
    for traffic in ("recorded", "planted"):
        assert matching[traffic]["same_recalls"]
        assert matching[traffic]["native_ms"] > 0
        assert matching[traffic]["numpy_ms"] > 0
    assert matching["planted"]["max_recall"] == 1.0
    pretrain = result["pretrain"]
    assert all(len(p["step_ms"]) == 1 for p in pretrain["phases"].values())
    # the experiment (144x224, 2+2 layers, batch 1, one step a train
    # command): K1 4 a step (exact levels and decoder), 4 in the offsets'
    # forward; the sweep's three variants K1 4 + 4, K6 2 + 2, K4 4; the
    # window deltas' four forwards K1 16, K5 2, K6 2 + 4 (win8_point's two
    # banded levels)
    experiment = result["experiment"]
    assert set(experiment["runs"]) == {"exact", "resume", "point", "tile",
                                       "offsets", "window_deltas"}
    assert [experiment["runs"][k]["start_step"] for k in (
        "exact", "resume", "point", "tile")] == [0, 1, 0, 0]
    assert all(experiment["runs"][k]["steps"] == 1 for k in (
        "exact", "resume", "point", "tile"))
    assert fwd["launches_experiment"] == 4 * 4 + 8 + 4 + 16
    assert rows["launches_experiment"] == value["launches_experiment"] == 16
    assert fwd_q["launches_experiment"] == 4
    assert win["launches_experiment"] == 2 + 2
    assert win_pp["launches_experiment"] == 2 + 4 + 6
    assert [k["launches_experiment"] for k in bwd_win] == [2, 2, 2, 2]
    assert set(experiment["sweep"]["recall"]) == {
        "win0", "win16_pp", "win16_pp_int8"}
    assert all(len(experiment["runs"][k]["losses"]) == 1 for k in (
        "exact", "resume", "point", "tile"))
    assert experiment["clamp_fracs_max_abs_diff_cpu"] <= (
        chip_smoke.EXP_CLAMP_ATOL)
    assert experiment["clamp_fracs_card"]["clamp_frac_win16_point"] > 0
    assert "coco/AP" in pretrain["test"] and pretrain["fresh_paths"] > 0
    out = "\n".join(lines)
    for phase in ("kernel build:", "msda_fwd serving encoder",
                  "msda_fwd training decoder", "msda_bwd training encoder",
                  "msda_fwd serving encoder_raster",
                  "msda_bwd training decoder Q=200 B=2",
                  "msda_bwd training encoder_raster",
                  "GB/s of L2 gather traffic (not a roofline share)",
                  "msda_fwd_q serving encoder_served",
                  "msda_fwd_q test encoder_served",
                  "msda_fwd_win_pp test encoder window 16",
                  "SGG evaluator, the exact run's",
                  "msda_fwd_q serving decoder batch 2",
                  "msda_fwd_win serving encoder window 16",
                  "bit-equal to msda_fwd_win_pp on the bands broadcast over "
                  "the points True",
                  "value max abs diff to msda_bwd_win_value_pp on the bands "
                  "broadcast over the points 0.000e+00",
                  "msda_fwd_win_pp serving encoder batch 2",
                  "serve exact", "serve served", "serve tile",
                  "ms/request, exact | served | tile, 2 rounds in turns",
                  "model f32 exact kernels vs plain MSDA",
                  "model f32 served kernels vs plain MSDA",
                  "int8 op without a window, forward + backward",
                  "train exact", "frozen leaves bit-identical",
                  "train f32 exact kernels vs plain",
                  "msda_bwd_win_rows + msda_bwd_win_value adaptation encoder",
                  "bit-equal to msda_bwd_win_rows_pp on the bands broadcast "
                  "over the points True",
                  "msda_fwd_q serving decoder Q=200 B=2",
                  "msda_bwd_win_rows_pp + msda_bwd_win_value_pp adaptation "
                  "encoder batch 2",
                  "train adaptation (window 16, band point, int8 False)",
                  "train adaptation tile (window 16, band tile",
                  "train adaptation int8 (window 16, band point, int8 True)",
                  "train f32 adaptation kernels vs plain",
                  "msda_fwd_bp serving encoder Q=",
                  "msda_fwd_bp training decoder Q=200 bfloat16 batch 2",
                  "msda_fwd_bp serving encoder_served",
                  "msda_fwd_bp serving encoder_windowed",
                  "serve exact with batch_p", "serve served with batch_p",
                  "serve tile with batch_p", "with batch_p (K11) vs plain",
                  "driver (train_egtr.main, batch_p on",
                  "artifact reloaded bit-equal: True",
                  "evaluate (evaluate_egtr.main, batch_p off",
                  "images with relations bit-equal to phase 17's: True",
                  "--infer_only", "host_rtt_ms",
                  "pretrain (pretrain_detr.main",
                  "experiment train exact (window 0",
                  "experiment train --resume --window 8: refused",
                  "experiment train point (window 16, band point)",
                  "experiment sweep --windows 0,16p,16pi (",
                  "rerun 0.", "experiment offsets", "largest difference "
                  "to the CPU's", "experiment window deltas (144x224)",
                  "detector leaves loaded",
                  "ddp (c): the drivers on 2 ranks (gloo)",
                  "one process's evaluate_egtr",
                  "ddp (a): 2 ranks (gloo, CUDA tensors) on one card",
                  "ranks' parameters bit-equal",
                  "all-reduce of", "ddp (b): 2 ranks x accum 2 x window 16",
                  "ddp (d): dryrun_multichip(1) on gloo",
                  "the step eager: launches",
                  "(j) the data-parallel step in one rank on gloo",
                  "its residual after each run's own AdamW updates",
                  "its forward a program in each rank",
                  "model f32 exact card vs CPU (F1)",
                  "model f32 served card vs CPU (F1)",
                  "experiment adapted model (window 16, band point) f32 card "
                  "vs CPU (F1)", "F2: the gradients' largest relative error",
                  "tp (f): dp 1 x mp 2 (2 ranks, gloo) on one card",
                  "the model group's 4 collectives of a step (2 all_gather",
                  "train_egtr --dp 1 --mp 2",
                  "the trained model's float32 logits vs one process's"):
        assert phase in out, phase
    # the data-parallel paths' launches in each of their ranks: 2+2 layers,
    # (a) one float32 step and three bf16 steps; (b) two microbatches, one
    # banded level of the 144x96 adaptation image
    for kernel in (fwd, rows, value):
        assert kernel["launches_ddp_per_rank"] == [4, 4]
        # a warm-up and a step with and one without DDP's reduction
        assert kernel["launches_ddp_bf16_per_rank"] == [3 * 4, 3 * 4]
        assert kernel["launches_ddp_adaptation_per_rank"] == [8, 8]
        assert kernel["launches_ddp_dryrun_world_1_per_rank"] == [4]
    for kernel in (win_pp, bwd_win[1], bwd_win[3]):
        assert kernel["launches_ddp_adaptation_per_rank"] == [4, 4]
    # (c) the drivers: no train step (2 images, global batch 4), a
    # validation batch a phase and two test images a rank
    assert fwd["launches_ddp_train_per_rank"] == [4 * 4, 4 * 4]
    assert fwd["launches_ddp_evaluate_per_rank"] == [2 * 4, 2 * 4]
    parallel = result["data_parallel"]
    assert parallel["ddp"]["grad_bytes"] > 0
    assert set(parallel["dryruns"]) == {"world_1"}
    assert parallel["dryruns"]["world_1"]["captured"] is False
    # (j) one rank (gloo on the faked card: the step functions that hold
    # the gradient reduction eager, the microbatch a program): (i)'s rule
    # on its float32 runs, a replay of the step at batch 2 and at 2 x
    # accum 2, the eval step and the runner's forward
    nccl = parallel["nccl_programs"]
    assert nccl["backend"] == "gloo" and nccl["programs"] == {
        "b2_accum1": {"whole": 0, "grads_mb": 0, "apply": 0},
        "b2_accum2": {"whole": 0, "grads_mb": 1, "apply": 0}}
    assert nccl["float32"]["held"] == list(chip_smoke.TRAIN_GRAPH_HELD)
    assert set(nccl["ms_in_turns"]["b2_accum2"]) == {"graph", "eager"}
    for kernel in (fwd, rows, value):
        assert kernel["launches_nccl_programs_replay_per_rank"] == [4]
    # (f) dp 1 x mp 2: each rank runs the whole detector, one float32 step,
    # a warm-up and one bf16 round, and the driver (one data rank: a step
    # of two microbatches, a validation batch a phase, 1 test image)
    for kernel in (fwd, rows, value):
        assert kernel["launches_tp_per_rank"] == [4, 4]
        assert kernel["launches_tp_bf16_per_rank"] == [2 * 4, 2 * 4]
    assert fwd["launches_tp_train_per_rank"] == [7 * 4, 7 * 4]
    assert rows["launches_tp_train_per_rank"] == [4 * 4, 4 * 4]
    tp = result["tensor_parallel"]
    # the forward gathers the two grids and sums the gate's mean; the
    # backward sums the head's input gradients
    assert tp["collectives_per_step"] == ["all_gather", "all_gather",
                                          "all_reduce", "all_reduce"]
    assert tp["trained_eval_max_abs_err"] <= chip_smoke.TP_EVAL_ATOL
    assert 10 * tp["trained_eval_max_abs_err"] < tp[
        "trained_eval_blocks_swapped"]
    assert len(tp["head_peak_bytes_per_rank"]) == 2
    assert tp["grad_sign_flips"] >= 0 and tp["param_worst_delta_name"]
    # F1: the card's band picks against the CPU's, served and experiment
    assert fwd_q["served_model_f32_max_abs_err"][
        "cpu_band_indices_differing"] == 0
    assert result["experiment"]["band_flips_vs_cpu"]["band_indices"] > 0


def test_chip_smoke_fails_when_a_kernel_is_bypassed(fake_card, monkeypatch):
    """The launch counts are the proof that the main path ran the kernels:
    a backward that skips one must fail the run."""
    real = msda_cuda.msda_bwd_value

    def uncounted(*args):
        out = real(*args)
        msda_cuda.launches["msda_bwd_value"] -= 1
        return out

    monkeypatch.setattr(msda_cuda, "msda_bwd_value", uncounted)
    # the int8 op's forward + backward is the first phase to run it
    with pytest.raises(SystemExit, match="expected .*'msda_bwd_value': 1"):
        chip_smoke.main()


def test_experiment_sweep_fails_when_a_windowed_variant_bypasses_its_kernel(
        fake_card, monkeypatch, tmp_path):
    """The sweep's launch counts are the proof that each variant ran its
    kernels: a windowed variant sent to the matmul oracle (which refuses
    int8, so the variant here is 16p) fails the phase."""
    from egtr_tpu_torch.models.layers import init_params
    from egtr_tpu_torch.scripts import exp_trained_offsets as exp
    from egtr_tpu_torch.scripts.make_synth_vg import make_synth_vg
    from egtr_tpu_torch.train.checkpoint import save_pretrained

    data, out = str(tmp_path / "vg"), str(tmp_path / "exp")
    make_synth_vg(data, seed=0, **chip_smoke.SYNTH_EXP)
    args = exp.parse_args(["train", "--data_path", data, "--out", out,
                           *chip_smoke.EXP_ARGS])
    cfg, model, *_ = exp.build(args)
    init_params(model, torch.Generator().manual_seed(0))
    save_pretrained(f"{out}/artifact", cfg, model.state_dict())
    real = exp._load_model

    def bypass(cfg, state, device):
        if cfg.msda_window:
            cfg = cfg.replace(msda_impl="matmul")
        return real(cfg, state, device)

    monkeypatch.setattr(exp, "_load_model", bypass)
    monkeypatch.setattr(chip_smoke, "EXP_SWEEP", ["--windows", "16p"])
    with pytest.raises(SystemExit, match="experiment sweep: .*"
                       "'msda_fwd_win_pp': 0, .*expected"):
        chip_smoke.exp_sweep(data, out, exp._bucket(args)[0])


def test_ddp_phase_fails_when_a_rank_fails(fake_card, monkeypatch,
                                           tmp_path):
    """One rank that exits non-zero fails the phase and ends the other."""
    monkeypatch.setattr(chip_smoke, "DRYRUN_WORLDS", (2,))
    fake_ranks(monkeypatch, tmp_path, fail_rank=1)
    with pytest.raises(RuntimeError,
                       match=r"(?s)Root Cause.*rank +: 1 .*exitcode +: 3"):
        chip_smoke.check_dryruns()


@pytest.mark.parametrize("phase,kernel", [
    ("check_adapt_accum", "msda_bwd_win_value_pp"),
    ("check_dryruns", "msda_fwd")])
def test_ddp_phase_fails_when_a_rank_counts_no_launch(
        fake_card, monkeypatch, tmp_path, phase, kernel):
    """The ranks' launch counts are the proof that they ran the kernels."""
    fake_ranks(monkeypatch, tmp_path, uncounted=kernel)
    with pytest.raises(SystemExit, match=f"'{kernel}': 0"):
        getattr(chip_smoke, phase)()


def test_tp_phase_fails_when_a_rank_counts_no_launch(fake_card, monkeypatch,
                                                    tmp_path):
    """Phase (f): a rank whose backward skips K3 fails itself after its
    float32 step, and with it the phase."""
    fake_ranks(monkeypatch, tmp_path, uncounted="msda_bwd_value")
    with pytest.raises(RuntimeError, match=r"(?s)tp \(f\) rank \d: "
                       r"launches .*'msda_bwd_value': 0"):
        chip_smoke.check_tp()


def test_chip_smoke_fails_when_the_served_path_bypasses_a_kernel(
        fake_card, monkeypatch):
    """K1 must not run on the served path, and K6 must: a dispatch that
    sends the banded levels elsewhere fails the run."""
    real = msda_cuda.msda_fwd_win_pp

    def uncounted(*args):
        out = real(*args)
        msda_cuda.launches["msda_fwd_win_pp"] -= 1
        return out

    monkeypatch.setattr(msda_cuda, "msda_fwd_win_pp", uncounted)
    with pytest.raises(SystemExit, match="msda_fwd_win_pp launched 0"):
        chip_smoke.main()


def test_chip_smoke_fails_when_batch_p_bypasses_k11(fake_card, monkeypatch):
    """With the flag on every exact forward must launch K11: a K11 that
    does not count fails the flag-on serving phase."""
    real = msda_cuda.msda_fwd_bp

    def uncounted(*args, **kw):
        out = real(*args, **kw)
        msda_cuda.launches["msda_fwd_bp"] -= 1
        return out

    monkeypatch.setattr(msda_cuda, "msda_fwd_bp", uncounted)
    with pytest.raises(SystemExit, match="with batch_p: msda_fwd_bp launched"):
        chip_smoke.main()


def test_chip_smoke_fails_when_routed_k11_differs_from_k1(fake_card,
                                                          monkeypatch):
    """K11's bfloat16 form runs K1's kernel and must give K1's bits: an
    output one bf16 step off in one element, well inside the tolerance
    against the plain version, fails the K11 phase."""
    from egtr_tpu_torch.models.detr import level_shapes

    real = msda_cuda.msda_fwd_bp

    def one_step_off(value, *args, **kw):
        out = real(value, *args, **kw)
        if value.dtype == torch.bfloat16:
            out.view(torch.int16).view(-1)[0] += 1
        return out

    monkeypatch.setattr(msda_cuda, "msda_fwd_bp", one_step_off)
    shapes = level_shapes(infer.BUCKET_HW, 4)
    with pytest.raises(SystemExit, match="not bit-equal to msda_fwd"):
        chip_smoke.check_bp_kernel(shapes, shapes)


def test_forward_counts_at_the_serving_bucket():
    """The launch counts chip_smoke demands per forward at full depth, from
    how the dispatch splits a call: 608x1008 has three levels taller than the
    window of 16 and one below it."""
    from egtr_tpu_torch.models.detr import level_shapes

    shapes = level_shapes((608, 1008), 4)
    assert shapes == ((76, 126), (38, 63), (19, 32), (10, 16))
    zero = dict.fromkeys(msda_cuda.KERNELS, 0)
    assert chip_smoke.forward_counts(infer.bench_config(), shapes) == {
        **zero, "msda_fwd": 12}
    # with batch_p K11 takes every exact launch, float and int8
    for cfg, banded in ((infer.bench_config(), {}),
                        (infer.serving_config(), {"msda_fwd_win_pp": 18}),
                        (infer.bench_config(msda_window=16, msda_band="tile"),
                         {"msda_fwd_win": 18})):
        assert chip_smoke.forward_counts(cfg, shapes, batch_p=True) == {
            **zero, "msda_fwd_bp": 12, **banded}
    assert chip_smoke.forward_counts(infer.serving_config(), shapes) == {
        **zero, "msda_fwd_q": 12, "msda_fwd_win_pp": 18}
    assert chip_smoke.forward_counts(
        infer.bench_config(msda_window=16, msda_band="tile"), shapes) == {
            **zero, "msda_fwd": 12, "msda_fwd_win": 18}
    assert chip_smoke.forward_counts(
        infer.bench_config(msda_int8=True), shapes) == {
            **zero, "msda_fwd_q": 12}
    # a window above every level bands nothing
    assert chip_smoke.forward_counts(
        infer.bench_config(msda_window=128), shapes) == {
            **zero, "msda_fwd": 12}


def test_step_counts_at_the_adaptation_bucket():
    """The launches chip_smoke demands per training microbatch at full
    depth: 608x1008 has three levels taller than the window of 16."""
    from egtr_tpu_torch.models.detr import level_shapes

    shapes = level_shapes((608, 1008), 4)
    zero = dict.fromkeys(msda_cuda.KERNELS, 0)
    exact = {"msda_bwd_rows": 12, "msda_bwd_value": 12}
    adapt = perf_train_step.adapt_config()
    assert chip_smoke.step_counts(adapt.replace(msda_window=0), shapes,
                                  batch_p=True) == {
        **zero, **exact, "msda_fwd_bp": 12}
    assert chip_smoke.step_counts(adapt, shapes) == {
        **zero, **exact, "msda_fwd_win_pp": 18, "msda_fwd": 12,
        "msda_bwd_win_rows_pp": 18, "msda_bwd_win_value_pp": 18}
    assert chip_smoke.step_counts(adapt.replace(msda_band="tile"),
                                  shapes) == {
        **zero, **exact, "msda_fwd_win": 18, "msda_fwd": 12,
        "msda_bwd_win_rows": 18, "msda_bwd_win_value": 18}
    assert chip_smoke.step_counts(adapt.replace(msda_int8=True), shapes) == {
        **zero, **exact, "msda_fwd_win_pp": 18, "msda_fwd_q": 12,
        "msda_bwd_win_rows_pp": 18, "msda_bwd_win_value_pp": 18}
    assert chip_smoke.step_counts(adapt.replace(msda_window=0), shapes) == {
        **zero, **exact, "msda_fwd": 12}


def test_step_counts_under_remat():
    """At full depth (6+6 layers) "full" adds each layer's forward launch to
    the microbatch's (K1 24), "dots" none (K1 12); the backward's K2 and K3
    stay at 12."""
    from egtr_tpu_torch.models.detr import level_shapes

    shapes = level_shapes(perf_train_step.BUCKET_HW, 4)
    zero = dict.fromkeys(msda_cuda.KERNELS, 0)
    exact = {"msda_bwd_rows": 12, "msda_bwd_value": 12}
    cfg = perf_train_step.train_config(use_remat=True)
    assert chip_smoke.step_counts(cfg.replace(remat_policy="full"),
                                  shapes) == {**zero, **exact,
                                              "msda_fwd": 24}
    assert chip_smoke.step_counts(cfg.replace(remat_policy="dots"),
                                  shapes) == {**zero, **exact,
                                              "msda_fwd": 12}


def test_chip_smoke_refuses_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_profiles_list_every_msda_kernel():
    """The probes' profiles name every hand-written MSDA kernel whatever its
    rank among the device rows, each kernel's template forms summed."""
    rows = [("void msda_fwd_q_kernel<__nv_bfloat16, 16>(signed char const*)",
             0.1, 6.0),
            ("ampere_bf16_s16816gemm", 2.0, 40.0),
            ("void msda_fwd_q_kernel<float, 16>(signed char const*)", 0.05,
             6.0),
            ("void msda_bwd_win_rows_kernel<float, 4>(float const*)", 0.2,
             18.0)]
    assert infer.msda_rows(rows) == {
        "msda_fwd_q_kernel": {"ms": 0.1 + 0.05, "calls": 12.0},
        "msda_bwd_win_rows_kernel": {"ms": 0.2, "calls": 18.0}}


def test_kernel_of_names_each_kernel_from_its_trace_row():
    """The launch measurement reads a trace's kernel rows, as the card's
    torch.profiler names them, back to the wrappers; a banded kernel's
    last template argument tells its tile form from its point form."""
    rows = {
        "void msda_fwd_kernel<__nv_bfloat16, float, 8, true>(__nv_bfloat16 "
        "const*, float const*, Levels, int": "msda_fwd",
        "void (anonymous namespace)::lsap_warp_kernel<7>(float const*, int "
        "const*, int, int, int, long*, float*, long*)": "lsap",
        "void (anonymous namespace)::lsap_cluster_kernel<6>(float const*, "
        "int const*, int, int, int, int, int, long*, float*, long*)": "lsap",
        "void msda_bwd_value_kernel<__nv_bfloat16, 4>(float const*, VGeom)":
            "msda_bwd_value",
        "void msda_bwd_rows_kernel<float, 4>(float const*, Levels, int,":
            "msda_bwd_rows",
        "void msda_fwd_q_kernel<signed char, 16>(signed char const*)":
            "msda_fwd_q",
        "msda_fwd_bp_kernel(float const*, float const*, float const*)":
            "msda_fwd_bp",
        "void msda_fwd_win_kernel<__nv_bfloat16, 8, true, true>(__nv_bfloat16"
        " const*, int const*, Segments, Geometry, W": "msda_fwd_win_pp",
        "void msda_fwd_win_kernel<__nv_bfloat16, 8, true, false>(Segments, ":
            "msda_fwd_win",
        "void msda_bwd_win_rows_kernel<__nv_bfloat16, 8, false>(float*, ":
            "msda_bwd_win_rows",
        "void msda_bwd_win_rows_kernel<float, 4, true>(float*, ":
            "msda_bwd_win_rows_pp",
        "void msda_bwd_win_value_kernel<__nv_bfloat16, 4, true>(int const*":
            "msda_bwd_win_value_pp",
        "void msda_bwd_win_value_kernel<float, 4, false>(int const*":
            "msda_bwd_win_value",
        "void at::native::vectorized_elementwise_kernel<4, float>(int)": None,
        "ampere_bf16_s16816gemm_bf16_128x64_ldg8_f2f_stages_64x4_tn": None,
    }
    for row, name in rows.items():
        assert chip_smoke.kernel_of(row) == name, row
    names = {n for n in rows.values() if n}
    assert names == set(msda_cuda.KERNELS) | {"lsap"}
    with pytest.raises(ValueError, match="PER_POINT"):
        chip_smoke.kernel_of("msda_fwd_win_kernel(float const*)")


def test_f32_distances_of_the_train_graph_check():
    """Phase (i)'s distances between two runs: each step's loss and
    gradient norm, the median leaf's parameter change, its residual after
    the run's own AdamW updates, and its gradient at the first and at the
    last step."""
    def run(loss, norm, scale):
        change = {f"p{i}": torch.full((4,), float(i + 1)) for i in range(3)}
        change["p2"] = change["p2"] * scale
        return {"loss": loss, "grad_norm": norm, "change": change,
                "residual": {k: torch.zeros(4) for k in change},
                "grad": {k: 2 * v for k, v in change.items()},
                "grad_last": {k: 3 * v for k, v in change.items()}}

    zero = dict.fromkeys(("loss", "grad_norm", "param_change",
                          "param_residual", "grad", "grad_last"), 0.0)
    a = run([4.0, 2.0], [1.0, 1.0], 1.0)
    assert chip_smoke._f32_distances(a, a) == zero
    # one leaf of three moved twice as far: the median leaf did not
    b = run([4.0, 2.5], [1.0, 2.0], 2.0)
    assert chip_smoke._f32_distances(b, a) == {
        **zero, "loss": 0.25, "grad_norm": 1.0}
    # every leaf moved half as far again: AdamW's answer to the run's own
    # gradients (no residual), or the update's own fault (a residual)
    c = run([4.0, 2.0], [1.0, 1.0], 1.0)
    c["change"] = {k: 1.5 * v for k, v in c["change"].items()}
    c["grad_last"] = {k: 2 * v for k, v in c["grad_last"].items()}
    got = chip_smoke._f32_distances(c, a)
    assert got["param_change"] == pytest.approx(0.5)
    assert got["grad_last"] == pytest.approx(1.0)
    assert got["param_residual"] == 0.0 and got["grad"] == 0.0
    c["residual"] = {k: 0.5 * v for k, v in a["change"].items()}
    assert chip_smoke._f32_distances(c, a)["param_residual"] == (
        pytest.approx(0.5))


def test_adam_replay_is_the_optimizer_s_update():
    """``AdamReplay`` recomputes the capturable AdamW's updates from a
    run's own clipped gradients: over three steps with changing learning
    -rate scales its residuals are float32 round-off, and an update at
    another scale (the planted ``lr_scale`` fault) leaves a residual of
    the update's size."""
    from egtr_tpu_torch.train.optim import make_optimizer

    def residual_over_change(real_scales, told_scales):
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(6, 5),
                                    torch.nn.Linear(5, 3))
        optimizer = make_optimizer(model, lr=1e-3, lr_backbone=1e-4)
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        adam = chip_smoke.AdamReplay(model, optimizer)
        steps = []
        for real, told in zip(real_scales, told_scales):
            before = adam.flat()
            optimizer.zero_grad()
            model(torch.randn(4, 6)).square().sum().backward()
            optimizer.step(real)
            steps.append((before, adam.flat(grad=True), told))
        moved = {n: float((p.detach() - start[n]).abs().max())
                 for n, p in model.named_parameters()}
        return max(float(r.abs().max()) / moved[n]
                   for n, r in adam.residual(steps, adam.flat()).items())

    scales = (1.0, 0.5, 0.25)
    # round-off: a few float32 steps of parameters of about 0.4 (3e-8 each)
    # over changes of about 2e-3
    assert residual_over_change(scales, scales) < 1e-4
    assert residual_over_change((1.0, 1.0, 1.0), scales) > 0.1


def test_counts_on_the_card_come_from_the_measurement(monkeypatch):
    """Where launches are measured, ``kernel_counts`` reads the card's
    trace, not the wrappers; with ``batch_p`` the launches of K11's routes
    are K11's, and a K1 call of its own in such a run is refused."""
    class Trace:
        def __init__(self):
            self.counts = dict.fromkeys(
                msda_cuda.KERNELS + msda_cuda.MATCHER_KERNELS, 0)
            self.running = False

        def resume(self):
            self.running = True

        def pause(self):
            if self.running:
                self.running = False
                self.counts.update(msda_fwd=24, msda_bwd_rows=12, lsap=6)

    monkeypatch.setattr(chip_smoke, "_meter", None)
    monkeypatch.setattr(chip_smoke, "measured", lambda: True)
    monkeypatch.setattr(chip_smoke, "CardLaunches", Trace)
    chip_smoke.reset_kernel_counts()
    msda_cuda.launches["msda_fwd"] += 1     # a warm-up's eager launch
    counts = chip_smoke.kernel_counts()
    assert {k: v for k, v in counts.items() if v} == {
        "msda_fwd": 24, "msda_bwd_rows": 12}
    assert chip_smoke.matcher_launches() == 6
    with pytest.raises(SystemExit, match="K1/K4 called directly"):
        chip_smoke.kernel_counts(batch_p=True)
    chip_smoke.reset_kernel_counts()
    msda_cuda.launches["msda_fwd_bp"] += 1
    counts = chip_smoke.kernel_counts(batch_p=True)
    assert {k: v for k, v in counts.items() if v} == {
        "msda_fwd_bp": 24, "msda_bwd_rows": 12}
    monkeypatch.setattr(chip_smoke, "_meter", None)
    with pytest.raises(RuntimeError, match="without reset_kernel_counts"):
        chip_smoke.kernel_counts()
    msda_cuda.reset_launches()


def test_card_launches_counts_the_card_rows_of_a_trace():
    """``CardLaunches.add`` counts a finished trace's kernel rows on the
    card by wrapper, and nothing the host ran."""
    class Event:
        def __init__(self, name, device):
            self._name, self._device = name, device

        def name(self):
            return self._name

        def device_type(self):
            return getattr(torch.autograd.DeviceType, self._device)

    rows = [("void msda_fwd_kernel<float, float, 4, true>(float const*)",
             "CUDA")] * 3 + [
        ("void (anonymous namespace)::lsap_warp_kernel<7>(float const*)",
         "CUDA"),
        ("void msda_bwd_win_rows_kernel<float, 4, true>(float*)", "CUDA"),
        ("cudaGraphLaunch", "CPU"),
        ("msda_fwd_kernel", "CPU")]

    class Trace:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return [Event(*r) for r in rows]

    meter = chip_smoke.CardLaunches()
    meter.add(Trace)
    assert {k: v for k, v in meter.counts.items() if v} == {
        "msda_fwd": 3, "lsap": 1, "msda_bwd_win_rows_pp": 1}


def test_reserved_by_pool_splits_the_snapshot(monkeypatch):
    """The driver's memory by pool: the snapshot's segments summed by
    ``segment_pool_id``, the programs' shared pool apart from the default
    pool and any other graph pool, this card's only; the peak's event is
    the first that reached the run's peak."""
    from egtr_tpu_torch.utils import aot

    segments = [
        {"device": 0, "segment_pool_id": (0, 0), "total_size": 2 * 10**9},
        {"device": 0, "segment_pool_id": (1, 7), "total_size": 5 * 10**9},
        {"device": 0, "segment_pool_id": (1, 7), "total_size": 10**9},
        {"device": 0, "segment_pool_id": (2, 3), "total_size": 10**8},
        {"device": 1, "segment_pool_id": (0, 0), "total_size": 10**10},
    ]
    monkeypatch.setattr(torch.cuda, "memory_snapshot", lambda: segments)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(aot, "_pools",
                        {torch.device("cuda", 0): (1, 7)})
    assert chip_smoke.reserved_by_pool() == pytest.approx(
        {"default": 2.0, "programs": 6.0, "other": 0.1})
    events = [{"tag": "a", "peak_reserved": 8.0},
              {"tag": "b", "peak_reserved": 9.5},
              {"tag": "c", "peak_reserved": 9.5}]
    assert chip_smoke.memory_peak_split(events, 9.5)["tag"] == "b"
    assert chip_smoke.memory_peak_split(events, 10.0) is None
