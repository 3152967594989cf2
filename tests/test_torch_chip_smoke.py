"""chip_smoke.py's control flow, rehearsed on the CPU at a tiny size.

The script needs a CUDA card, so here the card is faked: each CUDA kernel is
replaced by a counting call of its plain version, CUDA events by host
clocks, the 608x1008 and 800x1344 buckets and the bench and train models by
a 272x96 image (levels of 34, 17, 9 and 5 rows, so that a window of 16 bands
two levels and leaves two exact, as at 608x1008), the adaptation's bucket by
a 144x96 image (levels of 18, 9, 5 and 3 rows: one banded; no level one
pixel wide, where PyTorch's bfloat16 convolution on the CPU reads memory it
did not write) and 2+2-layer models. What this checks is the script itself:
its phases run in order, the launch counts it demands match what the model
and the train step make, and it ends with the result line. The kernels' own
checks run only on the card.
"""

import json
import time
from pathlib import Path

import pytest
import torch

import chip_smoke
from egtr_tpu_torch import config as config_mod
from egtr_tpu_torch import infer
from egtr_tpu_torch.data import loader as loader_mod
from egtr_tpu_torch.data import transforms as transforms_mod
from egtr_tpu_torch.data import visual_genome as vg_mod
from egtr_tpu_torch.ops import msda, msda_cuda
from egtr_tpu_torch.scripts import perf_train_step

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

TINY = dict(d_model=64, encoder_layers=2, decoder_layers=2,
            encoder_ffn_dim=128, decoder_ffn_dim=128, num_queries=12,
            num_labels=7, num_rel_labels=5)
DRIVER_TINY = dict(d_model=64, encoder_layers=2, decoder_layers=2,
                   encoder_ffn_dim=128, decoder_ffn_dim=128)


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

    bench_config = infer.bench_config
    train_config = perf_train_step.train_config
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", HostEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "host")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(msda_cuda, "msda_fwd", kernel)
    monkeypatch.setattr(msda_cuda, "msda_bwd_rows", bwd_rows)
    monkeypatch.setattr(msda_cuda, "msda_bwd_value", bwd_value)
    monkeypatch.setattr(msda_cuda, "msda_fwd_q", fwd_q)
    monkeypatch.setattr(msda_cuda, "msda_fwd_win",
                        fwd_win("msda_fwd_win", False))
    monkeypatch.setattr(msda_cuda, "msda_fwd_win_pp",
                        fwd_win("msda_fwd_win_pp", True))
    monkeypatch.setattr(msda_cuda, "msda_fwd_bp", fwd_bp)
    for name, per_point in (("msda_bwd_win_rows", False),
                            ("msda_bwd_win_rows_pp", True),
                            ("msda_bwd_win_value", False),
                            ("msda_bwd_win_value_pp", True)):
        part = "value" if "value" in name else "rows"
        monkeypatch.setattr(msda_cuda, name, bwd_win(name, per_point, part))
    # the dispatch takes the (faked) kernels for these CPU tensors, as it
    # does for CUDA tensors on the card
    monkeypatch.setattr(msda, "_takes_kernels",
                        lambda impl, value: impl in ("auto", "pallas"))
    monkeypatch.setattr(msda_cuda, "build", lambda: {
        name: tmp_path / f"lib{name}.so" for name in msda_cuda.sources()})
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "Host, 0.00 W")
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "SIDE_BY_SIDE_ROUNDS", 2)
    # one call each; a positive time, as a card's, for the rates
    monkeypatch.setattr(chip_smoke, "cuda_ms",
                        lambda fn, iters, warmup=0: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "graph_ms", lambda fn, *a: (fn(), 1.0)[1])
    monkeypatch.setattr(infer, "BUCKET_HW", (272, 96))
    monkeypatch.setattr(infer, "bench_config",
                        lambda **kw: bench_config(**{**TINY, **kw}))
    monkeypatch.setattr(infer, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    monkeypatch.setattr(perf_train_step, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    monkeypatch.setattr(perf_train_step, "BUCKET_HW", (64, 96))
    monkeypatch.setattr(
        perf_train_step, "train_config",
        lambda **kw: train_config(**{**perf_train_step.TINY, **kw}))
    adapt_config = perf_train_step.adapt_config
    monkeypatch.setattr(
        perf_train_step, "adapt_config",
        lambda **kw: adapt_config(**{**perf_train_step.TINY, **kw}))
    monkeypatch.setattr(perf_train_step, "ADAPT_HW", (144, 96))
    monkeypatch.setattr(perf_train_step, "ADAPT_BATCH", 1)
    monkeypatch.setattr(chip_smoke, "ADAPT_STEPS", 1)
    # the driver: 2+1+1 synthetic images of 144x96 that no resize changes
    # (the DETR scales and the test size set to their short side), one
    # bucket, a 2+2-layer model of the driver's bf16, 12 queries; batch 1
    # x accum 2: one optimizer step per phase
    real_cfg, real_ds = config_mod.EgtrConfig, vg_mod.VGDataset

    class SmallVG(real_ds):
        def __init__(self, *a, size=800, max_size=1333, **kw):
            super().__init__(*a, size=96, max_size=144, **kw)

    class TinyConfig(real_cfg):
        def __init__(self, **kw):
            super().__init__(**{**kw, **DRIVER_TINY})

    monkeypatch.setattr(config_mod, "EgtrConfig", TinyConfig)
    monkeypatch.setattr(vg_mod, "VGDataset", SmallVG)
    monkeypatch.setattr(transforms_mod, "DETR_TRAIN_SCALES", (96,))
    # the pretraining driver's crops may turn an image on its side
    monkeypatch.setattr(loader_mod, "default_buckets",
                        lambda max_size=1333: ((144, 96), (96, 144),
                                               (144, 144)))
    monkeypatch.setattr(chip_smoke, "SYNTH_VG", dict(
        n_train=2, n_val=1, n_test=1, height=144, width=96))
    args = list(chip_smoke.DRIVER_ARGS)
    for flag, value in (("--batch_size", "1"), ("--num_workers", "1")):
        args[args.index(flag) + 1] = value
    monkeypatch.setattr(chip_smoke, "DRIVER_ARGS", args + [
        "--num_queries", "12", "--max_gt_boxes", "8", "--max_gt_rels", "16"])
    # the pretraining driver: batch 1 x accum 2, one step per phase
    args = list(chip_smoke.PRETRAIN_ARGS)
    for flag, value in (("--batch_size", "1"), ("--num_workers", "1")):
        args[args.index(flag) + 1] = value
    monkeypatch.setattr(chip_smoke, "PRETRAIN_ARGS", args + [
        "--num_queries", "12", "--max_gt_boxes", "8"])
    # the float32 phase turns TF32 off; restore both flags afterwards
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                        torch.backends.cudnn.allow_tf32)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        torch.backends.cuda.matmul.allow_tf32)


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
        "msda_fwd_bp"]
    required = {"name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"}
    for k in kernels:
        assert required <= set(k), k["name"]
        assert k["route"] == "cuda" and k["library_ms"] is None
        assert k["bound_by"] in ("bytes", "operations") and k["bound_ms"] > 0
        assert isinstance(k["max_abs_err"], float)
        path, line = k["replaces"].split(":")
        assert path == "egtr_tpu/ops/msda_pallas.py" and int(line) > 0
        assert (REPO / k["source"]).exists()
        assert k["launches"] > 0
    fwd, rows, value, fwd_q, win, win_pp, *bwd_win, bp = kernels
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
                  "detector leaves loaded"):
        assert phase in out, phase


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
