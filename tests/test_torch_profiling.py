"""The port's profiling utilities (``egtr_tpu_torch/utils/profiling.py``):
``summarize_trace`` of a CPU torch.profiler trace and of a hand-written
trace of the card's events, a trace of the card without a device event
refused; the layer scopes (a capture's layer map with a stand-in for the
CUDA graph under capture, the spans only while a profiler runs, every
scope of an eager forward and training step of the tiny model), replays
read by their layer map on a hand-written trace, ``programs()``; and on
the card (skipped without one) the served request's replay against its
eager forward, layer by layer. Without JAX, so that the card's test runs on
a machine without it (the CPU tests read host-only traces, which a card
machine's profiler marks as the card's, so run the card's alone there):

    python -m pytest --noconftest tests/test_torch_profiling.py -q -k served
"""

import gc
import json

import pytest
import torch
from torch.profiler import record_function

from egtr_tpu_torch.utils import profiling

SCOPES = ("backbone", "input_proj", "encoder", "decoder", "relation_head",
          "postprocess", "criterion", "backward", "optimizer")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def test_summarize_cpu_trace(tmp_path):
    """On the CPU the device's work is the outermost ops of each thread;
    ``record_function`` scopes give ``by_module``, layer numbers folded."""
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    with profiling.device_trace(str(tmp_path)):
        for i in range(2):
            with record_function(f"encoder_layer_{i}/self_attn"):
                x = (a @ b).softmax(-1)
        x = x + 1
    events = profiling.load_trace_events(str(tmp_path))
    assert events and all(e["ph"] == "X" for e in events)
    summary = profiling.summarize_trace(str(tmp_path), iterations=2)
    assert summary["total_ms"] > 0
    assert sum(summary["by_op"].values()) == pytest.approx(
        summary["total_ms"])
    assert {"gemm", "softmax", "elementwise"} <= set(summary["by_op"])
    assert set(summary["by_module"]) == {"encoder_layer_N/self_attn",
                                         profiling.OTHER}
    assert sum(summary["by_module"].values()) == pytest.approx(
        summary["total_ms"])
    assert summary["replays"] == {"launched": 0, "attributed": 0}


def test_summarize_card_trace(tmp_path):
    """Kernels, copies and fills count, on the card's stream, under the
    innermost ``gpu_user_annotation`` around their start; host ops and
    launches do not."""
    def ev(cat, name, ts, dur, tid=7):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "pid": 0, "tid": tid}

    trace = {"traceEvents": [
        ev("cpu_op", "aten::mm", 0, 500, tid=1),
        ev("cuda_runtime", "cudaLaunchKernel", 10, 5, tid=1),
        ev("gpu_user_annotation", "decoder_layer_1", 90, 400),
        ev("gpu_user_annotation", "decoder_layer_1/cross_attn", 95, 200),
        ev("kernel", "void msda_fwd_kernel<float>(...)", 100, 30),
        ev("kernel", "ampere_sgemm_128x64_tn", 300, 50),
        ev("kernel", "sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwc",
           400, 60),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 600, 20),
        ev("gpu_memset", "Memset (Device)", 700, 4),
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 5, "pid": 0,
         "tid": 7},
    ]}
    with open(tmp_path / "1.trace.json", "w") as f:
        json.dump(trace, f)
    summary = profiling.summarize_trace(str(tmp_path), maps=[])
    assert summary["total_ms"] == pytest.approx(0.164)
    # cuDNN's Hopper convolution names hold "gemm" too
    assert summary["by_op"] == pytest.approx({
        "msda_fwd_kernel": 0.03, "gemm": 0.05, "conv": 0.06, "copy": 0.02,
        "fill": 0.004})
    assert summary["by_module"] == pytest.approx({
        "decoder_layer_N/cross_attn": 0.03, "decoder_layer_N": 0.11,
        profiling.OTHER: 0.024})


@pytest.mark.parametrize("card_sign", ["deviceProperties", "cuda_runtime"])
def test_summarize_refuses_a_card_trace_without_device_events(tmp_path,
                                                              card_sign):
    """A card's trace whose device events are missing (CUPTI recorded
    nothing, or only the CPU was traced around the card's work) is not
    summed from its host ops."""
    events = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
               "dur": 500, "pid": 0, "tid": 1}]
    trace = {"traceEvents": events}
    if card_sign == "deviceProperties":
        trace["deviceProperties"] = [{"id": 0, "name": "NVIDIA H100"}]
    else:
        events.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "ts": 10, "dur": 5,
                       "pid": 0, "tid": 1})
    with open(tmp_path / "1.trace.json", "w") as f:
        json.dump(trace, f)
    assert profiling.trace_device(trace) == "cuda"
    with pytest.raises(RuntimeError, match="no kernel, copy or fill"):
        profiling.summarize_trace(str(tmp_path))


def test_load_trace_events_without_a_trace(tmp_path):
    with pytest.raises(FileNotFoundError):
        profiling.load_trace_events(str(tmp_path))


class StubGraph:
    """A stand-in for the CUDA graph under capture: nodes added in
    order, each of a work kind or None (an event or empty node)."""

    def __init__(self):
        self.kinds = []

    def add(self, *kinds):
        self.kinds.extend(kinds)

    def nodes(self):
        return list(range(len(self.kinds)))

    def kind(self, node):
        return self.kinds[node]

    def order(self):
        return self.nodes()


def test_a_capture_maps_each_node_to_its_innermost_scope():
    g = StubGraph()
    with profiling.capture_layers(g) as box:
        g.add("memset")
        with profiling.scope("backbone"):
            g.add("kernel")
            with profiling.scope("inner"):
                g.add("kernel", None)
            g.add("memcpy")
        with profiling.scope("encoder"):
            pass
        g.add("kernel")
    assert box["nodes"] == [["memset", "other"], ["kernel", "backbone"],
                            ["kernel", "backbone/inner"],
                            ["memcpy", "backbone"], ["kernel", "other"]]
    # outside a capture a scope maps nothing
    assert profiling.scope("backbone") is profiling.span("backbone")


def test_a_capture_is_ordered_by_its_edges():
    nodes = ["c", "a", "b", "d"]
    edges = [("a", "b"), ("b", "c"), ("c", "d")]
    assert profiling.topological_order(nodes, edges) == ["a", "b", "c", "d"]
    # no edges: the order the nodes were listed in
    assert profiling.topological_order(nodes, []) == nodes


def test_spans_and_scopes_open_ranges_only_under_a_profiler():
    assert profiling.span("egtr.launch/t") is profiling.span("x")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("egtr.launch/t"):
            torch.ones(2).add_(1)
        with profiling.scope("encoder"):
            torch.ones(2).mul_(2)
    names = {e.name for e in prof.events()}
    assert {"egtr.launch/t", "encoder"} <= names


def test_programs_lists_the_live_programs():
    class Fake:
        tag, warmup_s, capture_s = "t", 1.5, 0.25
        layer_map = [["kernel", "encoder"]]

    p = Fake()
    profiling.track(p)
    found = [x for x in profiling.programs() if x["tag"] == "t"]
    assert found == [{"tag": "t", "nodes": [["kernel", "encoder"]],
                      "warmup_s": 1.5, "capture_s": 0.25}]
    del p
    gc.collect()
    assert not [x for x in profiling.programs() if x["tag"] == "t"]


def replay_trace():
    """Three replays of a three-node program (correlation 11 whole, 12 with
    its memset dropped, 15 with its memset run as a kernel), an eager
    kernel under a layer scope and a copy under a call-path span."""
    def ev(cat, name, ts, dur, corr=None, tid=7):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
             "pid": 0, "tid": tid}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    return {"traceEvents": [
        ev("user_annotation", "egtr.launch/infer", 90, 10, tid=1),
        ev("cuda_runtime", "cudaGraphLaunch", 92, 5, corr=11, tid=1),
        ev("user_annotation", "egtr.launch/infer", 190, 10, tid=1),
        ev("cuda_runtime", "cudaGraphLaunch", 192, 5, corr=12, tid=1),
        ev("cuda_runtime", "cudaLaunchKernel", 290, 5, corr=13, tid=1),
        ev("kernel", "sm90_xmma_fprop_implicit_gemm", 100, 30, corr=11),
        ev("gpu_memset", "Memset (Device)", 130, 2, corr=11),
        ev("kernel", "msda_fwd_kernel", 140, 20, corr=11),
        ev("kernel", "sm90_xmma_fprop_implicit_gemm", 200, 30, corr=12),
        ev("kernel", "msda_fwd_kernel", 240, 20, corr=12),
        ev("gpu_user_annotation", "decoder", 295, 20),
        ev("kernel", "elementwise_kernel", 300, 10, corr=13),
        ev("gpu_user_annotation", "egtr.copy_in/infer", 320, 10),
        ev("gpu_memcpy", "Memcpy DtoD", 320, 4, corr=14),
        ev("cuda_runtime", "cudaGraphLaunch", 392, 5, corr=15, tid=1),
        ev("kernel", "sm90_xmma_fprop_implicit_gemm", 400, 30, corr=15),
        ev("kernel", "memset32", 430, 2, corr=15),
        ev("kernel", "msda_fwd_kernel", 440, 20, corr=15),
    ]}


MAP = [["kernel", "backbone"], ["memset", "backbone"], ["kernel", "encoder"]]


def test_replays_are_read_by_their_layer_map(tmp_path):
    with open(tmp_path / "1.trace.json", "w") as f:
        json.dump(replay_trace(), f)
    summary = profiling.summarize_trace(str(tmp_path), maps=[MAP])
    assert summary["replays"] == {"launched": 3, "attributed": 2}
    # the damaged replay's events count in the total, under no layer
    assert summary["total_ms"] == pytest.approx(0.168)
    assert summary["by_module"] == pytest.approx({
        "backbone": 0.064, "encoder": 0.04, "decoder": 0.01,
        profiling.OTHER: 0.004})
    assert summary["by_op"]["conv"] == pytest.approx(0.09)
    # maps that disagree on a matching replay's scopes read nothing
    other = [list(n) for n in MAP]
    other[0][1] = "input_proj"
    summary = profiling.summarize_trace(str(tmp_path), maps=[MAP, other])
    assert summary["replays"] == {"launched": 3, "attributed": 0}


def tiny_step_and_request():
    """The tiny model's training step (accumulate 2) and request, both
    eager on the CPU, with their inputs."""
    from egtr_tpu_torch import infer
    from egtr_tpu_torch.scripts import perf_train_step as pts
    from egtr_tpu_torch.train.train_step import make_train_step

    cfg = pts.train_config(**pts.TINY, compute_dtype="float32")
    model, optimizer, generator = pts.build(cfg, "cpu")
    batch = pts.synthetic_batch(cfg, 2, 64, 96, "cpu")
    step = make_train_step(model, cfg, optimizer, accum_steps=2)
    mbs = [{k: v[a::2] if torch.is_tensor(v) else
            {kk: vv[a::2] for kk, vv in v.items()}
            for k, v in batch.items()} for a in range(2)]

    x, mask = batch["pixel_values"][:1], batch["pixel_mask"][:1]

    def run():
        step(mbs, generator)
        model.eval()
        infer.infer_eager(model, x, mask)
    return run


def test_every_scope_covers_its_work_in_an_eager_step_and_request(tmp_path):
    torch.manual_seed(0)
    run = tiny_step_and_request()
    # the host's trace alone, also where a card is there
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    prof.export_chrome_trace(str(tmp_path / "cpu.trace.json"))
    summary = profiling.summarize_trace(str(tmp_path))
    layers = summary["by_module"]
    assert set(layers) == set(SCOPES), layers
    assert all(ms > 0 for ms in layers.values())
    assert sum(layers.values()) == pytest.approx(summary["total_ms"])


def test_the_served_replay_reads_as_its_eager_forward_by_layer(cuda,
                                                               tmp_path):
    """The request's program at 608x1008 against the same forward eager:
    each layer above 5% of the eager time within 10%, and a replay's events
    are its map's work nodes, one for one. Of three replays one whole one
    is enough: CUPTI may drop a row of a replay (seen after other profiler
    sessions in the process), which leaves that replay unread."""
    from egtr_tpu_torch import infer
    from egtr_tpu_torch.ops import msda_cuda

    msda_cuda.build()
    model, x = infer.build(infer.bench_config(), 1, *infer.BUCKET_HW,
                           device=cuda)
    for _ in range(2):
        infer.infer(model, x)
    (program,) = infer._PROGRAMS[model].programs.values()
    assert program.layer_map and {s for _, s in program.layer_map} == {
        "backbone", "input_proj", "encoder", "decoder", "relation_head",
        "postprocess"}
    infer.infer_eager(model, x)
    torch.cuda.synchronize()
    with profiling.device_trace(str(tmp_path / "eager")):
        infer.infer_eager(model, x)
    with profiling.device_trace(str(tmp_path / "replay")):
        for _ in range(3):
            infer.infer(model, x)
    eager = profiling.summarize_trace(str(tmp_path / "eager"))
    events = [e for e in profiling.load_trace_events(str(tmp_path / "replay"))
              if e.get("cat") in profiling.DEVICE_CATEGORIES]
    runs = {}
    for e in events:
        runs.setdefault(e.get("args", {}).get("correlation"), []).append(e)
    assert len(program.layer_map) in {len(v) for v in runs.values()}
    read = profiling.summarize_trace(str(tmp_path / "replay"),
                                     maps=[program.layer_map])["replays"]
    assert read["launched"] == 3 and read["attributed"] >= 1, read
    replay = profiling.summarize_trace(str(tmp_path / "replay"),
                                       iterations=read["attributed"],
                                       maps=[program.layer_map])
    total = sum(eager["by_module"].values())
    for name, ms in eager["by_module"].items():
        if name != profiling.OTHER and ms > 0.05 * total:
            assert replay["by_module"][name] == pytest.approx(ms, rel=0.1), (
                name, eager["by_module"], replay["by_module"])
