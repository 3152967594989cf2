"""The readers of the program's own scopes and spans (``program_trace.py``)
on synthetic slices: replays read by their layer maps, a damaged replay
left out and made up by the launches' scale, the card's idle time inside
the program's spans, the nodes a slice image replays, the set-up seconds;
every new metric None on a slice without replays or programs."""

from __future__ import annotations

import io
import json
import os

import pytest

from portbench import harness, program_trace, tracing
from portbench.tests.test_portbench_trace import EVENTS


def ev(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


MAP = [["kernel", "backbone"], ["memset", "backbone"], ["kernel", "encoder"],
       ["kernel", "other"]]
PROGRAMS = [{"tag": "infer", "nodes": MAP, "warmup_s": 2.0,
             "capture_s": 0.5},
            {"tag": "train_apply", "nodes": MAP[:2], "warmup_s": 0.0,
             "capture_s": 0.25}]

# two replays of "infer": correlation 11 whole, 12 without its memset; the
# harness's spans with the program's inside
SLICE = [
    ev(tracing.SLICE, "user_annotation", 0.0, 400.0),
    ev("replay", "user_annotation", 0.0, 100.0),
    ev("egtr.dispatch/infer", "user_annotation", 5.0, 10.0),
    ev("egtr.copy_in/infer", "user_annotation", 15.0, 5.0),
    ev("egtr.launch/infer", "user_annotation", 20.0, 10.0),
    ev("egtr.copy_out/infer", "user_annotation", 30.0, 60.0),
    ev("replay", "user_annotation", 200.0, 100.0),
    ev("egtr.launch/infer", "user_annotation", 220.0, 10.0),
    ev("sm90_xmma_fprop_implicit_gemm", "kernel", 25.0, 30.0, 11),
    ev("Memset (Device)", "gpu_memset", 55.0, 2.0, 11),
    ev("msda_fwd_kernel", "kernel", 57.0, 20.0, 11),
    ev("elementwise_kernel", "kernel", 77.0, 3.0, 11),
    ev("sm90_xmma_fprop_implicit_gemm", "kernel", 225.0, 30.0, 12),
    ev("msda_fwd_kernel", "kernel", 255.0, 20.0, 12),
    ev("elementwise_kernel", "kernel", 275.0, 3.0, 12),
]


def context(events, images=2, programs=PROGRAMS, monkeypatch=None):
    if monkeypatch is not None:
        monkeypatch.setattr(program_trace, "live_programs",
                            lambda: programs)
    return harness.MetricContext(spec=None, trace=tracing.Trace(events),
                                 stats=harness.WindowStats(),
                                 info={"slice_images": images})


def test_replays_are_read_by_their_maps_and_scaled_to_the_launches():
    found = program_trace.read_replays(tracing.Trace(SLICE), PROGRAMS)
    assert found.launched == {"infer": 2} and found.attributed == {"infer": 1}
    assert found.share_attributed() == 0.5
    # the whole replay's time, twice: launched 2 over attributed 1
    assert found.scope_us("backbone") == pytest.approx(64.0)
    assert found.scope_us("encoder") == pytest.approx(40.0)
    assert found.scope_us("other") == pytest.approx(6.0)
    assert found.scope_us("decoder") is None
    assert found.scaled_us()[("backbone", "conv")] == pytest.approx(60.0)
    out = io.StringIO()
    program_trace.print_table(found, 2, {"egtr.copy_out/infer": 10.0}, out)
    assert "replays attributed: 1 of 2 (50.0%)" in out.getvalue()
    assert "idle in egtr.copy_out/infer" in out.getvalue()


def test_layer_metrics_per_image(monkeypatch):
    ctx = context(SLICE, monkeypatch=monkeypatch)
    read = program_trace.layer_reader
    assert read("backbone")(ctx) == pytest.approx(0.032)
    assert read("encoder")(ctx) == pytest.approx(0.020)
    assert read("postprocess")(ctx) is None
    # the layers and "other" make up the attributed replays' time, scaled
    total = sum(read(s)(ctx) for s in ("backbone", "encoder", "other"))
    assert total == pytest.approx(2 * 55.0 / 1e3 / 2)


def test_idle_inside_the_program_s_spans(monkeypatch):
    ctx = context(SLICE, monkeypatch=monkeypatch)
    idle = program_trace.call_idle(ctx.trace)
    # gaps: 0-25 (dispatch 5-15, copy_in 15-20, launch 20-25), 80-225
    # (copy_out 80-90, launch 220-225), 278-400 (in no program span)
    assert idle == pytest.approx({"egtr.dispatch/infer": 10.0,
                                  "egtr.copy_in/infer": 5.0,
                                  "egtr.launch/infer": 10.0,
                                  "egtr.copy_out/infer": 10.0})
    assert program_trace.call_idle_share(ctx) == pytest.approx(35 / 4)


def test_an_inner_span_takes_the_idle_time_first():
    events = [ev(tracing.SLICE, "user_annotation", 0.0, 100.0),
              ev("egtr.outer/t", "user_annotation", 0.0, 80.0),
              ev("egtr.inner/t", "user_annotation", 10.0, 20.0),
              ev("k", "kernel", 90.0, 10.0)]
    idle = program_trace.call_idle(tracing.Trace(events))
    assert idle == pytest.approx({"egtr.outer/t": 60.0, "egtr.inner/t": 20.0})


def test_nodes_per_image_and_setup_seconds(monkeypatch):
    ctx = context(SLICE, monkeypatch=monkeypatch)
    assert program_trace.graph_nodes_per_image(ctx) == pytest.approx(4.0)
    assert program_trace.setup_seconds("warmup_s") == pytest.approx(2.0)
    assert program_trace.setup_seconds("capture_s") == pytest.approx(0.75)


def test_a_memset_run_as_a_kernel_is_its_node():
    events = [e for e in SLICE if e.get("args", {}).get("correlation") != 12]
    events.append(ev("egtr.launch/infer", "user_annotation", 300.0, 5.0))
    events += [ev("sm90_xmma_fprop_implicit_gemm", "kernel", 310.0, 30.0, 13),
               ev("memset32", "kernel", 340.0, 2.0, 13),
               ev("msda_fwd_kernel", "kernel", 342.0, 20.0, 13),
               ev("elementwise_kernel", "kernel", 362.0, 3.0, 13)]
    found = program_trace.read_replays(tracing.Trace(events), PROGRAMS)
    assert found.launched == {"infer": 3} and found.attributed == {"infer": 2}
    # a gpu_memset where the map has a kernel does not match
    events[-4] = ev("Memset (Device)", "gpu_memset", 310.0, 30.0, 13)
    found = program_trace.read_replays(tracing.Trace(events), PROGRAMS)
    assert found.attributed == {"infer": 1}


def test_maps_of_two_tags_that_both_match_read_nothing():
    twin = [dict(PROGRAMS[0], tag="twin")]
    events = SLICE + [ev("egtr.launch/twin", "user_annotation", 300.0, 5.0)]
    assert program_trace.read_replays(tracing.Trace(events),
                                      PROGRAMS + twin) is None


def new_metrics():
    path = os.path.join(harness.REPO, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    return [m["name"] for m in bench["per_layer"]
            if m["source"] in ("program_span", "program_counter")]


@pytest.mark.parametrize("programs", [None, []], ids=["no_contract", "none"])
def test_every_new_metric_is_none_without_replays(monkeypatch, programs):
    """On a slice of an older program (no spans, no ``programs()``) or of
    no program, each reader returns None and raises nothing."""
    names = new_metrics()
    assert len(names) == 32
    for events in (EVENTS, SLICE):
        ctx = context(events, programs=programs, monkeypatch=monkeypatch)
        for name in names:
            read = harness.load_module("metrics", name).read
            if events is SLICE and name.startswith("call_idle_share"):
                continue        # the spans alone, no program needed
            assert read(ctx) is None, name
