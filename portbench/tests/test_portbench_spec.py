"""BENCHMARK.json against the shape the benchmark requires, and the harness
finding every cell, configuration, traffic mix and metric by name, a new
one by files alone."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return harness.benchmark_json()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w
               for w in bench["command"])
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_units_and_text(bench):
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names)), group
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])


def test_metrics_and_bounds(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert "bound" not in m
        if m["name"].split(".")[0].endswith("roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_finds_its_files(bench):
    used = set()
    for w in bench["workloads"]:
        spec = harness.load_spec(w["name"], bench)
        used.add(w["config"])
        assert spec.config["name"] == w["config"]
        assert os.path.exists(os.path.join(harness.REPO, next(
            c["file"] for c in bench["configs"] if c["name"] == w["config"])))
        harness.load_module("modes", spec.traffic["mode"])
        assert "setup_s" in spec.end_to_end and len(spec.end_to_end) >= 2
        assert spec.per_layer
        for name in spec.per_layer:
            assert callable(harness.load_module("metrics", name).read)
    assert used == {c["name"] for c in bench["configs"]}


def test_config_files_hold_their_cuts(bench):
    for c in bench["configs"]:
        with open(os.path.join(harness.REPO, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"]
        assert set(c["reduced"]) <= set(cfg["published_values"])
        for key in c["reduced"]:
            assert cfg[key] != cfg["published_values"][key]


def test_run_seconds_fit_the_full_check(bench):
    rs = bench["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_a_new_cell_is_files_only(bench, tmp_path, monkeypatch):
    """A cell, a traffic mix and a metric added as new files and entries,
    with no file of the harness edited."""
    root = tmp_path / "portbench"
    shutil.copytree(harness.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    monkeypatch.setattr(harness, "ROOT", str(root))
    with open(root / "workloads" / "closed-b1.json") as f:
        traffic = json.load(f)
    traffic["pool"] = 3
    with open(root / "workloads" / "closed-b1-pool3.json", "w") as f:
        json.dump(traffic, f)
    (root / "metrics" / "requests_seen.request.py").write_text(
        "def read(ctx):\n    return ctx.info['slice_images']\n")
    extended = json.loads(json.dumps(bench))
    extended["workloads"].append({
        "name": "oi-serve-b1-pool3", "config": "egtr-oi-r50",
        "traffic": "closed-b1-pool3", "chips": 1, "why": "a test cell"})
    for m in extended["end_to_end"]:
        if m["name"] in ("request_ms", "request_ms_p95"):
            m["workloads"].append("oi-serve-b1-pool3")
    extended["per_layer"].append({
        "name": "requests_seen.request", "unit": "images", "better": "higher",
        "source": "program_counter", "layer": "entry: serving",
        "moves": "request_ms", "workloads": ["oi-serve-b1-pool3"]})
    spec = harness.load_spec("oi-serve-b1-pool3", extended)
    assert spec.traffic["pool"] == 3
    assert spec.config["model"]["num_labels"] == 601
    assert spec.end_to_end == ["request_ms", "request_ms_p95", "setup_s"]
    assert spec.per_layer == ["requests_seen.request"]
    reader = harness.load_module("metrics", "requests_seen.request").read
    assert reader(harness.MetricContext(spec, None, None,
                                        {"slice_images": 7})) == 7
