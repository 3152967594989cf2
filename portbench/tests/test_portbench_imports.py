"""What the benchmark loads: no JAX and not the JAX package (top-level
names compared whole, since the port's name begins with the JAX package's),
and a reference that loads nothing of the port; and the refusals of a run
without a card, or without the program beside the benchmark."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from portbench import harness

REPO = harness.REPO
PROBE = """
import json, sys
{imports}
tops = sorted({{m.split('.')[0] for m in sys.modules}})
print(json.dumps(tops))
"""


def loaded(imports: str):
    env = dict(os.environ)
    out = subprocess.run([sys.executable, "-c", PROBE.format(imports=imports)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    tops = loaded("import portbench.run, portbench.harness, portbench.readings\n"
                  "from portbench import harness\n"
                  "for mode in ('request', 'offline', 'train'):\n"
                  "    harness.load_module('modes', mode)\n"
                  "import os\n"
                  "for f in os.listdir(os.path.join(harness.ROOT, 'metrics')):\n"
                  "    harness.load_module('metrics', f[:-3])\n"
                  "import egtr_tpu_torch.infer, egtr_tpu_torch.train.train_step")
    assert "egtr_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN), tops & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    tops = loaded("import portbench.reference.model, portbench.reference.train")
    assert "egtr_tpu_torch" not in tops
    assert not tops & set(harness.FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "egtr_tpu_torch_x", sys)
    assert "egtr_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib.fake" in harness.forbidden_modules()


def _run(cwd):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "vg-serve-b1",
         "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    out = _run(REPO)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
