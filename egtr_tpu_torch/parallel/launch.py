"""Run a function in several ranks under torchrun, with a timeout.

    spawn("package.module:function", 2, kwargs={...}, device="cpu",
          workdir=DIR, timeout=240)

runs ``python -m torch.distributed.run --standalone --nproc_per_node 2 -m
egtr_tpu_torch.parallel.launch DIR/spec.json``: torchrun starts the ranks,
each of which joins the group through ``dist.init_from_env``, calls
``function(device=<its device>, **kwargs)``, writes the JSON of the return
value to ``DIR/result{rank}.json``, waits for the others and leaves the
group. ``spawn`` returns the ranks' values in rank order. torchrun stops
every rank when one fails; a run past the timeout is stopped the same way.
Either raises RuntimeError with the tail of the ranks' output
(``DIR/torchrun.log``, torchrun's summary of the failure last); torchrun's
own files go under ``DIR/torchrun``.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
from typing import Any, Dict, List, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# how long torchrun may take to stop its ranks after the timeout
STOP_S = 60


def _tail(path: str, n: int = 6000) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def spawn(target: str, nprocs: int, *, workdir: str,
          kwargs: Optional[Dict[str, Any]] = None, device=None,
          timeout: float = 240.0, threads: Optional[int] = None,
          path: Sequence[str] = ()) -> List[Any]:
    """Run ``target(device=..., **kwargs)`` in ``nprocs`` ranks of one
    process group; returns each rank's return value (JSON), in rank order.

    ``device``: as ``dist.init_from_env`` takes it (None: the card).
    ``threads``: ``torch.set_num_threads`` in each rank. ``path``:
    directories put before the repo on the ranks' PYTHONPATH."""
    os.makedirs(workdir, exist_ok=True)
    spec_path = os.path.join(workdir, "spec.json")
    with open(spec_path, "w") as f:
        json.dump({"target": target, "kwargs": kwargs or {},
                   "device": None if device is None else str(device),
                   "threads": threads,
                   "workdir": os.path.abspath(workdir)}, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [*path, REPO, *filter(None, [env.get("PYTHONPATH")])])
    log = os.path.join(workdir, "torchrun.log")
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", str(nprocs), "--log-dir",
             os.path.join(workdir, "torchrun"), "-m",
             "egtr_tpu_torch.parallel.launch", spec_path],
            env=env, stdout=out, stderr=subprocess.STDOUT, cwd=REPO)
        try:
            code = proc.wait(timeout)
        except subprocess.TimeoutExpired:
            proc.terminate()            # torchrun stops its ranks on SIGTERM
            try:
                proc.wait(STOP_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            raise RuntimeError(
                f"{target}: {nprocs} ranks still running after "
                f"{timeout:.0f} s:\n{_tail(log)}") from None
    if code != 0:
        raise RuntimeError(f"{target}: torchrun ({nprocs} ranks) exited "
                           f"with {code}:\n{_tail(log)}")
    results = []
    for r in range(nprocs):
        with open(os.path.join(workdir, f"result{r}.json")) as f:
            results.append(json.load(f))
    return results


def _rank_main(spec_path: str) -> None:
    import torch

    from . import dist

    with open(spec_path) as f:
        spec = json.load(f)
    if spec["threads"]:
        torch.set_num_threads(spec["threads"])
    device = dist.init_from_env(spec["device"])
    module, name = spec["target"].split(":")
    fn = getattr(importlib.import_module(module), name)
    result = fn(device=device, **spec["kwargs"])
    path = os.path.join(spec["workdir"], f"result{dist.process_index()}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(result, f)
    os.replace(path + ".tmp", path)
    dist.barrier()
    dist.shutdown()


if __name__ == "__main__":
    _rank_main(sys.argv[1])
