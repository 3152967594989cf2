"""Data-parallel training: the ``train`` mode's optimizer step
(``egtr_tpu_torch.train.train_step.make_train_step``, its captured
microbatch and apply programs) on ``world`` ranks, one card each, under
NCCL (gloo on the CPU), each rank batch ``batch`` x ``accum``: the
published job seen from ``world`` of its cards, where the gradient
all-reduce (``train_step.GradientReduction``, one a step inside the apply
program) and the criterion's sums over the data group run.

The harness's process is rank 0 (card 0); it starts the other ranks as
processes of this module (``python3 -m portbench.modes.train_dp --rank
R``), after the CUDA kernels are built once (``msda_cuda.build``), so that
the ranks do not race on ``build/``. Rank 0 alone is timed and traced. Each
rank makes its own pool of batches with ``train``'s draws from (seed, rank)
and its dropout generator from (seed, rank); every rank draws the same
weights (the step broadcasts rank 0's). The set-up's warm steps run in
lockstep (their collectives hold them together); in the window rank 0 tells
the others each step through a store (``cmd/<k>``), and each acknowledges
the steps it completed (``done/<rank>/<k>``): a unit is one optimizer step
of every rank, and the window's end waits for every rank's last.
``train_images_per_s`` counts the images of every rank's completed steps
over rank 0's window; the harness's image counts (the per-image metrics of
the traced slice) are rank 0's.

Nothing hangs: the store's waits and the collectives time out
(``TIMEOUT_S``); rank 0 watches the other ranks and its own progress in a
thread, and a rank that exits with an error, or a run that makes no
progress for ``TIMEOUT_S``, ends every process with a code other than 0; a
rank whose rank 0 is gone ends itself.

Traffic parameters: ``train``'s and ``world``. The output check: the
reference's step (``reference/union.py``, float32, TF32 off) over the union
of the ranks' microbatches, the loss normalised over the union as the
port's criterion does at dp > 1, each share's dropout masks from its rank's
generator at the place the rank's program began it; compared as ``train``
compares (rank 0's loss, first gradient and change, which the all-reduce
makes every rank's).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time

import torch

from portbench import harness, serving
from portbench.modes import train
from portbench.modes.train import compare_steps, position
from portbench.reference.train import param_label
from portbench.reference.union import UnionStep

TIMEOUT_S = 300.0
LEAVE_S = 30.0


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def leave_group() -> None:
    """Rank 0, once the other ranks have exited: the group left without a
    collective. gloo's is torn down (a local act); NCCL's communicators are
    aborted (``ncclCommAbort`` waits for no peer; a graceful teardown, or a
    barrier, after the captured programs was seen to wait for ever on four
    cards), in a thread given ``LEAVE_S``."""
    import torch.distributed as tdist

    if not tdist.is_initialized():
        return
    if tdist.get_backend() != "nccl":
        tdist.destroy_process_group()
        return
    t0 = time.monotonic()
    abort = getattr(tdist.distributed_c10d, "_abort_process_group",
                    tdist.destroy_process_group)
    done = threading.Event()

    def run():
        abort()
        done.set()

    threading.Thread(target=run, daemon=True).start()
    left = done.wait(LEAVE_S)
    harness.log(f"[train_dp] group {'aborted' if left else 'not aborted'} "
                f"after {time.monotonic() - t0:.1f} s")


def rank_seed(seed: int, rank: int) -> int:
    return serving.sub_seed(seed, f"rank{rank}")


class Runner(train.Runner):
    # how rank 0 starts the other ranks: this module (a reading or a test
    # names another, which plants a fault in the rank first: ``dp_faults``)
    worker = ("-m", "portbench.modes.train_dp")

    def __init__(self, spec, seed, device, setup, rank=0, ports=None):
        super().__init__(spec, seed, device, setup)
        self.world = int(spec.traffic["world"])
        self.rank = rank
        self.ports = ports
        self.workers = []
        self.workdir = None
        self.beat = time.monotonic()
        self.watching = False

    # -- the ranks ---------------------------------------------------------
    def join_group(self):
        from egtr_tpu_torch.parallel import dist as pdist

        env = {"RANK": str(self.rank), "WORLD_SIZE": str(self.world),
               "LOCAL_RANK": str(self.rank),
               "LOCAL_WORLD_SIZE": str(self.world),
               "MASTER_ADDR": "localhost", "MASTER_PORT": str(self.ports[0])}
        self.saved_env = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        pdist.TIMEOUT = datetime.timedelta(seconds=TIMEOUT_S)
        self.device = pdist.init_from_env(self.device.type)
        self.store = torch.distributed.TCPStore(
            "localhost", self.ports[1], self.world, self.rank == 0,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))

    def spawn(self):
        """Rank 0: the other ranks' processes and the watchdog."""
        self.ports = (free_port(), free_port())
        self.workdir = tempfile.mkdtemp(prefix="portbench-dp-")
        spec_path = os.path.join(self.workdir, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(self.spec.__dict__, f)
        for r in range(1, self.world):
            cmd = [sys.executable, *self.worker, "--rank", str(r), "--spec", spec_path, "--seed",
                   str(self.seed), "--device", self.device.type,
                   "--ports", f"{self.ports[0]},{self.ports[1]}"]
            self.workers.append(subprocess.Popen(
                cmd, cwd=harness.REPO, stdout=sys.stderr.fileno()))
        self.watching = True
        threading.Thread(target=self.watch, daemon=True).start()

    def watch(self):
        """Rank 0's watchdog: a rank that failed, or no progress."""
        while self.watching:
            time.sleep(1.0)
            codes = [w.poll() for w in self.workers]
            failed = [r + 1 for r, c in enumerate(codes)
                      if c is not None and c != 0]
            stalled = time.monotonic() - self.beat > TIMEOUT_S
            if failed or stalled:
                harness.log(f"train_dp: rank(s) {failed} failed"
                            if failed else f"train_dp: no progress for "
                            f"{TIMEOUT_S:.0f} s")
                self.kill_workers()
                os._exit(5)

    def kill_workers(self):
        for w in self.workers:
            if w.poll() is None:
                w.kill()

    def make_batches(self):
        seed = self.seed
        self.seed = rank_seed(seed, self.rank)
        try:
            super().make_batches()
        finally:
            self.seed = seed

    # -- the step ----------------------------------------------------------
    def setup(self):
        from egtr_tpu_torch.models.egtr import EgtrModel
        from egtr_tpu_torch.ops import msda_cuda
        from egtr_tpu_torch.train.optim import make_optimizer
        from egtr_tpu_torch.train.train_step import make_train_step

        from portbench.weights import fill_model

        if self.rank == 0:
            if self.device.type == "cuda":
                with self.timer.part("kernels"):
                    msda_cuda.build()
            with self.timer.part("spawn"):
                self.spawn()
        with self.timer.part("process_group"):
            self.join_group()
        self.beat = time.monotonic()
        cfg = serving.egtr_config(self.spec.config)
        r = self.recipe
        with self.timer.part("weights"):
            with torch.device(self.device):
                model = EgtrModel(cfg)
            state = fill_model(model, serving.sub_seed(self.seed, "weights"),
                               cfg, self.spec.traffic["weights"])
        if self.rank == 0:
            with self.timer.exclude():
                self.p0 = {n: t.detach().to("cpu", copy=True)
                           for n, t in state.items()}
        del state
        with self.timer.part("inputs"):
            self.make_batches()
        with self.timer.part("optimizer"):
            opt = make_optimizer(model, lr=r["lr"], lr_backbone=r["lr_backbone"],
                                 lr_initialized=r["lr_initialized"],
                                 weight_decay=r["weight_decay"],
                                 grad_clip=r["gradient_clip_val"])
        with self.timer.part("make_train_step"):
            step = make_train_step(model, cfg, opt, task="sgg",
                                   accum_steps=self.A)
            self.dropout_seed = serving.sub_seed(
                rank_seed(self.seed, self.rank), "dropout")
            gen = torch.Generator(device=self.device).manual_seed(
                self.dropout_seed)
        self.program_state = {"model": model, "opt": opt, "step": step,
                              "gen": gen}
        self.offsets, self.warm_losses = [], []
        for s in range(self.warm):
            self.beat = time.monotonic()
            with self.timer.part("first_step" if s == 0 else "warm_steps"):
                before = position(gen)
                loss = self.step_once(record=False)
                after = position(gen)
            with self.timer.exclude():
                self.offsets.append((before, after))
                self.warm_losses.append(loss)
                self.store.set(f"offsets/{self.rank}/{s}",
                               pickle.dumps((before, after)))
                if s == 0 and self.rank == 0:
                    self.g1 = {}
                    for group in opt.adamw.param_groups:
                        for p in group["params"]:
                            st = opt.adamw.state.get(p)
                            self.g1[id(p)] = ((st["exp_avg"] / (1 - train.BETA1))
                                              .cpu() if st and "exp_avg" in st
                                              else torch.zeros(p.shape))
                    self.g1 = {n: self.g1[id(p)]
                               for n, p in model.named_parameters()
                               if id(p) in self.g1}
        if self.rank == 0:
            with self.timer.exclude():
                self.p3 = {n: p.detach().to("cpu", copy=True)
                           for n, p in model.named_parameters()}
        self.beat = time.monotonic()

    def unit(self):
        self.store.set(f"cmd/{self.k - self.warm}", "step")
        self.step_once()
        self.beat = time.monotonic()
        return self.A * self.B

    def drain(self):
        """Every rank's last step completed (rank 0's images: none more)."""
        n = self.k - self.warm
        if n:
            self.store.wait([f"done/{r}/{n - 1}"
                             for r in range(1, self.world)])
        self.beat = time.monotonic()
        return 0

    def serve(self):
        """A rank other than 0: steps as rank 0 commands them; at the stop,
        the process ends (its communicators with it)."""
        n = 0
        while True:
            cmd = self.store.get(f"cmd/{n}")
            if cmd == b"stop":
                harness.log(f"[train_dp] rank {self.rank}: stopped after "
                            f"{n} steps")
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(0)
            self.step_once()
            self.store.set(f"done/{self.rank}/{n}", "1")
            n += 1

    def end_to_end(self, window_s, images, units):
        return {"train_images_per_s":
                units * self.world * self.A * self.B / window_s}

    def slice_info(self):
        info = super().slice_info()
        info["world"] = self.world
        return info

    # -- the output check --------------------------------------------------
    def stop_workers(self):
        """Rank 0: the other ranks told to stop and joined, then the group
        left (``leave_group``)."""
        self.store.set(f"cmd/{self.k - self.warm}", "stop")
        t0 = self.beat = time.monotonic()
        deadline = t0 + TIMEOUT_S
        for w in self.workers:
            code = w.wait(timeout=max(deadline - time.monotonic(), 1.0))
            if code != 0:
                raise RuntimeError(f"train_dp: a rank exited with {code}")
        harness.log(f"[train_dp] {len(self.workers)} rank(s) exited after "
                    f"{time.monotonic() - t0:.1f} s")
        self.watching = False
        leave_group()
        self.workers = []
        if self.workdir is not None:
            shutil.rmtree(self.workdir, ignore_errors=True)
        for k, v in self.saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def check_offsets(self):
        """Rank 0: each rank's generator before and after each warm step,
        ``[rank][step]``."""
        return [[pickle.loads(self.store.get(f"offsets/{r}/{s}"))
                 for s in range(self.warm)] for r in range(self.world)]

    def check(self):
        offsets = self.check_offsets()
        self.stop_workers()
        losses, g1, change = self.union_reference_steps(offsets)
        prog_change = {n: self.p3[n] - self.p0[n] for n in self.p0}
        return compare_steps(self.spec.traffic["limits"],
                             (self.warm_losses, self.g1, prog_change),
                             (losses, g1, change))

    def union_reference_steps(self, offsets, quant=None):
        """The reference's three steps over the union of the ranks'
        microbatches: (losses, first gradient by leaf, change by leaf).
        ``offsets[r][s]``: rank ``r``'s generator before and after its step
        ``s``."""
        dev = self.device
        shares = []
        for r in range(self.world):
            self.rank = r
            self.make_batches()
            shares.append((self.images, self.masks, self.ref_batches))
        self.rank = 0
        seeds = [serving.sub_seed(rank_seed(self.seed, r), "dropout")
                 for r in range(self.world)]
        gens = [torch.Generator(device=dev) for _ in range(self.world)]
        params = {n: t.to(dev) for n, t in self.p0.items()}
        step = UnionStep(params, self.m, self.recipe, quant)
        del params
        losses, g1 = [], None
        with serving.float32_exact():
            for s in range(self.warm):
                mbs = []
                for a in range(self.A):
                    mbs.append([])
                    for images, masks, refs in shares:
                        ref = refs[s][a]
                        rows = ref["rows"]
                        mbs[a].append({
                            "pixel_values": images[rows],
                            "pixel_mask": masks[rows],
                            "targets": [{k: torch.as_tensor(v, device=dev)
                                         for k, v in tg.items()}
                                        for tg in ref["targets"]]})

                def seek(a, r, per, s=s):
                    before, after = offsets[r][s]
                    g = gens[r]
                    if g.device.type != "cuda":
                        if a == 0:
                            g.set_state(before)
                        return g
                    g.manual_seed(seeds[r])
                    g.set_offset(before if a == 0
                                 else after - per * (self.A - a))
                    return g

                out = step(mbs, seek)
                losses.append(out["loss"])
                if s == 0:
                    g1 = {n: g.cpu() for n, g in out["grads"].items()
                          if param_label(n) != "frozen"}
        change = {n: (p.detach().cpu() - self.p0[n])
                  for n, p in step.params.items()}
        return losses, g1, change


def worker_main(argv=None) -> int:
    """A rank other than 0 (``Runner.spawn`` starts it)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--spec", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", required=True)
    ap.add_argument("--ports", required=True)
    args = ap.parse_args(argv)
    with open(args.spec) as f:
        spec = harness.Spec(**json.load(f))
    parent = os.getppid()

    def orphan_watch():
        while True:
            time.sleep(1.0)
            if os.getppid() != parent:
                os._exit(6)

    threading.Thread(target=orphan_watch, daemon=True).start()
    ports = tuple(int(p) for p in args.ports.split(","))
    runner = Runner(spec, args.seed, torch.device(args.device),
                    harness.Setup(), rank=args.rank, ports=ports)
    runner.setup()
    runner.serve()


if __name__ == "__main__":
    sys.exit(worker_main())
