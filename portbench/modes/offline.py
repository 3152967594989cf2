"""Offline scene-graph extraction: batches of host images through
``egtr_tpu_torch.infer.infer``, one batch dispatched ahead.

Each unit queues one batch: its input copy from pinned host memory, the
request's program and the copy of its packed answers into a pinned host
buffer; then it waits for the oldest batch still in flight once more than
``ahead`` are, so that the card works on the next batch while the host
takes in the last one. The pool holds ``pool`` distinct batches drawn from
the seed, cycled. A batch counts when its answers reach the host.

Traffic parameters (``workloads/<name>.json``): as ``request``'s, with
``ahead``.
"""

from __future__ import annotations

from collections import deque

import torch

from portbench.modes.request import Runner as RequestRunner


class Runner(RequestRunner):
    def __init__(self, spec, seed, device, setup):
        super().__init__(spec, seed, device, setup)
        self.ahead = int(spec.traffic.get("ahead", 1))
        self.inflight = deque()
        self.buffers = []

    def _buffer(self, out):
        cuda = self.device.type == "cuda"
        if not self.buffers:
            self.buffers = [torch.empty(out.shape, dtype=out.dtype,
                                        pin_memory=cuda)
                            for _ in range(self.ahead + 1)]
        return self.buffers[self.k % len(self.buffers)]

    def dispatch(self):
        i = self.k % self.pool
        rows = slice(i * self.batch, (i + 1) * self.batch)
        model, infer = self.program_state["model"], self.program_state["infer"]
        rf = torch.profiler.record_function
        with rf("input_copy"):
            x = self.host_x[rows].to(self.device, non_blocking=True)
            m = self.host_m[rows].to(self.device, non_blocking=True)
        with rf("replay"):
            out = infer(model, x, m)
        with rf("output_copy"):
            buf = self._buffer(out)
            buf.copy_(out, non_blocking=True)
            ev = None
            if self.device.type == "cuda":
                ev = torch.cuda.Event()
                ev.record()
        self.k += 1
        self.inflight.append((ev, i, buf))

    def collect(self, record=True):
        ev, i, buf = self.inflight.popleft()
        with torch.profiler.record_function("wait"):
            if ev is not None:
                ev.synchronize()
        if record:
            self.answers.append((i, buf.clone()))
        return self.batch

    def request(self, record=True):
        self.dispatch()
        while self.inflight:
            self.collect(record)

    def unit(self):
        self.dispatch()
        done = 0
        while len(self.inflight) > self.ahead:
            done += self.collect()
        return done

    def drain(self):
        done = 0
        while self.inflight:
            done += self.collect()
        return done

    def end_to_end(self, window_s, images, units):
        return {"images_per_s": images / window_s}
