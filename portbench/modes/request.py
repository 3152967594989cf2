"""Serving, closed loop: one client sends a request, waits for its answer
on the host and sends the next.

A request is one host image (float32 [1,H,W,3] and its pixel mask, pinned)
copied to the card, ``egtr_tpu_torch.infer.infer`` (the forward and the
top-k postprocess, one captured program), and its packed answer copied back
to pinned host memory. The pool holds ``pool`` distinct images drawn from
the seed, which the client cycles through. Each request's latency is read
by CUDA events on the card's clock, recorded before its input copy is
queued and after its output copy: the span the request holds the card, the
host's launch calls included.

Traffic parameters (``workloads/<name>.json``): ``batch``, ``bucket_hw``
(the padded shape), ``image_hw`` (the valid area), ``pool``,
``warm_requests``, ``trace_units``, ``limits``.
"""

from __future__ import annotations

import statistics
import time

import torch

from portbench import serving


class Runner:
    def __init__(self, spec, seed, device, setup):
        self.spec, self.seed, self.device, self.timer = spec, seed, device, setup
        t = spec.traffic
        self.batch = int(t["batch"])
        self.bucket = tuple(t["bucket_hw"])
        self.valid = tuple(t["image_hw"])
        self.pool = int(t["pool"])
        self.program_state = {}
        self.latency_ms = []
        self.answers = []            # (pool index, host answer)
        self.k = 0
        self.staging = None

    def setup(self):
        from egtr_tpu_torch.infer import infer
        from egtr_tpu_torch.ops import msda_cuda

        if self.device.type == "cuda":
            with self.timer.part("kernels"):
                msda_cuda.build()
        _, model, self.state = serving.build_model(
            self.spec.config, self.seed, self.device, self.timer,
            self.spec.traffic["weights"])
        model.eval()
        with self.timer.part("inputs"):
            x, mask = serving.make_images(
                self.pool * self.batch, self.bucket, self.valid,
                serving.sub_seed(self.seed, "images"), self.device)
            pin = self.device.type == "cuda"
            self.host_x = x.cpu().pin_memory() if pin else x.cpu()
            self.host_m = mask.cpu().pin_memory() if pin else mask.cpu()
            del x, mask
        self.program_state = {"model": model, "infer": infer}
        with self.timer.part("first_request"):
            self.request(record=False)
        with self.timer.part("warm_requests"):
            for _ in range(int(self.spec.traffic.get("warm_requests", 5))):
                self.request(record=False)

    def _event(self):
        if self.device.type == "cuda":
            return torch.cuda.Event(enable_timing=True)
        return None

    def request(self, record=True):
        i = self.k % self.pool
        self.k += 1
        rows = slice(i * self.batch, (i + 1) * self.batch)
        model, infer = self.program_state["model"], self.program_state["infer"]
        rf = torch.profiler.record_function
        start, end = self._event(), self._event()
        cuda = start is not None
        t0 = time.perf_counter()
        with rf("input_copy"):
            if cuda:
                start.record()
            x = self.host_x[rows].to(self.device, non_blocking=True)
            m = self.host_m[rows].to(self.device, non_blocking=True)
        with rf("replay"):
            out = infer(model, x, m)
        with rf("output_copy"):
            if self.staging is None:
                self.staging = torch.empty(out.shape, dtype=out.dtype,
                                           pin_memory=cuda)
            self.staging.copy_(out, non_blocking=True)
            if cuda:
                end.record()
        with rf("wait"):
            if cuda:
                end.synchronize()
        if record:
            # the card's clock; the host's only in the CPU tests
            self.latency_ms.append(start.elapsed_time(end) if cuda else
                                   (time.perf_counter() - t0) * 1e3)
            self.answers.append((i, self.staging.clone()))

    def unit(self):
        self.request()
        return self.batch

    def drain(self):
        return 0

    def end_to_end(self, window_s, images, units):
        q = statistics.quantiles(self.latency_ms, n=100, method="inclusive")
        return {"request_ms": window_s * 1e3 / units, "request_ms_p95": q[94]}

    def slice_info(self):
        from portbench import flops

        m = self.spec.config["model"]
        return {"batch": self.batch, "hw": self.bucket, "train": False,
                "steps": 0, "forwards_per_unit": 1,
                "flops_per_image": flops.step_flops(m, self.bucket, 1, False),
                "model": m}

    def failed(self):
        return sum(1 for _, a in self.answers if not torch.isfinite(a).all())

    def check(self):
        return serving.check_answers(self)
