"""Drive the PyTorch port (egtr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
Every phase runs unguarded; any failure ends the script with a nonzero exit
and no result line. In order it:

1. prints the card's name and power limit (nvidia-smi);
2. builds the hand-written MSDA kernels (exact forward; backward rows and
   value; int8 forward; banded forward; banded backward rows and value;
   batched-P forward) and the matcher's assignment kernel (lsap) from
   egtr_tpu_torch/csrc and the native evaluation kernels from
   egtr_tpu_torch/native, the compilers started together;
3. holds the forward kernel against its plain PyTorch version at the two
   main paths' shapes (serving bucket 608x1008: levels (76,126),(38,63),
   (19,32),(10,16), S = 12738; training bucket 800x1344: levels (100,168),
   (50,84),(25,42),(13,21), S = 22323, where level 0 rounds the y weights in
   bfloat16; encoder call Q = S, decoder call Q = 200; 8 heads of 32) in
   float32 and bfloat16, at the encoder call with raster (encoder-like)
   locations beside the uniform ones, and at the decoder call at batch 2
   (the training step's) beside batch 1 (the serving request's); the list
   is ``EXACT_CALLS``; checks that two runs are bit-equal, times the
   kernel (CUDA events around the wrapper, and its own device time in a
   CUDA graph), the plain version and the ``F.grid_sample`` composite (a
   yardstick of several PyTorch calls that the port never calls), prints
   the corner-gather bytes and their rate as L2 gather traffic, and checks
   the kernel's batch addressing on a batch of 2;
4. holds the two backward kernels against the plain backward at the
   training bucket's shapes the same way (the row kernel bit-equal over two
   runs, the composite's autograd backward as the yardstick of both), times
   the value kernel (K3) at every call by CUDA events and in a CUDA graph
   beside its bound, and prints the largest difference between two runs of
   it (its float32 atomics add in an order that changes);
5. holds the int8 forward kernel (K4) against its plain version at the
   serving bucket's calls (``Q_CALLS``): the served encoder call (the one
   exact level, Q = S, raster queries), the int8 encoder call without a
   window (all levels) and the decoder call (Q = 200) at batch 1 and 2, with
   float32 and bfloat16 weights, and a batch of 2 of mirrored images; checks
   that two runs are bit-equal and the quantized values made on the card
   equal those made on the CPU, bit for bit, and times the kernel by CUDA
   events and in a CUDA graph beside its bound;
6. holds the banded forward kernels (K5 one band per tile, K6 one band per
   point) against their plain version on the three banded levels of the
   served encoder call (window 16, raster queries with offsets of a few
   pixels; prints the share of samples that clamp), with float32, bfloat16
   and int8 values, and a batch of 2; checks that two runs are bit-equal
   and that K5 is bit-equal to K6 given K5's tile bands broadcast over the
   points, and times both kernels by CUDA events and in a CUDA graph;
(g) (after phase 15) holds the matcher's kernel ``lsap`` (the JAX
   package's in-jit Hungarian solver) against its plain version, bit for bit
   in its three outputs, at B 2 and 4, Q 200 and 300 (two stages), the
   two-stage proposal matching's Q = S (22,323) at B 2, G 64,
   ``num_boxes`` from 0 to G and G everywhere, on random costs and on costs
   full of ties; each image's total cost equal to scipy's to 1e-6; prints
   per case the route (one warp an image, or a cluster of blocks), the
   search steps and µs per step, and times the kernel (CUDA events, and
   its device time in a CUDA graph) beside the parent commit's kernel
   (built from ``git show HEAD~1:egtr_tpu_torch/csrc/lsap.cu``, or a copy
   in ``build/lsap_parent.cu``; in graphs, in turns; held bit-equal too),
   the host scipy path it replaced (the copies included) and its bound;
7. serves a few requests through ``infer.infer`` at full width (ResNet-50,
   d_model 256, 6+6 layers, 200 queries, 150/50 labels, bfloat16, seeded
   random weights) in three configurations and checks the outputs and each
   kernel's launches per forward: the exact bench configuration (K1 12), the
   JAX package's serving default ``infer.serving_config()`` (window 16, one
   band per point, int8: K6 18, K4 12, K1 0) and ``msda_band="tile"`` without
   int8 (K5 18, K1 12); then times the three in turns, side by side. Each
   request is the model's captured CUDA graph, one per input signature
   (``utils/aot.py``; the first request captures it), and every launch
   count, measured on the card (``CardLaunches``), holds over replays; the
   trunk's frozen-BN epilogue kernel (``frozen_bn``) launches once a site,
   49 a ResNet-50 forward (``fbn_sites``), in this phase, (h), (k) and 18;
(h) (after phase 16) the exact and the served request as a graph against
   the same request op by op (``infer.infer_eager``): outputs (largest
   delta, bit-equality), launches per forward both ways, ms per request in
   turns, the card's launches and idle share per request (torch.profiler),
   peak and held memory; then the captured request replayed on another
   image, and the evaluation's forward + post-processing program
   (``runner.infer_program``) replayed on a batch it was not captured
   with, each against eager;
(k) (after (h)) holds the trunk's frozen-BN epilogue kernel ``frozen_bn``
   (the JAX package's frozen BN, ReLU and residual, which XLA fuses) against
   ``backbone.frozen_bn_act_plain`` bit for bit at every site of the
   608x1008 batch-1 and 800x1344 batch-8 trunks (into a map of its own and
   in place), times it and the chain of PyTorch kernels it replaces in a
   CUDA graph beside its bytes, and traces the offline request (batch 8 at
   800x1344, ``infer.infer``): 49 ``frozen_bn`` a forward;
8. runs the exact and the served model in float32 (TF32 off) through the
   kernels and through the plain versions and compares logits, boxes and
   relation scores, counting the band indices on which the two runs differ;
   then the same weights and input through the plain path on the CPU: the
   band indices on which the card's and the CPU's picks differ (open check
   F1: a float32 weighted mean summed in another order moves a near-tie
   band) beside the largest output delta, card against CPU;
9. runs one forward + backward of the int8 op without a window: K4, K2 and
   K3 one launch each, gradients equal to the exact op's;
10. trains: the train probe's step (``scripts/perf_train_step``) at full
   width, bfloat16, batch 2 at 800x1344, dropout 0.1: three steps and one
   accumulated step (accum 2 over a batch of 4), each a captured program
   (the accumulated one a microbatch program twice and an apply program).
   Checks that every metric is finite, the gradient norm positive, the
   trainable parameters moved, the frozen ones bit-identical, and that each
   microbatch launched each of the three kernels 12 times, the matcher
   kernel once per matching (6 with the auxiliary losses) and ``frozen_bn``
   never (grad mode is on);
(i) the training step as programs against eager: float32 (TF32 off,
   dropout 0) three steps, each on its own batch and learning-rate scale,
   the graph run's losses, gradient norms, last gradients and parameter
   changes less its own AdamW updates (recomputed in float64 from its
   gradients) from the nearest of three eager runs within four times the
   eager runs' largest distance of a pair, and
   two planted faults (a step that never zeroes its gradients, an update
   that reads the scale it was captured with) outside; bfloat16 batch 2 x
   accum 2 at 800x1344, ms per step in turns and memory both ways; at
   dropout 0.1 two replays on one batch give different losses (new masks
   each replay);
11. runs one float32 (TF32 off) forward + backward of the same model through
   the kernels and through the plain op and compares the total loss and
   every parameter's gradient, beside the plain path's own change when the
   pixels move by about one float32 step;
12. holds the banded backward kernels (K7 rows and K9 value, one band per
   tile; K8 rows and K10 value, one band per point) against their plain
   version on the three banded levels of the adaptation's encoder call
   (608x1008, window 16, raster queries with offsets of a few pixels; prints
   the clamped share and the value kernels' run-to-run difference; the row
   kernels bit-equal over two runs, and K7 bit-equal to K8 given K7's tile
   bands broadcast over the points; K9's largest difference to K10 on those
   broadcast bands; all four timed by CUDA events and in a CUDA graph, K9
   and K10 adding into the level's slice of a layer's gradient as the path
   calls them) in float32 and bfloat16 at the adaptation's microbatch of 4,
   and checks the batch addressing on a batch of 2;
13. trains the windowed path: the band-adaptation fine-tune's step
   (``perf_train_step.adapt_config``: window 16, one band per point, bf16,
   dropout 0.1, no auxiliary losses) at full width, batch 4 at 608x1008, its
   learning rates, three steps, and one step each of its siblings
   ``msda_band="tile"`` and one band per point with int8. Checks the metrics,
   the parameters, and each microbatch's launches: K6 18, K1 12, K8 18, K10
   18, K2 12, K3 12 (tile: K5 18, K1 12, K7 18, K9 18, K2 12, K3 12; int8:
   K6 18, K4 12, K8 18, K10 18, K2 12, K3 12);
14. runs one float32 (TF32 off, dropout 0) forward + backward of the
   adaptation model through the kernels and through their plain versions
   and compares them in the same way, and the band indices;
15. holds the batched-P forward K11 (``EGTR_MSDA_BATCH_P=1``) against its
   plain version and beside K1 on the same inputs, at the serving and
   training buckets' encoder and decoder calls in float32 and bfloat16 at a
   batch of 2, its int8 form beside K4 on the served encoder call's exact
   level and the decoder call, a windowed call's exact level (float32
   out), and the bfloat16 and int8 forms at three points a level and on
   values one element off their allocation; the bfloat16 and int8 forms
   run K1's and K4's kernels (``msda_cuda.BP_ROUTES``) and must give their
   bits at every call; times both kernels at each call (this runs before
   phase 7);
16. serves one request of each of phase 7's configurations with the flag on
   (``msda.FWD_BATCH_P``, what the environment variable sets at import):
   K11 takes every K1 / K4 launch (exact: K11 12; served: K6 18, K11 12;
   tile: K5 18, K11 12); the outputs bit-equal to the flag-off forward of
   the same model; phase 8 adds a float32 run with the flag on against the
   plain path;
17. runs the training driver ``scripts.train_egtr.main`` in-process with
   the flag on, at full width on its defaults: a synthetic VG set (8/2/2
   images at 600x1000, seed 0), batch 2 x accum 2, one epoch per phase.
   Checks the launches (K11 12 per forward: 2 x (2 steps x 2 microbatches
   + 1 validation batch) + 2 test images = 144; K2, K3 12 per microbatch =
   96; nothing else), the metrics.jsonl records of both phases, finite
   losses, the artifact, metrics_test.json's R@K, mR@K and COCO entries,
   the reloaded artifact's forward bit-equal to the trained model's, and a
   relaunch on the same output path that resumes and takes no step (only
   the test evaluation's 24 K11 launches); prints seconds per phase and
   ms per optimizer step from metrics.jsonl, and the run's peak memory
   against the same run with every step and evaluation forward eager,
   with the reserved memory by pool as each program's warm-up and capture
   ends and the peak's split; fails where the programs reserve more than
   1.5 GB over the eager run or allocate more than it;
18. holds K4, K5 and K6 against their plain versions at the test bucket's
   levels (800x1344), as phases 5 and 6 do at the serving bucket's; then
   runs the evaluation driver ``scripts.evaluate_egtr.main`` in-process,
   with the flag off, on phase 17's artifact and test split (800/1333,
   bf16, batch 1): R@K and mR@K equal to phase 17's ``metrics_test.json``
   (its test evaluation ran K11's bf16 form, bit-equal to K1, on the model
   the artifact reloads bit-equal), K1 12 and ``frozen_bn`` 49 per
   forward and nothing else; the SGG evaluator's calls of that run
   replayed with the native matcher and with the numpy loop, host ms of
   each and the same recalls; the same split with ``--msda_window 16
   --msda_band point --msda_int8 true`` (K6 18, K4 12, K1 0 per forward),
   its R@K beside the exact run's; and
   ``--infer_only`` (K1 12 per forward: the warm-up, the timed loop and the
   three decomposition loops), whose fps, strict-sync fps, chained and
   device-busy ms per image and host round trip must be finite and
   positive; prints each run's seconds;
19. runs the pretraining driver ``scripts.pretrain_detr.main`` in-process
   on the same synthetic VG set at full width (ResNet-50, d_model 256, 6+6
   layers, 200 queries, bf16, auxiliary losses, the crop augmentor), batch
   2 x accum 2, one epoch per phase: K1, K2 and K3 12 per microbatch and K1
   12 per evaluation forward, nothing else; finite losses in both phases'
   metrics.jsonl; the COCO entries of metrics_test.json; and
   ``merge_pretrained`` of the exported artifact into a fresh ``EgtrModel``
   init takes every detector leaf from the artifact and keeps the relation
   head's leaves and the frequency-bias tables fresh; prints its seconds;
20. runs the trained-offsets experiment (``scripts.exp_trained_offsets``)
   in-process on its own synthetic VG set (8/2/2 images at 600x1000: one
   608x1008 bucket) at full width (ResNet-50, d_model 256, 6+6 layers, 200
   queries, the set's 6 object and 4 predicate labels, bf16, batch 4):
   ``train`` (exact, a checkpoint a step) on a clock budget of seconds, ``train
   --resume`` (the step counter goes on; a resume with a drifted flag is
   refused by name), the adaptation ``--init_from`` the exact artifact
   with window 16 and one band per point, and its ``band="tile"``
   sibling; each command's launches equal step_counts x the steps its
   state directory records, and every loss is finite; then ``sweep
   --windows 0,16,16p,16pi,8p --int8`` on the adaptation's artifact
   (forward_counts per variant: K1, K4, K5, K6), the same command again
   (every variant skipped, no launch), R@K in [0, 1] and finite deltas to
   the exact outputs; ``offsets`` (K1 12), and the clamp fractions of the
   same captured offsets on the card and on the CPU within
   ``EXP_CLAMP_ATOL``; F1 on the adapted weights (one float32 forward on
   the card and on the CPU: the band indices that differ, the largest
   output delta); and ``scripts.exp_window_deltas.main`` at 608x1008
   (K1, K5, K6); prints each command's seconds and ms per step from the
   script's clock;
21. (after the Open Images, two-stage, remat and approximate top-k phases)
   runs the data-parallel path, its ranks processes that torchrun starts
   (``parallel.launch.spawn``, a timeout on each run), two of them sharing
   the card under gloo (NCCL refuses two ranks on one device); torchrun
   stops the others when a rank fails, and the script fails. Under gloo a
   function that holds a collective (the steps) runs eagerly, and one that
   holds none (the evaluation's forward at ``mp`` 1) is each rank's
   captured program (``utils/aot.maybe_aot``). (c), inside phase 17's
   directory, in one pair of ranks (gloo) on a synthetic set like phase
   17's with two test images a rank: ``train_egtr`` (global batch 8: one
   step per phase) with one metrics.jsonl a phase, the artifact and every
   checkpoint written by rank 0 alone, both ranks' test metrics equal and
   equal to metrics_test.json; then ``evaluate_egtr`` of the artifact,
   whose forward each rank captures and replays, and ``pretrain_detr``;
   one process's ``evaluate_egtr`` of the artifact equal, to 1e-12, to
   both ranks' train and evaluate runs; each rank's K1/K2/K3 launches
   exact, counted on its card trace (``evaluate_egtr``'s wrappers see the
   warm-up's alone).
   (a): the data-parallel step at full width, float32 (TF32 off), dropout
   0, global batch 4 at 800x1344 (two images a rank) against one
   process's step on the same batch: the loss terms and ``grad_norm``
   within 1e-4, the
   reduced gradients and the updated parameters within ``GRAD_RTOL`` of
   their largest entries, the zero-initialised parameters' first update
   within ``GRAD_RTOL`` of lr where their gradient decides it (their
   values' spread beside that of one process's step taken twice,
   ``_compare_step``), the ranks' parameters bit-equal, K1/K2/K3 12 per
   rank; then bf16 steps a rank (dropout 0.1): a warm-up, and rounds of a
   step and the step with its gradient reduction skipped, their ms per
   optimizer step and the reduction's exposed ms, beside phase 10's
   one-process steps; and a loop of the reduction's all-reduce alone, of
   one buffer of every leaf's gradient bytes (``DP_NOTE`` says what these
   times are not). (b): two ranks x accumulation 2 x the adaptation config
   at 608x1008, float32, global batch 8 (two ranks x two microbatches x
   two images), against one process's accumulated step: losses within
   1e-4, gradients, parameters and first updates within
   ``ADAPT_GRAD_RTOL``, each rank's K6/K8/K10 (and K1/K2/K3) launches
   exact. (d) ``dryrun_multichip(1)``, whose one rank runs NCCL on the
   card (a step, captured as a program, and ``all_gather_objects``), and
   (e)
   ``dryrun_multichip(2)`` (dp 1 x mp 2) and ``dryrun_multichip(4)`` (dp 2
   x mp 2, four ranks sharing the card) under gloo. (a), (b) and (f) also
   print open check F2: the gradients' largest relative error entry by
   entry and the entries of another sign, and the parameters' difference
   less the first AdamW update's of the two gradients. (f), the model axis
   (``--mp``), two ranks of dp 1 x mp 2 on the card, each computing half
   of the relation grid's rows: the float32 step at full width, batch 2 at
   800x1344, against one process's (losses within 1e-4, gradients and
   parameters within ``GRAD_RTOL``), the ranks bit-equal, K1/K2/K3 12 per
   rank (a rank without them fails itself); bf16 steps (dropout 0.1) after
   a warm-up, ms per optimizer step per rank beside one process's, the
   model group's collectives of a step replayed alone, each rank's peak
   memory of the relation head (forward, and forward + backward, alone on
   the step's inputs) and of the step beside one process's; then
   ``train_egtr --dp 1 --mp 2`` on a synthetic set like phase 17's, both
   ranks' test metrics equal and rank 0 alone writing; prints each
   phase's seconds;
(j) (after (d) and (e)) the data-parallel step as programs in one rank
   under NCCL (torchrun's variables, world 1): every step function is a
   captured program, its gradient all-reduce inside the graph. The float32
   runs of (i) in that rank under (i)'s rule, the planted faults outside;
   one replay each of the bf16 step at batch 2 and at 2 x accum 2 traced
   on the card, K1/K2/K3 and the matcher as one process's, NCCL's kernel
   among the rows; ms per step of both as programs and eager in turns,
   beside (i)'s and phase 10's one-process steps, and the programs'
   memory beside (i)'s; the eval step and the runner's forward replayed,
   programs of their own;
22. prints a ``kernels`` JSON line (with each kernel's launches per rank on
   the data-parallel paths, the matcher kernel's entry and then the trunk's
   epilogue kernel's last; the request and train-step graphs beside it),
   then ``{"ok": true, "device": ...}`` last.

The drivers of phases 17-20 run their steps, evaluation forwards and
requests as captured programs too. A replay launches its kernels without
their wrappers, so in this process every launch count is measured on the
card: a torch.profiler trace of the card's activity from
``reset_kernel_counts`` to ``kernel_counts``, its kernel rows read back to
the wrappers (``CardLaunches``, ``kernel_of``); timings taken inside such a
window carry the trace's cost. So do the ranks whose programs replay ((c)
and (j)); the ranks of (a), (b), (d)-(f), whose steps hold gloo
collectives and run eagerly, count by wrapper.

It exits nonzero without a result where CUDA is absent.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import torch

import numpy as np
from PIL import Image

from egtr_tpu_torch import infer, native
from egtr_tpu_torch.evaluation import runner as runner_module
from egtr_tpu_torch.evaluation import sg_eval
from egtr_tpu_torch.evaluation.sg_eval import SceneGraphEvaluator
from egtr_tpu_torch.models.detr import level_shapes
from egtr_tpu_torch.models.egtr import EgtrModel
from egtr_tpu_torch.models.layers import MSDeformableAttention
from egtr_tpu_torch.ops import criterion, matcher, msda, msda_cuda
from egtr_tpu_torch.ops.msda_window import segment_bounds
from egtr_tpu_torch.parallel import dist, dryrun
from egtr_tpu_torch.parallel.launch import spawn
from egtr_tpu_torch.parallel.mesh import make_mesh
from egtr_tpu_torch.scripts import perf_train_step
from egtr_tpu_torch.train import train_step as train_step_module
from egtr_tpu_torch.train.optim import Optimizer
from egtr_tpu_torch.train.train_step import make_train_step

# H100 SXM peaks (NVIDIA data sheet): HBM rate and float32 outside the
# tensor cores, where the kernel does its arithmetic
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# flops per sampled (query, head, level, point) and channel. Forward: two
# 2-corner dot products (3 each) and their weighted sum into the accumulator
# (4). Backward rows: dT (2), the two column sums times the hat derivatives
# (10), T and T*g (8), the daw and diy sums (8). Backward value: dT (2), four
# products and four additions (8).
FLOPS_PER_SAMPLE_CHANNEL = 10
FLOPS_ROWS, FLOPS_VALUE = 28, 10

# kernel vs plain: float32 differs only in the order of summation; bf16
# outputs may differ by one rounding of the float32 sum (2**-8), allow two
TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-3, 2 * 2.0 ** -8)}
# float32 model, kernel vs plain MSDA: summation order in 12 MSDA calls,
# carried through the decoder and the heads
MODEL_ATOL = 1e-3
# the same for the served model (window 16, one band per point, int8): a
# value whose two float32 versions straddle a rounding tie lands on the
# neighbouring int8 step (1/127 of its level's largest value), and a band
# index whose weighted mean straddles a tie moves a whole tile's clamp
SERVED_MODEL_ATOL = 2e-2
# backward kernels vs plain backward. float32: summation order only (warp
# shuffles and atomics against torch sums), relative to each output's largest
# entry. bfloat16: dvalue and daw are rounded once to bf16 from float32 sums
# in another order (one bf16 step, 2**-8; allow two); dloc stays float32 and
# sums bf16-exact products.
BWD_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-3, 2 * 2.0 ** -8)}
# float32 train step, kernels vs plain op: the loss, and each parameter's
# gradient relative to that gradient's largest entry (summation order in 12
# forward and 24 backward MSDA calls, carried through the whole backward)
GRAD_RTOL = 2e-3
# the same at the adaptation's configuration (608x1008, no auxiliary
# losses), whose gradients are more sensitive to round-off: the pixels times
# (1 + 1.2e-7 noise) move the plain path's own gradients by 3.6e-3 of the
# largest entry there, kernels vs plain 2.8e-3 (an H100; compare_train_f32
# prints both)
ADAPT_GRAD_RTOL = 1e-2
# and where a band index differs between the two runs: its tile's samples
# clamp to other rows in the forward and the backward
FLIPPED_BAND_GRAD_RTOL = 5e-2

# what library_composite_ms times: no one PyTorch call computes MSDA, so
# library_ms stays null
COMPOSITE_NOTE = ("a composite of several PyTorch calls, not one: "
                  "F.grid_sample per level plus the weighted sum")

H, D, L, P = 8, 32, 4, 4
WINDOW = 16         # the served window
MAX_OFFSET_PX = 4.0  # raster inputs: offsets of a few pixels, some clamp
N_REQUESTS = 4
N_TILE_REQUESTS = 2
SIDE_BY_SIDE_ROUNDS = 10
TRAIN_STEPS = 3
ADAPT_STEPS = 3
DEVICE = "cuda"
# the training driver's run: a synthetic VG set (scripts/make_synth_vg) and
# the driver's own defaults at full width (ResNet-50, d_model 256, 6+6
# layers, 200 queries, bf16), one epoch per phase
SYNTH_VG = dict(n_train=8, n_val=2, n_test=2, height=600, width=1000)
DRIVER_ARGS = ["--from_scratch", "true", "--batch_size", "2", "--accumulate",
               "2", "--max_epochs", "1", "--max_epochs_finetune", "1",
               "--num_workers", "2", "--seed", "0", "--log_every", "1"]
# the pretraining driver's run on the same set, on its own defaults at full
# width (ResNet-50, d_model 256, 6+6 layers, 200 queries, bf16)
PRETRAIN_ARGS = ["--batch_size", "2", "--accumulate", "2", "--max_epochs",
                 "1", "--max_epochs_finetune", "1", "--num_workers", "2",
                 "--seed", "0", "--log_every", "1"]
# the served configuration's overrides for the evaluation driver
SERVED_EVAL_ARGS = ["--msda_window", str(WINDOW), "--msda_band", "point",
                    "--msda_int8", "true"]
RECALL_KEYS = [f"single/{m}@{k}" for m in ("R", "mR") for k in (20, 50, 100)]
# replays of the exact evaluation's SGG-evaluator work, per matching path
SG_EVAL_ROUNDS = 20
# the ranks of each image's own top-k that a planted ground truth holds:
# six triplets
PLANTED_RANKS = (0, 10, 20, 30, 40, 50)
# the trained-offsets experiment (scripts/exp_trained_offsets): its own
# 8/2/2 synthetic VG set at 600x1000 (one 608x1008 bucket), the script's
# full-width bf16 model (ResNet-50, d_model 256, 6+6 layers, 200 queries) at
# batch 4; each train command's clock budget in seconds (the clock starts
# after the first step); the sweep's variants
SYNTH_EXP = dict(n_train=8, n_val=2, n_test=2, height=600, width=1000)
EXP_ARGS = ["--size", "600", "--max_size", "1000", "--batch", "4"]
EXP_TRAIN_SECONDS = {"exact": 2, "resume": 1, "point": 2, "tile": 1}
EXP_SWEEP = ["--windows", "0,16,16p,16pi,8p", "--int8"]
# the clamp fractions on the card against the CPU on the same offsets
EXP_CLAMP_ATOL = 1e-6
# Open Images V6 through the three drivers: a synthetic set of the paper's
# label spaces (601 objects, 30 predicates), the drivers' full width
SYNTH_OI = dict(n_train=8, n_val=2, n_test=2, height=600, width=1000)
OI_OBJECTS, OI_PREDICATES = 601, 30
OI_EVAL_ROUNDS = 5
# two stages: proposals from the encoder memory, 300 of them as queries
TWO_STAGE = dict(two_stage=True, with_box_refine=True,
                 two_stage_num_proposals=300)
TWO_STAGE_STEPS = 2
# rematerialized layers, each policy and none
REMAT = {"off": dict(use_remat=False),
         "full": dict(use_remat=True, remat_policy="full"),
         "dots": dict(use_remat=True, remat_policy="dots")}
REMAT_STEPS = 3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call from CUDA events, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def msda_inputs(Q, S, dtype, seed, batch=1, points=P):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    value = torch.randn((batch, S, H, D), generator=g, device=DEVICE).to(dtype)
    # locations roam slightly outside [0, 1] so the zero padding is hit
    loc = torch.rand((batch, Q, H, L, points, 2), generator=g,
                     device=DEVICE) * 1.2 - 0.1
    aw = torch.randn((batch, Q, H, L * points), generator=g,
                     device=DEVICE).softmax(-1)
    return value, loc, aw.reshape(batch, Q, H, L, points).to(dtype)


def raster_inputs(shapes, dtype, seed, batch=1):
    """Encoder-like inputs: the queries are the raster tokens of ``shapes``,
    reference points on their own pixel centres, offsets of up to
    MAX_OFFSET_PX pixels on every level."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    S = sum(h * w for h, w in shapes)
    value = torch.randn((batch, S, H, D), generator=g, device=DEVICE).to(dtype)
    refs = []
    for h, w in shapes:
        yy, xx = torch.meshgrid(torch.arange(h, device=DEVICE),
                                torch.arange(w, device=DEVICE), indexing="ij")
        refs.append(torch.stack([(xx.reshape(-1) + 0.5) / w,
                                 (yy.reshape(-1) + 0.5) / h], -1))
    ref = torch.cat(refs)                                     # [S, 2]
    wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                      device=DEVICE)
    off = (torch.rand((batch, S, H, len(shapes), P, 2), generator=g,
                      device=DEVICE) * 2 - 1) * MAX_OFFSET_PX
    loc = ref[None, :, None, None, None, :] + off / wh[None, None, None, :,
                                                       None, :]
    aw = torch.randn((batch, S, H, len(shapes) * P), generator=g,
                     device=DEVICE).softmax(-1)
    return value, loc.contiguous(), aw.reshape(batch, S, H, len(shapes),
                                               P).to(dtype)


# The calls at which K1 and K2 are held to their plain versions and timed,
# in each bucket and in float32 and bfloat16 (scripts/time_msda_kernels.py
# times the same list): (call, batch). The encoder call has Q = S, uniform
# or raster locations; the decoder call Q = 200: at batch 1 the serving
# request's (B*Q*H = 1,600 rows), at batch 2 the training step's (3,200).
EXACT_CALLS = (("encoder", 1), ("decoder", 1), ("encoder_raster", 1),
               ("decoder", 2))
DECODER_Q = 200


def exact_calls():
    """(call, batch, dtype) of every call of EXACT_CALLS, in its order."""
    return [(call, batch, dtype) for call, batch in EXACT_CALLS
            for dtype in (torch.float32, torch.bfloat16)]


def exact_call_inputs(shapes, call, batch, dtype, seed):
    """(Q, value, loc, aw) at one call of EXACT_CALLS."""
    S = sum(h * w for h, w in shapes)
    if call == "encoder_raster":
        return (S, *raster_inputs(shapes, dtype, seed, batch))
    Q = S if call == "encoder" else DECODER_Q
    return (Q, *msda_inputs(Q, S, dtype, seed, batch))


def grad_output(batch, Q, dtype, seed):
    """A seeded output gradient for the backward kernels."""
    return torch.randn((batch, Q, H * D), device=DEVICE,
                       generator=torch.Generator(device=DEVICE)
                       .manual_seed(seed)).to(dtype)


def bound(tensors, aw, flops_per_sample_channel=FLOPS_PER_SAMPLE_CHANNEL):
    """Least time for a call on the card: ``tensors`` (each input read once,
    each output written once) over the HBM rate, against the flops over the
    float32 rate (``aw`` has one entry per sample). Returns (ms, "bytes" |
    "operations")."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    flops = aw.numel() * D * flops_per_sample_channel
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flops / FP32_FLOPS * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def graph_ms(fn, per_graph: int = 20, replays: int = 10) -> float:
    """The kernel's own device time per call: ``per_graph`` calls captured
    in one CUDA graph, replayed ``replays`` times after a warm replay (at
    the decoder calls ``cuda_ms`` times the host's wrapper instead)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (per_graph * replays)


def composite_msda(value, shapes, loc, aw):
    """A yardstick the port never calls: MSDA as PyTorch's own calls write
    it, ``F.grid_sample`` (bilinear, zero padding, align_corners=False) per
    level and the weighted sum over points and levels. A composite of
    several calls, not one PyTorch call; it rounds nothing as the kernels
    do, and takes the grid in the value dtype."""
    B, _, Hh, Dh = value.shape
    Q, Pp = loc.shape[1], loc.shape[4]
    starts = msda.level_starts(shapes)
    out = 0
    for lid, (h, w) in enumerate(shapes):
        v = value[:, starts[lid]:starts[lid] + h * w].permute(0, 2, 3, 1)
        grid = (2 * loc[:, :, :, lid] - 1).transpose(1, 2)
        sampled = torch.nn.functional.grid_sample(
            v.reshape(B * Hh, Dh, h, w),
            grid.reshape(B * Hh, Q, Pp, 2).to(value.dtype), mode="bilinear",
            padding_mode="zeros", align_corners=False)      # [B*H, D, Q, P]
        a = aw[:, :, :, lid].transpose(1, 2).reshape(B * Hh, 1, Q, Pp)
        out = out + (sampled * a).sum(-1)
    return out.view(B, Hh, Dh, Q).permute(0, 3, 1, 2).reshape(B, Q, Hh * Dh)


def gather_bytes(aw, value):
    """Corner-gather bytes of a call, from the shapes: every sample reads
    four corner rows of D values (L2 gather traffic where the value tensor
    stays in L2, as at these calls; not device-memory bytes)."""
    return aw.numel() * 4 * value.shape[3] * value.element_size()


def _fwd_row(bucket, call, Q, value, shapes, loc, aw):
    """K1 at one call: held to the plain version, bit-equal over two runs,
    timed beside the plain version and the grid_sample composite."""
    kern = msda_cuda.msda_fwd(value, shapes, loc, aw)
    again = msda_cuda.msda_fwd(value, shapes, loc, aw)
    plain = msda.ms_deform_attn_plain(value, shapes, loc, aw)
    composite = composite_msda(value, shapes, loc, aw)
    torch.cuda.synchronize()
    dtype = value.dtype
    err = (kern.float() - plain.float()).abs()
    atol, rtol = TOL[dtype]
    limit = atol + rtol * plain.float().abs()
    row = {
        "bucket": bucket, "call": call, "Q": Q, "batch": value.shape[0],
        "dtype": str(dtype).split(".")[-1],
        "max_abs_err": err.max().item(),
        "max_err_over_limit": (err / limit).max().item(),
        "bit_equal_run_to_run": torch.equal(kern, again),
        "ms": cuda_ms(lambda: msda_cuda.msda_fwd(value, shapes, loc, aw),
                      100),
        "graph_ms": graph_ms(lambda: msda_cuda.msda_fwd(value, shapes, loc,
                                                        aw)),
        "plain_ms": cuda_ms(lambda: msda.ms_deform_attn_plain(
            value, shapes, loc, aw), 5),
        "library_composite_ms": cuda_ms(lambda: composite_msda(
            value, shapes, loc, aw), 10),
        "composite_max_abs_diff": (composite.float()
                                   - plain.float()).abs().max().item(),
    }
    row["bound_ms"], row["bound_by"] = bound((value, loc, aw, kern), aw)
    row["gather_bytes"] = gather_bytes(aw, value)
    row["gather_GBps_L2"] = row["gather_bytes"] / row["ms"] / 1e6
    print(f"msda_fwd {bucket} {call} Q={Q} B={row['batch']} {row['dtype']}: "
          f"max abs err "
          f"{row['max_abs_err']:.3e} (err/limit "
          f"{row['max_err_over_limit']:.3f}, atol {atol} rtol {rtol}), "
          f"bit-equal run to run {row['bit_equal_run_to_run']}; kernel "
          f"{row['ms']:.4f} ms (device {row['graph_ms']:.4f} ms in a CUDA "
          f"graph), plain {row['plain_ms']:.4f} ms, grid_sample composite "
          f"{row['library_composite_ms']:.4f} ms (max abs diff to plain "
          f"{row['composite_max_abs_diff']:.2e}), bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}); corner gathers "
          f"{row['gather_bytes'] / 1e6:.1f} MB, {row['gather_GBps_L2']:.0f} "
          "GB/s of L2 gather traffic (not a roofline share)", flush=True)
    if not torch.isfinite(kern.float()).all():
        raise SystemExit(f"msda_fwd {call} {dtype}: non-finite output")
    if row["max_err_over_limit"] > 1.0:
        raise SystemExit(f"msda_fwd {call} {dtype}: kernel disagrees "
                         "with the plain version")
    if not row["bit_equal_run_to_run"]:
        raise SystemExit(f"msda_fwd {call} {dtype}: two runs differ")
    return row


def check_kernel(shapes, bucket):
    """K1 against the plain version at every call of EXACT_CALLS."""
    S = sum(h * w for h, w in shapes)
    rows = []
    for n, (call, batch, dtype) in enumerate(exact_calls()):
        seed = (50 if call == "encoder_raster" else 0) + n
        Q, value, loc, aw = exact_call_inputs(shapes, call, batch, dtype,
                                              seed)
        rows.append(_fwd_row(bucket, call, Q, value, shapes, loc, aw))
    # the batch index of the kernel's addressing, on two mirrored images
    value, loc, aw = msda_inputs(200, S, torch.float32, seed=4)
    value, loc, aw = (torch.cat([t, t.flip(1)]) for t in (value, loc, aw))
    plain = msda.ms_deform_attn_plain(value, shapes, loc, aw)
    err = (msda_cuda.msda_fwd(value, shapes, loc, aw) - plain).abs()
    atol, rtol = TOL[torch.float32]
    print(f"msda_fwd {bucket} decoder batch 2 float32: max abs err "
          f"{err.max().item():.3e}", flush=True)
    if (err > atol + rtol * plain.abs()).any():
        raise SystemExit("msda_fwd batch 2: kernel disagrees with plain")
    return rows


def _f32_err(kern, plain):
    """(max abs err, err over the float32 limit): the new forward kernels
    and their plain versions both return float32 sums of the same rounded
    products, so they differ in the order of summation only."""
    atol, rtol = TOL[torch.float32]
    err = (kern - plain).abs()
    return err.max().item(), (err / (atol + rtol * plain.abs())).max().item()


# The calls at which K4 is held to its plain version and timed, in the
# serving bucket (scripts/time_msda_kernels.py times the same list): (call,
# batch). The served encoder call sums the one exact level of a window of
# 16 (Q = S, raster queries), the int8 encoder call without a window every
# level (Q = S, raster), the decoder call every level (Q = 200) at batch 1
# (a served request's) and 2.
Q_CALLS = (("encoder_served", 1), ("encoder", 1), ("decoder", 1),
           ("decoder", 2))


def q_calls():
    """(call, batch, weights dtype) of every call of Q_CALLS, in order."""
    return [(call, batch, dtype) for call, batch in Q_CALLS
            for dtype in (torch.float32, torch.bfloat16)]


def q_call_inputs(shapes, call, batch, dtype, seed):
    """(Q, levels, value, loc, aw) at one call of Q_CALLS: the values for
    ``msda.quantize_levels``, the weights in ``dtype``."""
    S = sum(h * w for h, w in shapes)
    levels = tuple(range(len(shapes)))
    if call == "encoder_served":
        levels = tuple(l for l, (h, _) in enumerate(shapes) if h <= WINDOW)
    if call.startswith("encoder"):
        Q = S
        value, loc, aw = raster_inputs(shapes, dtype, seed, batch)
    else:
        Q = DECODER_Q
        value, loc, aw = msda_inputs(Q, S, dtype, seed, batch)
    return Q, levels, value, loc, aw


def check_q_kernel(shapes, bucket="serving"):
    """K4 against its plain version at every call of Q_CALLS on ``bucket``'s
    levels: within the float32 tolerance, bit-equal over two runs, timed by
    CUDA events and in a CUDA graph beside its bound."""
    S = sum(h * w for h, w in shapes)
    starts = msda.level_starts(shapes)
    rows = []
    for n, (call, batch, dtype) in enumerate(q_calls()):
        Q, levels, value, loc, aw = q_call_inputs(shapes, call, batch,
                                                  dtype, n)
        vq, scale = msda.quantize_levels(value, shapes)
        vq_cpu, scale_cpu = msda.quantize_levels(value.cpu(), shapes)
        if not (torch.equal(vq.cpu(), vq_cpu)
                and torch.equal(scale.cpu(), scale_cpu)):
            raise SystemExit(f"msda_fwd_q {call} {dtype}: the values "
                             "quantized on the card differ from those "
                             "quantized on the CPU")
        args = (vq, scale, shapes, loc, aw)
        fn = lambda: msda_cuda.msda_fwd_q(*args, levels=levels)
        kern, again = fn(), fn()
        plain = msda.msda_fwd_q_plain(*args, levels=levels)
        torch.cuda.synchronize()
        row = {"bucket": bucket, "call": call, "Q": Q, "batch": batch,
               "levels": list(levels), "dtype": str(dtype).split(".")[-1]}
        row["max_abs_err"], row["max_err_over_limit"] = _f32_err(kern, plain)
        row["bit_equal_run_to_run"] = torch.equal(kern, again)
        row["ms"] = cuda_ms(fn, 100)
        row["graph_ms"] = graph_ms(fn)
        row["plain_ms"] = cuda_ms(lambda: msda.msda_fwd_q_plain(
            *args, levels=levels), 5)
        # what the call must move: the summed levels' values, scales,
        # locations and weights, and the float32 output
        moved = [t for l in levels for t in (
            vq[:, starts[l]:starts[l] + shapes[l][0] * shapes[l][1]],
            scale[..., l], loc[:, :, :, l], aw[:, :, :, l])]
        row["bound_ms"], row["bound_by"] = bound(
            (*moved, kern), aw[:, :, :, :len(levels)])
        atol, rtol = TOL[torch.float32]
        print(f"msda_fwd_q {bucket} {call} Q={Q} B={batch} levels "
              f"{list(levels)} {row['dtype']} weights: max abs err "
              f"{row['max_abs_err']:.3e} (err/limit "
              f"{row['max_err_over_limit']:.3f}, atol {atol} rtol {rtol}), "
              f"bit-equal run to run {row['bit_equal_run_to_run']}; kernel "
              f"{row['ms']:.4f} ms (device {row['graph_ms']:.4f} ms in a CUDA "
              f"graph), plain {row['plain_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}); quantized "
              "values equal to the CPU's", flush=True)
        if not torch.isfinite(kern).all():
            raise SystemExit(f"msda_fwd_q {bucket} {call} {dtype}: "
                             "non-finite")
        if row["max_err_over_limit"] > 1.0:
            raise SystemExit(f"msda_fwd_q {bucket} {call} {dtype}: kernel "
                             "disagrees with the plain version")
        if not row["bit_equal_run_to_run"]:
            raise SystemExit(f"msda_fwd_q {bucket} {call} {dtype}: two runs "
                             "differ")
        rows.append(row)
    # the batch index of the kernel's addressing, on two mirrored images
    value, loc, aw = msda_inputs(200, S, torch.float32, seed=len(rows))
    value, loc, aw = (torch.cat([t, t.flip(1)]) for t in (value, loc, aw))
    vq, scale = msda.quantize_levels(value, shapes)
    _, over = _f32_err(msda_cuda.msda_fwd_q(vq, scale, shapes, loc, aw),
                       msda.msda_fwd_q_plain(vq, scale, shapes, loc, aw))
    print(f"msda_fwd_q {bucket} decoder batch 2: err/limit {over:.3f}",
          flush=True)
    if over > 1.0:
        raise SystemExit(f"msda_fwd_q {bucket} batch 2: kernel disagrees "
                         "with plain")
    return rows


BANDED = {"tile": ("msda_fwd_win", False), "point": ("msda_fwd_win_pp", True)}


def _banded_level_args(value, loc, aw, shapes, lid, per_point, int8):
    """The banded kernels' inputs for one level of an encoder call, as
    ``msda._windowed_forward`` makes them, and the clamped share."""
    S = loc.shape[1]
    h, w = shapes[lid]
    segs = segment_bounds(S, shapes)
    locT, awT = msda.rows_t(loc, aw)
    bidx, ix, iy_band, _, aw_eff, inband, in_img = msda.win_level_rows(
        locT, awT, lid, h, w, WINDOW, segs, D, per_point)
    source = value
    if int8:
        source, scale = msda.quantize_levels(value, shapes)
        aw_eff = aw_eff * scale[:, :, lid, None, None]
    start = msda.level_starts(shapes)[lid]
    clamped = 1.0 - inband.sum().item() / max(in_img.sum().item(), 1)
    return (source[:, start:start + h * w], bidx, ix, iy_band, aw_eff, h, w,
            WINDOW, segs, S), clamped


def broadcast_bands(bidx, P):
    """A tile band table [B, H, T] broadcast over P points, [B, H, P, T]:
    the per-point kernels' table for the same bands."""
    B, H_, T = bidx.shape
    return bidx[:, :, None, :].expand(B, H_, P, T).contiguous()


def check_win_kernels(shapes, bucket="serving"):
    """K5 and K6 against their plain version on the banded levels of the
    served encoder call on ``bucket``'s levels, K5 also against K6 on its
    tile bands broadcast over the points; one row per (band, value type),
    times summed over the levels (one launch each)."""
    banded = [l for l, (h, _) in enumerate(shapes) if h > WINDOW]
    rows = []
    for band, (name, per_point) in BANDED.items():
        kernel = getattr(msda_cuda, name)
        for form, dtype, int8 in (("float32", torch.float32, False),
                                  ("bfloat16", torch.bfloat16, False),
                                  ("int8", torch.bfloat16, True)):
            value, loc, aw = raster_inputs(shapes, dtype, seed=len(rows))
            row = {"bucket": bucket, "kernel": name, "band": band,
                   "dtype": form,
                   "levels": banded, "max_abs_err": 0.0,
                   "max_err_over_limit": 0.0, "ms": 0.0, "graph_ms": 0.0,
                   "plain_ms": 0.0, "bound_ms": 0.0, "ms_per_level": [],
                   "graph_ms_per_level": [], "clamped_share": [],
                   "bit_equal_run_to_run": True}
            if not per_point:
                row["bit_equal_to_k6_broadcast"] = True
            for lid in banded:
                args, clamped = _banded_level_args(value, loc, aw, shapes,
                                                   lid, per_point, int8)
                kern = kernel(*args)
                row["bit_equal_run_to_run"] &= torch.equal(kern,
                                                           kernel(*args))
                if not per_point:
                    # K5 is K6 with a band table whose point stride is 0
                    wide = broadcast_bands(args[1], args[2].shape[2])
                    row["bit_equal_to_k6_broadcast"] &= torch.equal(
                        kern, msda_cuda.msda_fwd_win_pp(args[0], wide,
                                                        *args[2:]))
                plain = msda.msda_fwd_win_plain(*args)
                torch.cuda.synchronize()
                if not torch.isfinite(kern).all():
                    raise SystemExit(f"{name} {bucket} {form} level {lid}: "
                                     "non-finite")
                err, over = _f32_err(kern, plain)
                row["max_abs_err"] = max(row["max_abs_err"], err)
                row["max_err_over_limit"] = max(row["max_err_over_limit"],
                                                over)
                ms = cuda_ms(lambda: kernel(*args), 100)
                row["ms"] += ms
                row["ms_per_level"].append(ms)
                ms = graph_ms(lambda: kernel(*args))
                row["graph_ms"] += ms
                row["graph_ms_per_level"].append(ms)
                row["plain_ms"] += cuda_ms(
                    lambda: msda.msda_fwd_win_plain(*args), 5)
                row["clamped_share"].append(clamped)
                level_ms, by = bound((*args[:5], kern), args[4])
                row["bound_ms"] += level_ms
                row["bound_by"] = by
            atol, rtol = TOL[torch.float32]
            print(f"{name} {bucket} encoder window {WINDOW} levels {banded} "
                  f"{form}: max abs err {row['max_abs_err']:.3e} (err/limit "
                  f"{row['max_err_over_limit']:.3f}, atol {atol} rtol {rtol}); "
                  f"kernel {row['ms']:.4f} ms "
                  f"({[round(m, 4) for m in row['ms_per_level']]} per level; "
                  f"device {row['graph_ms']:.4f} ms in a CUDA graph, "
                  f"{[round(m, 4) for m in row['graph_ms_per_level']]}), "
                  f"plain {row['plain_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}); bit-equal "
                  f"run to run {row['bit_equal_run_to_run']}"
                  + ("" if per_point else
                     "; bit-equal to msda_fwd_win_pp on the bands broadcast "
                     f"over the points {row['bit_equal_to_k6_broadcast']}")
                  + "; clamped share of the in-image samples per level "
                  f"{[round(c, 4) for c in row['clamped_share']]}", flush=True)
            if row["max_err_over_limit"] > 1.0:
                raise SystemExit(f"{name} {bucket} {form}: kernel disagrees "
                                 "with the plain version")
            if not row["bit_equal_run_to_run"]:
                raise SystemExit(f"{name} {bucket} {form}: two runs differ")
            if not row.get("bit_equal_to_k6_broadcast", True):
                raise SystemExit(f"{name} {bucket} {form}: differs from "
                                 "msda_fwd_win_pp on the tile bands "
                                 "broadcast over the points")
            rows.append(row)
        # the batch index of the kernel's addressing, on the middle level
        value, loc, aw = raster_inputs(shapes, torch.float32, seed=50)
        value, loc, aw = (torch.cat([t, t.flip(1)]) for t in (value, loc, aw))
        args, _ = _banded_level_args(value, loc.contiguous(), aw, shapes,
                                     banded[len(banded) // 2], per_point,
                                     False)
        _, over = _f32_err(kernel(*args), msda.msda_fwd_win_plain(*args))
        print(f"{name} {bucket} encoder batch 2 float32: err/limit "
              f"{over:.3f}", flush=True)
        if over > 1.0:
            raise SystemExit(f"{name} {bucket} batch 2: kernel disagrees "
                             "with plain")
    return rows


def _banded_bwd_args(value, loc, aw, g, shapes, lid, per_point):
    """The banded backward kernels' inputs for one level of an encoder
    call, as ``msda._windowed_backward`` makes them, and the clamped share
    of the in-image samples."""
    args, clamped = _banded_level_args(value, loc, aw, shapes, lid,
                                       per_point, False)
    return (*args[:5], g, *args[5:]), clamped


def check_bwd_win_kernels(shapes, batch):
    """K7 + K9 and K8 + K10 against their plain version on the banded
    levels of the adaptation's encoder call, K7 and K9 also against K8 and
    K10 on their tile bands broadcast over the points; one row per (band,
    dtype), times summed over the levels (one launch of each kernel per
    level)."""
    banded = [l for l, (h, _) in enumerate(shapes) if h > WINDOW]
    rows = []
    for band, (rows_name, value_name) in BANDED_BWD.items():
        per_point = band == "point"
        rows_kernel = getattr(msda_cuda, rows_name)
        value_kernel = getattr(msda_cuda, value_name)
        for dtype in (torch.float32, torch.bfloat16):
            value, loc, aw = raster_inputs(shapes, dtype, seed=400 + len(rows),
                                           batch=batch)
            g = torch.randn(value.shape[:2] + (H * D,), device=DEVICE,
                            generator=torch.Generator(device=DEVICE)
                            .manual_seed(len(rows))).to(dtype)
            # the layer's float32 value gradient, whose level slices the
            # value kernels add into (msda._windowed_backward)
            dvalue_layer = torch.zeros(value.shape, dtype=torch.float32,
                                       device=DEVICE)
            starts = msda.level_starts(shapes)
            row = {"rows_kernel": rows_name, "value_kernel": value_name,
                   "band": band, "dtype": str(dtype).split(".")[-1],
                   "batch": batch, "levels": banded,
                   "max_abs_err": {}, "max_err_over_limit": {},
                   "rows_ms": 0.0, "rows_graph_ms": 0.0, "value_ms": 0.0,
                   "value_graph_ms": 0.0,
                   "plain_ms": 0.0, "rows_bit_equal_run_to_run": True,
                   "rows_bound_ms": 0.0, "value_bound_ms": 0.0,
                   "value_run_to_run_max_abs_diff": 0.0,
                   "clamped_share": []}
            for lid in banded:
                args, clamped = _banded_bwd_args(value, loc, aw, g, shapes,
                                                 lid, per_point)
                dix, diy, daw = rows_kernel(*args)
                rows_again = rows_kernel(*args)
                dvalue = value_kernel(*args)
                again = value_kernel(*args)
                plain = msda.msda_bwd_win_plain(*args)
                torch.cuda.synchronize()
                for name, k, p in zip(("dvalue", "dix", "diy", "daw"),
                                      (dvalue, dix, diy, daw), plain):
                    if not torch.isfinite(k).all():
                        raise SystemExit(f"{rows_name}/{value_name} {dtype} "
                                         f"level {lid}: non-finite {name}")
                    err, over = _scaled_err(k, p, dtype)
                    row["max_abs_err"][name] = max(
                        row["max_abs_err"].get(name, 0.0), err)
                    row["max_err_over_limit"][name] = max(
                        row["max_err_over_limit"].get(name, 0.0), over)
                row["value_run_to_run_max_abs_diff"] = max(
                    row["value_run_to_run_max_abs_diff"],
                    (dvalue - again).abs().max().item())
                row["rows_bit_equal_run_to_run"] &= all(
                    torch.equal(a, b) for a, b in zip((dix, diy, daw),
                                                      rows_again))
                if not per_point:
                    # K7 and K9 are K8 and K10 with a band table whose point
                    # stride is 0: K7 bit-equal to K8 given the tile bands
                    # for every point, K9 up to the order of its adds
                    wide = broadcast_bands(args[1], args[2].shape[2])
                    wide_args = (args[0], wide, *args[2:])
                    as_k8 = msda_cuda.msda_bwd_win_rows_pp(*wide_args)
                    row["rows_bit_equal_to_k8_broadcast"] = row.get(
                        "rows_bit_equal_to_k8_broadcast", True) and all(
                        torch.equal(a, b)
                        for a, b in zip((dix, diy, daw), as_k8))
                    row["value_max_abs_diff_to_k10_broadcast"] = max(
                        row.get("value_max_abs_diff_to_k10_broadcast", 0.0),
                        (dvalue - msda_cuda.msda_bwd_win_value_pp(
                            *wide_args)).abs().max().item())
                row["rows_ms"] += cuda_ms(lambda: rows_kernel(*args), 50)
                row["rows_graph_ms"] += graph_ms(lambda: rows_kernel(*args))
                h, w = shapes[lid]
                into = dvalue_layer[:, starts[lid]:starts[lid] + h * w]
                row["value_ms"] += cuda_ms(
                    lambda: value_kernel(*args, out=into), 50)
                row["value_graph_ms"] += graph_ms(
                    lambda: value_kernel(*args, out=into))
                row["plain_ms"] += cuda_ms(
                    lambda: msda.msda_bwd_win_plain(*args), 3, warmup=1)
                row["clamped_share"].append(clamped)
                inputs = (*args[:5], g)
                ms, row["rows_bound_by"] = bound(
                    (*inputs, dix, diy, daw), args[4], FLOPS_ROWS)
                row["rows_bound_ms"] += ms
                ms, row["value_bound_by"] = bound(
                    (*inputs[1:], dvalue), args[4], FLOPS_VALUE)
                row["value_bound_ms"] += ms
            atol, rtol = BWD_TOL[dtype]
            print(f"{rows_name} + {value_name} adaptation encoder window "
                  f"{WINDOW} levels {banded} batch {batch} {row['dtype']}: "
                  f"max abs err {row['max_abs_err']} (err/limit "
                  f"{row['max_err_over_limit']}, atol {atol}*max|ref| rtol "
                  f"{rtol}); rows {row['rows_ms']:.4f} ms (device "
                  f"{row['rows_graph_ms']:.4f} ms in a CUDA graph, zeroed "
                  f"outputs included; bound {row['rows_bound_ms']:.4f} ms, "
                  f"{row['rows_bound_by']}; bit-equal run to run "
                  f"{row['rows_bit_equal_run_to_run']}"
                  + ("" if per_point else
                     "; bit-equal to msda_bwd_win_rows_pp on the bands "
                     "broadcast over the points "
                     f"{row['rows_bit_equal_to_k8_broadcast']}") + "), "
                  f"value {row['value_ms']:.4f} ms (device "
                  f"{row['value_graph_ms']:.4f} ms in a CUDA graph, into the "
                  f"layer gradient's slice; bound {row['value_bound_ms']:.4f} "
                  f"ms, {row['value_bound_by']}), "
                  f"plain {row['plain_ms']:.4f} ms; value run-to-run max abs "
                  f"diff {row['value_run_to_run_max_abs_diff']:.3e}"
                  + ("" if per_point else
                     "; value max abs diff to msda_bwd_win_value_pp on the "
                     "bands broadcast over the points "
                     f"{row['value_max_abs_diff_to_k10_broadcast']:.3e}")
                  + "; clamped "
                  f"share per level "
                  f"{[round(c, 4) for c in row['clamped_share']]}", flush=True)
            if max(row["max_err_over_limit"].values()) > 1.0:
                raise SystemExit(f"{rows_name}/{value_name} {dtype}: kernels "
                                 "disagree with the plain version")
            if not row["rows_bit_equal_run_to_run"]:
                raise SystemExit(f"{rows_name} {dtype}: two runs differ")
            if not row.get("rows_bit_equal_to_k8_broadcast", True):
                raise SystemExit(f"{rows_name} {dtype}: differs from "
                                 "msda_bwd_win_rows_pp on the tile bands "
                                 "broadcast over the points")
            rows.append(row)
        # the batch index of the kernels' addressing, on the middle level
        value, loc, aw = raster_inputs(shapes, torch.float32, seed=450)
        g = torch.randn(value.shape[:2] + (H * D,), device=DEVICE)
        value, loc, aw, g = (torch.cat([t, t.flip(1)])
                             for t in (value, loc, aw, g))
        args, _ = _banded_bwd_args(value, loc.contiguous(), aw, g, shapes,
                                   banded[len(banded) // 2], per_point)
        got = (value_kernel(*args), *rows_kernel(*args))
        over = max(_scaled_err(k, p, torch.float32)[1]
                   for k, p in zip(got, msda.msda_bwd_win_plain(*args)))
        print(f"{rows_name} + {value_name} adaptation encoder batch 2 "
              f"float32: err/limit {over:.3f}", flush=True)
        if over > 1.0:
            raise SystemExit(f"{rows_name}/{value_name} batch 2: kernels "
                             "disagree with plain")
    return rows


def _bp_row(label, kern, plain, same, same_name, timed, same_timed, bound_of,
            routed):
    """One K11 call held to its plain version (float32 sums on both sides
    for the float32 and int8 forms; one bf16 rounding of the output for the
    bf16 form) and beside K1 / K4 on the same inputs: bit for bit where the
    form runs that kernel (``routed``: ``msda_cuda.BP_ROUTES``), else the
    same products folded over the points in another order, within the same
    limit."""
    torch.cuda.synchronize()
    if not torch.isfinite(kern.float()).all():
        raise SystemExit(f"msda_fwd_bp {label}: non-finite output")
    dtype = kern.dtype if kern.dtype == torch.bfloat16 else torch.float32
    atol, rtol = TOL[dtype]
    err = (kern.float() - plain.float()).abs()
    over = (err / (atol + rtol * plain.float().abs())).max().item()
    diff = (kern.float() - same.float()).abs()
    same_over = (diff / (atol + rtol * same.float().abs())).max().item()
    row = {"call": label, "max_abs_err": err.max().item(),
           "max_err_over_limit": over, "routed_to": same_name if routed
           else "msda_fwd_bp",
           f"{same_name}_max_abs_diff": diff.max().item(),
           f"{same_name}_diff_over_limit": same_over,
           f"bit_equal_to_{same_name}": torch.equal(kern, same),
           "ms": cuda_ms(timed, 100), f"ms_{same_name}_same_call":
               cuda_ms(same_timed, 100)}
    row["bound_ms"], row["bound_by"] = bound_of(kern)
    print(f"msda_fwd_bp {label}: runs {row['routed_to']}; max abs err "
          f"{row['max_abs_err']:.3e} (err/limit {over:.3f}, atol {atol} rtol "
          f"{rtol}); against {same_name} on the same inputs max abs diff "
          f"{row[f'{same_name}_max_abs_diff']:.3e} (over the same limit "
          f"{same_over:.3f}), bit-equal "
          f"{row[f'bit_equal_to_{same_name}']}; kernel {row['ms']:.4f} ms, "
          f"{same_name} {row[f'ms_{same_name}_same_call']:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
    if over > 1.0 or same_over > 1.0:
        raise SystemExit(f"msda_fwd_bp {label}: kernel disagrees with the "
                         f"plain version or with {same_name}")
    if routed and not row[f"bit_equal_to_{same_name}"]:
        raise SystemExit(f"msda_fwd_bp {label}: runs {same_name}'s kernel "
                         f"but is not bit-equal to {same_name}")
    return row


def _unaligned(t):
    """``t``'s values in a tensor whose storage starts one element past an
    allocation: a pointer that takes only the narrowest loads."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def check_bp_kernel(shapes, train_shapes, batch=2):
    """K11 against its plain version and beside K1 (K4 for the int8 form)
    at the serving and training calls (encoder Q = S, decoder Q = 200) in
    float32 and bfloat16, at a batch of 2; the int8 form on the served
    encoder call's exact level 3 and on the decoder call; the float form on
    a windowed call's exact level (float32 out); the bfloat16 and int8 forms
    on the serving decoder call at three points a level and on values one
    element off their allocation. The bfloat16 and int8 forms run K1's and
    K4's kernels and must give their bits."""
    rows = []

    def float_row(label, value, shp, loc, aw, moved, samples, **kw):
        """``moved``: what the call reads; ``samples``: one weight a summed
        sample."""
        args = (value, shp, loc, aw)
        return _bp_row(
            label, msda_cuda.msda_fwd_bp(*args, **kw),
            msda.msda_fwd_bp_plain(*args, **kw),
            msda_cuda.msda_fwd(*args, **kw), "msda_fwd",
            lambda: msda_cuda.msda_fwd_bp(*args, **kw),
            lambda: msda_cuda.msda_fwd(*args, **kw),
            lambda out: bound((*moved, out), samples),
            msda_cuda.BP_ROUTES[value.dtype] == "msda_fwd") | {
                "plain_ms": cuda_ms(
                    lambda: msda.msda_fwd_bp_plain(*args, **kw), 5)}

    def int8_row(label, vq, scale, loc, aw, levels, moved, samples):
        args = (vq, shapes, loc, aw)
        kw = dict(levels=levels, scale=scale)
        return _bp_row(
            label, msda_cuda.msda_fwd_bp(*args, **kw),
            msda.msda_fwd_bp_plain(*args, **kw),
            msda_cuda.msda_fwd_q(vq, scale, shapes, loc, aw, levels=levels),
            "msda_fwd_q", lambda: msda_cuda.msda_fwd_bp(*args, **kw),
            lambda: msda_cuda.msda_fwd_q(vq, scale, shapes, loc, aw,
                                         levels=levels),
            lambda out: bound((*moved, out), samples),
            msda_cuda.BP_ROUTES[vq.dtype] == "msda_fwd_q") | {
                "plain_ms": cuda_ms(
                    lambda: msda.msda_fwd_bp_plain(*args, **kw), 5)}

    for bucket, shp in (("serving", shapes), ("training", train_shapes)):
        S = sum(h * w for h, w in shp)
        for call, Q in (("encoder", S), ("decoder", DECODER_Q)):
            for dtype in (torch.float32, torch.bfloat16):
                value, loc, aw = msda_inputs(Q, S, dtype, seed=500 + len(rows),
                                             batch=batch)
                row = float_row(
                    f"{bucket} {call} Q={Q} {str(dtype)[6:]} batch {batch}",
                    value, shp, loc, aw, (value, loc, aw), aw)
                row.update(bucket=bucket, Q=Q, form=str(dtype)[6:])
                rows.append(row)
    S = sum(h * w for h, w in shapes)
    exact = tuple(l for l, (h, _) in enumerate(shapes) if h <= WINDOW)
    starts = msda.level_starts(shapes)

    def moved_levels(values, levels, *per_level):
        """What a call on ``levels`` reads: those levels' values and the
        level slices of ``per_level`` (scales, locations, weights)."""
        return [t for l in levels for t in (
            values[:, starts[l]:starts[l] + shapes[l][0] * shapes[l][1]],
            *(x[..., l] if x.dim() == 3 else x[:, :, :, l]
              for x in per_level))]

    for call, Q, levels in (("encoder_served", S, exact),
                            ("decoder", DECODER_Q,
                             tuple(range(len(shapes))))):
        if Q == S:
            value, loc, aw = raster_inputs(shapes, torch.bfloat16,
                                           seed=600 + len(rows), batch=batch)
        else:
            value, loc, aw = msda_inputs(Q, S, torch.bfloat16,
                                         seed=600 + len(rows), batch=batch)
        vq, scale = msda.quantize_levels(value, shapes)
        row = int8_row(
            f"serving {call} Q={Q} levels {list(levels)} int8 batch {batch}",
            vq, scale, loc, aw, levels,
            moved_levels(vq, levels, scale, loc, aw),
            aw[:, :, :, :len(levels)])
        row.update(bucket="serving", Q=Q, form="int8", levels=list(levels))
        rows.append(row)
    # a windowed call's exact level (band="tile"), float32 out
    value, loc, aw = raster_inputs(shapes, torch.bfloat16, seed=700,
                                   batch=batch)
    row = float_row(
        f"serving encoder_windowed Q={S} levels {list(exact)} bfloat16, "
        f"float32 out, batch {batch}", value, shapes, loc, aw,
        moved_levels(value, exact, loc, aw), aw[:, :, :, :len(exact)],
        levels=exact, out_dtype=torch.float32)
    row.update(bucket="serving", Q=S, form="bfloat16_f32_out",
               levels=list(exact))
    rows.append(row)
    # the routed forms where K11's own lane split took no call: three
    # points a level, and values one element off their allocation
    for label, points, shift in (("P=3", 3, False), ("unaligned", P, True)):
        value, loc, aw = msda_inputs(DECODER_Q, S, torch.bfloat16,
                                     seed=710 + len(rows), batch=batch,
                                     points=points)
        vq, scale = msda.quantize_levels(value, shapes)
        if shift:
            value, vq = _unaligned(value), _unaligned(vq)
        row = float_row(f"serving decoder Q={DECODER_Q} {label} bfloat16 "
                        f"batch {batch}", value, shapes, loc, aw,
                        (value, loc, aw), aw)
        row.update(bucket="serving", Q=DECODER_Q, form=f"bfloat16 {label}")
        rows.append(row)
        row = int8_row(f"serving decoder Q={DECODER_Q} {label} int8 batch "
                       f"{batch}", vq, scale, loc, aw, None,
                       (vq, scale, loc, aw), aw)
        row.update(bucket="serving", Q=DECODER_Q, form=f"int8 {label}")
        rows.append(row)
    return rows


# the banded backward kernels (rows, value) per band
BANDED_BWD = {"tile": ("msda_bwd_win_rows", "msda_bwd_win_value"),
              "point": ("msda_bwd_win_rows_pp", "msda_bwd_win_value_pp")}


# the hand-written kernels' __global__ functions, by the wrapper that
# launches each: a banded kernel serves both forms of its pair, told apart
# by its last template argument (PER_POINT); K11's bfloat16 and int8 forms
# run K1's and K4's kernels (msda_cuda.BP_ROUTES), so a trace counts them
# under msda_fwd and msda_fwd_q (``kernel_counts(batch_p=True)``)
DEVICE_KERNELS = {
    "msda_fwd_kernel": "msda_fwd", "msda_fwd_q_kernel": "msda_fwd_q",
    "msda_fwd_bp_kernel": "msda_fwd_bp",
    "msda_bwd_rows_kernel": "msda_bwd_rows",
    "msda_bwd_value_kernel": "msda_bwd_value",
    "lsap_warp_kernel": "lsap", "lsap_cluster_kernel": "lsap",
    "msda_fwd_win_kernel": ("msda_fwd_win", "msda_fwd_win_pp"),
    "msda_bwd_win_rows_kernel": ("msda_bwd_win_rows",
                                 "msda_bwd_win_rows_pp"),
    "msda_bwd_win_value_kernel": ("msda_bwd_win_value",
                                  "msda_bwd_win_value_pp"),
    "frozen_bn_kernel": "frozen_bn"}


def kernel_of(key):
    """The wrapper whose kernel a profiler row names (``DEVICE_KERNELS``),
    or None for any other kernel."""
    for found in re.finditer(r"\b(\w+_kernel)\b(?:<([^<>]*)>)?", key):
        name = DEVICE_KERNELS.get(found.group(1))
        if isinstance(name, tuple):
            per_point = (found.group(2) or "").split(",")[-1].strip()
            if per_point not in ("true", "false"):
                raise ValueError(f"{key!r}: no PER_POINT argument")
            return name[per_point == "true"]
        if name is not None:
            return name
    return None


# the kernels NCCL launches for a collective: its collective kernels
# (``ncclDevKernel_AllReduce_...``) and, in a group of one rank, the kernel
# that scales the values of a mean (``oneRankReduce``)
NCCL_KERNEL = re.compile(r"nccl|onerank", re.IGNORECASE)


class CardLaunches:
    """The hand-written kernels' launches on the card, measured: a
    torch.profiler trace of the card's activity, which sees each kernel that
    a graph replay runs, counted by kernel (``kernel_of``); NCCL's kernels
    by name in ``collectives``. ``pause`` ends the trace so far and counts
    it, so that another profiler may run; ``resume`` starts the next;
    ``add`` counts another's finished trace."""

    def __init__(self):
        self.counts = dict.fromkeys(
            msda_cuda.KERNELS + msda_cuda.MATCHER_KERNELS
            + msda_cuda.BACKBONE_KERNELS, 0)
        self.collectives = {}
        self._prof = None

    def resume(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()

    def pause(self):
        if self._prof is not None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self._prof.stop()
            self.add(self._prof)
            self._prof = None
            TRACE_COST["traces"] += 1
            TRACE_COST["seconds"] += time.perf_counter() - t0

    def add(self, prof):
        # the raw events: no per-event Python objects, no averaging
        for e in prof.profiler.kineto_results.events():
            if e.device_type().name == "CUDA":
                name = kernel_of(e.name())
                if name is not None:
                    self.counts[name] += 1
                elif NCCL_KERNEL.search(e.name()):
                    self.collectives[e.name()] = (
                        self.collectives.get(e.name(), 0) + 1)


# what reading the traces cost (their stop and count), over the run
TRACE_COST = {"traces": 0, "seconds": 0.0}


_meter = None


def measured() -> bool:
    """Whether this process counts launches on the card (``CardLaunches``)
    rather than by wrapper: one process on a card, where requests and steps
    replay captured programs. A rank measures where it asks to
    (``reset_kernel_counts(on_card=True)``): where its programs replay."""
    return torch.device(DEVICE).type == "cuda" and not dist.is_distributed()


def reset_kernel_counts(on_card=None):
    """Every count to 0 and, where ``on_card`` (default ``measured()``) and
    the device is a card, a new measurement on the card, which the next
    ``kernel_counts``, ``matcher_launches`` or ``collective_launches``
    ends."""
    global _meter
    msda_cuda.reset_launches()
    if _meter is not None:
        _meter.pause()
    _meter = None
    if measured() if on_card is None else (
            on_card and torch.device(DEVICE).type == "cuda"):
        _meter = CardLaunches()
        _meter.resume()


def _counts(batch_p=False):
    if _meter is None:
        if measured():
            raise RuntimeError("kernel counts read without "
                               "reset_kernel_counts")
        return dict(msda_cuda.launches)
    _meter.pause()
    counts = dict(_meter.counts)
    if batch_p:
        # every exact forward went through K11, whose bfloat16 and int8
        # forms the trace counts under their routes; the wrappers show that
        # no K1 or K4 call of their own was among them
        direct = {k: msda_cuda.launches[k] for k in ("msda_fwd",
                                                     "msda_fwd_q")}
        if any(direct.values()):
            raise SystemExit(f"batch_p run: K1/K4 called directly {direct}")
        for route in direct:
            counts["msda_fwd_bp"] += counts.pop(route)
            counts[route] = 0
    return counts


def collective_launches():
    """NCCL's kernels by name since ``reset_kernel_counts``, measured on
    the card (empty where nothing is measured)."""
    if _meter is None:
        return {}
    _meter.pause()
    return dict(_meter.collectives)


def kernel_counts(batch_p=False):
    """The MSDA kernels' launches since ``reset_kernel_counts``: on the card
    measured (``CardLaunches``), replays included, else the wrappers'
    counts; with ``batch_p`` (a run with the flag on) K11's launches
    include those the trace counts under its routes (the matcher's:
    ``matcher_launches``)."""
    counts = _counts(batch_p)
    return {k: counts[k] for k in msda_cuda.KERNELS}


def matcher_launches():
    return _counts()["lsap"]


def backbone_launches():
    """The trunk's frozen-BN epilogue kernel's launches since
    ``reset_kernel_counts``, counted as ``kernel_counts`` counts."""
    return _counts()["frozen_bn"]


def fbn_sites(cfg):
    """The frozen-BN epilogue sites of the trunk of a model of ``cfg``: its
    ``frozen_bn`` launches an inference forward on the card."""
    from egtr_tpu_torch.models import epilogue_sites

    return epilogue_sites.sites_per_forward(cfg.backbone_blocks)


def matches_per_pass(cfg):
    """Hungarian matches per criterion pass (a microbatch of a train step,
    or an evaluation batch's loss): the last layer's, one per earlier
    decoder layer with auxiliary losses, one for the two-stage proposals."""
    return (1 + (cfg.decoder_layers - 1) * int(cfg.auxiliary_loss)
            + int(cfg.two_stage))


def forward_counts(cfg, shapes, batch_p=False):
    """Launches per model forward, from how ``msda.ms_deform_attn`` splits a
    call: per encoder layer one launch per banded level and one for the
    exact levels together; per decoder layer one launch over all levels.
    With ``batch_p`` K11 takes every launch of K1 or K4."""
    n_banded = sum(h > cfg.msda_window for h, _ in shapes) if (
        cfg.msda_window) else 0
    counts = dict.fromkeys(msda_cuda.KERNELS, 0)
    exact = ("msda_fwd_bp" if batch_p else
             "msda_fwd_q" if cfg.msda_int8 else "msda_fwd")
    counts[exact] = (cfg.encoder_layers * int(n_banded < len(shapes))
                     + cfg.decoder_layers)
    counts[BANDED[cfg.msda_band][0]] += cfg.encoder_layers * n_banded
    return counts


def step_counts(cfg, shapes, batch_p=False):
    """Launches per microbatch of a train step: the forward's and the
    backward's, which ``msda._windowed_backward`` splits the same way (per
    encoder layer one launch each of the banded rows and value kernels per
    banded level and one each of K2 and K3 for the exact levels together;
    per decoder layer one each of K2 and K3). The backward does not read
    ``batch_p``."""
    counts = forward_counts(cfg, shapes, batch_p)
    n_banded = sum(h > cfg.msda_window for h, _ in shapes) if (
        cfg.msda_window) else 0
    exact_calls = (cfg.encoder_layers * int(n_banded < len(shapes))
                   + cfg.decoder_layers)
    counts["msda_bwd_rows"] += exact_calls
    counts["msda_bwd_value"] += exact_calls
    for name in BANDED_BWD[cfg.msda_band]:
        counts[name] += cfg.encoder_layers * n_banded
    if cfg.use_remat and cfg.remat_policy == "full":
        # the backward recomputes every layer, its MSDA forward included
        for name, n in forward_counts(cfg, shapes, batch_p).items():
            counts[name] += n
    return counts


def serve(cfg, label, n_requests):
    """The main path: requests through infer.infer at full width."""
    model, x = infer.build(cfg, 1, *infer.BUCKET_HW, seed=0)
    reset_kernel_counts()
    times, packed = infer.time_requests(model, x, n_requests, warmup=2)
    with torch.inference_mode():
        out = model(x)
    torch.cuda.synchronize()
    counts = {**kernel_counts(), "frozen_bn": backbone_launches()}
    forwards = n_requests + 2 + 1
    per_forward = {**forward_counts(
        cfg, level_shapes(infer.BUCKET_HW, cfg.num_feature_levels)),
        "frozen_bn": fbn_sites(cfg)}
    Q, C, R = cfg.num_queries, cfg.num_labels, cfg.num_rel_labels
    k = min(100, Q * Q)
    expect = {"logits": (1, Q, C), "pred_boxes": (1, Q, 4),
              "pred_rel": (1, Q, Q, R), "pred_connectivity": (1, Q, Q, 1)}
    for key, shape in expect.items():
        if tuple(out[key].shape) != shape:
            raise SystemExit(f"{key}: shape {tuple(out[key].shape)} != {shape}")
        if not torch.isfinite(out[key]).all():
            raise SystemExit(f"{key}: non-finite values")
    n_packed = 3 * k + k + 2 * k + k * R + Q + Q + 4 * Q
    if packed.shape != (n_packed,) or not torch.isfinite(packed).all():
        raise SystemExit(f"packed output: shape {tuple(packed.shape)} "
                         f"(expected {n_packed}) or non-finite values")
    hw = "x".join(map(str, infer.BUCKET_HW))
    launched = {k: v for k, v in counts.items() if v}
    print(f"serve {label} (window {cfg.msda_window}, band {cfg.msda_band}, "
          f"int8 {cfg.msda_int8}) {cfg.compute_dtype} {hw} b1: {n_requests} "
          f"requests, ms/request mean "
          f"{sum(times) / len(times):.3f} min {min(times):.3f} max "
          f"{max(times):.3f}; launches {launched} over {forwards} forwards",
          flush=True)
    for name, n in counts.items():
        if n != per_forward[name] * forwards:
            raise SystemExit(f"serve {label}: {name} launched {n} times, "
                             f"expected {per_forward[name] * forwards} "
                             f"({per_forward[name]} per forward)")
    return counts, times, model, x


def time_side_by_side(models, x, rounds):
    """Requests of several configurations in turns (one request each per
    round), so that a slow spell of the host falls on all of them: ms per
    request from CUDA events, per label."""
    times = {label: [] for label in models}
    for _ in range(rounds):
        for label, model in models.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            infer.infer(model, x)
            end.record()
            end.synchronize()
            times[label].append(start.elapsed_time(end))
    return times


def plain_copy(model, cfg, device):
    """The same weights in a model whose MSDA takes the kernels' plain
    versions on any device."""
    copy = EgtrModel(cfg)
    copy.load_state_dict(model.state_dict(), strict=True)
    for module in copy.modules():
        if isinstance(module, MSDeformableAttention):
            module.msda_impl = "plain"
    return copy.to(device)


def bands_vs_cpu(model, cfg, x, out, bands):
    """The card's band picks against the CPU's (open check F1): the same
    float32 weights and input through the plain path on the CPU, whose
    ``window_rows`` sums each band's weighted mean in its own order. Returns
    (the ``bidx`` that differ from the card's ``bands``, how many there are,
    the largest |card - CPU| of the outputs: the flips' effect on top of the
    round-off of two devices)."""
    host = plain_copy(model, cfg, "cpu").eval()
    msda.band_index_log = []
    try:
        with torch.inference_mode():
            out_h = host(x.cpu())
    finally:
        bands_h = msda.band_index_log
        msda.band_index_log = None
    differing = sum(int((a.cpu() != b).sum())
                    for (_, a), (_, b) in zip(bands, bands_h))
    total = sum(a.numel() for _, a in bands)
    deltas = {k: (out[k].float().cpu() - out_h[k].float()).abs().max().item()
              for k in ("logits", "pred_boxes", "pred_rel")}
    return differing, total, deltas


def compare_f32(cfg, label, limit, cpu=False):
    """Same float32 weights, kernel path against the plain-MSDA path, and
    the kernel path again with ``batch_p`` (K11 for K1 / K4); ``cpu``: also
    the card's band picks and outputs against the CPU's (``bands_vs_cpu``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg.replace(compute_dtype="float32")
    model_k, x = infer.build(cfg, 1, *infer.BUCKET_HW, seed=0)
    _noise_msda_heads(model_k, x.device)
    model_p = plain_copy(model_k, cfg, x.device).eval()
    shapes = level_shapes(infer.BUCKET_HW, cfg.num_feature_levels)
    per_forward = forward_counts(cfg, shapes)
    outs, bands = [], []
    for model, expect, batch_p in (
            (model_k, per_forward, False),
            (model_p, dict.fromkeys(per_forward, 0), False),
            (model_k, forward_counts(cfg, shapes, batch_p=True), True)):
        reset_kernel_counts()
        msda.band_index_log = []
        old_flag, msda.FWD_BATCH_P = msda.FWD_BATCH_P, batch_p
        try:
            with torch.inference_mode():
                outs.append(model(x))
        finally:
            msda.FWD_BATCH_P = old_flag
            bands.append(msda.band_index_log)
            msda.band_index_log = None
        if kernel_counts(batch_p) != expect:
            raise SystemExit(f"f32 {label} (batch_p {batch_p}) launches "
                             f"{kernel_counts(batch_p)}, expected {expect}")
    out_k, out_p, out_bp = outs
    differing = sum(int((a != b).sum()) for (_, a), (_, b) in zip(*bands[:2]))
    total = sum(a.numel() for _, a in bands[0])
    # two stages: the proposals the decoder starts from, compared first
    proposals = {label: int((o["proposal_indices"]
                             != out_p["proposal_indices"]).sum())
                 for label, o in (("kernels", out_k), ("batch_p", out_bp))
                 } if cfg.two_stage else {}
    errs, errs_bp = {}, {}
    for key in ("logits", "pred_boxes", "pred_rel"):
        errs[key] = (out_k[key] - out_p[key]).abs().max().item()
        errs_bp[key] = (out_bp[key] - out_p[key]).abs().max().item()
    print(f"model f32 {label} kernels vs plain MSDA: max abs err {errs} "
          f"(atol {limit}); {differing} of {total} band indices differ; "
          f"with batch_p (K11) vs plain: {errs_bp}"
          + (f"; proposal indices differing from the plain path's "
             f"{proposals} of {out_p['proposal_indices'].numel()}"
             if proposals else ""), flush=True)
    if max(errs.values()) > limit or max(errs_bp.values()) > limit or not all(
            torch.isfinite(o[k]).all() for o in (out_k, out_bp)
            for k in errs) or any(proposals.values()):
        raise SystemExit(f"float32 {label} model: kernel path disagrees with "
                         "plain")
    if proposals:
        errs["proposal_indices_differing"] = proposals
    errs["band_indices_differing"] = differing
    errs["band_indices"] = total
    errs["batch_p"] = errs_bp
    if cpu:
        flips, n, deltas = bands_vs_cpu(model_k, cfg, x, out_k, bands[0])
        print(f"model f32 {label} card vs CPU (F1): {flips} of {n} band "
              f"indices differ; largest output delta card - CPU {deltas}",
              flush=True)
        if not all(math.isfinite(v) for v in deltas.values()):
            raise SystemExit(f"float32 {label} model on the CPU: {deltas}")
        errs["cpu_band_indices_differing"] = flips
        errs["cpu_max_abs_delta"] = deltas
    return errs


def serve_batch_p(models, x):
    """The served forward with the flag on (what EGTR_MSDA_BATCH_P=1 sets
    at import): one request of each configuration through ``infer.infer``
    and one forward, K11 in place of every K1 / K4 launch; the outputs bit
    for bit those of the same model's flag-off forward on the same input,
    since K11's bfloat16 and int8 forms run K1's and K4's kernels."""
    results = {}
    shapes = level_shapes(infer.BUCKET_HW, 4)
    for label, model in models.items():
        cfg = model.config
        with torch.inference_mode():
            off = model(x)
        reset_kernel_counts()
        old_flag, msda.FWD_BATCH_P = msda.FWD_BATCH_P, True
        try:
            packed = infer.infer(model, x)
            with torch.inference_mode():
                on = model(x)
            torch.cuda.synchronize()
        finally:
            msda.FWD_BATCH_P = old_flag
        counts = kernel_counts(batch_p=True)
        per_forward = forward_counts(cfg, shapes, batch_p=True)
        keys = ("logits", "pred_boxes", "pred_rel")
        errs = {k: (on[k].float() - off[k].float()).abs().max().item()
                for k in keys}
        equal = all(torch.equal(on[k], off[k]) for k in keys)
        print(f"serve {label} with batch_p: launches per forward "
              f"{ {k: v // 2 for k, v in counts.items() if v} }; outputs "
              f"bit-equal to the flag-off forward {equal} (max abs diff "
              f"{errs})", flush=True)
        for name, n in counts.items():
            if n != 2 * per_forward[name]:
                raise SystemExit(f"serve {label} with batch_p: {name} "
                                 f"launched {n} times in 2 forwards, "
                                 f"expected {2 * per_forward[name]}")
        if not torch.isfinite(packed).all() or not equal:
            raise SystemExit(f"serve {label} with batch_p: outputs differ "
                             "from the flag-off forward")
        results[label] = {"counts": counts, "max_abs_diff": errs,
                          "bit_equal_flag_off": equal}
    return results


def _scaled_err(got, ref, dtype):
    """Largest |got - ref| over the limit atol*max|ref| + rtol*|ref|."""
    atol, rtol = BWD_TOL[dtype]
    ref = ref.float()
    err = (got.float() - ref).abs()
    limit = atol * max(1.0, ref.abs().max().item()) + rtol * ref.abs()
    return err.max().item(), (err / limit).max().item()


def _bwd_row(bucket, call, Q, value, shapes, loc, aw, g):
    """K2 and K3 at one call: held to the plain backward, K2 bit-equal over
    two runs, both timed beside the plain backward and the autograd
    backward of the grid_sample composite."""
    args = (value, shapes, loc, aw, g)
    dtype = value.dtype
    dloc, daw = msda_cuda.msda_bwd_rows(*args)
    dloc2, daw2 = msda_cuda.msda_bwd_rows(*args)
    dvalue = msda_cuda.msda_bwd_value(*args)
    again = msda_cuda.msda_bwd_value(*args)
    pv, pl, pa = msda.ms_deform_attn_plain_bwd(*args)
    leaves = [t.detach().clone().requires_grad_() for t in (value, loc, aw)]
    composite = composite_msda(leaves[0], shapes, leaves[1], leaves[2])
    torch.cuda.synchronize()
    errs = {n: _scaled_err(k, p, dtype) for n, k, p in (
        ("dvalue", dvalue, pv), ("dloc", dloc, pl), ("daw", daw, pa))}
    row = {
        "bucket": bucket, "call": call, "Q": Q, "batch": value.shape[0],
        "dtype": str(dtype).split(".")[-1],
        "max_abs_err": {n: e[0] for n, e in errs.items()},
        "max_err_over_limit": {n: e[1] for n, e in errs.items()},
        "rows_bit_equal_run_to_run": torch.equal(dloc, dloc2)
        and torch.equal(daw, daw2),
        "value_run_to_run_max_abs_diff":
            (dvalue.float() - again.float()).abs().max().item(),
        "rows_ms": cuda_ms(lambda: msda_cuda.msda_bwd_rows(*args), 50),
        "rows_graph_ms": graph_ms(lambda: msda_cuda.msda_bwd_rows(*args)),
        "value_ms": cuda_ms(lambda: msda_cuda.msda_bwd_value(*args), 50),
        "value_graph_ms": graph_ms(lambda: msda_cuda.msda_bwd_value(*args)),
        # the plain backward computes all three gradients in one call
        "plain_ms": cuda_ms(lambda: msda.ms_deform_attn_plain_bwd(*args), 3,
                            warmup=1),
        # the composite's autograd backward computes all three too (K2 + K3)
        "library_composite_ms": cuda_ms(lambda: torch.autograd.grad(
            composite, leaves, g, retain_graph=True), 5, warmup=1),
    }
    row["rows_bound_ms"], row["rows_bound_by"] = bound(
        (value, loc, aw, g, dloc, daw), aw, FLOPS_ROWS)
    row["value_bound_ms"], row["value_bound_by"] = bound(
        (loc, aw, g, dvalue), aw, FLOPS_VALUE)
    row["rows_gather_bytes"] = gather_bytes(aw, value)
    row["rows_gather_GBps_L2"] = row["rows_gather_bytes"] / row["rows_ms"] / 1e6
    atol, rtol = BWD_TOL[dtype]
    print(f"msda_bwd {bucket} {call} Q={Q} B={row['batch']} {row['dtype']}: "
          f"max abs "
          f"err {row['max_abs_err']} (err/limit "
          f"{row['max_err_over_limit']}, atol {atol}*max|ref| rtol "
          f"{rtol}); rows {row['rows_ms']:.4f} ms (device "
          f"{row['rows_graph_ms']:.4f} ms in a CUDA graph; bound "
          f"{row['rows_bound_ms']:.4f} ms, {row['rows_bound_by']}; corner "
          f"gathers {row['rows_gather_bytes'] / 1e6:.1f} MB, "
          f"{row['rows_gather_GBps_L2']:.0f} GB/s of L2 gather traffic, not a "
          f"roofline share; bit-equal run to run "
          f"{row['rows_bit_equal_run_to_run']}), value "
          f"{row['value_ms']:.4f} ms (device {row['value_graph_ms']:.4f} ms "
          f"in a CUDA graph, zeroing and cast included; bound "
          f"{row['value_bound_ms']:.4f} ms, {row['value_bound_by']}), plain "
          f"backward {row['plain_ms']:.4f} "
          f"ms, grid_sample composite's backward "
          f"{row['library_composite_ms']:.4f} ms; value kernel run-to-run "
          f"max abs diff {row['value_run_to_run_max_abs_diff']:.3e}",
          flush=True)
    for t in (dvalue, dloc, daw):
        if not torch.isfinite(t.float()).all():
            raise SystemExit(f"msda_bwd {call} {dtype}: non-finite")
    if max(row["max_err_over_limit"].values()) > 1.0:
        raise SystemExit(f"msda_bwd {call} {dtype}: kernels disagree "
                         "with the plain backward")
    if not row["rows_bit_equal_run_to_run"]:
        raise SystemExit(f"msda_bwd_rows {call} {dtype}: two runs differ")
    return row


def check_bwd_kernels(shapes, bucket):
    """K2 and K3 against the plain backward at every call of EXACT_CALLS in
    the training bucket."""
    S = sum(h * w for h, w in shapes)
    rows = []
    for n, (call, batch, dtype) in enumerate(exact_calls()):
        seed = (150 if call == "encoder_raster" else 100) + n
        Q, value, loc, aw = exact_call_inputs(shapes, call, batch, dtype,
                                              seed)
        g = grad_output(batch, Q, dtype, n)
        rows.append(_bwd_row(bucket, call, Q, value, shapes, loc, aw, g))
    # the batch index of the kernels' addressing, on two mirrored images
    value, loc, aw = msda_inputs(200, S, torch.float32, seed=200)
    g = torch.randn((1, 200, H * D), device=DEVICE)
    value, loc, aw, g = (torch.cat([t, t.flip(1)]) for t in (value, loc, aw, g))
    got = msda_cuda.msda_bwd(value, shapes, loc, aw, g)
    ref = msda.ms_deform_attn_plain_bwd(value, shapes, loc, aw, g)
    over = max(_scaled_err(k, p, torch.float32)[1] for k, p in zip(got, ref))
    print(f"msda_bwd {bucket} decoder batch 2 float32: err/limit {over:.3f}",
          flush=True)
    if over > 1.0:
        raise SystemExit("msda_bwd batch 2: kernels disagree with plain")
    return rows


def check_int8_grad(shapes):
    """One forward + backward of the int8 op without a window (bfloat16,
    encoder call): K4 forward, K2 and K3 backward, one launch each, and the
    exact op's gradients (straight-through)."""
    S = sum(h * w for h, w in shapes)
    value, loc, aw = msda_inputs(S, S, torch.bfloat16, seed=300)
    g = torch.randn((1, S, H * D), device=DEVICE,
                    generator=torch.Generator(device=DEVICE).manual_seed(301)
                    ).bfloat16()
    grads, counts = {}, {}
    for int8 in (True, False):
        leaves = [t.clone().requires_grad_() for t in (value, loc, aw)]
        reset_kernel_counts()
        out = msda.ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2],
                                  int8=int8)
        grads[int8] = torch.autograd.grad(out, leaves, g)
        torch.cuda.synchronize()
        counts[int8] = {k: v for k, v in kernel_counts().items() if v}
    expect = {"msda_fwd_q": 1, "msda_bwd_rows": 1, "msda_bwd_value": 1}
    if counts[True] != expect:
        raise SystemExit(f"int8 forward + backward launched {counts[True]}, "
                         f"expected {expect}")
    # the row kernel is deterministic; the value kernel's atomics are not
    (dv_q, dl_q, da_q), (dv, dl, da) = grads[True], grads[False]
    err, over = _scaled_err(dv_q, dv, torch.bfloat16)
    print(f"int8 op without a window, forward + backward: launches "
          f"{counts[True]} (exact op: {counts[False]}); dloc and daw equal "
          f"to the exact op's: {torch.equal(dl_q, dl) and torch.equal(da_q, da)}"
          f"; dvalue max abs diff {err:.3e} (err/limit {over:.3f}, the value "
          "kernel's float32 atomics)", flush=True)
    if not (torch.equal(dl_q, dl) and torch.equal(da_q, da)) or over > 1.0:
        raise SystemExit("int8 op: gradients differ from the exact op's")
    return counts[True]


def _noise_msda_heads(model, device, seed=1):
    """Random init zeroes the offset and weight kernels, so sampling would
    not depend on the image; give them seeded noise."""
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("sampling_offsets.weight",
                              "attention_weights.weight")):
                p.normal_(0.0, 0.1, generator=g)


def train(cfg, label, hw, batch_size, steps, lrs=perf_train_step.LRS,
          accum=False):
    """A training main path: the train probe's step at full width, ``steps``
    steps on a batch of ``batch_size`` at ``hw`` and, with ``accum``, one
    accumulated step (accum 2 over twice the batch). Checks the metrics, the
    parameters and each microbatch's launches (``step_counts``)."""
    model, optimizer, generator = perf_train_step.build(cfg, DEVICE, seed=0,
                                                        lrs=lrs)
    old = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = perf_train_step.synthetic_batch(cfg, batch_size, *hw, DEVICE,
                                            seed=0)
    step = make_train_step(model, cfg, optimizer, task="sgg")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    times, metrics = perf_train_step.time_steps(step, batch, generator,
                                                steps, DEVICE)
    results = {"step": metrics}
    microbatches = steps
    accum_times = []
    if accum:
        step_accum = make_train_step(model, cfg, optimizer, task="sgg",
                                     accum_steps=2)
        batch2 = perf_train_step.synthetic_batch(cfg, 2 * batch_size, *hw,
                                                 DEVICE, seed=1)
        accum_times, results["accumulated step"] = perf_train_step.time_steps(
            step_accum, batch2, generator, 1, DEVICE)
        microbatches += 2
    counts = kernel_counts()
    matched = matcher_launches()
    trunk = backbone_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_microbatch = step_counts(cfg, level_shapes(hw, cfg.num_feature_levels))
    launched = {k: v for k, v in counts.items() if v}
    print(f"train {label} (window {cfg.msda_window}, band {cfg.msda_band}, "
          f"int8 {cfg.msda_int8}) {cfg.compute_dtype} {hw[0]}x{hw[1]} "
          f"b{batch_size}: {steps} steps, ms/step "
          f"{[round(t, 1) for t in times]} (the first builds cuDNN's plans)"
          + (f"; accumulated step (accum 2, batch {2 * batch_size}) "
             f"{accum_times[0]:.1f} ms" if accum else "")
          + f"; max memory allocated {peak_gb:.2f} GB; launches {launched} "
          f"over {microbatches} microbatches; "
          + "; ".join(f"{name} total_loss {m['total_loss']:.4f} grad_norm "
                      f"{m['grad_norm']:.4f}" for name, m in results.items()),
          flush=True)
    for name, m in results.items():
        bad = [k for k, v in m.items() if v != v or v in (float("inf"),
                                                         float("-inf"))]
        if bad:
            raise SystemExit(f"train {label} {name}: non-finite metrics {bad}")
        if not m["grad_norm"] > 0:
            raise SystemExit(f"train {label} {name}: grad_norm "
                             f"{m['grad_norm']}")
        expect = {"total_loss", "grad_norm", "loss_rel", "loss_connectivity",
                  f"rel_gate_{cfg.decoder_layers}"}
        if cfg.auxiliary_loss:
            expect.add(f"loss_ce_{cfg.decoder_layers - 2}")
        if cfg.two_stage:
            expect |= {"loss_ce_enc", "loss_bbox_enc", "loss_giou_enc"}
        if not expect <= set(m):
            raise SystemExit(f"train {label} {name}: metrics lack "
                             f"{sorted(expect - set(m))}")
    for kernel, n in counts.items():
        if n != per_microbatch[kernel] * microbatches:
            raise SystemExit(
                f"train {label}: {kernel} launched {n} times, expected "
                f"{per_microbatch[kernel] * microbatches} "
                f"({per_microbatch[kernel]} per microbatch)")
    if matched != matches_per_pass(cfg) * microbatches:
        raise SystemExit(f"train {label}: the matcher kernel launched "
                         f"{matched} times, expected "
                         f"{matches_per_pass(cfg) * microbatches}")
    if trunk:
        raise SystemExit(f"train {label}: the frozen-BN kernel launched "
                         f"{trunk} times under grad mode")
    moved = {group: [0, 0] for group in ("main", "backbone", "initialized")}
    for name, p in model.named_parameters():
        group = optimizer.labels[name]
        if group == "frozen":
            if not torch.equal(p, old[name]):
                raise SystemExit(f"train {label}: frozen parameter {name} "
                                 "changed")
        else:
            moved[group][0] += int(not torch.equal(p, old[name]))
            moved[group][1] += 1
        if not torch.isfinite(p).all():
            raise SystemExit(f"train {label}: parameter {name} is not finite")
    print(f"train {label}: parameters moved per group (moved, all) {moved}; "
          f"frozen leaves bit-identical", flush=True)
    for group, (n_moved, n_all) in moved.items():
        # a leaf whose gradient is exactly zero gets no Adam step
        if n_moved < 0.9 * n_all:
            raise SystemExit(f"train {label}: only {n_moved} of {n_all} "
                             f"{group} parameters moved")
    return {"counts": counts, "per_microbatch": per_microbatch,
            "lsap_launches": matched, "frozen_bn_launches": trunk,
            "ms_per_step": times, "accumulated_step_ms": accum_times,
            "max_memory_allocated_gb": peak_gb}


def _largest_grad_err(grads, ref, label):
    """(largest |grad - ref| over ref's largest entry, over all parameters;
    that parameter's name)."""
    worst, worst_name = 0.0, ""
    for name, gp in ref.items():
        gk = grads[name]
        if gk is None or gp is None:
            if gk is not gp:
                raise SystemExit(f"f32 train {label}: gradient of {name} "
                                 "missing on one path")
            continue
        if not torch.isfinite(gk).all():
            raise SystemExit(f"f32 train {label}: non-finite gradient of "
                             f"{name}")
        err = (gk - gp).abs().max().item() / max(gp.abs().max().item(), 1e-12)
        if err > worst:
            worst, worst_name = err, name
    return worst, worst_name


def compare_train_f32(cfg, label, hw, batch_size, limit):
    """One float32 forward + backward (TF32 off, dropout 0) of a training
    model through the kernels and through their plain versions: total loss,
    every parameter's gradient (relative to its largest entry, within
    ``limit``), and the band indices of a windowed model. Beside it, the
    model's own sensitivity: the plain path again with the pixels times
    (1 + 1.2e-7 noise), about one float32 step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg.replace(compute_dtype="float32", dropout=0.0)
    model_k, _, _ = perf_train_step.build(cfg, DEVICE, seed=0)
    _noise_msda_heads(model_k, DEVICE)
    model_p = plain_copy(model_k, cfg, DEVICE)
    batch = perf_train_step.synthetic_batch(cfg, batch_size, *hw, DEVICE,
                                            seed=0)
    pixels = batch["pixel_values"]
    nudged = pixels * (1.0 + 1.2e-7 * torch.randn(
        pixels.shape, device=DEVICE,
        generator=torch.Generator(device=DEVICE).manual_seed(2)))
    per_pass = step_counts(cfg, level_shapes(hw, cfg.num_feature_levels))
    zero = dict.fromkeys(per_pass, 0)
    results, bands = [], []
    for model, x, expect in ((model_k, pixels, per_pass),
                             (model_p, pixels, zero), (model_p, nudged, zero)):
        model.train()
        model.zero_grad(set_to_none=True)
        reset_kernel_counts()
        msda.band_index_log = []
        try:
            out = model(x, batch["pixel_mask"])
            total, _ = criterion.sgg_criterion(out, batch["labels"], cfg,
                                               train=True)
            total.backward()
            torch.cuda.synchronize()
        finally:
            bands.append(msda.band_index_log)
            msda.band_index_log = None
        if kernel_counts() != expect:
            raise SystemExit(f"f32 train {label} launches {kernel_counts()}, "
                             f"expected {expect}")
        results.append((total.item(), {n: p.grad for n, p in
                                       model.named_parameters()}))
    (loss_k, grads_k), (loss_p, grads_p), (_, grads_n) = results
    differing = sum(int((a != b).sum()) for (_, a), (_, b) in zip(*bands[:2]))
    n_bands = sum(a.numel() for _, a in bands[0])
    worst, worst_name = _largest_grad_err(grads_k, grads_p, label)
    nudge, nudge_name = _largest_grad_err(grads_n, grads_p, label)
    limit = max(limit, FLIPPED_BAND_GRAD_RTOL) if differing else limit
    print(f"train f32 {label} kernels vs plain ({cfg.encoder_layers}+"
          f"{cfg.decoder_layers} layers, window {cfg.msda_window}, band "
          f"{cfg.msda_band}, {hw[0]}x{hw[1]} b{batch_size}): total loss "
          f"{loss_k:.6f} vs {loss_p:.6f}; largest gradient error relative to "
          f"the gradient's largest entry {worst:.3e} ({worst_name}), over "
          f"{len(grads_p)} parameters (rtol {limit}); {differing} of "
          f"{n_bands} band indices differ; the plain path with the pixels "
          f"times (1 + 1.2e-7 noise) moves by {nudge:.3e} ({nudge_name})",
          flush=True)
    if abs(loss_k - loss_p) > 1e-4 * abs(loss_p) or worst > limit:
        raise SystemExit(f"float32 train step {label}: kernel path disagrees "
                         "with the plain versions")
    return {"loss_kernels": loss_k, "loss_plain": loss_p,
            "max_grad_rel_err": worst, "band_indices_differing": differing,
            "band_indices": n_bands, "nudged_pixels_max_grad_rel_change": nudge}


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _driver_forwards(args, synth=None):
    """Forwards of one driver run on the synthetic set ``synth`` (default
    SYNTH_VG): per phase, every microbatch of every optimizer step and every
    validation batch; then the test images, one per batch."""
    synth = SYNTH_VG if synth is None else synth
    batch, accum = (int(args[args.index(k) + 1])
                    for k in ("--batch_size", "--accumulate"))
    steps = synth["n_train"] // (batch * accum)
    val_batches = -(-synth["n_val"] // batch)
    microbatches = 2 * steps * accum
    return microbatches + 2 * val_batches + synth["n_test"], microbatches


@contextlib.contextmanager
def recorded_entries(cls=SceneGraphEvaluator, calls=None):
    """Each image's prediction entry (top-k pairs, their predicate scores,
    boxes, classes) as an SGG evaluator class ``cls`` receives it, once per
    image (the per-predicate evaluators see the same entry again); with a
    list ``calls``, also every call, as (evaluator, gt entry, prediction
    entry, keywords)."""
    log = []
    real = cls.evaluate_entry

    def evaluate_entry(self, gt_entry, pred_entry, *args, **kw):
        if not log or log[-1] is not pred_entry:
            log.append(pred_entry)
        if calls is not None:
            calls.append((self, gt_entry, pred_entry, kw))
        return real(self, gt_entry, pred_entry, *args, **kw)

    cls.evaluate_entry = evaluate_entry
    try:
        yield log
    finally:
        cls.evaluate_entry = real


def planted_gt(pred_entry):
    """A ground truth of the triplets at PLANTED_RANKS of an image's own
    ranking, under its top predicate: the traffic of a model that finds
    them, where every gt triplet has predictions with its labels to match
    boxes against."""
    ranks = [r for r in PLANTED_RANKS if r < len(pred_entry["pred_rel_inds"])]
    pairs = np.asarray(pred_entry["pred_rel_inds"])[ranks]
    predicates = np.asarray(pred_entry["rel_scores"])[ranks].argmax(1)
    objects = sorted(set(pairs.ravel().tolist()))
    index = {q: i for i, q in enumerate(objects)}
    return {"gt_relations": np.array([[index[s], index[o], p] for (s, o), p
                                      in zip(pairs.tolist(), predicates)]),
            "gt_boxes": np.asarray(pred_entry["pred_boxes"], float)[objects],
            "gt_classes": np.asarray(pred_entry["pred_classes"])[objects]}


def time_sg_eval(calls, rounds=SG_EVAL_ROUNDS):
    """The SGG evaluators' work of one evaluation run (``calls`` from
    ``recorded_entries``, replayed on fresh evaluators), as recorded and
    with each call's ground truth planted from its predictions
    (``planted_gt``), its triplets matched by the native kernel and by the
    numpy loop, its plain version: host ms per replay (the least of
    ``rounds``), whether both give the same recalls, and the largest
    recall."""
    paths = {"native": sg_eval._compute_pred_matches,
             "numpy": sg_eval._compute_pred_matches_plain}
    traffic = {"recorded": calls,
               "planted": [(evaluator, planted_gt(pred_entry), pred_entry, kw)
                           for evaluator, _, pred_entry, kw in calls]}
    out = {"calls": len(calls)}
    for name, replay in traffic.items():
        ms, recalls = {}, {}
        for label, match in paths.items():
            sg_eval._compute_pred_matches = match
            try:
                for _ in range(rounds):
                    fresh = {}
                    t0 = time.perf_counter()
                    for evaluator, gt_entry, pred_entry, kw in replay:
                        fresh.setdefault(id(evaluator), SceneGraphEvaluator(
                            evaluator.multiple_preds,
                            tuple(evaluator.recalls))
                        ).evaluate_entry(gt_entry, pred_entry, **kw)
                    t = 1e3 * (time.perf_counter() - t0)
                    ms[label] = min(ms.get(label, t), t)
            finally:
                sg_eval._compute_pred_matches = paths["native"]
            recalls[label] = [e.recalls for e in fresh.values()]
        out[name] = {
            "native_ms": ms["native"], "numpy_ms": ms["numpy"],
            "same_recalls": recalls["native"] == recalls["numpy"],
            "max_recall": max(r for e in recalls["native"]
                              for v in e.values() for r in v)}
    return out


def same_entries(a, b) -> bool:
    return len(a) == len(b) and all(
        x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
        for x, y in zip(a, b))


def driver_paths(workdir):
    """The synthetic VG set and the training driver's output path."""
    return f"{workdir}/vg", f"{workdir}/run"


def _phase_records(out, phase):
    """A phase's train and val records from its metrics.jsonl, and whether
    both kinds are there with every loss finite."""
    records = _records(f"{out}/{phase}/metrics.jsonl")
    train = [r for r in records if r["phase"] == "train"]
    val = [r for r in records if r["phase"] == "val"]
    losses = [v for r in train + val for k, v in r.items() if "loss" in k]
    return train, val, bool(train and val and all(
        math.isfinite(v) for v in losses))


def _peak_memory():
    """(peak allocated, peak reserved) GB since the last reset: a captured
    program's memory is its pool's, reserved and not allocated while it
    replays."""
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() / 1e9,
            torch.cuda.max_memory_reserved() / 1e9)


# the training driver's programs may reserve at most this much more than
# its eager run (GB)
DRIVER_PROGRAM_MEMORY_GB = 1.5


def reserved_by_pool():
    """GB reserved on the card by pool, from ``torch.cuda.memory_snapshot``:
    the caching allocator's default pool, the programs' shared pool
    (``aot.graph_pool``) and any other graph pool."""
    from egtr_tpu_torch.utils import aot

    device = torch.device(DEVICE, torch.cuda.current_device())
    pool = aot._pools.get(device)
    split = {"default": 0, "programs": 0, "other": 0}
    for seg in torch.cuda.memory_snapshot():
        if seg.get("device", device.index) != device.index:
            continue
        pid = tuple(seg.get("segment_pool_id", (0, 0)))
        key = ("default" if pid == (0, 0) else "programs"
               if pool is not None and pid == tuple(pool) else "other")
        split[key] += seg["total_size"]
    return {k: v / 1e9 for k, v in split.items()}


@contextlib.contextmanager
def program_memory(events):
    """Record into ``events``, for each program made while active
    (``aot.Program``), the peak reserved and allocated GB and the reserved
    GB by pool (``reserved_by_pool``) before its warm-up (or, for a later
    signature, its capture), as its warm-up ends (before
    ``aot.release_cached`` returns the warm-up's cache) and as its capture
    ends. Segments go back to the card only by ``empty_cache``, so the
    reserved memory when the peak first reaches its final value is the
    peak's."""
    from egtr_tpu_torch.utils import aot

    init, release = aot.Program.__init__, aot.release_cached
    current = []  # [tag, releases so far] of the program being made

    def record(when):
        torch.cuda.synchronize()
        events.append({"tag": current[-1][0] if current else None,
                       "when": when,
                       "peak_reserved": torch.cuda.max_memory_reserved() / 1e9,
                       "peak_allocated":
                           torch.cuda.max_memory_allocated() / 1e9,
                       **reserved_by_pool()})

    def released(device):
        # a program releases first, and again as its warm-up ends
        if current:
            current[-1][1] += 1
            record("before" if current[-1][1] == 1 else "warm-up")
        release(device)

    def program(self, fn, args, tag, warm_up=True):
        current.append([tag, 0])
        try:
            init(self, fn, args, tag, warm_up)
            record("capture")
        finally:
            current.pop()

    with mock.patch.object(aot.Program, "__init__", program), \
            mock.patch.object(aot, "release_cached", released):
        yield events


def memory_peak_split(events, total):
    """The event at which the peak reserved memory first reached
    ``total`` GB (None if it was reached outside a program)."""
    return next((e for e in events if e["peak_reserved"] >= total - 1e-9),
                None)


def reloads_bit_equal(model, artifact):
    """Whether the saved artifact reloads into the trained model's forward,
    bit for bit, on a seeded image of the training bucket."""
    from egtr_tpu_torch.train.checkpoint import load_pretrained

    cfg, sd = load_pretrained(artifact, map_location=DEVICE)
    reloaded = EgtrModel(cfg)
    reloaded.load_state_dict(sd, strict=True)
    reloaded = reloaded.to(DEVICE).eval()
    x = torch.randn((1, *perf_train_step.BUCKET_HW, 3), device=DEVICE,
                    generator=torch.Generator(device=DEVICE).manual_seed(3))
    with torch.inference_mode():
        a, b = model.eval()(x), reloaded(x)
    return all(torch.equal(a[k], b[k]) for k in (
        "logits", "pred_boxes", "pred_rel", "pred_connectivity"))


def drive_trainer(workdir):
    """The training driver's main path, in-process, with the flag on: a
    synthetic VG set, ``train_egtr.main`` (two phases, checkpoints, the
    artifact, the SGG + COCO test evaluation), the artifact reloaded, and
    a relaunch on the same output path that resumes and takes no step."""
    from egtr_tpu_torch.scripts import train_egtr
    from egtr_tpu_torch.scripts.make_synth_vg import make_synth_vg

    data, out = driver_paths(workdir)
    t0 = time.perf_counter()
    make_synth_vg(data, seed=0, **SYNTH_VG)
    t_data = time.perf_counter() - t0
    argv = ["--data_path", data, "--output_path", out, "--device", DEVICE,
            *DRIVER_ARGS]
    old_flag, msda.FWD_BATCH_P = msda.FWD_BATCH_P, True
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_counts()
        t0 = time.perf_counter()
        events = []
        with recorded_entries() as entries, program_memory(events):
            model = train_egtr.main(argv)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        memory = {"graph": _peak_memory()}
        peak_event = memory_peak_split(events, memory["graph"][1])
        counts = kernel_counts(batch_p=True)
        matched = matcher_launches()
        bit_equal = reloads_bit_equal(model, f"{out}/artifact")
        reset_kernel_counts()
        t0 = time.perf_counter()
        train_egtr.main(argv)
        torch.cuda.synchronize()
        t_relaunch = time.perf_counter() - t0
        relaunched = kernel_counts(batch_p=True)
        # the same run op by op, in a directory of its own: its memory
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eager_argv = list(argv)
        eager_argv[eager_argv.index("--output_path") + 1] = f"{out}_eager"
        with _eager_steps(), mock.patch.object(
                runner_module, "maybe_aot", lambda fn, tag, *a, **kw: fn):
            train_egtr.main(eager_argv)
        memory["eager"] = _peak_memory()
    finally:
        msda.FWD_BATCH_P = old_flag
    per_forward = forward_counts(
        model.config, level_shapes(perf_train_step.BUCKET_HW,
                                   model.config.num_feature_levels),
        batch_p=True)["msda_fwd_bp"]
    forwards, microbatches = _driver_forwards(DRIVER_ARGS)
    expect = dict.fromkeys(msda_cuda.KERNELS, 0)
    expect.update(msda_fwd_bp=per_forward * forwards,
                  msda_bwd_rows=per_forward * microbatches,
                  msda_bwd_value=per_forward * microbatches)
    # a match per criterion pass: the train microbatches and the
    # validation batches (the test evaluation computes no loss)
    expect_matched = matches_per_pass(model.config) * (
        forwards - SYNTH_VG["n_test"])
    phases, bad = {}, []
    for phase in ("main", "finetune"):
        train, val, ok = _phase_records(out, phase)
        if not ok:
            bad.append(f"{phase}: {len(train)} train and {len(val)} val "
                       "records, or a non-finite loss")
        phases[phase] = {
            "epoch_seconds": [r["epoch_seconds"] for r in val],
            "step_ms": [1e3 * r["step_seconds"] for r in train],
            "train_total_loss": [r["total_loss"] for r in train],
            "validation_total_loss": [r["validation_total_loss"]
                                      for r in val]}
    with open(f"{out}/metrics_test.json") as f:
        test = json.load(f)
    keys = RECALL_KEYS + [k for k in test if k.startswith("coco/")]
    if not all(k in test and math.isfinite(test[k]) for k in keys) or len(
            keys) < 7:
        bad.append(f"metrics_test.json lacks finite {keys}: {test}")
    artifact = sorted(os.listdir(f"{out}/artifact"))
    if artifact != ["config.json", "weights.pt"]:
        bad.append(f"artifact holds {artifact}")
    step_ms = [t for p in phases.values() for t in p["step_ms"]]
    print(f"driver (train_egtr.main, batch_p on; {SYNTH_VG}, "
          f"{' '.join(DRIVER_ARGS)}): data written in {t_data:.1f} s; run "
          f"{t_run:.1f} s, epochs "
          f"{ {p: [round(t, 1) for t in v['epoch_seconds']] for p, v in phases.items()} } s"
          f", ms per optimizer step {[round(t, 1) for t in step_ms]} (mean "
          f"{sum(step_ms) / len(step_ms):.1f}); launches "
          f"{ {k: v for k, v in counts.items() if v} } (expected "
          f"{ {k: v for k, v in expect.items() if v} }); losses "
          f"{ {p: v['validation_total_loss'] for p, v in phases.items()} }; "
          f"test metrics {test}; artifact reloaded bit-equal: {bit_equal}; "
          f"relaunch {t_relaunch:.1f} s, launches "
          f"{ {k: v for k, v in relaunched.items() if v} }"
          f"; (peak allocated, peak reserved) GB of the run, graphs "
          f"{memory['graph']} against eager {memory['eager']}", flush=True)
    print("driver memory by program (GB; reserved by pool before each "
          "program, as its warm-up ends and as its capture ends): "
          + "; ".join(
              f"{e['tag']} {e['when']}: peak reserved "
              f"{e['peak_reserved']:.3f}, allocated "
              f"{e['peak_allocated']:.3f}, default {e['default']:.3f}, "
              f"programs {e['programs']:.3f}, other {e['other']:.3f}"
              for e in events)
          + f"; the peak's ({memory['graph'][1]:.3f} GB reserved): "
          + (f"{peak_event['tag']} {peak_event['when']}, default "
             f"{peak_event['default']:.3f}, programs "
             f"{peak_event['programs']:.3f}, other {peak_event['other']:.3f}"
             if peak_event else "outside a program"), flush=True)
    if counts != expect:
        raise SystemExit(f"driver: launches {counts}, expected {expect}")
    over = memory["graph"][1] - memory["eager"][1]
    if over > DRIVER_PROGRAM_MEMORY_GB:
        raise SystemExit(f"driver: the programs reserve {over:.3f} GB more "
                         f"than the eager run (limit "
                         f"{DRIVER_PROGRAM_MEMORY_GB} GB): {memory}")
    if memory["graph"][0] > memory["eager"][0]:
        raise SystemExit(f"driver: the programs' peak allocated exceeds the "
                         f"eager run's: {memory}")
    if matched != expect_matched:
        raise SystemExit(f"driver: the matcher kernel launched {matched} "
                         f"times, expected {expect_matched}")
    if bad:
        raise SystemExit(f"driver: {bad}")
    if not bit_equal:
        raise SystemExit("driver: the reloaded artifact's forward differs")
    if relaunched != {**dict.fromkeys(relaunched, 0),
                      "msda_fwd_bp": per_forward * SYNTH_VG["n_test"]}:
        raise SystemExit(f"driver relaunch: launches {relaunched}: it must "
                         "resume and take no step, only the test evaluation")
    return {"counts": counts, "lsap_launches": matched, "phases": phases,
            "seconds": t_run, "peak_memory_gb": memory,
            "program_memory_gb": events, "peak_split_gb": peak_event,
            "relaunch_seconds": t_relaunch, "data_seconds": t_data,
            "mean_step_ms": sum(step_ms) / len(step_ms), "test": test,
            "entries": entries}


def _test_bucket(data, cfg):
    """The padded (H, W) of the test split's first batch, as the drivers'
    loaders make it."""
    from egtr_tpu_torch.data.loader import Loader
    from egtr_tpu_torch.data.visual_genome import VGDataset

    batch = next(iter(Loader(VGDataset(data, "test", size=800,
                                       max_size=1333), 1, shuffle=False,
                             max_gt=cfg.max_gt_boxes,
                             num_rel_labels=cfg.num_rel_labels,
                             num_workers=1)))
    return tuple(batch["pixel_values"].shape[1:3])


@contextlib.contextmanager
def _fps_trace_counted(evaluate_egtr):
    """The FPS loop's own torch.profiler run (the card's busy time) with
    the launch measurement paused around it and counting its trace, since
    two profilers cannot run at once."""
    if _meter is None:
        yield
        return
    real_busy, real_rows = evaluate_egtr._device_busy_ms, infer.device_rows

    def rows(prof, n):
        _meter.add(prof)
        return real_rows(prof, n)

    def busy_ms(fn):
        _meter.pause()
        with mock.patch.object(infer, "device_rows", rows):
            ms = real_busy(fn)
        _meter.resume()
        return ms

    with mock.patch.object(evaluate_egtr, "_device_busy_ms", busy_ms):
        yield


def drive_evaluate(workdir, driver):
    """The evaluation driver's main path, in-process, with the flag off, on
    phase 17's artifact and test split: first K4, K5 and K6 held against
    their plain versions at the test bucket's levels, the served run's
    shapes; then the exact run, whose R@K and mR@K, and each image's top-k
    triplets, must be phase 17's, and whose SGG-evaluator work is replayed
    with the native matcher and with the numpy loop; the served
    configuration's overrides; and the FPS loop."""
    from egtr_tpu_torch.config import EgtrConfig
    from egtr_tpu_torch.scripts import evaluate_egtr

    data, out = driver_paths(workdir)
    artifact = f"{out}/artifact"
    cfg = EgtrConfig.load(f"{artifact}/config.json")
    bucket = _test_bucket(data, cfg)
    shapes = level_shapes(bucket, cfg.num_feature_levels)
    q_rows = check_q_kernel(shapes, "test")
    win_rows = check_win_kernels(shapes, "test")
    argv = ["--data_path", data, "--artifact_path", artifact, "--device",
            DEVICE]
    n_test = SYNTH_VG["n_test"]
    served_cfg = cfg.replace(msda_window=WINDOW, msda_band="point",
                             msda_int8=True)
    runs, bad, calls = {}, [], []
    sites = fbn_sites(cfg)  # the artifact's trunk's (ResNet-50's 49)
    # forwards per run; run_fps: one warm-up, the timed loop's, and
    # decomposition loops of ten on the first batch (strict sync, chained,
    # and on the card chained under the profiler)
    loops = 3 if torch.device(DEVICE).type == "cuda" else 2
    for label, extra, run_cfg, forwards in (
            ("exact", [], cfg, n_test),
            ("served", SERVED_EVAL_ARGS, served_cfg, n_test),
            ("infer_only", ["--infer_only", "true"], cfg,
             1 + n_test + loops * 10)):
        reset_kernel_counts()
        t0 = time.perf_counter()
        with recorded_entries(
                calls=calls if label == "exact" else None) as entries, \
                _fps_trace_counted(evaluate_egtr):
            result = evaluate_egtr.main(argv + extra)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {**kernel_counts(), "frozen_bn": backbone_launches()}
        expect = {k: v * forwards
                  for k, v in forward_counts(run_cfg, shapes).items()}
        expect["frozen_bn"] = sites * forwards
        if counts != expect:
            bad.append(f"{label}: launches {counts}, expected {expect}")
        runs[label] = {"seconds": seconds, "counts": counts,
                       "result": result}
        if label == "exact":
            runs[label]["top_k_bit_equal_to_driver"] = same_top_k = (
                bool(entries) and same_entries(entries, driver["entries"]))
    matching = time_sg_eval(calls)
    want = {k: driver["test"][k] for k in RECALL_KEYS}
    exact = {k: runs["exact"]["result"][k] for k in RECALL_KEYS}
    served = {k: runs["served"]["result"][k] for k in RECALL_KEYS}
    fps = runs["infer_only"]["result"]
    fps_keys = ("fps", "strict_sync_fps", "chained_ms_per_image",
                "device_ms_per_image", "host_rtt_ms")
    print(f"evaluate (evaluate_egtr.main, batch_p off; phase 17's artifact, "
          f"{n_test} test images at {bucket}): exact "
          f"{runs['exact']['seconds']:.1f} s, R@K/mR@K {exact} (phase 17: "
          f"{want}), top-k triplets of its {len(driver['entries'])} images "
          f"with relations bit-equal to phase 17's: {same_top_k}; served "
          f"({' '.join(SERVED_EVAL_ARGS)}) {runs['served']['seconds']:.1f} s, "
          f"R@K/mR@K {served}; --infer_only {runs['infer_only']['seconds']:.1f}"
          f" s, { {k: fps[k] for k in fps_keys + ('device_idle_share', 'images', 'device', 'timer')} }"
          f"; launches "
          f"{ {l: {k: v for k, v in r['counts'].items() if v} for l, r in runs.items()} }"
          f"; SGG evaluator, the exact run's {matching['calls']} calls "
          f"replayed (host ms, least of {SG_EVAL_ROUNDS}), native matcher | "
          "numpy loop: "
          + "; ".join(f"{name} {m['native_ms']:.3f} | {m['numpy_ms']:.3f}, "
                      f"same recalls {m['same_recalls']}, largest recall "
                      f"{m['max_recall']}" for name, m in matching.items()
                      if name != "calls"), flush=True)
    if not (matching["recorded"]["same_recalls"]
            and matching["planted"]["same_recalls"]):
        bad.append("the native matcher's recalls differ from the numpy "
                   "loop's")
    if matching["planted"]["max_recall"] != 1.0:
        bad.append("the planted ground truth found no match")
    if not same_top_k:
        bad.append("the top-k triplets differ from phase 17's")
    if exact != want:
        bad.append(f"R@K/mR@K {exact} differ from phase 17's {want}")
    if not all(math.isfinite(fps[k]) and fps[k] > 0 for k in fps_keys):
        bad.append(f"--infer_only: {fps}")
    if bad:
        raise SystemExit(f"evaluate: {bad}")
    return {"runs": runs, "q_rows": q_rows, "win_rows": win_rows,
            "sg_eval": matching, "bucket": list(bucket)}


def drive_pretrain(workdir):
    """The pretraining driver's main path, in-process: two phases at full
    width on the synthetic VG set, the artifact, the COCO test evaluation;
    then the artifact merged into a fresh EGTR model."""
    from egtr_tpu_torch.scripts import pretrain_detr
    from egtr_tpu_torch.train.checkpoint import (load_pretrained,
                                                 merge_pretrained)

    data, _ = driver_paths(workdir)
    out = f"{workdir}/pretrain"
    reset_kernel_counts()
    t0 = time.perf_counter()
    detector = pretrain_detr.main(["--data_path", data, "--output_path", out,
                                   "--device", DEVICE, *PRETRAIN_ARGS])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernel_counts()
    cfg = detector.config
    del detector
    per_forward = forward_counts(
        cfg, level_shapes(perf_train_step.BUCKET_HW,
                          cfg.num_feature_levels))["msda_fwd"]
    forwards, microbatches = _driver_forwards(PRETRAIN_ARGS)
    expect = dict.fromkeys(msda_cuda.KERNELS, 0)
    expect.update(msda_fwd=per_forward * forwards,
                  msda_bwd_rows=per_forward * microbatches,
                  msda_bwd_value=per_forward * microbatches)
    bad, phases = [], {}
    for phase in ("main", "finetune"):
        train, val, ok = _phase_records(out, phase)
        if not ok:
            bad.append(f"{phase}: {len(train)} train and {len(val)} val "
                       "records, or a non-finite loss")
        phases[phase] = {
            "step_ms": [1e3 * r["step_seconds"] for r in train],
            "train_total_loss": [r["total_loss"] for r in train],
            "validation_total_loss": [r["validation_total_loss"]
                                      for r in val]}
    with open(f"{out}/metrics_test.json") as f:
        test = json.load(f)
    if not test or not all(k.startswith("coco/") and math.isfinite(v)
                           for k, v in test.items()):
        bad.append(f"metrics_test.json: {test}")
    # train_egtr --pretrained: every detector leaf from the artifact, the
    # relation head and the frequency-bias tables fresh
    art_cfg, artifact = load_pretrained(f"{out}/artifact")
    fresh = EgtrModel(art_cfg).state_dict()
    _, initialized = merge_pretrained(fresh, artifact)
    want = sorted(n.replace(".", "/") for n in fresh
                  if n.startswith("relation_head.")
                  or n in ("rel_dist", "triplet_dist"))
    detector_leaves = sum(n.startswith("model.") for n in fresh)
    if sorted(initialized) != want or len(artifact) != detector_leaves:
        bad.append(f"merge_pretrained: {len(initialized)} fresh paths "
                   f"({len(want)} expected), {len(artifact)} artifact "
                   f"entries for {detector_leaves} detector leaves")
    print(f"pretrain (pretrain_detr.main; {SYNTH_VG}, "
          f"{' '.join(PRETRAIN_ARGS)}): {seconds:.1f} s, ms per optimizer "
          f"step { {p: [round(t, 1) for t in v['step_ms']] for p, v in phases.items()} }"
          f"; launches { {k: v for k, v in counts.items() if v} } (expected "
          f"{ {k: v for k, v in expect.items() if v} }); losses "
          f"{ {p: v['validation_total_loss'] for p, v in phases.items()} }; "
          f"test metrics {test}; merged into EgtrModel: {len(artifact)} "
          f"detector leaves loaded, {len(initialized)} paths fresh "
          "(the relation head and the frequency-bias tables)", flush=True)
    if counts != expect:
        raise SystemExit(f"pretrain: launches {counts}, expected {expect}")
    if bad:
        raise SystemExit(f"pretrain: {bad}")
    return {"counts": counts, "seconds": seconds, "phases": phases,
            "test": test, "fresh_paths": len(initialized)}


def exp_command(argv):
    """One command of the experiment script, in-process, with its launches
    counted alone: (its result, seconds, launches)."""
    from egtr_tpu_torch.scripts import exp_trained_offsets as exp

    reset_kernel_counts()
    t0 = time.perf_counter()
    result = exp.main(argv)
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0, kernel_counts()


def exp_sweep(data, out, bucket):
    """The sweep over EXP_SWEEP on ``out``'s artifact, then the same
    command again: per variant forward_counts x the test batches; the
    rerun skips every variant and launches nothing."""
    from egtr_tpu_torch.scripts import exp_trained_offsets as exp
    from egtr_tpu_torch.train.checkpoint import load_pretrained

    argv = ["sweep", "--data_path", data, "--out", out, "--device", DEVICE,
            *EXP_ARGS, *EXP_SWEEP]
    args = exp.parse_args(argv)
    cfg, _ = load_pretrained(f"{out}/artifact")
    shapes = level_shapes(bucket, cfg.num_feature_levels)
    batches = -(-SYNTH_EXP["n_test"] // args.batch)
    variants = exp.parse_windows(args.windows, args.int8)
    expect = dict.fromkeys(msda_cuda.KERNELS, 0)
    for win, band, int8 in variants:
        per_forward = forward_counts(cfg.replace(
            msda_window=win, msda_band=band, msda_int8=int8), shapes)
        for name, n in per_forward.items():
            expect[name] += n * batches
    report, seconds, counts = exp_command(argv)
    again, seconds_again, counts_again = exp_command(argv)
    keys = [exp.variant_key(*v) for v in variants]
    bad = []
    if counts != expect:
        bad.append(f"launches {counts}, expected {expect}")
    if any(counts_again.values()) or again != report:
        bad.append(f"the rerun launched {counts_again} or changed the "
                   "report: it must skip every variant")
    recalls = {k: [report.get(k, {}).get(m) for m in (
        "R@20", "R@50", "R@100", "mR@20", "mR@50", "mR@100")] for k in keys}
    if not all(v is not None and 0.0 <= v <= 1.0
               for row in recalls.values() for v in row):
        bad.append(f"R@K outside [0, 1]: {recalls}")
    deltas = {k: report.get(f"{k}_vs_exact_outputs") for k in keys[1:]}
    if not all(d and sorted(d) == sorted(exp.KEYS) and all(
            math.isfinite(v) for row in d.values() for v in row.values())
            for d in deltas.values()):
        bad.append(f"the deltas to the exact outputs: {deltas}")
    print(f"experiment sweep {' '.join(EXP_SWEEP)} ({batches} batch of "
          f"{args.batch} a variant): {seconds:.1f} s, rerun "
          f"{seconds_again:.1f} s (launches {counts_again}); launches "
          f"{ {k: v for k, v in counts.items() if v} } (expected "
          f"{ {k: v for k, v in expect.items() if v} }); R@50 "
          f"{ {k: r[1] for k, r in recalls.items()} }; logits max abs delta "
          f"{ {k: d['logits']['max_abs'] for k, d in deltas.items() if d} }",
          flush=True)
    if bad:
        raise SystemExit(f"experiment sweep: {bad}")
    return {"counts": counts, "seconds": seconds,
            "rerun_seconds": seconds_again,
            "recall": {k: dict(zip(("R@20", "R@50", "R@100", "mR@20",
                                    "mR@50", "mR@100"), v))
                       for k, v in recalls.items()},
            "vs_exact_outputs": deltas}


def exp_bands_vs_cpu(artifact, bucket):
    """F1 on the adaptation's weights (window 16, one band per point, its
    trained offsets): one float32 forward of a seeded image at the bucket
    on the card, and the same on the CPU (``bands_vs_cpu``)."""
    from egtr_tpu_torch.train.checkpoint import load_pretrained

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, state = load_pretrained(artifact)
    cfg = cfg.replace(compute_dtype="float32", dropout=0.0)
    model = EgtrModel(cfg)
    model.load_state_dict(state, strict=True)
    model = model.to(DEVICE).eval()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (1, *bucket, 3)).astype(np.float32)).to(DEVICE)
    msda.band_index_log = []
    try:
        with torch.inference_mode():
            out = model(x)
    finally:
        bands = msda.band_index_log
        msda.band_index_log = None
    flips, n, deltas = bands_vs_cpu(model, cfg, x, out, bands)
    print(f"experiment adapted model (window {cfg.msda_window}, band "
          f"{cfg.msda_band}) f32 card vs CPU (F1): {flips} of {n} band "
          f"indices differ; largest output delta card - CPU {deltas}",
          flush=True)
    if not n or not all(math.isfinite(v) for v in deltas.values()):
        raise SystemExit(f"experiment card vs CPU: {n} band indices, "
                         f"deltas {deltas}")
    return {"band_indices_differing": flips, "band_indices": n,
            "max_abs_delta": deltas}


def drive_experiment(workdir):
    """The trained-offsets experiment's main path, in-process, through
    ``exp_trained_offsets.main``: train (exact), train --resume (and a
    resume with a drifted flag, refused), the adaptation (window 16, one
    band per point) and its tile sibling from the exact artifact, the sweep
    twice, offsets (the clamp fractions also on the CPU), and
    ``exp_window_deltas.main``; each command's launches against
    step_counts x the steps its state directory records, or
    forward_counts x its forwards."""
    from egtr_tpu_torch.scripts import exp_trained_offsets as exp
    from egtr_tpu_torch.scripts import exp_window_deltas
    from egtr_tpu_torch.scripts.make_synth_vg import make_synth_vg
    from egtr_tpu_torch.train.checkpoint import (CheckpointManager,
                                                 load_pretrained)

    data, out = f"{workdir}/exp_vg", f"{workdir}/exp"
    make_synth_vg(data, seed=0, **SYNTH_EXP)
    common = ["--data_path", data, "--device", DEVICE, *EXP_ARGS]
    bucket = exp._bucket(exp.parse_args(["train", "--out", out, *common]))[0]
    runs, bad = {}, []
    commands = (
        ("exact", out, ["--ckpt_every", "1"]),
        ("resume", out, ["--resume"]),
        ("point", f"{out}_w16p", ["--init_from", f"{out}/artifact",
                                  "--window", "16", "--band", "point"]),
        ("tile", f"{out}_w16", ["--init_from", f"{out}/artifact",
                                "--window", "16"]))
    for label, run_out, extra in commands:
        result, seconds, counts = exp_command([
            "train", "--out", run_out, *common, "--train_seconds",
            str(EXP_TRAIN_SECONDS[label]), *extra])
        losses = result["losses"]
        cfg, _ = load_pretrained(f"{run_out}/artifact")
        state = CheckpointManager(f"{run_out}/state", max_to_keep=2)
        steps = state.latest_step() - result["start_step"]
        expect = {k: v * steps for k, v in step_counts(
            cfg, level_shapes(bucket, cfg.num_feature_levels)).items()}
        ms = (1e3 * result["clock_seconds"] / (steps - 1)
              if steps > 1 else None)
        runs[label] = {"seconds": seconds, "steps": steps,
                       "start_step": result["start_step"],
                       "ms_per_step_clock": ms, "losses": losses,
                       "counts": counts}
        print(f"experiment train {label} (window {cfg.msda_window}, band "
              f"{cfg.msda_band}): {seconds:.1f} s, steps "
              f"{result['start_step']} -> {result['step']}, ms per step "
              f"from the clock {ms}; launches "
              f"{ {k: v for k, v in counts.items() if v} } (expected "
              f"{ {k: v for k, v in expect.items() if v} }); losses "
              f"{[round(x, 4) for x in losses]}", flush=True)
        if counts != expect:
            bad.append(f"train {label}: launches {counts}, expected {expect}")
        if steps < 1 or result["step"] != state.latest_step() or len(
                losses) != steps or not all(map(math.isfinite, losses)):
            bad.append(f"train {label}: {steps} steps, state at "
                       f"{state.all_steps()}, losses {losses}")
        if label == "resume" and result["start_step"] != (
                runs["exact"]["start_step"] + runs["exact"]["steps"]):
            bad.append(f"the resume started at step {result['start_step']}")
    # a resume whose flags build another config is refused by name
    refusal = None
    try:
        exp_command(["train", "--out", out, *common, "--resume",
                     "--window", "8"])
    except SystemExit as e:
        refusal = str(e)
    print(f"experiment train --resume --window 8: refused: {refusal}",
          flush=True)
    if not refusal or "['msda_window']" not in refusal:
        bad.append(f"a drifted resume was not refused by name: {refusal}")
    if bad:
        raise SystemExit(f"experiment: {bad}")

    sweep = exp_sweep(data, f"{out}_w16p", bucket)
    result, seconds, counts = exp_command(
        ["offsets", "--out", f"{out}_w16p", *common])
    stats = result["stats"]
    cfg, _ = load_pretrained(f"{out}_w16p/artifact")
    shapes = level_shapes(bucket, cfg.num_feature_levels)
    expect = forward_counts(cfg.replace(msda_window=0), shapes)
    runs["offsets"] = {"seconds": seconds, "counts": counts}
    # the clamp fractions of the command's captured offsets, on the card
    # and again on the CPU
    card = {k: v for k, v in stats.items() if k.startswith("clamp_frac_")}
    host = exp._clamp_fracs(
        [o.cpu() for o in result["offsets"]],
        [a.cpu() for a in result["weights"]], shapes,
        cfg.d_model // cfg.encoder_attention_heads)
    clamp_err = max(abs(card[k] - host[k]) for k in card)
    print(f"experiment offsets: {seconds:.1f} s; launches "
          f"{ {k: v for k, v in counts.items() if v} } (expected "
          f"{ {k: v for k, v in expect.items() if v} }); stats {stats}; "
          f"clamp fractions on the card {card}, largest difference to the "
          f"CPU's {clamp_err:.3e} (limit {EXP_CLAMP_ATOL})", flush=True)
    if counts != expect:
        bad.append(f"offsets: launches {counts}, expected {expect}")
    if not all(math.isfinite(v) for v in stats.values()) or not card:
        bad.append(f"offsets: {stats}")
    if clamp_err > EXP_CLAMP_ATOL:
        bad.append(f"clamp fractions: card {card}, CPU {host}")
    flips = exp_bands_vs_cpu(f"{out}_w16p/artifact", bucket)

    # the window-deltas script at the FPS-protocol shape
    reset_kernel_counts()
    t0 = time.perf_counter()
    deltas = exp_window_deltas.main([f"{workdir}/win_deltas.json",
                                     "--device", DEVICE])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernel_counts()
    base = exp_window_deltas.base_config()
    shapes = level_shapes(exp_window_deltas.HW, base.num_feature_levels)
    expect = dict.fromkeys(msda_cuda.KERNELS, 0)
    for kw in [{}] + [kw for _, kw in exp_window_deltas.VARIANTS]:
        for name, n in forward_counts(base.replace(**kw), shapes).items():
            expect[name] += n
    runs["window_deltas"] = {"seconds": seconds, "counts": counts}
    print(f"experiment window deltas ({exp_window_deltas.HW[0]}x"
          f"{exp_window_deltas.HW[1]}): {seconds:.1f} s; launches "
          f"{ {k: v for k, v in counts.items() if v} } (expected "
          f"{ {k: v for k, v in expect.items() if v} }); {deltas}",
          flush=True)
    if counts != expect:
        bad.append(f"window deltas: launches {counts}, expected {expect}")
    if sorted(deltas) != sorted(n for n, _ in exp_window_deltas.VARIANTS) \
            or not all(math.isfinite(v) for row in deltas.values()
                       for d in row.values() for v in d.values()):
        bad.append(f"window deltas: {deltas}")
    if bad:
        raise SystemExit(f"experiment: {bad}")
    total = dict.fromkeys(msda_cuda.KERNELS, 0)
    for counts in [r["counts"] for r in runs.values()] + [sweep["counts"]]:
        for name, n in counts.items():
            total[name] += n
    return {"counts": total, "runs": runs, "sweep": sweep,
            "offset_stats": stats, "clamp_fracs_card": card,
            "clamp_fracs_max_abs_diff_cpu": clamp_err,
            "band_flips_vs_cpu": flips, "window_deltas": deltas}


def write_synth_oi(out, n_train, n_val, n_test, height, width, seed=0):
    """A synthetic Open Images V6 set in the reference's layout
    (data/open_image.py:31-158): ``annotations/categories_dict.json`` with
    OI_OBJECTS object and OI_PREDICATES predicate names,
    ``annotations/vrd-{split}-anno.json`` (xyxy boxes, labels, [subject,
    object, predicate] triples: every image has some, and a repeated triple
    and a second predicate on one pair for the train split's filters) and
    the JPEGs under ``images/``: colored rectangles on noise, one rectangle
    a box."""
    rng = np.random.default_rng(seed)
    os.makedirs(f"{out}/images", exist_ok=True)
    os.makedirs(f"{out}/annotations", exist_ok=True)
    with open(f"{out}/annotations/categories_dict.json", "w") as f:
        json.dump({"obj": [f"object_{i}" for i in range(OI_OBJECTS)],
                   "rel": [f"predicate_{i}" for i in range(OI_PREDICATES)]},
                  f)
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        annos = []
        for i in range(n):
            img = rng.integers(80, 130, (height, width, 3)).astype(np.uint8)
            boxes, labels = [], []
            for _ in range(int(rng.integers(3, 7))):
                w = int(rng.integers(width // 10, width // 3))
                h = int(rng.integers(height // 10, height // 3))
                x = int(rng.integers(0, width - w - 1))
                y = int(rng.integers(0, height - h - 1))
                label = int(rng.integers(0, OI_OBJECTS))
                img[y:y + h, x:x + w] = rng.integers(0, 255, 3)
                boxes.append([x, y, x + w - 1, y + h - 1])
                labels.append(label)
            rels = [[s_, s_ + 1, int(rng.integers(0, OI_PREDICATES))]
                    for s_ in range(len(boxes) - 1)]
            rels += [rels[0], [0, 1, (rels[0][2] + 1) % OI_PREDICATES]]
            fn = f"{split}_{i}"
            Image.fromarray(img, "RGB").save(f"{out}/images/{fn}.jpg",
                                             quality=90)
            annos.append({"img_fn": fn, "bbox": boxes, "det_labels": labels,
                          "rel": rels})
        with open(f"{out}/annotations/vrd-{split}-anno.json", "w") as f:
            json.dump(annos, f)


@contextlib.contextmanager
def recorded_oi_calls():
    """Every call of an ``OIEvaluator`` as (gt entry, prediction entry), and
    the bytes per image of each ``rel_full`` the runner made."""
    from egtr_tpu_torch.evaluation import runner
    from egtr_tpu_torch.evaluation.oi_eval import OIEvaluator

    calls, rel_bytes = [], []
    real_call, real_rel_full = OIEvaluator.__call__, runner.rel_full

    def call(self, gt_entry, pred_entry):
        calls.append((gt_entry, pred_entry))
        return real_call(self, gt_entry, pred_entry)

    def rel_full(out):
        t = real_rel_full(out)
        rel_bytes.append(t[0].numel() * t.element_size())
        return t

    OIEvaluator.__call__, runner.rel_full = call, rel_full
    try:
        yield calls, rel_bytes
    finally:
        OIEvaluator.__call__, runner.rel_full = real_call, real_rel_full


def time_oi_eval(calls, rel_categories, classes, rounds=OI_EVAL_ROUNDS):
    """The OI evaluator's work of one run (``calls`` from
    ``recorded_oi_calls``) replayed on fresh evaluators, its triplets
    matched by the native kernel and by the numpy loop: host ms per image
    of the calls plus ``aggregate_metrics`` (the least of ``rounds``) and
    the metrics of each path."""
    from egtr_tpu_torch.evaluation.oi_eval import OIEvaluator

    paths = {"native": sg_eval._compute_pred_matches,
             "numpy": sg_eval._compute_pred_matches_plain}
    ms, metrics = {}, {}
    for label, match in paths.items():
        sg_eval._compute_pred_matches = match
        try:
            for _ in range(rounds):
                evaluator = OIEvaluator(rel_categories, classes)
                t0 = time.perf_counter()
                for gt_entry, pred_entry in calls:
                    evaluator(gt_entry, pred_entry)
                metrics[label] = evaluator.aggregate_metrics()
                t = 1e3 * (time.perf_counter() - t0) / max(len(calls), 1)
                ms[label] = min(ms.get(label, t), t)
        finally:
            sg_eval._compute_pred_matches = paths["native"]
    return {"images": len(calls), "native_ms_per_image": ms["native"],
            "numpy_ms_per_image": ms["numpy"],
            "same_metrics": metrics["native"] == metrics["numpy"],
            "metrics": metrics["native"]}


def drive_oi(workdir):
    """Open Images V6 through the three entry points at full width, on a
    synthetic OI set (601 objects, 30 predicates): ``train_egtr.main
    --dataset open_images`` (K1, K2, K3 12 per microbatch, the artifact
    reloaded bit-equal, the ``oi/*`` test metrics), ``evaluate_egtr.main
    --dataset open_images`` on that artifact (``oi/*`` equal to the training
    driver's, ``rel_full``'s bytes per image, the OI evaluator's host ms per
    image on both matchers) and ``pretrain_detr.main --dataset
    open_images``."""
    from egtr_tpu_torch.scripts import evaluate_egtr, pretrain_detr, train_egtr

    data, out = f"{workdir}/oi", f"{workdir}/oi_run"
    t0 = time.perf_counter()
    write_synth_oi(data, seed=0, **SYNTH_OI)
    t_data = time.perf_counter() - t0
    oi = ["--dataset", "open_images", "--data_path", data, "--device",
          DEVICE]
    runs, bad = {}, []

    reset_kernel_counts()
    t0 = time.perf_counter()
    model = train_egtr.main([*oi, "--output_path", out, *DRIVER_ARGS])
    torch.cuda.synchronize()
    runs["train"] = {"seconds": time.perf_counter() - t0,
                     "counts": kernel_counts()}
    cfg = model.config
    bit_equal = reloads_bit_equal(model, f"{out}/artifact")
    del model
    with open(f"{out}/metrics_test.json") as f:
        trained = json.load(f)
    oi_keys = sorted(k for k in trained if k.startswith("oi/"))

    reset_kernel_counts()
    t0 = time.perf_counter()
    with recorded_oi_calls() as (calls, rel_bytes):
        evaluated = evaluate_egtr.main([*oi, "--artifact_path",
                                        f"{out}/artifact"])
    torch.cuda.synchronize()
    runs["evaluate"] = {"seconds": time.perf_counter() - t0,
                        "counts": kernel_counts()}
    with open(f"{data}/annotations/categories_dict.json") as f:
        names = json.load(f)
    host = time_oi_eval(calls, names["rel"], names["obj"])

    reset_kernel_counts()
    t0 = time.perf_counter()
    detector = pretrain_detr.main([*oi, "--output_path", f"{workdir}/oi_pre",
                                   *PRETRAIN_ARGS])
    torch.cuda.synchronize()
    runs["pretrain"] = {"seconds": time.perf_counter() - t0,
                        "counts": kernel_counts()}
    del detector
    with open(f"{workdir}/oi_pre/metrics_test.json") as f:
        pretrained = json.load(f)

    per_forward = forward_counts(cfg, level_shapes(
        perf_train_step.BUCKET_HW, cfg.num_feature_levels))["msda_fwd"]
    n_test = SYNTH_OI["n_test"]
    for label, args in (("train", DRIVER_ARGS), ("evaluate", None),
                        ("pretrain", PRETRAIN_ARGS)):
        forwards, microbatches = (_driver_forwards(args, SYNTH_OI) if args
                                  else (n_test, 0))
        expect = dict.fromkeys(msda_cuda.KERNELS, 0)
        expect.update(msda_fwd=per_forward * forwards,
                      msda_bwd_rows=per_forward * microbatches,
                      msda_bwd_value=per_forward * microbatches)
        runs[label]["expected"] = expect
        if runs[label]["counts"] != expect:
            bad.append(f"{label}: launches {runs[label]['counts']}, "
                       f"expected {expect}")
        counts = runs[label]["counts"]
        # K1 per forward (each microbatch's included), K2 and K3 per
        # microbatch
        runs[label]["per_microbatch"] = {
            "msda_fwd": counts["msda_fwd"] / forwards,
            **{k: counts[k] / microbatches
               for k in ("msda_bwd_rows", "msda_bwd_value") if microbatches}}
        for phase in ("main", "finetune"):
            if label != "evaluate":
                root = out if label == "train" else f"{workdir}/oi_pre"
                train, val, ok = _phase_records(root, phase)
                if not ok:
                    bad.append(f"{label} {phase}: {len(train)} train and "
                               f"{len(val)} val records, or a non-finite "
                               "loss")
                runs[label].setdefault("step_ms", {})[phase] = [
                    1e3 * r["step_seconds"] for r in train]
    if (cfg.num_labels, cfg.num_rel_labels) != (OI_OBJECTS, OI_PREDICATES):
        bad.append(f"labels {cfg.num_labels}/{cfg.num_rel_labels}")
    want_keys = {"oi/w_rel_mAP", "oi/w_phr_mAP", "oi/microR@50", "oi/score",
                 "oi/bbox/AP"}
    if not want_keys <= set(oi_keys) or not all(
            math.isfinite(trained[k]) for k in oi_keys):
        bad.append(f"metrics_test.json: {trained}")
    same = {k: evaluated[k] == trained[k] for k in oi_keys}
    if not all(same.values()):
        bad.append(f"evaluate_egtr's oi/* differ from train_egtr's: {same}")
    if not bit_equal:
        bad.append("the reloaded artifact's forward differs")
    if not host["same_metrics"]:
        bad.append("the OI evaluator's metrics differ between the native "
                   "matcher and the numpy loop")
    if len(calls) != n_test or set(rel_bytes) != {
            cfg.num_queries ** 2 * cfg.num_rel_labels * 4}:
        bad.append(f"{len(calls)} OI evaluator calls, rel_full bytes per "
                   f"image {sorted(set(rel_bytes))}")
    if not pretrained or not all(k.startswith("coco/") and math.isfinite(v)
                                 for k, v in pretrained.items()):
        bad.append(f"pretrain metrics_test.json: {pretrained}")
    print(f"open images (synthetic, {SYNTH_OI}, {OI_OBJECTS} objects and "
          f"{OI_PREDICATES} predicates, written in {t_data:.1f} s): "
          f"train_egtr {runs['train']['seconds']:.1f} s, launches per "
          f"microbatch {runs['train']['per_microbatch']}, ms per optimizer "
          f"step {runs['train']['step_ms']}, artifact reloaded bit-equal "
          f"{bit_equal}; test metrics { {k: trained[k] for k in oi_keys} }; "
          f"evaluate_egtr {runs['evaluate']['seconds']:.1f} s, launches "
          f"{ {k: v for k, v in runs['evaluate']['counts'].items() if v} }, "
          f"oi/* equal to train_egtr's: {all(same.values())}; rel_full "
          f"{sorted(set(rel_bytes))} bytes per image; OI evaluator host ms "
          f"per image over {host['images']} images, native matcher "
          f"{host['native_ms_per_image']:.3f} | numpy loop "
          f"{host['numpy_ms_per_image']:.3f}, same metrics "
          f"{host['same_metrics']}; pretrain_detr "
          f"{runs['pretrain']['seconds']:.1f} s, launches per microbatch "
          f"{runs['pretrain']['per_microbatch']}, test metrics {pretrained}",
          flush=True)
    if bad:
        raise SystemExit(f"open images: {bad}")
    return {"runs": runs, "test": {k: trained[k] for k in oi_keys},
            "rel_full_bytes_per_image": rel_bytes[0],
            "oi_eval_host": {k: v for k, v in host.items() if k != "metrics"},
            "pretrain_test": pretrained, "data_seconds": t_data}


def check_two_stage(train_shapes):
    """``two_stage`` at full width (Q = two_stage_num_proposals = 300, 4-d
    reference points): K1, K2 and K3 against their plain versions at the
    decoder's Q = 300 calls of the training bucket; a bfloat16 forward at
    the serving bucket (K1 12); a train step at batch 2, 800x1344, with the
    proposals' ``_enc`` losses (K1, K2, K3 12 per microbatch); and the
    float32 outputs through the kernels against the plain versions, the
    proposal indices compared first."""
    cfg = infer.bench_config(**TWO_STAGE)
    Q = cfg.two_stage_num_proposals
    S = sum(h * w for h, w in train_shapes)
    fwd_rows, bwd_rows = [], []
    for n, (batch, dtype) in enumerate(((1, torch.float32),
                                        (1, torch.bfloat16),
                                        (2, torch.bfloat16))):
        value, loc, aw = msda_inputs(Q, S, dtype, seed=400 + n, batch=batch)
        fwd_rows.append(_fwd_row("two_stage", "decoder", Q, value,
                                 train_shapes, loc, aw))
        g = grad_output(batch, Q, dtype, 410 + n)
        bwd_rows.append(_bwd_row("two_stage", "decoder", Q, value,
                                 train_shapes, loc, aw, g))
    model, x = infer.build(cfg, 1, *infer.BUCKET_HW, seed=0)
    reset_kernel_counts()
    with torch.inference_mode():
        out = model(x)
    torch.cuda.synchronize()
    serve_counts = kernel_counts()
    del model
    expect = forward_counts(cfg, level_shapes(infer.BUCKET_HW,
                                              cfg.num_feature_levels))
    shapes_ok = (tuple(out["logits"].shape) == (1, Q, cfg.num_labels)
                 and tuple(out["pred_rel"].shape)
                 == (1, Q, Q, cfg.num_rel_labels)
                 and tuple(out["init_reference_points"].shape) == (1, Q, 4))
    finite = all(torch.isfinite(out[k].float()).all() for k in (
        "logits", "pred_boxes", "pred_rel", "pred_connectivity"))
    print(f"two-stage forward (bf16, {infer.BUCKET_HW}, Q {Q}): launches "
          f"{ {k: v for k, v in serve_counts.items() if v} } (expected "
          f"{ {k: v for k, v in expect.items() if v} }); shapes {shapes_ok}, "
          f"finite {finite}", flush=True)
    if serve_counts != expect or not (shapes_ok and finite):
        raise SystemExit("two-stage forward: launches, shapes or values")
    del out
    step = train(perf_train_step.train_config(**TWO_STAGE), "two-stage",
                 perf_train_step.BUCKET_HW, 2, TWO_STAGE_STEPS)
    errs = compare_f32(cfg, "two-stage", MODEL_ATOL)
    return {"fwd_rows": fwd_rows, "bwd_rows": bwd_rows,
            "serve_counts": serve_counts, "train": step, "f32": errs}


def _grads_f32(cfg, batch):
    """One float32 forward + backward (TF32 off) of the train probe's model,
    its dropout masks from a seeded generator: (total loss, gradients,
    launches)."""
    model, _, _ = perf_train_step.build(cfg, DEVICE, seed=0)
    _noise_msda_heads(model, DEVICE)
    generator = torch.Generator(device=DEVICE).manual_seed(7)
    reset_kernel_counts()
    out = model.train()(batch["pixel_values"], batch["pixel_mask"], generator)
    total, _ = criterion.sgg_criterion(out, batch["labels"], cfg, True,
                                       generator=generator)
    total.backward()
    torch.cuda.synchronize()
    return total.item(), {n: p.grad for n, p in model.named_parameters()}, \
        kernel_counts()


def check_remat(train_cfg):
    """Rematerialized layers at full width, batch 2, 800x1344: bfloat16
    train steps with ``use_remat`` off, "full" and "dots" (K1 12, 24 and 12
    per microbatch; K2 and K3 12), each with its peak memory; then one
    float32 forward + backward under each policy at dropout 0.1, its
    gradients against the step without remat within GRAD_RTOL (the same
    dropout masks: the recompute restores the step generator)."""
    hw = perf_train_step.BUCKET_HW
    runs = {}
    for label, kw in REMAT.items():
        runs[label] = train(train_cfg.replace(**kw), f"remat {label}", hw, 2,
                            REMAT_STEPS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = train_cfg.replace(compute_dtype="float32")
    batch = perf_train_step.synthetic_batch(f32, 2, *hw, DEVICE, seed=0)
    loss0, grads0, _ = _grads_f32(f32, batch)
    grads = {}
    for label, kw in REMAT.items():
        if not kw["use_remat"]:
            continue
        loss, g, counts = _grads_f32(f32.replace(**kw), batch)
        worst, name = _largest_grad_err(g, grads0, f"remat {label}")
        grads[label] = {"loss": loss, "loss_off": loss0,
                        "max_grad_rel_err": worst, "worst_parameter": name,
                        "counts": counts}
    # train() held each run to step_counts, which doubles the forward's
    # launches under "full"
    per_microbatch = {label: r["counts"]["msda_fwd"] // REMAT_STEPS
                      for label, r in runs.items()}
    print(f"remat (bf16, {hw[0]}x{hw[1]} b2): K1 launches per microbatch "
          f"{per_microbatch}; max memory allocated GB "
          f"{ {k: round(r['max_memory_allocated_gb'], 3) for k, r in runs.items()} }"
          f"; ms per step { {k: [round(t, 1) for t in r['ms_per_step']] for k, r in runs.items()} }"
          f"; float32 at dropout 0.1, against the step without remat: "
          f"{ {k: (v['loss'], v['loss_off'], v['max_grad_rel_err'], v['worst_parameter']) for k, v in grads.items()} }"
          f" (rtol {GRAD_RTOL})", flush=True)
    off = per_microbatch["off"]
    if per_microbatch != {"off": off, "full": 2 * off, "dots": off}:
        raise SystemExit(f"remat: K1 per microbatch {per_microbatch}")
    for label, v in grads.items():
        if v["max_grad_rel_err"] > GRAD_RTOL or abs(
                v["loss"] - loss0) > 1e-5 * abs(loss0):
            raise SystemExit(f"remat {label}: the gradients or the loss "
                             "differ from the step without remat")
    return {"train": runs, "f32_grads": {
        k: {n: x for n, x in v.items() if n != "counts"}
        for k, v in grads.items()}, "k1_per_microbatch": per_microbatch}


def check_approx_topk(train_cfg):
    """``rel_sample_approx_topk`` on the card: the exact top-k, so one train
    step with the flag equals the same step without it (the same weights,
    batch and generator): every loss term bit for bit, the gradient norm
    within the value kernel's run-to-run spread (GRAD_RTOL)."""
    hw = perf_train_step.BUCKET_HW
    results = {}
    for flag in (False, True):
        cfg = train_cfg.replace(rel_sample_approx_topk=flag)
        model, optimizer, generator = perf_train_step.build(cfg, DEVICE,
                                                            seed=0)
        batch = perf_train_step.synthetic_batch(cfg, 2, *hw, DEVICE, seed=0)
        step = make_train_step(model, cfg, optimizer, task="sgg")
        results[flag] = perf_train_step.time_steps(step, batch, generator, 1,
                                                   DEVICE)[1]
        del model, optimizer
    off, on = results[False], results[True]
    losses_equal = all(on[k] == off[k] for k in off if k != "grad_norm")
    norm_diff = abs(on["grad_norm"] - off["grad_norm"]) / off["grad_norm"]
    print(f"rel_sample_approx_topk (bf16, {hw[0]}x{hw[1]} b2, one step): "
          f"loss terms bit-equal to the step without the flag "
          f"{losses_equal} (total {on['total_loss']} vs "
          f"{off['total_loss']}); grad norm relative difference "
          f"{norm_diff:.3e}", flush=True)
    if not losses_equal or not norm_diff <= GRAD_RTOL:
        raise SystemExit("rel_sample_approx_topk: the step differs from the "
                         "step without the flag")
    return {"losses_bit_equal": losses_equal,
            "grad_norm_rel_diff": norm_diff, "total_loss": on["total_loss"]}


# --------------------------------------------------------------------------
# data-parallel: ranks of one process group started by torchrun with a
# timeout, two of them sharing the one card under gloo (NCCL refuses two
# ranks on one device); torchrun stops the others when one fails, and the
# phase fails
# --------------------------------------------------------------------------

DP_RANKS = 2
RANK_TIMEOUT_S = 600
# phase (a): the global batch of the data-parallel step (two images a
# rank), the loss terms held to one process's step on it, and their rtol
DDP_GLOBAL_BATCH = 4
DDP_LOSS_KEYS = ("total_loss", "loss_ce", "loss_bbox", "loss_giou",
                 "loss_rel", "grad_norm")
DDP_LOSS_RTOL = 1e-4
# phase (a)'s bf16 timing: after a warm-up step, this many rounds of a step
# and of the same step with its gradient reduction skipped
DDP_STEPS = 3
# phase (b): two ranks x two microbatches x two images
DDP_ADAPT_GLOBAL_BATCH = 8
# AdamW's eps (train/optim.py). A parameter that was zero takes a first
# step of lr * g / (|g| + eps): the update of such a parameter is held where
# its gradient is at least this many eps
ADAM_EPS = 1e-8
ZERO_INIT_HELD_EPS = 100
# the dry runs' world sizes: (d) one rank under NCCL, (e) two (dp 1 x mp 2)
# and four (dp 2 x mp 2) under gloo
DRYRUN_WORLDS = (1, 2, 4)
DP_NOTE = ("two ranks time-slice one card and gloo stages every collective "
           "through the host: not a node of cards, and not scaling")


def run_ranks(target, workdir, n=DP_RANKS, **kwargs):
    """``target`` (a function of this script) in ``n`` ranks on the card
    under torchrun (gloo: ``dist.init_from_env`` takes it for ranks that
    share a card); returns each rank's value."""
    return spawn(f"chip_smoke:{target}", n, workdir=workdir, kwargs=kwargs,
                 device=DEVICE, timeout=RANK_TIMEOUT_S)


def _rows(tree, lo, hi):
    if isinstance(tree, dict):
        return {k: _rows(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi]


def _digest(model) -> str:
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _f32_step(cfg, hw, global_batch, accum, lrs, device, rank=0, world=1,
              mesh=None):
    """One float32 step (TF32 off) of a seeded model on rank ``rank``'s
    slice of the seeded global batch (with ``mesh``: its data rank's, the
    model on the mesh): (metrics, model, launches, the learning rate of
    each trained parameter: ``{"lr": name -> lr, "zero": the same for the
    parameters that were zero before it}``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, optimizer, generator = perf_train_step.build(cfg, device, seed=0,
                                                        lrs=lrs, mesh=mesh)
    if mesh is not None:
        rank, world = mesh.data_index, mesh.dp
    zero = {n for n, p in model.named_parameters() if not p.any()}
    batch = perf_train_step.synthetic_batch(cfg, global_batch, *hw, device,
                                            seed=0)
    n = global_batch // world
    step = make_train_step(model, cfg, optimizer, accum_steps=accum)
    reset_kernel_counts()
    metrics = step(_rows(batch, rank * n, (rank + 1) * n), generator)
    torch.cuda.synchronize()
    lr = {id(p): float(g["lr"]) for g in optimizer.adamw.param_groups
          for p in g["params"]}
    lr_of = {n: lr[id(p)] for n, p in model.named_parameters() if id(p) in lr}
    return ({k: float(v) for k, v in metrics.items()}, model, kernel_counts(),
            {"lr": lr_of, "zero": {n: v for n, v in lr_of.items()
                                   if n in zero}})


def _one_process_twice(cfg, hw, global_batch, accum, lrs):
    """One process's float32 step, and its parameters after the same step
    taken a second time (on the host): their difference is the spread that
    the run-to-run round-off of the kernels' float32 atomics gives. Returns
    (metrics, model, learning rates as ``_f32_step``'s, the second
    parameters)."""
    _, again, _, _ = _f32_step(cfg, hw, global_batch, accum, lrs, DEVICE)
    again = {n: p.detach().cpu() for n, p in again.named_parameters()}
    torch.cuda.empty_cache()
    ref, model, _, step_lrs = _f32_step(cfg, hw, global_batch, accum, lrs,
                                        DEVICE)
    model.cpu()
    torch.cuda.empty_cache()
    return ref, model, step_lrs, again


def _save_step(model, path):
    """A step's parameters and gradients, on the host."""
    torch.save({n: (p.detach().cpu(), p.grad.cpu())
                for n, p in model.named_parameters()}, path)


@contextlib.contextmanager
def _unsynced():
    """The step with its gradient reduction skipped
    (``train_step.GradientReduction`` a no-op): the same step without the
    all-reduce, for timing only."""
    with mock.patch.object(train_step_module.GradientReduction, "__call__",
                           lambda self: None):
        yield


def rank_ddp_step(device, out):
    """Phase (a) in one rank: the float32 data-parallel step on the rank's
    two images (its parameters and gradients saved for the comparison);
    then bf16 steps at the probe's settings (dropout 0.1): a warm-up, and
    rounds of a step and the same step with its gradient reduction
    skipped, timed; and the reduction's all-reduce alone, of one buffer of
    every leaf's gradient bytes."""
    rank = dist.process_index()
    world = dist.process_count()
    cfg = perf_train_step.train_config(compute_dtype="float32", dropout=0.0)
    metrics, model, counts, _ = _f32_step(cfg, perf_train_step.BUCKET_HW,
                                          DDP_GLOBAL_BATCH, 1,
                                          perf_train_step.LRS, device, rank,
                                          world)
    if rank == 0:
        _save_step(model, f"{out}/rank0.pt")
    digest = _digest(model)
    del model
    torch.cuda.empty_cache()

    cfg = perf_train_step.train_config()
    model, optimizer, _ = perf_train_step.build(cfg, device, seed=0)
    generator = torch.Generator(device=device).manual_seed(1 + rank)
    n = DDP_GLOBAL_BATCH // world
    batch = _rows(perf_train_step.synthetic_batch(
        cfg, DDP_GLOBAL_BATCH, *perf_train_step.BUCKET_HW, device, seed=1),
        rank * n, (rank + 1) * n)
    step = make_train_step(model, cfg, optimizer)
    reset_kernel_counts()
    step(batch, generator)
    ms = {"synced": [], "unsynced": []}
    for _ in range(DDP_STEPS):
        for kind, times in ms.items():
            with (_unsynced() if kind == "unsynced"
                  else contextlib.nullcontext()):
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                bf16 = step(batch, generator)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
    bf16_counts = kernel_counts()
    grad_bytes = sum(4 * p.numel() for p in model.parameters())
    flat = torch.zeros(grad_bytes // 4, dtype=torch.float32, device=device)
    allreduce_ms = []
    for _ in range(3):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce_(flat, mean=True)
        torch.cuda.synchronize()
        allreduce_ms.append(1e3 * (time.perf_counter() - t0))
    return {"metrics": metrics, "digest": digest, "counts": counts,
            "bf16_ms_per_step": ms["synced"],
            "bf16_unsynced_ms_per_step": ms["unsynced"],
            "bf16_counts": bf16_counts,
            "bf16_total_loss": float(bf16["total_loss"]),
            "grad_bytes": grad_bytes, "allreduce_ms": allreduce_ms}


def _value_errs(values, ref_model):
    """Each parameter's largest |value - ref| over ref's largest entry."""
    errs = {}
    for n, p in ref_model.named_parameters():
        r = p.detach().cpu()
        errs[n] = float((values[n] - r).abs().max()) / max(
            float(r.abs().max()), 1e-12)
    return errs


def _zero_init_update_err(values, ref_model, zero, limit):
    """The first update of the parameters that were zero (``zero``: name ->
    lr) against one process's, over lr, at the entries where one process's
    clipped gradient g decides it: |g| at least ZERO_INIT_HELD_EPS x eps and
    ten times ``limit`` of the parameter's largest |g|. There the update
    lr * g / (|g| + eps) is lr to 1% with g's sign, and a gradient that
    differs by ``limit`` of the largest entry moves it by 1e-3 of lr; below,
    it follows the gradient's last bits. Returns (largest error over lr,
    its parameter, the entries held, and the largest |g| over eps at the
    entries whose update differs by more than ``limit`` x lr: the witness
    that those are the entries where |g| is near eps)."""
    worst, worst_name, held, differ_g = 0.0, "", 0, 0.0
    for n, p in ref_model.named_parameters():
        if n not in zero or p.grad is None:
            continue
        g = p.grad.cpu().abs()
        err = (values[n] - p.detach().cpu()).abs() / zero[n]
        if (err > limit).any():
            differ_g = max(differ_g, float(g[err > limit].max()) / ADAM_EPS)
        mask = g >= max(ZERO_INIT_HELD_EPS * ADAM_EPS,
                        10 * limit * float(g.max()))
        if not mask.any():
            continue
        held += int(mask.sum())
        if float(err[mask].max()) > worst:
            worst, worst_name = float(err[mask].max()), n
    return worst, worst_name, held, differ_g


def _adam_first_step_check(saved, ref_model, lr_of):
    """Open check F2: is the parameters' difference after one step the
    first AdamW update's, lr * g / (|g| + eps) of each side's clipped
    gradient g? Compares every trained entry's measured difference with
    lr * (u(g_rank) - u(g_one)), over the parameter's largest entry, and
    counts the entries whose gradients differ in sign. Returns the largest
    relative difference of the gradients (entry by entry, where one
    process's |g| is at least ZERO_INIT_HELD_EPS x eps), the sign flips,
    the largest unexplained residual, and the parameter of the largest
    measured difference with its lr and the |g| / eps of both sides
    there."""
    def u(g):
        return g / (g.abs() + ADAM_EPS)

    rel, flips, residual = 0.0, 0, 0.0
    worst = (0.0, "", 0.0, 0.0, 0.0)
    for name, p in ref_model.named_parameters():
        value, g_rank = saved[name]
        g_one = p.grad.cpu() if p.grad is not None else None
        if g_one is None or g_rank is None:
            continue
        g_rank = g_rank.double()
        g_one = g_one.double()
        flips += int((torch.sign(g_rank) != torch.sign(g_one)).sum())
        held = g_one.abs() >= ZERO_INIT_HELD_EPS * ADAM_EPS
        if held.any():
            rel = max(rel, float(((g_rank - g_one).abs()[held]
                                  / g_one.abs()[held]).max()))
        if name not in lr_of:
            continue
        ref = p.detach().cpu().double()
        scale = max(float(ref.abs().max()), 1e-12)
        measured = value.double() - ref
        predicted = -lr_of[name] * (u(g_rank) - u(g_one))
        residual = max(residual, float((measured - predicted).abs().max())
                       / scale)
        at = int(measured.abs().argmax())
        if float(measured.abs().flatten()[at]) / scale > worst[0]:
            worst = (float(measured.abs().flatten()[at]) / scale, name,
                     lr_of[name], float(g_rank.flatten()[at]) / ADAM_EPS,
                     float(g_one.flatten()[at]) / ADAM_EPS)
    return {"grad_max_entry_rel_err": rel, "grad_sign_flips": flips,
            "adam_residual_over_largest_entry": residual,
            "param_worst_delta": worst[0], "param_worst_delta_name": worst[1],
            "param_worst_delta_lr": worst[2],
            "param_worst_delta_grad_over_eps": [worst[3], worst[4]]}


def _compare_step(label, path, ref_model, step_lrs, limit, again):
    """Rank 0's step (``_save_step`` at ``path``) against one process's
    model after its step: each parameter's gradient and updated value, the
    largest difference over its largest entry, within ``limit``; the
    parameters that were zero before the step (``step_lrs["zero"]``: name
    -> lr) by their update where their gradient decides it
    (``_zero_init_update_err``), within ``limit`` x lr. Their values'
    largest difference over all entries is reported beside that of
    ``again``, one process's step taken a second time: the spread that the
    kernels' run-to-run round-off alone gives them. F2: the difference of
    the parameters against the first AdamW update's of the two gradients
    (``_adam_first_step_check``)."""
    zero = step_lrs["zero"]
    saved = torch.load(path)
    grad_err, grad_name = _largest_grad_err(
        {n: g for n, (_, g) in saved.items()},
        {n: p.grad.cpu() for n, p in ref_model.named_parameters()}, label)
    errs = _value_errs({n: v for n, (v, _) in saved.items()}, ref_model)
    again_errs = _value_errs(again, ref_model)
    param_name = max((n for n in errs if n not in zero), key=errs.get)
    zero_name = max(zero, key=errs.get) if zero else ""
    again_name = max(zero, key=again_errs.get) if zero else ""
    update_err, update_name, held, differ_g = _zero_init_update_err(
        {n: v for n, (v, _) in saved.items()}, ref_model, zero, limit)
    out = {"grad_max_rel_err": grad_err, "grad_worst": grad_name,
           "param_max_rel_err": errs[param_name], "param_worst": param_name,
           "zero_init_params": len(zero),
           "zero_init_update_err_over_lr": update_err,
           "zero_init_update_worst": update_name,
           "zero_init_entries_held": held,
           "zero_init_differing_max_grad_over_eps": differ_g,
           "zero_init_param_max_rel_err": errs.get(zero_name, 0.0),
           "zero_init_param_worst": zero_name,
           "one_process_again_zero_init_max_rel_err":
               again_errs.get(again_name, 0.0),
           "one_process_again_zero_init_worst": again_name,
           "one_process_again_param_max_rel_err": max(
               v for n, v in again_errs.items() if n not in zero),
           "limit": limit,
           **_adam_first_step_check(saved, ref_model, step_lrs["lr"])}
    text = (f"reduced gradients' largest error over their largest entry "
            f"{grad_err:.3e} ({grad_name}), updated parameters' "
            f"{errs[param_name]:.3e} ({param_name}), limit {limit}; the "
            f"{len(zero)} zero-initialised parameters' first update at the "
            f"{held} entries their gradient decides {update_err:.3e} of lr "
            f"({update_name}), limit {limit}, and where it differs by more "
            f"|g| <= {differ_g:.3g} eps; their values over all entries "
            f"{out['zero_init_param_max_rel_err']:.3e} ({zero_name}), one "
            f"process against itself "
            f"{out['one_process_again_zero_init_max_rel_err']:.3e} "
            f"({again_name}; the other parameters "
            f"{out['one_process_again_param_max_rel_err']:.3e}); F2: the "
            f"gradients' largest relative error entry by entry (|g| >= "
            f"{ZERO_INIT_HELD_EPS} eps) {out['grad_max_entry_rel_err']:.3e}, "
            f"{out['grad_sign_flips']} entries of another sign; the largest "
            f"parameter difference {out['param_worst_delta']:.3e} "
            f"({out['param_worst_delta_name']}, lr "
            f"{out['param_worst_delta_lr']:.1e}, |g| / eps there "
            f"{[round(v, 3) for v in out['param_worst_delta_grad_over_eps']]}"
            f"), the parameters' difference less the first AdamW update's "
            f"of the two gradients {out['adam_residual_over_largest_entry']:.3e}"
            f" of the largest entry")
    if (grad_err > limit or errs[param_name] > limit or update_err > limit
            or (zero and not held)):
        raise SystemExit(f"{label}: {text}")
    return out, text


def _check_ranks(label, ranks, ref, keys, expect_counts):
    """The ranks' metrics equal each other and, for ``keys``, one process's
    within DDP_LOSS_RTOL; their parameters bit-equal; each rank's launches
    ``expect_counts``."""
    bad = []
    if any(r["metrics"] != ranks[0]["metrics"] for r in ranks):
        bad.append("the ranks' metrics differ")
    if any(r["digest"] != ranks[0]["digest"] for r in ranks):
        bad.append("the ranks' parameters differ")
    for k in keys:
        got, want = ranks[0]["metrics"][k], ref[k]
        if not abs(got - want) <= DDP_LOSS_RTOL * abs(want):
            bad.append(f"{k} {got} vs one process's {want}")
    for r, rank in enumerate(ranks):
        if rank["counts"] != expect_counts:
            bad.append(f"rank {r} launches {rank['counts']}, expected "
                       f"{expect_counts}")
    if bad:
        raise SystemExit(f"{label}: {bad}")


def check_ddp(single_rank_ms):
    """Phase (a): the data-parallel step at full width, two ranks on the
    card, against one process's step on the same global batch; then the
    ranks' bf16 steps with and without their gradient reduction, the
    reduction's all-reduce alone and the gradient bytes (``DP_NOTE``)."""
    t_phase = time.perf_counter()
    hw = perf_train_step.BUCKET_HW
    cfg = perf_train_step.train_config(compute_dtype="float32", dropout=0.0)
    ref, model, step_lrs, again = _one_process_twice(
        cfg, hw, DDP_GLOBAL_BATCH, 1, perf_train_step.LRS)
    with tempfile.TemporaryDirectory() as work:
        ranks = run_ranks("rank_ddp_step", work, out=work)
        step_errs, step_text = _compare_step("ddp f32", f"{work}/rank0.pt",
                                             model, step_lrs, GRAD_RTOL,
                                             again)
    del model
    shapes = level_shapes(hw, cfg.num_feature_levels)
    _check_ranks("ddp f32", ranks, ref, DDP_LOSS_KEYS,
                 step_counts(cfg, shapes))
    bf16_expect = {k: v * (1 + 2 * DDP_STEPS) for k, v in step_counts(
        perf_train_step.train_config(), shapes).items()}
    if any(r["bf16_counts"] != bf16_expect for r in ranks):
        raise SystemExit(f"ddp bf16: launches per rank "
                         f"{[r['bf16_counts'] for r in ranks]}, expected "
                         f"{bf16_expect}")
    ms, unsynced = ([max(r[key][i] for r in ranks) for i in range(DDP_STEPS)]
                    for key in ("bf16_ms_per_step",
                                "bf16_unsynced_ms_per_step"))
    exposed = [a - b for a, b in zip(ms, unsynced)]
    exposed_median = sorted(exposed)[len(exposed) // 2]
    allreduce = [max(r["allreduce_ms"][i] for r in ranks) for i in range(3)]
    seconds = time.perf_counter() - t_phase
    print(f"ddp (a): {DP_RANKS} ranks (gloo, CUDA tensors) on one card, "
          f"float32 at {hw[0]}x{hw[1]}, global batch {DDP_GLOBAL_BATCH}: "
          + ", ".join(f"{k} {ranks[0]['metrics'][k]:.6f} vs one process's "
                      f"{ref[k]:.6f}" for k in DDP_LOSS_KEYS)
          + f"; {step_text}; ranks' parameters bit-equal; launches per "
          f"rank {ranks[0]['counts']}. bf16 (dropout 0.1, 2 images a rank, "
          f"after a warm-up step): ms per optimizer step "
          f"{[round(t, 1) for t in ms]} on {DP_RANKS} ranks, "
          f"{[round(t, 1) for t in unsynced]} with the step's gradient "
          f"reduction skipped, the reduction's exposed ms "
          f"{[round(t, 1) for t in exposed]} (median {exposed_median:.1f}); "
          f"{[round(t, 1) for t in single_rank_ms]} on one process "
          f"(phase 10); all-reduce of {ranks[0]['grad_bytes']} gradient "
          f"bytes alone, one buffer: "
          f"{[round(t, 1) for t in allreduce]} ms ({DP_NOTE}); "
          f"{seconds:.1f} s", flush=True)
    return {"metrics": ranks[0]["metrics"], "one_process": ref, **step_errs,
            "counts_per_rank": [r["counts"] for r in ranks],
            "bf16_counts_per_rank": [r["bf16_counts"] for r in ranks],
            "bf16_ms_per_step": ms, "bf16_unsynced_ms_per_step": unsynced,
            "exposed_reduction_ms": exposed,
            "exposed_reduction_ms_median": exposed_median,
            "one_process_ms_per_step": single_rank_ms,
            "allreduce_alone_ms": allreduce,
            "grad_bytes": ranks[0]["grad_bytes"], "seconds": seconds,
            "note": DP_NOTE}


def rank_adapt_accum(device, out):
    """Phase (b) in one rank: the adaptation config's float32 step,
    accumulation 2, on the rank's half of the global batch."""
    rank = dist.process_index()
    cfg = perf_train_step.adapt_config(compute_dtype="float32", dropout=0.0)
    metrics, model, counts, _ = _f32_step(
        cfg, perf_train_step.ADAPT_HW, DDP_ADAPT_GLOBAL_BATCH, 2,
        perf_train_step.ADAPT_LRS, device, rank, dist.process_count())
    if rank == 0:
        _save_step(model, f"{out}/rank0.pt")
    return {"metrics": metrics, "digest": _digest(model), "counts": counts}


def check_adapt_accum():
    """Phase (b): two ranks x accumulation 2 x the adaptation config (window
    16, one band per point) at 608x1008, float32, against one process's
    accumulated step on the same global batch."""
    t_phase = time.perf_counter()
    cfg = perf_train_step.adapt_config(compute_dtype="float32", dropout=0.0)
    hw, global_batch = perf_train_step.ADAPT_HW, DDP_ADAPT_GLOBAL_BATCH
    ref, model, step_lrs, again = _one_process_twice(
        cfg, hw, global_batch, 2, perf_train_step.ADAPT_LRS)
    with tempfile.TemporaryDirectory() as work:
        ranks = run_ranks("rank_adapt_accum", work, out=work)
        step_errs, step_text = _compare_step(
            "ddp adaptation", f"{work}/rank0.pt", model, step_lrs,
            ADAPT_GRAD_RTOL, again)
    del model
    loss_keys = [k for k in DDP_LOSS_KEYS if k in ref]
    expect = {k: 2 * v for k, v in step_counts(
        cfg, level_shapes(hw, cfg.num_feature_levels)).items()}
    _check_ranks("ddp adaptation", ranks, ref, loss_keys, expect)
    seconds = time.perf_counter() - t_phase
    banded = {k: [r["counts"][k] for r in ranks] for k in (
        "msda_fwd_win_pp", "msda_bwd_win_rows_pp", "msda_bwd_win_value_pp")}
    print(f"ddp (b): {DP_RANKS} ranks x accum 2 x window {cfg.msda_window} "
          f"per point, float32 at {hw[0]}x{hw[1]}, global batch "
          f"{global_batch}: "
          + ", ".join(f"{k} {ranks[0]['metrics'][k]:.6f} vs one process's "
                      f"{ref[k]:.6f}" for k in loss_keys)
          + f"; {step_text}; K6/K8/K10 per rank {banded}; {seconds:.1f} s",
          flush=True)
    return {"metrics": ranks[0]["metrics"], "one_process": ref, **step_errs,
            "counts_per_rank": [r["counts"] for r in ranks],
            "seconds": seconds}


def rank_drivers(device, runs):
    """The drivers' ``main`` one after another in one rank, in one process
    group; ``runs``: [driver, argv, path or None]. Per run: the metrics its
    evaluation returned, the files it wrote with ``torch.save`` (the
    collectives pickle through it too, into memory), its launches measured
    on the card (``CardLaunches``: the programs the rank replays launch
    without their wrappers) and those its wrappers saw (``wrapper_counts``:
    the eager calls alone), its seconds, and on rank 0 the JSON at ``path``
    as the run left it."""
    import importlib

    from egtr_tpu_torch.evaluation import runner

    seen = {}
    real_save = torch.save

    def save(obj, f, *a, **kw):
        if isinstance(f, (str, os.PathLike)):   # not the collectives' bytes
            seen["saved"].append(str(f))
        return real_save(obj, f, *a, **kw)

    def capture(real):
        def evaluate(*a, **kw):
            seen["metrics"] = real(*a, **kw)
            return seen["metrics"]
        return evaluate

    torch.save = save
    for fn in ("evaluate_sgg", "evaluate_detection"):
        setattr(runner, fn, capture(getattr(runner, fn)))
    results = []
    for driver, argv, path in runs:
        seen["saved"] = []
        reset_kernel_counts(on_card=True)
        t0 = time.perf_counter()
        importlib.import_module(f"egtr_tpu_torch.scripts.{driver}").main(argv)
        torch.cuda.synchronize()
        wrapper = {k: msda_cuda.launches[k] for k in msda_cuda.KERNELS}
        run = {"metrics": seen.pop("metrics"), "saved": seen["saved"],
               "counts": kernel_counts(), "wrapper_counts": wrapper,
               "seconds": time.perf_counter() - t0}
        if path and dist.is_primary():
            with open(path) as f:
                run["read"] = json.load(f)
        results.append(run)
    return results


def _same_metrics(a, b) -> bool:
    return a.keys() == b.keys() and all(
        (math.isnan(a[k]) and math.isnan(b[k]))
        or math.isclose(a[k], b[k], rel_tol=1e-12, abs_tol=1e-12)
        for k in a)


def _rank_forwards(args, world, synth):
    """Per rank: (forwards, microbatches) of one driver run, each phase one
    epoch of global batches of ``batch_size x world x accumulate``, the
    validation's of ``batch_size x world``, one test image a rank."""
    batch, accum = (int(args[args.index(k) + 1])
                    for k in ("--batch_size", "--accumulate"))
    steps = synth["n_train"] // (batch * world * accum)
    val_batches = -(-synth["n_val"] // (batch * world))
    microbatches = 2 * steps * accum
    return (microbatches + 2 * val_batches
            + -(-synth["n_test"] // world)), microbatches


def drive_ranks(workdir):
    """Phase (c): ``train_egtr``, ``evaluate_egtr`` and ``pretrain_detr`` on
    two ranks on the card (gloo), one after another in the same ranks, on
    a synthetic set like phase 17's with two test images a rank; then one
    process's ``evaluate_egtr`` of the artifact. The steps hold collectives
    and run eagerly under gloo; the evaluation's forward holds none and is
    each rank's captured program, which the second test image replays: the
    launches are counted on each rank's card trace, and the wrappers of
    ``evaluate_egtr`` see the warm-up's alone."""
    from egtr_tpu_torch.scripts import evaluate_egtr
    from egtr_tpu_torch.scripts.make_synth_vg import make_synth_vg

    t_phase = time.perf_counter()
    synth = dict(SYNTH_VG, n_test=2 * DP_RANKS)
    data = f"{workdir}/vg_dp"
    make_synth_vg(data, seed=0, **synth)
    out, pre_out = f"{workdir}/run_dp", f"{workdir}/pretrain_dp"
    on_card = ["--device", DEVICE]
    eval_argv = ["--data_path", data, "--artifact_path", f"{out}/artifact",
                 "--coco_eval", "true"]
    ranks = run_ranks("rank_drivers", f"{workdir}/ranks", runs=[
        ["train_egtr", ["--data_path", data, "--output_path", out, *on_card,
                        *DRIVER_ARGS], f"{out}/metrics_test.json"],
        ["evaluate_egtr", [*eval_argv, *on_card], None],
        ["pretrain_detr", ["--data_path", data, "--output_path", pre_out,
                           *on_card, *PRETRAIN_ARGS], None]])
    train, two, pre = zip(*ranks)
    t_train, t_two, t_pre = (max(r["seconds"] for r in runs)
                             for runs in (train, two, pre))
    written = train[0]["read"]
    bad = []
    records = {p: _records(f"{out}/{p}/metrics.jsonl")
               for p in ("main", "finetune")}
    forwards, microbatches = _rank_forwards(DRIVER_ARGS, DP_RANKS, synth)
    steps = microbatches // 2 // int(
        DRIVER_ARGS[DRIVER_ARGS.index("--accumulate") + 1])
    for phase, recs in records.items():
        kinds = [r["phase"] for r in recs]
        if kinds != ["train"] * steps + ["val"]:
            bad.append(f"{phase} metrics.jsonl holds {kinds}")
    artifact = sorted(os.listdir(f"{out}/artifact"))
    weights = [f for r in train for f in r["saved"]
               if f.endswith("weights.pt")]
    if artifact != ["config.json", "weights.pt"] or len(weights) != 1:
        bad.append(f"artifact {artifact}, weights written {weights}")
    if train[1]["saved"]:
        bad.append(f"rank 1 wrote {train[1]['saved']}")
    if not _same_metrics(train[0]["metrics"], train[1]["metrics"]):
        bad.append("the ranks' test metrics differ")
    if not _same_metrics(written, train[0]["metrics"]):
        bad.append("metrics_test.json is not the ranks' metrics")
    # one process's evaluation of the same artifact
    t0 = time.perf_counter()
    one = evaluate_egtr.main([*eval_argv, "--device", DEVICE])
    t_one = time.perf_counter() - t0
    if not _same_metrics({k: one[k] for k in written}, written):
        bad.append(f"one process's evaluate_egtr {one} vs {written}")
    if not all(_same_metrics(r["metrics"], one) for r in two):
        bad.append("evaluate_egtr on two ranks differs from one process")
    if not _same_metrics(pre[0]["metrics"], pre[1]["metrics"]):
        bad.append("pretrain_detr: the ranks' test metrics differ")
    cfg = perf_train_step.train_config()
    per_forward = cfg.encoder_layers + cfg.decoder_layers
    expect = {}
    for name, runs, args in (("train_egtr", train, DRIVER_ARGS),
                             ("pretrain_detr", pre, PRETRAIN_ARGS)):
        fwd, mbs = _rank_forwards(args, DP_RANKS, synth)
        expect[name] = {**dict.fromkeys(msda_cuda.KERNELS, 0),
                        "msda_fwd": per_forward * fwd,
                        "msda_bwd_rows": per_forward * mbs,
                        "msda_bwd_value": per_forward * mbs}
        for r, run in enumerate(runs):
            if run["counts"] != expect[name]:
                bad.append(f"{name} rank {r} launches {run['counts']}, "
                           f"expected {expect[name]}")
    # evaluate_egtr: one forward a test image; on the card the first is
    # the program's warm-up, the wrappers' only launches, and the others
    # replays
    test_forwards = -(-synth["n_test"] // DP_RANKS)
    expect["evaluate_egtr"] = {**dict.fromkeys(msda_cuda.KERNELS, 0),
                               "msda_fwd": per_forward * test_forwards}
    replayed = torch.device(DEVICE).type == "cuda"
    for r, run in enumerate(two):
        eager_fwd = per_forward if replayed else per_forward * test_forwards
        if run["counts"] != expect["evaluate_egtr"] or (
                run["wrapper_counts"]["msda_fwd"] != eager_fwd):
            bad.append(f"evaluate_egtr rank {r} launches {run['counts']} "
                       f"(wrappers {run['wrapper_counts']}), expected "
                       f"{expect['evaluate_egtr']}, {eager_fwd} K1 eager")
    seconds = time.perf_counter() - t_phase
    print(f"ddp (c): the drivers on {DP_RANKS} ranks (gloo) on one card, "
          f"{synth}: train_egtr ({' '.join(DRIVER_ARGS)}) {t_train:.1f} s,"
          f" launches per rank {[r['counts']['msda_fwd'] for r in train]} K1 "
          f"/ {[r['counts']['msda_bwd_rows'] for r in train]} K2 / "
          f"{[r['counts']['msda_bwd_value'] for r in train]} K3, test "
          f"metrics {written}; evaluate_egtr on {DP_RANKS} ranks "
          f"{t_two:.1f} s, its forward a program in each rank: K1 per rank "
          f"{[r['counts']['msda_fwd'] for r in two]} on the card, "
          f"{[r['wrapper_counts']['msda_fwd'] for r in two]} through the "
          f"wrappers (the warm-up); pretrain_detr ({' '.join(PRETRAIN_ARGS)}) "
          f"{t_pre:.1f} s, test metrics {pre[0]['metrics']}; one process's "
          f"evaluate_egtr {t_one:.1f} s, equal to 1e-12 to both ranks' runs; "
          f"{seconds:.1f} s", flush=True)
    if bad:
        raise SystemExit(f"ddp drivers: {bad}")
    return {"train_seconds": t_train, "evaluate_one_seconds": t_one,
            "evaluate_seconds": t_two, "pretrain_seconds": t_pre,
            "seconds": seconds, "test": written,
            "counts_per_rank": {"train": [r["counts"] for r in train],
                                "evaluate": [r["counts"] for r in two],
                                "pretrain": [r["counts"] for r in pre]}}


def check_dryruns():
    """Phases (d) and (e): ``dryrun_multichip`` in one rank, whose group
    runs NCCL on the card (world size 1, torchrun's variables), and in two
    (dp 1 x mp 2) and four (dp 2 x mp 2) ranks sharing the card (gloo):
    one step on the JAX dry run's mesh, the loader shards and the
    evaluator merge (``all_gather_objects``) in each."""
    out = {}
    for n in DRYRUN_WORLDS:
        backend = "nccl" if n == 1 and DEVICE == "cuda" else "gloo"
        t0 = time.perf_counter()
        result = dryrun.dryrun_multichip(n, device=DEVICE,
                                         timeout=RANK_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        launched = result["launches"]
        print(f"ddp ({'d' if n == 1 else 'e'}): dryrun_multichip({n}) on "
              f"{result['backend']}, dp x mp {result['mesh']}, the step "
              f"{'captured' if result['captured'] else 'eager'}: launches "
              f"{launched}; {seconds:.1f} s", flush=True)
        # the step holds its gradient reduction: a program under NCCL
        if result["backend"] != backend or result["captured"] != (
                backend == "nccl") or not all(
                launched[k] for k in ("msda_fwd", "msda_bwd_rows",
                                      "msda_bwd_value")):
            raise SystemExit(f"dryrun_multichip({n}): backend "
                             f"{result['backend']} (expected {backend}), "
                             f"captured {result['captured']}, launches "
                             f"{launched}")
        out[f"world_{n}"] = {**result, "seconds": seconds}
    return out


# --------------------------------------------------------------------------
# phase (j): the data-parallel step as programs in one rank under NCCL,
# its gradient all-reduce inside the graph
# --------------------------------------------------------------------------

NCCL_NOTE = ("one rank under NCCL (world 1): the collective is NCCL's "
             "one-rank kernel, not a ring over NVLink; the programs and "
             "their capture are those of any world size")


def _bf16_pair(cfg, accum, device):
    """One bf16 model's step as programs and eager (``_eager_steps``), at
    batch 2 x ``accum``: the programs' first call (the warm-up and the
    capture) and a second, the memory then (as (i) takes it, before the
    eager step exists); one replay traced on the card (the kernels, the
    matcher, NCCL's kernels); then the eager step's first call. Returns
    (the model, the two steps, the batch, the generator, the trace, the
    memory)."""
    model, optimizer, generator = perf_train_step.build(cfg, device, seed=0)
    batch = perf_train_step.synthetic_batch(
        cfg, 2 * accum, *perf_train_step.BUCKET_HW, device, seed=1)
    steps = {"graph": make_train_step(model, cfg, optimizer,
                                      accum_steps=accum)}
    steps["graph"](batch, generator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps["graph"](batch, generator)
    memory = _memory()
    reset_kernel_counts(on_card=True)
    steps["graph"](batch, generator)
    torch.cuda.synchronize()
    trace = {"counts": kernel_counts(), "matched": matcher_launches(),
             "nccl": collective_launches()}
    with _eager_steps():
        steps["eager"] = make_train_step(model, cfg, optimizer,
                                         accum_steps=accum)
    steps["eager"](batch, generator)
    return model, steps, batch, generator, trace, memory


def _programs_of(fn, names):
    """How many programs each of ``fn``'s functions holds (0 where it runs
    eagerly: ``maybe_aot`` gave the function itself)."""
    return {n: len(getattr(getattr(fn, n), "programs", {})) for n in names}


def rank_nccl_programs(device):
    """Phase (j) in one rank (world 1, torchrun's variables; NCCL on the
    card): (i)'s float32 runs, their launches measured on the card, and
    (i)'s rule; bf16 steps at batch 2 and 2 x accum 2 as programs against
    eager in turns, with a replay of each traced and the programs' memory;
    the eval step and the runner's forward as programs, a replay of each
    traced. A failure of the rule returns its message."""
    from egtr_tpu_torch.train.train_step import make_eval_step

    out = {"backend": torch.distributed.get_backend()}
    hw = perf_train_step.BUCKET_HW
    cfg = perf_train_step.train_config()
    f32 = cfg.replace(compute_dtype="float32", dropout=0.0)
    runs = f32_runs(f32, hw, on_card=True)
    out["f32_launches"] = {w: [r["counts"], r["matched"]]
                           for w, r in runs.items()
                           if w in ("graph", "eager_0")}
    try:
        out["float32"] = f32_rule(runs, "(j)")
    except SystemExit as e:
        return {**out, "failed": str(e)}
    del runs
    torch.cuda.empty_cache()
    out["ms_in_turns"], out["traced"], out["memory"] = {}, {}, {}
    out["programs"] = {}
    for accum in (2, 1):
        model, steps, batch, generator, trace, memory = _bf16_pair(
            cfg, accum, device)
        times = {"graph": [], "eager": []}
        for _ in range(TRAIN_GRAPH_TURNS):
            for way in ("graph", "eager"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                steps[way](batch, generator)
                torch.cuda.synchronize()
                times[way].append((time.perf_counter() - t0) * 1e3)
        key = f"b2_accum{accum}"
        out["ms_in_turns"][key], out["traced"][key] = times, trace
        out["memory"][key] = memory
        out["programs"][key] = _programs_of(steps["graph"],
                                            ("whole", "grads_mb", "apply"))
        if accum == 2:
            del model, steps, batch, generator
            torch.cuda.empty_cache()
    # the eval step and the runner's forward (no collective at world 1)
    batch = perf_train_step.synthetic_batch(cfg, 2, *hw, device, seed=1)
    eval_step = make_eval_step(model, cfg)
    first = eval_step(batch)[1]
    reset_kernel_counts(on_card=True)
    replayed = eval_step(batch)[1]
    torch.cuda.synchronize()
    out["eval"] = {"counts": kernel_counts(), "matched": matcher_launches(),
                   "programs": len(getattr(eval_step.program, "programs",
                                           {})),
                   "total_loss": [float(first["total_loss"]),
                                  float(replayed["total_loss"])]}
    images = {"pixel_values": batch["pixel_values"].cpu().numpy(),
              "pixel_mask": batch["pixel_mask"].cpu().numpy()}
    run = runner_module.infer_program(model, cfg)
    first = run(images)
    reset_kernel_counts(on_card=True)
    replayed = run(images)
    torch.cuda.synchronize()
    out["runner"] = {"counts": kernel_counts(),
                     "programs": len(getattr(run.program, "programs", {})),
                     "max_abs_delta_to_warm_up": _max_delta(replayed,
                                                            first)[0]}
    return out


def check_nccl_programs(one_process):
    """Phase (j): ``rank_nccl_programs`` in one rank under NCCL on the card
    (gloo where the device is not a card), against (i)'s one-process
    programs (``one_process``: phase (i)'s result and phase 10's ms per
    step). Under NCCL every step function is a program, its gradient
    all-reduce among the replay's kernels; the float32 runs pass (i)'s rule
    with the planted faults outside; K1/K2/K3 and the matcher launch as in
    one process; the eval step and the runner's forward replay
    (``NCCL_NOTE``)."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        (rank,) = run_ranks("rank_nccl_programs", work, n=1)
    if "failed" in rank:
        raise SystemExit(rank["failed"])
    on_card = torch.device(DEVICE).type == "cuda"
    backend = "nccl" if on_card else "gloo"
    captured = rank["backend"] == "nccl"
    hw = perf_train_step.BUCKET_HW
    cfg = perf_train_step.train_config()
    shapes = level_shapes(hw, cfg.num_feature_levels)
    per_mb, per_mb_f32 = (step_counts(c, shapes) for c in (
        cfg, cfg.replace(compute_dtype="float32", dropout=0.0)))
    bad = []
    if rank["backend"] != backend:
        bad.append(f"backend {rank['backend']}, expected {backend}")
    for way, (c, m) in rank["f32_launches"].items():
        if c != {k: TRAIN_STEPS * v for k, v in per_mb_f32.items()} or (
                m != TRAIN_STEPS * matches_per_pass(cfg)):
            bad.append(f"float32 {way}: launches {c}, matcher {m}")
    # at world 1 the microbatch holds no collective: a program under any
    # backend; the whole step and the apply hold the gradient reduction
    expect_programs = {
        "b2_accum1": {"whole": int(captured), "grads_mb": 0, "apply": 0},
        "b2_accum2": {"whole": 0, "grads_mb": 1, "apply": int(captured)}}
    if rank["programs"] != expect_programs:
        bad.append(f"programs {rank['programs']}, expected "
                   f"{expect_programs}")
    for key, trace in rank["traced"].items():
        accum = int(key[-1])
        if trace["counts"] != {k: accum * v for k, v in per_mb.items()} or (
                trace["matched"] != accum * matches_per_pass(cfg)):
            bad.append(f"{key} replay: launches {trace['counts']}, "
                       f"matcher {trace['matched']}")
        if on_card and not trace["nccl"]:
            bad.append(f"{key} replay: no NCCL kernel in its trace")
    per_forward = forward_counts(cfg, shapes)
    if rank["eval"]["counts"] != per_forward or (
            rank["eval"]["matched"] != matches_per_pass(cfg)) or (
            rank["runner"]["counts"] != per_forward):
        bad.append(f"eval / runner replays: launches {rank['eval']} / "
                   f"{rank['runner']}")
    # neither holds a collective at world 1 (the runner's is itself where
    # the device is not a card)
    if (rank["eval"]["programs"], rank["runner"]["programs"]) != (
            1, int(on_card)):
        bad.append(f"eval / runner programs {rank['eval']['programs']} / "
                   f"{rank['runner']['programs']}")
    if not all(math.isfinite(x) for x in rank["eval"]["total_loss"]):
        bad.append(f"eval losses {rank['eval']['total_loss']}")
    seconds = time.perf_counter() - t_phase
    f32 = rank["float32"]
    one = one_process["train_graphs"]["bf16_accum2"]
    print(f"(j) the data-parallel step in one rank on {rank['backend']} "
          f"({NCCL_NOTE}), as programs: {rank['programs']}; float32 3 "
          f"steps against eager in the rank, {_f32_text(f32)}; the "
          f"replays' kernels K1/K2/K3, matcher, NCCL "
          + "; ".join(f"{k} {t['counts']['msda_fwd']}/"
                      f"{t['counts']['msda_bwd_rows']}/"
                      f"{t['counts']['msda_bwd_value']}, {t['matched']}, "
                      f"{t['nccl']}" for k, t in rank["traced"].items())
          + f"; bf16 ms per step in turns {rank['ms_in_turns']}, one "
          f"process's programs (i) b2 x accum 2 {one['ms_in_turns']} and "
          f"phase 10's b2 {one_process['ms_per_step']}; (peak allocated, "
          f"reserved) GB of the programs {rank['memory']}, one process's "
          f"b2 x accum 2 ({one['peak_allocated_gb']['graph']}, "
          f"{one['reserved_gb']['graph']}); the eval step {rank['eval']} "
          f"and the runner's forward {rank['runner']} replayed; "
          f"{seconds:.1f} s", flush=True)
    if bad:
        raise SystemExit(f"(j): {bad}")
    return {**rank, "seconds": seconds, "note": NCCL_NOTE,
            "counts_per_rank": [rank["traced"]["b2_accum1"]["counts"]],
            "one_process_ms_in_turns": one["ms_in_turns"],
            "one_process_reserved_gb": one["reserved_gb"]["graph"]}


# --------------------------------------------------------------------------
# phase (f): the model axis (--mp), dp 1 x mp 2, two ranks time-slicing the
# card under gloo; each computes half of the relation grid's rows
# --------------------------------------------------------------------------

TP_MP = 2
# the float32 step's and the bf16 rounds' global batch (one data rank)
TP_GLOBAL_BATCH = 2
# bf16 rounds after a warm-up step
TP_STEPS = 3
TP_NOTE = ("two ranks time-slice one card and gloo stages each collective "
           "through the host: correctness and memory per rank, not scaling")
# the trained model's float32 evaluation forward, mp 2 vs one process: the
# same kernels at the same shapes; the head's products over half the rows
# differ in summation order only, so MODEL_ATOL's bound serves
TP_EVAL_ATOL = MODEL_ATOL


def _head_inputs(model):
    """Keep the relation head's inputs of the model's next forwards (the
    last one): (the dict they go into, the hook's handle)."""
    seen = {}

    def pre(module, args, kwargs):
        seen["args"] = [a.detach() for a in args]
        seen["kwargs"] = kwargs

    return seen, model.relation_head.register_forward_pre_hook(
        pre, with_kwargs=True)


def head_peak_bytes(head, seen):
    """The relation head alone on kept inputs (``_head_inputs``): the peak
    bytes allocated above what was allocated before it, over its forward
    and over its forward and backward. Every rank of a model group calls
    it together (the head's collectives)."""
    args = [a.clone().requires_grad_(a.is_floating_point())
            for a in seen["args"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = head(*args, **seen["kwargs"])
    torch.cuda.synchronize()
    fwd = torch.cuda.max_memory_allocated() - base
    (out["pred_rel_logits"].sum()
     + out["pred_connectivity_logits"].sum()).backward()
    torch.cuda.synchronize()
    return fwd, torch.cuda.max_memory_allocated() - base


@contextlib.contextmanager
def _recording(calls, group):
    """Record (op, shape, dtype) of every sum ("all_reduce", in place:
    ``dist.all_reduce_``, which ``all_reduce_sum`` calls too) and gather
    ("all_gather") over ``group`` meanwhile."""
    real = {op: getattr(dist, fn) for op, fn in COLLECTIVES.items()}

    def recorder(op):
        def record(tensor, group_=None, *rest, **kw):
            if group_ is group:
                calls.append((op, tuple(tensor.shape), tensor.dtype))
            return real[op](tensor, group_, *rest, **kw)
        return record

    for op in real:
        setattr(dist, COLLECTIVES[op], recorder(op))
    try:
        yield
    finally:
        for op, fn in real.items():
            setattr(dist, COLLECTIVES[op], fn)


# the collectives ``_recording`` names, by the function of ``dist`` each is
COLLECTIVES = {"all_reduce": "all_reduce_", "all_gather": "all_gather"}


def _replay_ms(calls, group, device, mp, gather_as_sum=False):
    """The recorded collectives of one step (``_recording``) alone, three
    times: ms of each round. ``gather_as_sum``: each gather as the sum of
    zero-filled buffers of the gathered size, each rank's rows written in
    place (the all_reduce a gather would be without ``all_gather``)."""
    bufs = []
    for op, shape, dtype in calls:
        if op == "all_gather" and gather_as_sum:
            op, shape = "all_reduce", (shape[0], shape[1] * mp, *shape[2:])
        bufs.append((getattr(dist, COLLECTIVES[op]),
                     torch.zeros(shape, dtype=dtype, device=device)))
    ms = []
    for _ in range(3):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for collective, b in bufs:
            collective(b, group)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return ms


def trained_forward(artifact, data, device, mesh=None):
    """The float32 evaluation forward (TF32 off) of a trained artifact, on
    the model of ``mesh``, of the first test image of the synthetic set at
    ``data`` as the drivers load it: its relation and connectivity logits,
    on the host."""
    from egtr_tpu_torch.data.loader import Loader
    from egtr_tpu_torch.data.visual_genome import VGDataset
    from egtr_tpu_torch.train.checkpoint import load_pretrained

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, sd = load_pretrained(artifact)
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    model = EgtrModel(cfg, mesh=mesh)
    model.load_state_dict(sd, strict=True)
    batch = next(iter(Loader(VGDataset(data, "test", size=800,
                                       max_size=1333), 1, shuffle=False,
                             max_gt=cfg.max_gt_boxes,
                             num_rel_labels=cfg.num_rel_labels,
                             num_workers=1)))
    model = model.to(device).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(batch["pixel_values"]).to(device),
                    torch.from_numpy(batch["pixel_mask"]).to(device))
    return {k: out[k].float().cpu() for k in ("pred_rel_logits",
                                              "pred_connectivity_logits")}


def _bf16_rounds(model, optimizer, generator, device):
    """The probe's bf16 step (dropout 0.1) on the seeded global batch of
    TP_GLOBAL_BATCH: a warm-up step that keeps the head's inputs, then
    TP_STEPS timed steps with the step's peak memory. Returns (ms per step,
    peak bytes, the warm-up's kept head inputs, the last metrics)."""
    cfg = model.config
    batch = perf_train_step.synthetic_batch(
        cfg, TP_GLOBAL_BATCH, *perf_train_step.BUCKET_HW, device, seed=1)
    step = make_train_step(model, cfg, optimizer)
    seen, handle = _head_inputs(model)
    step(batch, generator)
    handle.remove()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, metrics = [], {}
    for _ in range(TP_STEPS):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(batch, generator)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return ms, torch.cuda.max_memory_allocated(), seen, metrics


def rank_tp(device, out, runs):
    """Phase (f) in one rank of dp 1 x mp 2: the float32 step on the
    global batch (its launches checked; rank 0's parameters and gradients
    saved for the comparison); the bf16 rounds, the model group's
    collectives of one step replayed alone, the head's peak memory; then
    the drivers ``runs`` (``rank_drivers``)."""
    mesh = make_mesh(1, TP_MP)
    rank = dist.process_index()
    cfg = perf_train_step.train_config(compute_dtype="float32", dropout=0.0)
    metrics, model, counts, _ = _f32_step(
        cfg, perf_train_step.BUCKET_HW, TP_GLOBAL_BATCH, 1,
        perf_train_step.LRS, device, mesh=mesh)
    # a rank that did not run the kernels fails here, before the rest
    expect = step_counts(cfg, level_shapes(perf_train_step.BUCKET_HW,
                                           cfg.num_feature_levels))
    if counts != expect:
        raise SystemExit(f"tp (f) rank {rank}: launches {counts}, expected "
                         f"{expect}")
    if rank == 0:
        _save_step(model, f"{out}/rank0.pt")
    digest = _digest(model)
    del model
    torch.cuda.empty_cache()

    model, optimizer, generator = perf_train_step.build(
        perf_train_step.train_config(), device, seed=0, mesh=mesh)
    calls = []
    reset_kernel_counts()
    with _recording(calls, mesh.model_group):
        ms, peak, seen, bf16 = _bf16_rounds(model, optimizer, generator,
                                            device)
    bf16_counts = kernel_counts()
    per_step = calls[:len(calls) // (1 + TP_STEPS)]
    group = mesh.model_group
    collective_ms = _replay_ms(per_step, group, device, TP_MP)
    gathers = [c for c in per_step if c[0] == "all_gather"]
    gather_ms = _replay_ms(gathers, group, device, TP_MP)
    gather_as_sum_ms = _replay_ms(gathers, group, device, TP_MP,
                                  gather_as_sum=True)
    head_fwd, head_both = head_peak_bytes(model.relation_head, seen)
    del model, optimizer, seen
    torch.cuda.empty_cache()
    drivers = rank_drivers(device, runs)
    argv = runs[0][1]
    logits = trained_forward(
        f"{argv[argv.index('--output_path') + 1]}/artifact",
        argv[argv.index("--data_path") + 1], device, mesh)
    if rank == 0:
        torch.save(logits, f"{out}/tp_eval.pt")
    return {"metrics": metrics, "digest": digest, "counts": counts,
            "mesh": [mesh.data_index, mesh.model_index],
            "bf16_ms_per_step": ms, "bf16_counts": bf16_counts,
            "bf16_total_loss": float(bf16["total_loss"]),
            "step_peak_bytes": peak, "head_fwd_peak_bytes": head_fwd,
            "head_peak_bytes": head_both,
            "collectives_per_step": [op for op, _, _ in per_step],
            "collective_bytes_per_step": sum(
                math.prod(shape) * dtype.itemsize
                for _, shape, dtype in per_step),
            "collectives_alone_ms": collective_ms,
            "gathers_alone_ms": gather_ms,
            "gathers_as_sums_ms": gather_as_sum_ms,
            "drivers": drivers}


def _one_process_memory():
    """One process's bf16 rounds (``_bf16_rounds``) and its head's peak
    memory, for phase (f)'s comparison."""
    model, optimizer, generator = perf_train_step.build(
        perf_train_step.train_config(), DEVICE, seed=0)
    ms, peak, seen, _ = _bf16_rounds(model, optimizer, generator, DEVICE)
    head_fwd, head_both = head_peak_bytes(model.relation_head, seen)
    del model, optimizer, seen
    torch.cuda.empty_cache()
    return {"ms_per_step": ms, "step_peak_bytes": peak,
            "head_fwd_peak_bytes": head_fwd, "head_peak_bytes": head_both}


def check_tp():
    """Phase (f): the relation grid's rows split over two ranks on the card
    (dp 1 x mp 2, gloo), against one process: the float32 step at full
    width on the global batch of TP_GLOBAL_BATCH at 800x1344 (losses within
    DDP_LOSS_RTOL, gradients and parameters within GRAD_RTOL,
    ``_compare_step``), the ranks bit-equal, K1/K2/K3 12 a microbatch in
    each; the bf16 step's ms per rank, its model-group collectives alone,
    each rank's peak memory of the head and of the step beside one
    process's; and ``train_egtr --dp 1 --mp 2`` on phase 17's synthetic set
    (``TP_NOTE``)."""
    from egtr_tpu_torch.scripts.make_synth_vg import make_synth_vg

    t_phase = time.perf_counter()
    hw = perf_train_step.BUCKET_HW
    cfg = perf_train_step.train_config(compute_dtype="float32", dropout=0.0)
    shapes = level_shapes(hw, cfg.num_feature_levels)
    with tempfile.TemporaryDirectory() as work:
        data, out = f"{work}/vg", f"{work}/run_tp"
        make_synth_vg(data, seed=0, **SYNTH_VG)
        driver_args = ["--data_path", data, "--output_path", out,
                       "--device", DEVICE, *DRIVER_ARGS, "--dp", "1",
                       "--mp", str(TP_MP)]
        ranks = run_ranks("rank_tp", f"{work}/ranks", n=TP_MP, out=work,
                          runs=[["train_egtr", driver_args,
                                 f"{out}/metrics_test.json"]])
        # one process's references, after the ranks have left the card
        ref, model, step_lrs, again = _one_process_twice(
            cfg, hw, TP_GLOBAL_BATCH, 1, perf_train_step.LRS)
        one = _one_process_memory()
        step_errs, step_text = _compare_step("tp f32", f"{work}/rank0.pt",
                                             model, step_lrs, GRAD_RTOL,
                                             again)
        del model
        torch.cuda.empty_cache()
        got = torch.load(f"{work}/tp_eval.pt", weights_only=True)
        want = trained_forward(f"{out}/artifact", data, DEVICE)
    # the trained model's relation grid, gathered over the model group vs
    # one process, and what the ranks' blocks gathered in the wrong order
    # would differ by: the check must see that fault at least tenfold
    eval_err = max(float((got[k] - want[k]).abs().max()) for k in want)
    eval_swapped = min(float((torch.roll(
        want[k], want[k].shape[1] // TP_MP, dims=1) - want[k]).abs().max())
        for k in want)
    _check_ranks("tp f32", ranks, ref, DDP_LOSS_KEYS,
                 step_counts(cfg, shapes))
    bad = []
    bf16_expect = {k: v * (1 + TP_STEPS) for k, v in step_counts(
        perf_train_step.train_config(), shapes).items()}
    for r, rank in enumerate(ranks):
        if rank["bf16_counts"] != bf16_expect or not all(
                rank["counts"][k] for k in ("msda_fwd", "msda_bwd_rows",
                                            "msda_bwd_value")):
            bad.append(f"rank {r} launches {rank['counts']} / bf16 "
                       f"{rank['bf16_counts']}, expected {bf16_expect}")
    if [r["mesh"] for r in ranks] != [[0, m] for m in range(TP_MP)]:
        bad.append(f"meshes {[r['mesh'] for r in ranks]}")
    driver = [r["drivers"][0] for r in ranks]
    fwd, mbs = _rank_forwards(DRIVER_ARGS, 1, SYNTH_VG)
    per_forward = cfg.encoder_layers + cfg.decoder_layers
    driver_expect = {**dict.fromkeys(msda_cuda.KERNELS, 0),
                     "msda_fwd": per_forward * fwd,
                     "msda_bwd_rows": per_forward * mbs,
                     "msda_bwd_value": per_forward * mbs}
    for r, run in enumerate(driver):
        if run["counts"] != driver_expect:
            bad.append(f"train_egtr --mp {TP_MP} rank {r} launches "
                       f"{run['counts']}, expected {driver_expect}")
    if not all(_same_metrics(run["metrics"], driver[0]["metrics"])
               for run in driver):
        bad.append("train_egtr --mp: the ranks' test metrics differ")
    if not (eval_err <= TP_EVAL_ATOL and 10 * eval_err < eval_swapped):
        bad.append(f"train_egtr --mp: the trained model's float32 logits "
                   f"differ from one process's by {eval_err:.3g} (limit "
                   f"{TP_EVAL_ATOL}; blocks swapped {eval_swapped:.3g})")
    if not _same_metrics(driver[0]["read"], driver[0]["metrics"]):
        bad.append("train_egtr --mp: metrics_test.json is not the ranks'")
    if any(run["saved"] for run in driver[1:]):
        bad.append(f"rank 1 wrote {driver[1]['saved']}")
    ms = [max(r["bf16_ms_per_step"][i] for r in ranks)
          for i in range(TP_STEPS)]
    coll, gathers, as_sums = ([max(r[key][i] for r in ranks)
                               for i in range(3)]
                              for key in ("collectives_alone_ms",
                                          "gathers_alone_ms",
                                          "gathers_as_sums_ms"))
    ops = ranks[0]["collectives_per_step"]
    mb = 1e-6
    head_mb = [(round(r["head_fwd_peak_bytes"] * mb, 1),
                round(r["head_peak_bytes"] * mb, 1)) for r in ranks]
    seconds = time.perf_counter() - t_phase
    print(f"tp (f): dp 1 x mp {TP_MP} ({TP_MP} ranks, gloo) on one card, "
          f"float32 at {hw[0]}x{hw[1]}, global batch {TP_GLOBAL_BATCH}: "
          + ", ".join(f"{k} {ranks[0]['metrics'][k]:.6f} vs one process's "
                      f"{ref[k]:.6f}" for k in DDP_LOSS_KEYS)
          + f"; {step_text}; ranks' parameters bit-equal; launches per "
          f"rank {[r['counts'] for r in ranks]}. bf16 (dropout 0.1, after a "
          f"warm-up step): ms per optimizer step per rank "
          f"{[round(t, 1) for t in ms]}, one process "
          f"{[round(t, 1) for t in one['ms_per_step']]}; the model group's "
          f"{len(ops)} collectives of a step ({ops.count('all_gather')} "
          f"all_gather; {ranks[0]['collective_bytes_per_step']} bytes in) "
          f"alone {[round(t, 1) for t in coll]} ms, its gathers "
          f"{[round(t, 1) for t in gathers]} ms, as sums of zero-filled "
          f"buffers {[round(t, 1) for t in as_sums]} ms; the head's peak "
          f"MB, forward / "
          f"forward + backward, per rank "
          f"{head_mb}, one process ({round(one['head_fwd_peak_bytes'] * mb, 1)}, "
          f"{round(one['head_peak_bytes'] * mb, 1)}); the step's peak GB per "
          f"rank {[round(r['step_peak_bytes'] / 1e9, 3) for r in ranks]}, "
          f"one process {one['step_peak_bytes'] / 1e9:.3f}; train_egtr "
          f"--dp 1 --mp {TP_MP} {max(r['seconds'] for r in driver):.1f} s, "
          f"launches per rank {[r['counts']['msda_fwd'] for r in driver]} "
          f"K1, test metrics equal on every rank, the trained model's "
          f"float32 logits vs one process's {eval_err:.3g} (limit "
          f"{TP_EVAL_ATOL}; the ranks' blocks swapped {eval_swapped:.3g}) "
          f"({TP_NOTE}); "
          f"{seconds:.1f} s", flush=True)
    if bad:
        raise SystemExit(f"tp (f): {bad}")
    return {"metrics": ranks[0]["metrics"], "one_process": ref, **step_errs,
            "counts_per_rank": [r["counts"] for r in ranks],
            "bf16_counts_per_rank": [r["bf16_counts"] for r in ranks],
            "train_counts_per_rank": [r["counts"] for r in driver],
            "bf16_ms_per_step": ms,
            "one_process_bf16_ms_per_step": one["ms_per_step"],
            "collectives_per_step": ranks[0]["collectives_per_step"],
            "collective_bytes_per_step":
                ranks[0]["collective_bytes_per_step"],
            "collectives_alone_ms": coll, "gathers_alone_ms": gathers,
            "gathers_as_sums_ms": as_sums,
            "trained_eval_max_abs_err": eval_err,
            "trained_eval_blocks_swapped": eval_swapped,
            "head_fwd_peak_bytes_per_rank": [r["head_fwd_peak_bytes"]
                                             for r in ranks],
            "head_peak_bytes_per_rank": [r["head_peak_bytes"]
                                         for r in ranks],
            "one_process_head_fwd_peak_bytes": one["head_fwd_peak_bytes"],
            "one_process_head_peak_bytes": one["head_peak_bytes"],
            "step_peak_bytes_per_rank": [r["step_peak_bytes"]
                                         for r in ranks],
            "one_process_step_peak_bytes": one["step_peak_bytes"],
            "train_egtr_seconds": max(r["seconds"] for r in driver),
            "train_egtr_test": driver[0]["metrics"],
            "seconds": seconds, "note": TP_NOTE}


# (g) the matcher's assignment kernel: the JAX package's in-jit solver
# (egtr_tpu/ops/matcher.py:_lsa_single) at the criterion's shapes: B images
# a microbatch, Q queries (300 with two stages, and the two-stage proposal
# matching's Q = S tokens of the training bucket), G = max_gt_boxes slots
LSAP_G = 64
LSAP_CASES = ((2, 200), (4, 200), (2, 300), (4, 300), (2, 22323))
LSAP_ITERS = 50
LSAP_SCIPY_ITERS = 5
# relaxing one column in a search step: an add, two subtractions and the
# comparison
LSAP_OPS_PER_COLUMN = 4


def lsap_costs(B, Q, G, kind, seed):
    """Random costs, or costs full of ties: integers of {0, 1, 2},
    duplicate queries and a slot every query reaches at the same cost."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return (3.0 * rng.standard_normal((B, Q, G))).astype(np.float32)
    cost = rng.integers(0, 3, (B, Q, G)).astype(np.float32)
    cost[:, 10] = cost[:, 3]
    cost[:, 20:24] = cost[:, 0:1]
    cost[:, :, 5] = 1.0
    return cost


def host_scipy_match(cost, num_boxes):
    """The port's former matcher: the cost matrix copied to the host,
    scipy's ``linear_sum_assignment`` per image on its real slots, the
    assignment copied back (query_index, gt_index)."""
    from scipy.optimize import linear_sum_assignment

    B, Q, G = cost.shape
    host = cost.transpose(1, 2).cpu().numpy()
    counts = num_boxes.cpu().numpy()
    col4row = np.full((B, G), -1, np.int64)
    gt_index = np.full((B, Q), -1, np.int64)
    for b in range(B):
        rows, cols = linear_sum_assignment(host[b, :int(counts[b])])
        col4row[b, rows] = cols
        gt_index[b, cols] = rows
    return (torch.from_numpy(col4row).to(cost.device),
            torch.from_numpy(gt_index).to(cost.device))


# the parent commit's matcher kernel, timed in turns with this one: its
# source from git, or from a copy left in build/ where the checkout has no
# history; its C interface is the one-block kernel's
PARENT_LSAP_REV = "HEAD~1"
PARENT_LSAP_COPY = "lsap_parent.cu"
PARENT_LSAP_SIGNATURE = "int B, int Q, int G, int threads, int cpt, void* stream"
# milliseconds of calls each timing takes (at least 3, at most LSAP_ITERS)
LSAP_TIMING_MS = 150.0


def parent_lsap_source():
    """(source text, where from) of the parent commit's lsap.cu, or (None,
    why not)."""
    copy = msda_cuda.BUILD_DIR / PARENT_LSAP_COPY
    if copy.exists():
        return copy.read_text(), str(copy)
    here = os.path.dirname(os.path.abspath(__file__))
    spec = f"{PARENT_LSAP_REV}:egtr_tpu_torch/csrc/lsap.cu"
    try:
        out = subprocess.run(["git", "-C", here, "show", spec],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return None, f"git show {spec}: {e}"
    if out.returncode != 0:
        return None, f"git show {spec}: {out.stderr.strip()[:200]}"
    return out.stdout, f"git show {spec}"


def build_parent_lsap():
    """The parent commit's matcher kernel built into build/ (nvcc, the
    port's flags): (library path or None, where its source came from or why
    there is none)."""
    text, origin = parent_lsap_source()
    if text is None:
        return None, origin
    if PARENT_LSAP_SIGNATURE not in text:
        return None, f"{origin}: not the one-block kernel's interface"
    if text == msda_cuda.SOURCE_LSAP.read_text():
        return None, f"{origin}: the same source as this checkout's"
    key = hashlib.sha256(text.encode()).hexdigest()[:16]
    lib = msda_cuda.BUILD_DIR / f"liblsap_parent-{key}.so"
    if not lib.exists():
        try:
            nvcc = msda_cuda._nvcc()
        except RuntimeError as e:
            return None, f"{origin}: {e}"
        msda_cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = msda_cuda.BUILD_DIR / f"lsap_parent-{key}.cu"
        src.write_text(text)
        tmp = lib.with_suffix(".tmp.so")
        out = subprocess.run([nvcc, *msda_cuda.NVCC_FLAGS, "-o",
                              str(tmp), str(src)], capture_output=True,
                             text=True)
        if out.returncode != 0:
            return None, f"{origin}: nvcc failed: {out.stderr[-300:]}"
        os.replace(tmp, lib)
    return lib, origin


def parent_lsap_call(lib):
    """A function (cost, num_boxes) -> the parent kernel's three outputs:
    one block an image, Q rounded up to a warp and at most 1024 threads,
    the fewest columns a thread (a power of two) that cover Q."""
    import ctypes

    fn = ctypes.CDLL(str(lib)).lsap
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]

    def call(cost, num_boxes):
        B, Q, G = cost.shape
        threads = min(1024, -(-Q // 32) * 32)
        cpt = 1
        while threads * cpt < Q:
            cpt *= 2
        out = (torch.empty((B, G), dtype=torch.int64, device=cost.device),
               torch.empty((B, G), dtype=torch.float32, device=cost.device),
               torch.empty((B, Q), dtype=torch.int64, device=cost.device))
        path = torch.empty((B, Q), dtype=torch.int32, device=cost.device)
        rc = fn(cost.data_ptr(), num_boxes.data_ptr(), path.data_ptr(),
                *(t.data_ptr() for t in out), B, Q, G, threads, cpt,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"parent lsap kernel: CUDA error {rc}")
        return out

    return call


def _timing_iters(fn):
    """Calls of ``fn`` that take about LSAP_TIMING_MS (3 to LSAP_ITERS)."""
    first = cuda_ms(fn, 1, warmup=1)
    return max(3, min(LSAP_ITERS, int(LSAP_TIMING_MS / max(first, 1e-3))))


def check_lsap(parent=(None, "not built")):
    """(g) The matcher kernel against its plain version on the card's
    inputs, bit for bit in all three outputs, at B 2 and 4, Q 200 and 300,
    and Q = S (22,323) at B 2, G 64, nb from 0 to G (and nb = G
    everywhere), on random costs and on costs full of ties; each image's
    total cost equal to scipy's to 1e-6; per case the route
    (``msda_cuda.lsap_geometry``), the search steps (``lsap_plain(stats=)``:
    summed and the longest image's, which the kernel's chain follows), the
    kernel's ms (CUDA events around the wrapper), its device ms in a CUDA
    graph (as the main path's programs run it) and µs per step of the
    longest image, beside the parent commit's kernel timed in graphs in
    turns (parent, new, new, parent; ``parent``: ``build_parent_lsap()``,
    which is also held bit-equal), the host scipy path's (copies included)
    and the plain version's (on the CPU, the only place it runs)."""
    from scipy.optimize import linear_sum_assignment

    lib, parent_origin = parent
    old = parent_lsap_call(lib) if lib is not None else None
    rows, bad = [], []
    for B, Q in LSAP_CASES:
        geom = msda_cuda.lsap_geometry(B, Q, LSAP_G)
        for kind in ("random", "ties"):
            cost = lsap_costs(B, Q, LSAP_G, kind, seed=B * Q)
            for nb in (np.linspace(0, LSAP_G, B).round(),
                       np.full(B, LSAP_G)):
                ct = torch.from_numpy(cost)
                nt = torch.from_numpy(nb.astype(np.int32))
                stats = {}
                t0 = time.perf_counter()
                plain = matcher.lsap_plain(ct, nt, stats)
                plain_ms = (time.perf_counter() - t0) * 1e3
                cost_d, nb_d = ct.to(DEVICE), nt.to(DEVICE)
                kern = [t.cpu() for t in msda_cuda.lsap(cost_d, nb_d)]
                equal = all(torch.equal(k, p) for k, p in zip(kern, plain))
                err = float((kern[1] - plain[1]).abs().max())
                optimal = True
                for b in range(B):
                    n = int(nb[b])
                    r, c = linear_sum_assignment(cost[b].T[:n])
                    best = float(cost[b].T[r, c].astype(np.float64).sum())
                    q = kern[0][b, :n].numpy()
                    got = float(cost[b].T[np.arange(n), q]
                                .astype(np.float64).sum())
                    optimal &= (len(set(q.tolist())) == n
                                and abs(got - best) <= 1e-6 * max(
                                    1.0, abs(best)))

                def new_call():
                    return msda_cuda.lsap(cost_d, nb_d)

                iters = _timing_iters(new_call)
                ms = cuda_ms(new_call, iters)
                timed = {"parent": [], "new": []}
                parent_equal = None
                calls = {"new": (new_call, iters)}
                if old is not None:
                    parent_equal = all(torch.equal(k, p.cpu()) for k, p in
                                       zip(kern, old(cost_d, nb_d)))

                    def old_call():
                        return old(cost_d, nb_d)

                    calls["parent"] = (old_call, _timing_iters(old_call))
                # device time in CUDA graphs (the main path's programs),
                # in turns where the parent's kernel is there
                for who in ("parent", "new", "new", "parent"):
                    if who in calls:
                        fn, n_it = calls[who]
                        timed[who].append(graph_ms(
                            fn, min(20, n_it), max(1, min(10, n_it // 4))))
                g_ms = sum(timed["new"]) / len(timed["new"])
                parent_ms = (sum(timed["parent"]) / len(timed["parent"])
                             if timed["parent"] else None)
                host_scipy_match(cost_d, nb_d)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(LSAP_SCIPY_ITERS):
                    host_scipy_match(cost_d, nb_d)
                torch.cuda.synchronize()
                scipy_ms = (time.perf_counter() - t0) * 1e3 / LSAP_SCIPY_ITERS
                nbytes = (cost_d.numel() * 4 + nb_d.numel() * 4
                          + sum(t.numel() * t.element_size() for t in kern))
                byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
                op_ms = (stats.get("steps", 0) * Q * LSAP_OPS_PER_COLUMN
                         / FP32_FLOPS * 1e3)
                chain = max(stats.get("image_steps", [0]))
                row = {"B": B, "Q": Q, "G": LSAP_G, "costs": kind,
                       "num_boxes": [int(v) for v in nb],
                       "route": geom.route, "cluster": geom.cluster,
                       "cpt": geom.cpt, "smem_bytes": geom.smem,
                       "rows_in_smem": geom.rows,
                       "search_steps": stats.get("steps", 0),
                       "longest_image_steps": chain,
                       "bit_equal_to_plain": equal, "max_abs_err": err,
                       "optimal_vs_scipy": optimal, "ms": ms,
                       "graph_ms_in_turns": timed["new"],
                       "us_per_step": (1e3 * g_ms / chain if chain else None),
                       "parent_graph_ms": parent_ms,
                       "parent_graph_ms_in_turns": timed["parent"],
                       "parent_us_per_step": (1e3 * parent_ms / chain
                                              if chain and parent_ms
                                              else None),
                       "parent_bit_equal": parent_equal,
                       "graph_ms": g_ms, "host_scipy_ms": scipy_ms,
                       "plain_ms": plain_ms, "plain_device": "cpu",
                       "bound_ms": max(byte_ms, op_ms),
                       "bound_by": ("bytes" if byte_ms >= op_ms
                                    else "operations")}
                rows.append(row)
                if not (equal and optimal):
                    bad.append(row)
    main = next(r for r in rows if (r["B"], r["Q"], r["costs"]) == (
        2, 200, "random") and r["num_boxes"][0] == 0)

    def fmt(x, spec):
        return "-" if x is None else format(x, spec)

    print(f"(g) matcher kernel (lsap) vs its plain version: "
          f"{sum(r['bit_equal_to_plain'] for r in rows)} of {len(rows)} "
          f"cases bit-equal, {sum(r['optimal_vs_scipy'] for r in rows)} "
          f"optimal against scipy; B2 Q200 G64: kernel {main['ms']:.4f} ms "
          f"(graph {main['graph_ms']:.4f}), host scipy path "
          f"{main['host_scipy_ms']:.3f} ms, plain (CPU) "
          f"{main['plain_ms']:.1f} ms, bound {main['bound_ms']:.6f} ms "
          f"({main['bound_by']}); parent kernel ({parent_origin}) in turns; "
          f"per case (B, Q, costs, num_boxes, route, steps summed / longest "
          f"image, ms, graph ms, us per step, parent graph ms, parent us per "
          f"step, parent bit-equal, scipy ms): "
          + "; ".join(
              f"{r['B']},{r['Q']},{r['costs']},"
              f"{'0..G' if r['num_boxes'][0] == 0 else 'G'},"
              f"{r['route']}x{r['cluster']},{r['search_steps']}/"
              f"{r['longest_image_steps']},{r['ms']:.4f},"
              f"{r['graph_ms']:.4f},{fmt(r['us_per_step'], '.3f')},"
              f"{fmt(r['parent_graph_ms'], '.4f')},"
              f"{fmt(r['parent_us_per_step'], '.3f')},"
              f"{r['parent_bit_equal']},{r['host_scipy_ms']:.3f}"
              for r in rows), flush=True)
    if bad:
        raise SystemExit(f"(g) matcher kernel disagrees: {bad}")
    return {"rows": rows, "main": main, "parent_origin": parent_origin}


REQUEST_ROUNDS = 10
REQUEST_PROFILED = 5


def _memory():
    """(peak allocated GB since the last reset, reserved GB once the
    caching allocator gave back what no tensor and no program holds)."""
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    return peak, torch.cuda.memory_reserved() / 1e9


def check_request_graphs(models, x):
    """(h) Each configuration's request as its captured program
    (``infer.infer``, one replay; phase 7 captured it) against the same
    request op by op (``infer.infer_eager``): the packed outputs, their
    largest delta and whether they are bit-equal; the launches per forward
    of both against ``forward_counts``; ms per request in turns (graph,
    eager, ...); the card's launches and idle share per request under
    torch.profiler; peak memory."""
    results = {}
    shapes = level_shapes(infer.BUCKET_HW, 4)
    for label, model in models.items():
        per_forward = {**forward_counts(model.config, shapes),
                       "frozen_bn": fbn_sites(model.config)}
        outs, counts, peaks = {}, {}, {}
        for way, request in (("graph", infer.infer),
                             ("eager", infer.infer_eager)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_kernel_counts()
            outs[way] = request(model, x)
            counts[way] = {**kernel_counts(),
                           "frozen_bn": backbone_launches()}
            peaks[way] = _memory()
        delta = float((outs["graph"] - outs["eager"]).abs().max())
        equal = bool(torch.equal(outs["graph"], outs["eager"]))
        times = {"graph": [], "eager": []}
        for _ in range(REQUEST_ROUNDS):
            for way, request in (("graph", infer.infer),
                                 ("eager", infer.infer_eager)):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                request(model, x)
                end.record()
                end.synchronize()
                times[way].append(start.elapsed_time(end))
        prof = {way: infer.profile_requests(model, x, REQUEST_PROFILED,
                                            top=5, request=request)
                for way, request in (("graph", infer.infer),
                                     ("eager", infer.infer_eager))}
        med = {w: sorted(t)[len(t) // 2] for w, t in times.items()}
        print(f"(h) request {label} as a graph vs eager: bit-equal {equal} "
              f"(max abs delta {delta}); launches per forward graph "
              f"{ {k: v for k, v in counts['graph'].items() if v} } eager "
              f"{ {k: v for k, v in counts['eager'].items() if v} }; ms per "
              f"request in turns, median graph {med['graph']:.3f} eager "
              f"{med['eager']:.3f}; card launches per request graph "
              f"{prof['graph']['device_launches_per_request']:.0f} eager "
              f"{prof['eager']['device_launches_per_request']:.0f}, idle "
              f"share graph {prof['graph']['device_idle_share']:.3f} eager "
              f"{prof['eager']['device_idle_share']:.3f}; (peak allocated, "
              f"reserved) GB graph {peaks['graph']} eager {peaks['eager']}",
              flush=True)
        for way in counts:
            if counts[way] != per_forward:
                raise SystemExit(f"(h) request {label} {way}: launches "
                                 f"{counts[way]}, expected {per_forward}")
        if not delta <= SERVED_MODEL_ATOL:
            raise SystemExit(f"(h) request {label}: the graph's outputs "
                             f"differ from eager by {delta}")
        other = replayed_on_other_inputs(model, x)
        print(f"(h) request {label} on another image: {other}", flush=True)
        results[label] = {
            "other_inputs": other,
            "bit_equal": equal, "max_abs_delta": delta,
            "launches_per_forward": counts["graph"],
            "ms_in_turns": times, "median_ms": med,
            "profile": {w: {k: p[k] for k in (
                "wall_ms_per_request", "device_busy_ms_per_request",
                "device_idle_share", "device_launches_per_request")}
                for w, p in prof.items()},
            "peak_allocated_gb": {w: p[0] for w, p in peaks.items()},
            "reserved_gb": {w: p[1] for w, p in peaks.items()}}
    return results


def _max_delta(a, b):
    """(largest |a - b| over the tensors of two dicts or two tensors,
    whether all are bit-equal)."""
    if isinstance(a, torch.Tensor):
        a, b = {"": a}, {"": b}
    delta = max(float((a[k].float() - b[k].float()).abs().max()) for k in a)
    return delta, all(torch.equal(a[k], b[k]) for k in a)


def replayed_on_other_inputs(model, x):
    """A captured request replayed on an image it was not captured with, and
    the evaluation's forward + post-processing program
    (``runner.infer_program``) replayed on a batch it was not captured
    with, each against the same call op by op: their largest delta, which
    must stay within ``SERVED_MODEL_ATOL``, and whether the replay's
    outputs moved with its inputs."""
    rng = np.random.default_rng(1)
    images = [rng.standard_normal(tuple(x.shape)).astype(np.float32)
              for _ in range(2)]
    x2 = torch.from_numpy(images[0]).to(x.device)
    request = infer.infer(model, x2)
    delta, equal = _max_delta(request, infer.infer_eager(model, x2))
    moved = not torch.equal(request, infer.infer(model, x))
    batches = [{"pixel_values": im, "pixel_mask": np.ones(im.shape[:3], bool)}
               for im in images]
    run = runner_module.infer_program(model, model.config)
    first = run(batches[0])  # the warm-up; the program is captured
    replayed = run(batches[1])
    with mock.patch.object(runner_module, "maybe_aot",
                           lambda fn, tag, *a, **kw: fn):
        eager = runner_module.infer_program(model, model.config)(batches[1])
    run_delta, run_equal = _max_delta(replayed, eager)
    run_moved = not _max_delta(replayed, first)[1]
    result = {"request_max_abs_delta": delta, "request_bit_equal": equal,
              "request_moved": moved,
              "runner_max_abs_delta": run_delta,
              "runner_bit_equal": run_equal, "runner_moved": run_moved}
    if not (delta <= SERVED_MODEL_ATOL and run_delta <= SERVED_MODEL_ATOL
            and moved and run_moved):
        raise SystemExit(f"(h) a replay on other inputs: {result}")
    return result


# (k): the offline request's replays after the one that captures it
FBN_OFFLINE_REPLAYS = 2
L2_BYTES = 50 * 2 ** 20


def frozen_bn_rows():
    """The trunk's frozen-BN epilogue kernel (``frozen_bn``) through its
    wrapper at every site (``epilogue_sites.trunk_sites``) of the serving
    trunk (608x1008, batch 1) and the offline one (800x1344, batch 8) of a
    bfloat16 ResNet-50, on seeded maps and norm statistics: into a map of
    its own and into x itself against ``backbone.frozen_bn_act_plain``, bit
    for bit; its device time in a CUDA graph beside that of the chain of
    PyTorch kernels it replaces and beside its bytes (each map read or
    written once, the norms' vectors once) at 3.35 TB/s, and whether those
    fit the L2 (so that repeated calls find them warm). Returns (a row a
    site, each trunk's sums by bucket)."""
    from egtr_tpu_torch.models import backbone, epilogue_sites

    bits = epilogue_sites.bits
    rows, trunks = [], {}
    for bucket, (hw, batch) in epilogue_sites.BUCKETS.items():
        sites = epilogue_sites.trunk_sites(hw, batch)
        total = {"graph_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                 "bytes": 0}
        for site, (shape, dtype, form) in enumerate(sites):
            x, residual, bn, residual_bn = epilogue_sites.site_inputs(
                shape, dtype, form, site, DEVICE)
            params = bn.vectors()
            residual_params = (None if residual_bn is None
                               else residual_bn.vectors())
            out = torch.empty_like(x)

            def kernel():
                return msda_cuda.frozen_bn(x, params, residual,
                                           residual_params, out=out)

            def plain():
                return backbone.frozen_bn_act_plain(x, bn, residual,
                                                    residual_bn)

            with torch.inference_mode():
                want, got = plain(), kernel()
                err = float((got.float() - want.float()).abs().max())
                equal = bool(torch.equal(bits(got), bits(want)))
                same = x.clone()
                msda_cuda.frozen_bn(same, params, residual, residual_params,
                                    out=same)
                in_place = bool(torch.equal(bits(same), bits(want)))
                ms, plain_ms = graph_ms(kernel), graph_ms(plain)
            nbytes = ((2 if residual is None else 3) * x.numel()
                      * x.element_size()
                      + 4 * shape[1] * (4 if residual_bn is None else 8))
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            rows.append({"bucket": bucket, "site": site,
                         "shape": list(shape), "dtype": str(dtype)[6:],
                         "form": form, "graph_ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "times_bound": ms / bound_ms,
                         "bytes": nbytes, "in_l2": nbytes <= L2_BYTES,
                         "max_abs_err": err, "bit_equal": equal,
                         "bit_equal_in_place": in_place})
            for key in total:
                total[key] += rows[-1][key]
            del x, residual, out, want, got, same
        trunks[bucket] = {"hw": list(hw), "batch": batch,
                          "sites": len(sites), **total,
                          "times_bound": total["graph_ms"]
                          / total["bound_ms"]}
        torch.cuda.empty_cache()
    return rows, trunks


def check_frozen_bn(cfg):
    """(k) ``frozen_bn_rows``: every site of the serving and the offline
    trunk bit-equal to the expression. Then the offline request,
    ``infer.infer`` of a model of ``cfg`` at batch 8 at 800x1344, captured
    and replayed: its launches on the card's trace, ``frozen_bn`` once a
    site and the MSDA kernels' ``forward_counts``, a forward."""
    from egtr_tpu_torch.models import epilogue_sites

    rows, trunks = frozen_bn_rows()
    bad = [r for r in rows if not (r["bit_equal"]
                                   and r["bit_equal_in_place"])]
    print("(k) frozen_bn at every site, device ms a trunk in a CUDA graph "
          "(kernel | the chain it replaces | bytes at 3.35 TB/s): "
          + "; ".join(f"{b} {t['hw'][0]}x{t['hw'][1]} b{t['batch']}, "
                      f"{t['sites']} sites: {t['graph_ms']:.4f} | "
                      f"{t['plain_ms']:.4f} | {t['bound_ms']:.4f} "
                      f"({t['times_bound']:.2f}x)"
                      for b, t in trunks.items())
          + f"; bit-equal to the expression at every site: {not bad}",
          flush=True)
    if bad:
        where = [(r["bucket"], r["site"], r["form"]) for r in bad]
        raise SystemExit(f"(k) frozen_bn differs from the expression at "
                         f"{where}")
    hw, batch = epilogue_sites.BUCKETS["offline"]
    model, x = infer.build(cfg, batch, *hw, seed=0)
    forwards = 1 + FBN_OFFLINE_REPLAYS
    reset_kernel_counts()
    for _ in range(forwards):
        packed = infer.infer(model, x)
    torch.cuda.synchronize()
    counts = {**kernel_counts(), "frozen_bn": backbone_launches()}
    per_forward = {**forward_counts(cfg, level_shapes(
        hw, cfg.num_feature_levels)), "frozen_bn": fbn_sites(cfg)}
    expect = {k: v * forwards for k, v in per_forward.items()}
    print(f"(k) offline request {hw[0]}x{hw[1]} b{batch} (infer.infer, "
          f"{forwards} forwards): launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    if counts != expect or not torch.isfinite(packed).all():
        raise SystemExit(f"(k) offline request: launches {counts}, "
                         f"expected {expect}, or non-finite outputs")
    del model, x, packed
    torch.cuda.empty_cache()
    return {"rows": rows, "trunks": trunks, "offline_launches": counts,
            "offline_forwards": forwards,
            "sites_per_forward": per_forward["frozen_bn"]}


TRAIN_GRAPH_TURNS = 2
# (i), float32: each step's learning-rate scale (a replay must read each,
# as the warm-up schedule changes it from step to step) and batch seed
TRAIN_GRAPH_LR_SCALES = (1.0, 0.5, 0.25)
TRAIN_GRAPH_SEEDS = (10, 11, 12)
# the least limit of (i)'s float32 comparisons, about 32 float32 steps of
# the value: the replays run the kernels cuBLAS and cuDNN chose under
# capture, which may differ from eager's, so the graph run's loss and
# gradient norm may sit a few steps from both eager runs while these agree
# bit for bit (an H100: 1 step of the loss, 13 of the gradient norm)
TRAIN_GRAPH_FLOOR = 2.0 ** -18
# the eager runs whose pairwise distances make (i)'s spread, and how far
# beyond the spread the graph run may lie: the distance between two runs
# of the same step varies tenfold from pair to pair, so the spread is the
# largest of three pairs
TRAIN_GRAPH_EAGER_RUNS = 3
TRAIN_GRAPH_SPREAD_FACTOR = 4
# the readings (i)'s rule holds: each step's loss and gradient norm, the
# first step's gradients (every run begins from one state there, so that
# they differ by K3's atomics alone), and the parameters' change less the
# AdamW updates of the run's own gradients (``AdamReplay``). The raw
# change and the last step's gradients are printed beside them, not held:
# from the second step on, a run whose state moved by K3's noise may take
# a near-tie in the matching or the negatives' top-k the other way, and
# about one run in four then lies 4-10x farther from the others in both
# (open check F3), so those readings measure that amplification and not
# the program
TRAIN_GRAPH_HELD = ("loss", "grad_norm", "grad", "param_residual")
# an entry's update differs by at least this share of its learning rate
# between two runs: a sign that AdamW's normalized step flipped (F3)
FLIP_SHARE_OF_LR = 0.5


def _eager_steps():
    """The train step's functions without their programs: what maybe_aot
    wraps, op by op."""
    return mock.patch.object(train_step_module, "maybe_aot",
                             lambda fn, tag, *a, **kw: fn)


def _planted(fault):
    """A step program with a planted fault, for the reading that (i)'s
    check must refuse: ``zero_grad`` a step that never zeroes its
    gradients (each replay adds to the last one's), ``lr_scale`` an update
    that reads the scale it was captured with."""
    if fault == "zero_grad":
        return mock.patch.object(Optimizer, "zero_grad", lambda self: None)
    real = Optimizer.step
    return mock.patch.object(Optimizer, "step",
                             lambda self, lr_scale=1.0: real(self, 1.0))


class AdamReplay:
    """AdamW's updates recomputed in float64 from a run's own clipped
    gradients (torch's formula: the decay ``p * (1 - lr * wd)``, then
    ``lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)``), step by
    step from the parameters each step began with. ``residual``: per
    trained leaf, the run's change less those updates. Two runs' residuals
    differ by what their changes differ by beyond AdamW's answer to their
    own gradients: the program's fault, not the gradient noise that AdamW
    turns into a change (F3). The trained leaves are read as one flat
    buffer (``flat``: one kernel), so that a run's snapshots add little to
    the trace that counts its launches."""

    def __init__(self, model, optimizer):
        d = optimizer.adamw.defaults
        (self.b1, self.b2), self.eps, self.wd = (d["betas"], d["eps"],
                                                 d["weight_decay"])
        names = {id(p): n for n, p in model.named_parameters()}
        self.names, self.leaves, base = [], [], []
        for g in optimizer.adamw.param_groups:
            for p in g["params"]:
                self.names.append(names[id(p)])
                self.leaves.append(p)
                base.append(torch.full((p.numel(),), g["base_lr"],
                                       dtype=torch.float32, device=p.device))
        # each entry's rate as the device computes it: a float32 base
        # times the float32 scale
        self.base = torch.cat(base)

    def flat(self, grad=False):
        return torch.cat([(p.grad if grad else p).detach().reshape(-1)
                          for p in self.leaves])

    def lr(self, scale):
        """Each trained leaf's learning rate at ``scale``."""
        at, out = 0, {}
        for n, p in zip(self.names, self.leaves):
            out[n] = float(self.base[at] * torch.tensor(
                float(scale), dtype=torch.float32))
            at += p.numel()
        return out

    def residual(self, steps, after):
        """``steps``: per step (the flat parameters it began with, its
        flat clipped gradients, its learning-rate scale); ``after``: the
        flat parameters after the last. Per trained leaf, the change less
        the recomputed updates."""
        begins = [p0 for p0, _, _ in steps[1:]] + [after]
        m = v = r = 0.0
        for t, ((p0, g, scale), p1) in enumerate(zip(steps, begins), 1):
            lr = (self.base * torch.tensor(float(scale), dtype=torch.float32,
                                           device=self.base.device)).double()
            g = g.double()
            m = self.b1 * m + (1 - self.b1) * g
            v = self.b2 * v + (1 - self.b2) * g * g
            want = p0.double() * (1 - lr * self.wd) - lr / (
                1 - self.b1 ** t) * m / (v.sqrt() / (1 - self.b2 ** t) ** 0.5
                                         + self.eps)
            r = r + (p1.double() - want)
        return {n: x.float().view_as(p) for n, p, x in zip(
            self.names, self.leaves,
            r.split([p.numel() for p in self.leaves]))}


def _restore(model, optimizer, start, generator, state):
    """The state a run began from, in place (a captured program reads
    these tensors): the parameters, AdamW's moments and step counts, the
    generator. The gradients stay: the step zeroes them itself (a planted
    fault that does not shows)."""
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(start[n])
        for st in optimizer.adamw.state.values():
            for t in st.values():
                if isinstance(t, torch.Tensor):
                    t.zero_()
    generator.set_state(state)


def _f32_run(f32, hw, way, on_card=None):
    """Three float32 steps at batch 2, each on its own seeded batch and
    learning-rate scale, ``way`` "graph", "eager" or a planted fault
    (``_planted``) in the programs. The step's first call (for the
    programs their warm-up and capture) takes the first batch, then the
    initial state comes back (``_restore``), so that every measured step
    of the graph run is a replay and its first one starts where every
    eager run's does. Returns each step's total loss and gradient norm,
    each trainable leaf's change and its residual (``AdamReplay``), each
    leaf's last learning rate, the first and the last step's gradients,
    and the launches of the three steps (measured on the card;
    ``on_card`` as ``reset_kernel_counts`` takes it)."""
    model, optimizer, generator = perf_train_step.build(f32, DEVICE, seed=0)
    batches = [perf_train_step.synthetic_batch(f32, 2, *hw, DEVICE, seed=s)
               for s in TRAIN_GRAPH_SEEDS]
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    seed_state = generator.get_state()
    frozen = {n for n, label in optimizer.labels.items()
              if label == "frozen"}
    adam = AdamReplay(model, optimizer)
    leaves = dict(model.named_parameters())

    def all_grads():
        return torch.cat([p.grad.detach().reshape(-1)
                          for p in leaves.values()])

    with (_eager_steps() if way == "eager" else _planted(way)
          if way != "graph" else contextlib.nullcontext()):
        step = make_train_step(model, f32, optimizer)
        step(batches[0], generator, lr_scale=TRAIN_GRAPH_LR_SCALES[0])
        _restore(model, optimizer, start, generator, seed_state)
        reset_kernel_counts(on_card)
        metrics, steps, first = [], [], None
        for b, scale in zip(batches, TRAIN_GRAPH_LR_SCALES):
            before = adam.flat()
            metrics.append(step(b, generator, lr_scale=scale))
            steps.append((before, adam.flat(grad=True), scale))
            if first is None:
                first = all_grads()
        torch.cuda.synchronize()
        counts = kernel_counts()
        matched = matcher_launches()
    sizes = [p.numel() for p in leaves.values()]
    run = {"loss": [float(m["total_loss"]) for m in metrics],
           "grad_norm": [float(m["grad_norm"]) for m in metrics],
           "change": {n: p.detach() - start[n] for n, p
                      in model.named_parameters() if n not in frozen},
           "residual": adam.residual(steps, adam.flat()),
           "lr": adam.lr(TRAIN_GRAPH_LR_SCALES[-1]),
           "grad": {n: g.view_as(p) for (n, p), g in zip(
               leaves.items(), first.split(sizes))},
           "grad_last": {n: p.grad.detach().clone() for n, p
                         in model.named_parameters()},
           "counts": counts, "matched": matched}
    del model, optimizer, step, start, adam, steps, leaves
    return run


def _rel_err(a, b):
    """Largest |a - b| over b's largest entry, over all tensors."""
    return max(float((a[n] - b[n]).abs().max())
               / max(float(b[n].abs().max()), 1e-30) for n in b)


def _median(values):
    values = sorted(values)
    return values[len(values) // 2] if values else 0.0


def _f32_distances(a, b):
    """How far run ``a`` lies from run ``b``: each step's total loss and
    gradient norm (the largest relative difference over the steps), the
    parameters' change (per trainable leaf, the mean |change_a - change_b|
    over the mean |change_b|; the median leaf), the same of the residuals
    (``param_residual``: the changes less each run's own AdamW updates,
    over the mean |change_b|), and the first and the last step's gradients
    (``grad``, ``grad_last``: per leaf the L2 distance over b's L2 norm;
    the median leaf)."""
    def steps(key):
        return max(abs(x - y) / max(abs(y), 1e-30)
                   for x, y in zip(a[key], b[key]))

    def grads(key):
        return _median([float((a[key][n] - g).norm() / g.norm())
                        for n, g in b[key].items() if g.norm() > 0])

    moved = {n: d.abs().mean() for n, d in b["change"].items()}
    change = [float((a["change"][n] - d).abs().mean() / moved[n])
              for n, d in b["change"].items() if moved[n] > 0]
    residual = [float((a["residual"][n] - r).abs().mean() / moved[n])
                for n, r in b["residual"].items() if moved.get(n, 0) > 0]
    return {"loss": steps("loss"), "grad_norm": steps("grad_norm"),
            "param_change": _median(change),
            "param_residual": _median(residual), "grad": grads("grad"),
            "grad_last": grads("grad_last")}


def _leaf_group(name):
    """A leaf's module family: ``model.decoder_layer_3.fc1.weight`` ->
    ``decoder_layer``."""
    return re.sub(r"(_\d+)+$", "", name.removeprefix("model.").split(".")[0])


def _flip_leaves(a, b, top=3):
    """Where the parameter change of runs ``a`` and ``b`` differs (F3):
    the entries whose changes differ by at least ``FLIP_SHARE_OF_LR`` of
    the leaf's last learning rate, over all leaves; the leaves whose
    change's distance exceeds 1e-6, by module family; and the ``top``
    leaves by that distance (name, distance, entries, the same distance
    of the residuals)."""
    rows, flips, over = [], 0, {}
    for n, d in b["change"].items():
        moved = d.abs().mean()
        if moved <= 0 or n not in a["lr"]:
            continue
        diff = a["change"][n] - d
        k = int((diff.abs() >= FLIP_SHARE_OF_LR * a["lr"][n]).sum())
        flips += k
        x = float(diff.abs().mean() / moved)
        if x > 1e-6:
            over[_leaf_group(n)] = over.get(_leaf_group(n), 0) + 1
        rows.append((n, x, k, float(
            (a["residual"][n] - b["residual"][n]).abs().mean() / moved)))
    rows.sort(key=lambda r: -r[1])
    return {"entries": flips, "leaves_over_1e-6": over,
            "top": [[n, f"{x:.3g}", k, f"{y:.3g}"] for n, x, k, y
                    in rows[:top]]}


def f32_rule(runs, label):
    """(i)'s rule on float32 runs (``_f32_run``) "graph", "eager_*" and the
    planted faults: the eager runs' distances of a pair make the spread;
    each held reading (``TRAIN_GRAPH_HELD``) of the graph run, to the
    nearer eager run, within ``TRAIN_GRAPH_SPREAD_FACTOR`` times the spread
    or ``TRAIN_GRAPH_FLOOR``; each planted fault beyond it in at least one.
    Returns the readings, with the F3 witness per pair (``_flip_leaves``);
    raises SystemExit with ``label`` where the rule fails."""
    eager_ways = sorted(w for w in runs if w.startswith("eager"))
    eager = [runs[w] for w in eager_ways]
    pairs = [_f32_distances(a, b) for i, a in enumerate(eager)
             for b in eager[i + 1:]]
    spread = {k: max(d[k] for d in pairs) for k in pairs[0]}
    limit = {k: max(TRAIN_GRAPH_SPREAD_FACTOR * v, TRAIN_GRAPH_FLOOR)
             for k, v in spread.items()}
    readings, nearest = {}, {}
    for way in ("graph", "zero_grad", "lr_scale"):
        to_each = [_f32_distances(runs[way], e) for e in eager]
        readings[way] = {k: min(d[k] for d in to_each) for k in spread}
        nearest[way] = eager_ways[min(
            range(len(eager)), key=lambda i: to_each[i]["param_change"])]
    flips = {"eager_pairs": [_flip_leaves(a, b) for i, a in enumerate(eager)
                             for b in eager[i + 1:]],
             "graph_to_nearest": _flip_leaves(runs["graph"],
                                              runs[nearest["graph"]])}
    result = {"losses": {w: r["loss"] for w, r in runs.items()},
              "grad_norms": {w: r["grad_norm"] for w, r in runs.items()},
              "eager_pairs": pairs, "eager_spread": spread, "limit": limit,
              "held": list(TRAIN_GRAPH_HELD), "readings": readings,
              "flips": flips,
              "worst_leaf_rel_err": {
                  "param_change": [_rel_err(runs["graph"]["change"],
                                            e["change"]) for e in eager],
                  "grad": [_rel_err(runs["graph"]["grad"], e["grad"])
                           for e in eager],
                  "grad_last": [_rel_err(runs["graph"]["grad_last"],
                                         e["grad_last"]) for e in eager]}}
    beyond = {k: readings["graph"][k] for k in TRAIN_GRAPH_HELD
              if readings["graph"][k] > limit[k]}
    if beyond:
        raise SystemExit(f"{label} float32: graph vs eager beyond the limit "
                         f"{limit} in {beyond}: {result}")
    for fault in ("zero_grad", "lr_scale"):
        if all(readings[fault][k] <= limit[k] for k in TRAIN_GRAPH_HELD):
            raise SystemExit(f"{label} float32: the planted fault {fault} "
                             f"passes the check: {readings[fault]}")
    return result


def f32_runs(f32, hw, on_card=None):
    """(i)'s float32 runs: the graph run, ``TRAIN_GRAPH_EAGER_RUNS`` eager
    runs and the two planted faults, TF32 off."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ways = ("graph", *(f"eager_{i}" for i in range(TRAIN_GRAPH_EAGER_RUNS)),
            "zero_grad", "lr_scale")
    runs = {}
    try:
        for way in ways:
            runs[way] = _f32_run(f32, hw, "eager" if way.startswith("eager")
                                 else way, on_card)
            torch.cuda.empty_cache()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return runs


def _f32_text(r):
    return (f"losses {r['losses']}, gradient norms {r['grad_norms']}; "
            f"distances (loss, grad_norm, median leaf's parameter change, "
            f"its residual after each run's own AdamW updates, median "
            f"leaf's gradient at the first and at the last step) eager-eager "
            f"pairs {r['eager_pairs']}, limit "
            f"{r['limit']} on {r['held']}, to the nearer eager run "
            f"{r['readings']}; F3, entries whose change differs by >= "
            f"{FLIP_SHARE_OF_LR} lr and the leaves the change's distance "
            f"is largest in (name, distance, entries, residual's distance) "
            f"{r['flips']}; worst leaf (informative) "
            f"{r['worst_leaf_rel_err']}; launches measured "
            f"{r.get('launches')}")


def check_train_graphs(train_cfg):
    """(i) The training step as programs against eager: float32 (TF32 off)
    at dropout 0, three steps at batch 2, 800x1344, each on its own batch
    and learning-rate scale; the graph run against three eager runs
    (``f32_rule``): each step's loss and gradient norm, the median leaf's
    last gradients and its parameter change less the run's own AdamW
    updates (``AdamReplay``; ``_f32_distances``) of the nearer eager run,
    each within ``TRAIN_GRAPH_SPREAD_FACTOR`` times the eager runs' largest
    distance of a pair (K3's float32 atomics add in an order that
    changes), or ``TRAIN_GRAPH_FLOOR`` where they agree bit for bit; the
    raw parameter change printed beside them with the entries whose
    update AdamW flipped (F3); two planted faults (``_planted``) must fall
    outside; the launches measured on the card. Then bfloat16 batch 2 x
    accum 2 (the microbatch
    program twice, then the apply program) against eager in turns, ms per
    step and memory both ways; at dropout 0.1 (learning rates 0), replays
    on one batch draw new masks: their losses differ."""
    hw = perf_train_step.BUCKET_HW
    f32 = train_cfg.replace(compute_dtype="float32", dropout=0.0)
    runs = f32_runs(f32, hw)
    f32_result = f32_rule(runs, "(i)")
    per_mb = step_counts(f32, level_shapes(hw, 4))
    f32_counts = {way: (r["counts"], r["matched"]) for way, r in runs.items()
                  if way in ("graph", "eager_0")}
    f32_result["launches"] = f32_counts
    for way, (c, m) in f32_counts.items():
        if c != {k: TRAIN_STEPS * v for k, v in per_mb.items()} or (
                m != TRAIN_STEPS * matches_per_pass(f32)):
            raise SystemExit(f"(i) float32 {way}: launches {c}, matcher "
                             f"{m}")
    del runs
    torch.cuda.empty_cache()
    # bf16, batch 2 x accum 2, in turns on one model and optimizer
    model, optimizer, generator = perf_train_step.build(train_cfg, DEVICE,
                                                        seed=0)
    batch = perf_train_step.synthetic_batch(train_cfg, 4, *hw, DEVICE,
                                            seed=1)
    steps = {"graph": make_train_step(model, train_cfg, optimizer,
                                      accum_steps=2)}
    with _eager_steps():
        steps["eager"] = make_train_step(model, train_cfg, optimizer,
                                         accum_steps=2)
    memory, counts = {}, {}
    for way in ("eager", "graph"):
        steps[way](batch, generator)  # the graph's first call captures
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_counts()
        steps[way](batch, generator)
        counts[way] = (kernel_counts(), matcher_launches())
        memory[way] = _memory()
    times = {"graph": [], "eager": []}
    for _ in range(TRAIN_GRAPH_TURNS):
        for way in ("graph", "eager"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps[way](batch, generator)
            torch.cuda.synchronize()
            times[way].append((time.perf_counter() - t0) * 1e3)
    programs = _programs_of(steps["graph"], ("whole", "grads_mb", "apply"))
    per_mb_bf16 = step_counts(train_cfg, level_shapes(hw, 4))
    del model, optimizer, steps
    torch.cuda.empty_cache()
    # dropout 0.1, learning rates 0: the same batch through the program
    model, optimizer, generator = perf_train_step.build(
        train_cfg, DEVICE, seed=0,
        lrs=dict(lr=0.0, lr_backbone=0.0, lr_initialized=0.0))
    batch = perf_train_step.synthetic_batch(train_cfg, 2, *hw, DEVICE,
                                            seed=2)
    step = make_train_step(model, train_cfg, optimizer)
    dropout_losses = [float(step(batch, generator)["total_loss"])
                      for _ in range(3)]
    del model, optimizer, step
    torch.cuda.empty_cache()
    print(f"(i) train step as programs vs eager: float32 3 steps (own "
          f"batches, lr scales {TRAIN_GRAPH_LR_SCALES}), "
          f"{_f32_text(f32_result)}; bf16 b2 x accum 2 {hw[0]}x{hw[1]}: "
          f"programs {programs}, ms per step in turns {times}, (peak "
          f"allocated, reserved) GB {memory}, launches {counts}; dropout "
          f"0.1 losses of one batch, warm-up then two replays: "
          f"{dropout_losses}", flush=True)
    if programs != {"whole": 0, "grads_mb": 1, "apply": 1}:
        raise SystemExit(f"(i) the accumulated step ran programs "
                         f"{programs}")
    for way, (c, m) in counts.items():
        if c != {k: 2 * v for k, v in per_mb_bf16.items()} or (
                m != 2 * matches_per_pass(train_cfg)):
            raise SystemExit(f"(i) accumulated step {way}: launches {c}, "
                             f"matcher {m}")
    if len(set(dropout_losses[1:])) != 2:
        raise SystemExit(f"(i) replays drew the same dropout masks: "
                         f"{dropout_losses}")
    return {"float32": f32_result,
            "bf16_accum2": {"ms_in_turns": times, "programs": programs,
                            "peak_allocated_gb": {w: m[0] for w, m
                                                  in memory.items()},
                            "reserved_gb": {w: m[1] for w, m
                                            in memory.items()}},
            "dropout_replay_losses": dropout_losses}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; it needs one GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        built = pool.submit(msda_cuda.build), pool.submit(native.build)
        parent_lsap = pool.submit(build_parent_lsap)
        libs, native_lib = (f.result() for f in built)
        parent_lsap = parent_lsap.result()
    print(f"kernel build: {sorted(p.name for p in libs.values())} and "
          f"{native_lib.name} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    cfg = infer.bench_config()
    train_cfg = perf_train_step.train_config()
    shapes = level_shapes(infer.BUCKET_HW, cfg.num_feature_levels)
    train_shapes = level_shapes(perf_train_step.BUCKET_HW,
                                train_cfg.num_feature_levels)
    adapt_cfg = perf_train_step.adapt_config()
    adapt_hw = perf_train_step.ADAPT_HW
    adapt_shapes = level_shapes(adapt_hw, adapt_cfg.num_feature_levels)
    rows = check_kernel(shapes, "serving")
    train_rows = check_kernel(train_shapes, "training")
    bwd_rows = check_bwd_kernels(train_shapes, "training")
    q_rows = check_q_kernel(shapes)
    win_rows = check_win_kernels(shapes)
    bp_rows = check_bp_kernel(shapes, train_shapes)
    lsap = check_lsap(parent_lsap)

    served_cfg = infer.serving_config()
    tile_cfg = infer.bench_config(msda_window=WINDOW, msda_band="tile")
    exact_counts, exact_ms, exact_model, x = serve(cfg, "exact", N_REQUESTS)
    served_counts, served_ms, served_model, _ = serve(served_cfg, "served",
                                                      N_REQUESTS)
    tile_counts, tile_ms, tile_model, _ = serve(tile_cfg, "tile",
                                                N_TILE_REQUESTS)
    side_by_side = time_side_by_side(
        {"exact": exact_model, "served": served_model, "tile": tile_model},
        x, SIDE_BY_SIDE_ROUNDS)
    medians = {k: sorted(v)[len(v) // 2] for k, v in side_by_side.items()}
    print(f"ms/request, exact | served | tile, {SIDE_BY_SIDE_ROUNDS} rounds "
          f"in turns, on {card}: median "
          + " | ".join(f"{medians[k]:.3f}" for k in side_by_side)
          + "; min " + " | ".join(f"{min(v):.3f}"
                                  for v in side_by_side.values()),
          flush=True)
    batch_p_serve = serve_batch_p(
        {"exact": exact_model, "served": served_model, "tile": tile_model}, x)
    request_graphs = check_request_graphs(
        {"exact": exact_model, "served": served_model}, x)
    del exact_model, served_model, tile_model
    fbn = check_frozen_bn(cfg)
    model_errs = compare_f32(cfg, "exact", MODEL_ATOL, cpu=True)
    served_errs = compare_f32(served_cfg, "served", SERVED_MODEL_ATOL,
                              cpu=True)
    int8_grad_counts = check_int8_grad(shapes)
    exact_train = train(train_cfg, "exact", perf_train_step.BUCKET_HW, 2,
                        TRAIN_STEPS, accum=True)
    counts = exact_train["counts"]
    train_graphs = check_train_graphs(train_cfg)
    train_errs = compare_train_f32(train_cfg, "exact",
                                   perf_train_step.BUCKET_HW, 2, GRAD_RTOL)
    # the windowed path: the banded backward kernels, the band-adaptation
    # fine-tune and its siblings
    bwd_win_rows = check_bwd_win_kernels(adapt_shapes,
                                         perf_train_step.ADAPT_BATCH)
    adapt_args = (adapt_hw, perf_train_step.ADAPT_BATCH)
    adapt = train(adapt_cfg, "adaptation", *adapt_args, ADAPT_STEPS,
                  lrs=perf_train_step.ADAPT_LRS)
    adapt_tile = train(adapt_cfg.replace(msda_band="tile"), "adaptation tile",
                       *adapt_args, 1, lrs=perf_train_step.ADAPT_LRS)
    adapt_int8 = train(adapt_cfg.replace(msda_int8=True), "adaptation int8",
                       *adapt_args, 1, lrs=perf_train_step.ADAPT_LRS)
    adapt_errs = compare_train_f32(adapt_cfg, "adaptation", adapt_hw, 2,
                                   ADAPT_GRAD_RTOL)
    # the training driver with every exact forward through K11
    with tempfile.TemporaryDirectory() as workdir:
        driver = drive_trainer(workdir)
        # the other two entry points on phase 17's set and artifact
        evaluate = drive_evaluate(workdir, driver)
        pretrain = drive_pretrain(workdir)
        # the trained-offsets experiment and the window-deltas script
        experiment = drive_experiment(workdir)
        # Open Images V6 through the same three entry points
        open_images = drive_oi(workdir)
        # (c) the three drivers on two ranks sharing the card
        torch.cuda.empty_cache()
        ddp_drivers = drive_ranks(workdir)
    # the options the port took last: two stages, rematerialized layers and
    # the approximate top-k of the negative mining
    two_stage = check_two_stage(train_shapes)
    remat = check_remat(train_cfg)
    approx_topk = check_approx_topk(train_cfg)
    # data-parallel: (a) the step, (b) with accumulation and the banded
    # kernels, (d) NCCL in one rank and (e) the dry run in two
    torch.cuda.empty_cache()
    ddp = check_ddp(exact_train["ms_per_step"])
    ddp_adapt = check_adapt_accum()
    ddp_dryruns = check_dryruns()
    # (j) the step as programs in one rank under NCCL
    torch.cuda.empty_cache()
    nccl = check_nccl_programs({"train_graphs": train_graphs,
                                "ms_per_step": exact_train["ms_per_step"]})
    # (f) the model axis: the relation grid's rows over two ranks
    torch.cuda.empty_cache()
    tp = check_tp()
    oi_runs = {label: run["counts"]
               for label, run in open_images["runs"].items()}
    new_paths = {"experiment": experiment["counts"],
                 "oi_train": oi_runs["train"],
                 "oi_evaluate": oi_runs["evaluate"],
                 "oi_pretrain": oi_runs["pretrain"],
                 "two_stage_serving": two_stage["serve_counts"],
                 "two_stage_training": two_stage["train"]["counts"],
                 **{f"remat_{label}_training": run["counts"]
                    for label, run in remat["train"].items()
                    if label != "off"}}

    def new_launches(kernel):
        return {f"launches_{path}": counts[kernel]
                for path, counts in new_paths.items() if counts[kernel]}

    def pick(table, call, dtype="bfloat16", batch=1):
        return next(r for r in table if r["call"] == call
                    and r["dtype"] == dtype and r.get("batch", 1) == batch)

    def banded_entry(name, line, main_form, launches):
        mine = {r["dtype"]: r for r in win_rows if r["kernel"] == name}
        test_bucket = [r for r in evaluate["win_rows"] if r["kernel"] == name]
        main = mine[main_form]
        return {
            "name": name, "route": "cuda",
            "source": "egtr_tpu_torch/csrc/msda_fwd_win.cu",
            "replaces": f"egtr_tpu/ops/msda_pallas.py:{line}",
            "launches": launches, **new_launches(name),
            "max_abs_err": max(r["max_abs_err"]
                               for r in [*mine.values(), *test_bucket]),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "form": main_form,
            "graph_ms": main["graph_ms"],
            "ms_float32": mine["float32"]["ms"],
            "ms_bfloat16": mine["bfloat16"]["ms"],
            "ms_int8": mine["int8"]["ms"],
            **{f"graph_ms_{form}": r["graph_ms"] for form, r in mine.items()},
            "bit_equal_run_to_run": all(r["bit_equal_run_to_run"]
                                        for r in mine.values()),
            "calls": list(mine.values()),
            "calls_test_bucket": test_bucket,
            **({"bit_equal_to_k6_broadcast": all(
                r["bit_equal_to_k6_broadcast"]
                for r in [*mine.values(), *test_bucket])}
               if name == "msda_fwd_win" else {}),
        }

    def banded_bwd_entry(kind, name, line, launches):
        mine = [r for r in bwd_win_rows if r[f"{kind}_kernel"] == name]
        main = next(r for r in mine if r["dtype"] == "bfloat16")
        keys = ("dix", "diy", "daw") if kind == "rows" else ("dvalue",)
        entry = {
            "name": name, "route": "cuda",
            "source": "egtr_tpu_torch/csrc/msda_bwd_win.cu",
            "replaces": f"egtr_tpu/ops/msda_pallas.py:{line}",
            "launches": launches, **new_launches(name),
            "max_abs_err": max(main["max_abs_err"][k] for k in keys),
            "ms": main[f"{kind}_ms"],
            # the plain version computes rows and value in one call
            "plain_ms": main["plain_ms"],
            "bound_ms": main[f"{kind}_bound_ms"],
            "bound_by": main[f"{kind}_bound_by"],
            "library_ms": None, "form": "bfloat16", "batch": main["batch"],
            "ms_float32": next(r for r in mine
                               if r["dtype"] == "float32")[f"{kind}_ms"],
            "calls": mine,
        }
        if kind == "value":
            entry["graph_ms"] = main["value_graph_ms"]
            entry["graph_ms_float32"] = next(
                r for r in mine if r["dtype"] == "float32")["value_graph_ms"]
            entry["run_to_run_max_abs_diff"] = max(
                r["value_run_to_run_max_abs_diff"] for r in mine)
            if name == "msda_bwd_win_value":
                entry["max_abs_diff_to_k10_broadcast"] = max(
                    r["value_max_abs_diff_to_k10_broadcast"] for r in mine)
        else:
            entry["graph_ms"] = main["rows_graph_ms"]
            entry["graph_ms_float32"] = next(
                r for r in mine if r["dtype"] == "float32")["rows_graph_ms"]
            entry["bit_equal_run_to_run"] = all(
                r["rows_bit_equal_run_to_run"] for r in mine)
            if name == "msda_bwd_win_rows":
                entry["bit_equal_to_k8_broadcast"] = all(
                    r["rows_bit_equal_to_k8_broadcast"] for r in mine)
        return entry

    main_row = pick(rows, "encoder")
    bp_main = next(r for r in bp_rows if r["bucket"] == "serving"
                   and r["Q"] != 200 and r["form"] == "bfloat16")
    bp_launches = {label: r["counts"]["msda_fwd_bp"]
                   for label, r in batch_p_serve.items()}
    bp_launches["driver"] = driver["counts"]["msda_fwd_bp"]
    # the source that serves each form of K11, the main (bfloat16) form's
    # first
    here = os.path.dirname(os.path.abspath(__file__))
    bp_routes = {str(dtype)[6:]: fn
                 for dtype, fn in msda_cuda.BP_ROUTES.items()}
    bp_sources = {form: os.path.relpath(msda_cuda.source_of(fn), here)
                  for form, fn in bp_routes.items()}
    bp_entry = {
        "name": "msda_fwd_bp", "route": "cuda",
        "source": bp_sources["bfloat16"],
        "sources_by_form": bp_sources, "routes_by_form": bp_routes,
        "replaces": "egtr_tpu/ops/msda_pallas.py:180",
        "launches": sum(bp_launches.values()),
        **{f"launches_{k}": v for k, v in bp_launches.items()},
        "max_abs_err": max(r["max_abs_err"] for r in bp_rows
                           if r["form"] == "bfloat16"),
        "ms": bp_main["ms"], "plain_ms": bp_main["plain_ms"],
        "bound_ms": bp_main["bound_ms"], "bound_by": bp_main["bound_by"],
        "library_ms": None, "form": "bfloat16",
        "ms_msda_fwd_same_call": bp_main["ms_msda_fwd_same_call"],
        "bit_equal_where_routed": all(
            r[f"bit_equal_to_{r['routed_to']}"] for r in bp_rows
            if r["routed_to"] != "msda_fwd_bp"),
        "calls": bp_rows,
        "served_f32_max_abs_err": {"exact": model_errs["batch_p"],
                                   "served": served_errs["batch_p"]},
        "served_bf16_max_abs_diff_flag_off": {
            label: r["max_abs_diff"] for label, r in batch_p_serve.items()},
        "served_bf16_bit_equal_flag_off": {
            label: r["bit_equal_flag_off"]
            for label, r in batch_p_serve.items()},
    }
    bwd_row = pick(bwd_rows, "encoder")
    q_row = pick(q_rows, "encoder_served")
    bf16_bwd = [r for r in bwd_rows if r["dtype"] == "bfloat16"]
    # the evaluation driver's runs (exact, served, --infer_only) and the
    # pretraining driver's
    evaluated = {label: run["counts"]
                 for label, run in evaluate["runs"].items()}
    pretrained = pretrain["counts"]
    fwd_launches = (exact_counts["msda_fwd"] + tile_counts["msda_fwd"]
                    + counts["msda_fwd"])
    # the trunk's epilogue kernel on the inference paths
    fbn_launches = {
        "serving": exact_counts["frozen_bn"],
        "serving_served": served_counts["frozen_bn"],
        "serving_tile": tile_counts["frozen_bn"],
        "offline": fbn["offline_launches"]["frozen_bn"],
        **{f"evaluate{'' if label == 'exact' else '_' + label}":
           run["frozen_bn"] for label, run in evaluated.items()}}
    fbn_main = fbn["trunks"]["offline"]
    kernels = {"kernels": [{
        "name": "msda_fwd",
        "route": "cuda",
        "source": "egtr_tpu_torch/csrc/msda_fwd.cu",
        "replaces": "egtr_tpu/ops/msda_pallas.py:144",
        "launches": fwd_launches,
        "launches_serving": exact_counts["msda_fwd"],
        "launches_serving_tile": tile_counts["msda_fwd"],
        "launches_serving_served": served_counts["msda_fwd"],
        "launches_training": counts["msda_fwd"],
        "launches_adaptation": adapt["counts"]["msda_fwd"],
        "launches_evaluate": evaluated["exact"]["msda_fwd"],
        "launches_evaluate_infer_only": evaluated["infer_only"]["msda_fwd"],
        "launches_pretrain": pretrained["msda_fwd"],
        **new_launches("msda_fwd"),
        "max_abs_err": max(r["max_abs_err"] for r in rows + train_rows
                           + two_stage["fwd_rows"]
                           if r["dtype"] == "bfloat16"),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "library_composite_ms": main_row["library_composite_ms"],
        "library_composite": COMPOSITE_NOTE,
        "graph_ms": main_row["graph_ms"],
        "gather_bytes": main_row["gather_bytes"],
        "gather_GBps_L2": main_row["gather_GBps_L2"],
        "ms_encoder": main_row["ms"],
        "ms_encoder_raster": pick(rows, "encoder_raster")["ms"],
        "ms_decoder": pick(rows, "decoder")["ms"],
        "graph_ms_decoder": pick(rows, "decoder")["graph_ms"],
        "graph_ms_decoder_batch2_training": pick(
            train_rows, "decoder", batch=2)["graph_ms"],
        "ms_encoder_training": pick(train_rows, "encoder")["ms"],
        "ms_encoder_raster_training": pick(train_rows,
                                           "encoder_raster")["ms"],
        "ms_decoder_training": pick(train_rows, "decoder")["ms"],
        "calls": rows + train_rows,
        "calls_two_stage": two_stage["fwd_rows"],
        "model_f32_max_abs_err": model_errs,
        "two_stage_model_f32_max_abs_err": two_stage["f32"],
    }, {
        "name": "msda_bwd_rows",
        "route": "cuda",
        "source": "egtr_tpu_torch/csrc/msda_bwd.cu",
        "replaces": "egtr_tpu/ops/msda_pallas.py:487",
        "launches": counts["msda_bwd_rows"],
        "launches_training": counts["msda_bwd_rows"],
        "launches_adaptation": adapt["counts"]["msda_bwd_rows"],
        "launches_pretrain": pretrained["msda_bwd_rows"],
        **new_launches("msda_bwd_rows"),
        "max_abs_err": max(max(r["max_abs_err"][k] for k in ("dloc", "daw"))
                           for r in bf16_bwd),
        "ms": bwd_row["rows_ms"],
        "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["rows_bound_ms"],
        "bound_by": bwd_row["rows_bound_by"],
        "library_ms": None,
        "library_composite_ms": bwd_row["library_composite_ms"],
        "library_composite": COMPOSITE_NOTE + " (its autograd backward: the "
                             "work of K2 and K3 together)",
        "graph_ms": bwd_row["rows_graph_ms"],
        "gather_bytes": bwd_row["rows_gather_bytes"],
        "gather_GBps_L2": bwd_row["rows_gather_GBps_L2"],
        "ms_encoder": bwd_row["rows_ms"],
        "ms_encoder_raster": pick(bwd_rows, "encoder_raster")["rows_ms"],
        "ms_decoder": pick(bwd_rows, "decoder")["rows_ms"],
        "graph_ms_decoder": pick(bwd_rows, "decoder")["rows_graph_ms"],
        "graph_ms_decoder_batch2": pick(bwd_rows, "decoder",
                                        batch=2)["rows_graph_ms"],
        "calls": bwd_rows,
        "calls_two_stage": two_stage["bwd_rows"],
    }, {
        "name": "msda_bwd_value",
        "route": "cuda",
        "source": "egtr_tpu_torch/csrc/msda_bwd.cu",
        "replaces": "egtr_tpu/ops/msda_pallas.py:608",
        "launches": counts["msda_bwd_value"],
        "launches_training": counts["msda_bwd_value"],
        "launches_adaptation": adapt["counts"]["msda_bwd_value"],
        "launches_pretrain": pretrained["msda_bwd_value"],
        **new_launches("msda_bwd_value"),
        "max_abs_err": max(r["max_abs_err"]["dvalue"] for r in bf16_bwd),
        "ms": bwd_row["value_ms"],
        "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["value_bound_ms"],
        "bound_by": bwd_row["value_bound_by"],
        "library_ms": None,
        "library_composite_ms": bwd_row["library_composite_ms"],
        "library_composite": COMPOSITE_NOTE + " (its autograd backward: the "
                             "work of K2 and K3 together)",
        "graph_ms": bwd_row["value_graph_ms"],
        "ms_encoder": bwd_row["value_ms"],
        "ms_encoder_raster": pick(bwd_rows, "encoder_raster")["value_ms"],
        "ms_decoder": pick(bwd_rows, "decoder")["value_ms"],
        "graph_ms_decoder": pick(bwd_rows, "decoder")["value_graph_ms"],
        "graph_ms_decoder_batch2": pick(bwd_rows, "decoder",
                                        batch=2)["value_graph_ms"],
        "calls": bwd_rows,
        "calls_two_stage": two_stage["bwd_rows"],
        "run_to_run_max_abs_diff": max(
            r["value_run_to_run_max_abs_diff"] for r in bwd_rows),
    }, {
        "name": "msda_fwd_q",
        "route": "cuda",
        "source": "egtr_tpu_torch/csrc/msda_fwd_q.cu",
        "replaces": "egtr_tpu/ops/msda_pallas.py:130",
        "launches": served_counts["msda_fwd_q"],
        "launches_serving_served": served_counts["msda_fwd_q"],
        "launches_evaluate_served": evaluated["served"]["msda_fwd_q"],
        "launches_adaptation_int8": adapt_int8["counts"]["msda_fwd_q"],
        **new_launches("msda_fwd_q"),
        "max_abs_err": max(r["max_abs_err"]
                           for r in q_rows + evaluate["q_rows"]),
        "ms": q_row["ms"],
        "plain_ms": q_row["plain_ms"],
        "bound_ms": q_row["bound_ms"],
        "bound_by": q_row["bound_by"],
        "library_ms": None,
        "graph_ms": q_row["graph_ms"],
        "ms_encoder_served": q_row["ms"],
        "ms_encoder": pick(q_rows, "encoder")["ms"],
        "ms_decoder": pick(q_rows, "decoder")["ms"],
        "graph_ms_encoder": pick(q_rows, "encoder")["graph_ms"],
        "graph_ms_decoder": pick(q_rows, "decoder")["graph_ms"],
        "graph_ms_decoder_batch2": pick(q_rows, "decoder",
                                        batch=2)["graph_ms"],
        "bit_equal_run_to_run": all(r["bit_equal_run_to_run"]
                                    for r in q_rows),
        "calls": q_rows,
        "calls_test_bucket": evaluate["q_rows"],
        "int8_grad_launches": int8_grad_counts,
        "served_model_f32_max_abs_err": served_errs,
    },
        banded_entry("msda_fwd_win", 240, "bfloat16",
                     tile_counts["msda_fwd_win"]),
        {**banded_entry("msda_fwd_win_pp", 249, "int8",
                        served_counts["msda_fwd_win_pp"]),
         "launches_serving_served": served_counts["msda_fwd_win_pp"],
         "launches_evaluate_served": evaluated["served"]["msda_fwd_win_pp"]},
        banded_bwd_entry("rows", "msda_bwd_win_rows", 836,
                         adapt_tile["counts"]["msda_bwd_win_rows"]),
        banded_bwd_entry("rows", "msda_bwd_win_rows_pp", 722,
                         adapt["counts"]["msda_bwd_win_rows_pp"]),
        banded_bwd_entry("value", "msda_bwd_win_value", 877,
                         adapt_tile["counts"]["msda_bwd_win_value"]),
        banded_bwd_entry("value", "msda_bwd_win_value_pp", 772,
                         adapt["counts"]["msda_bwd_win_value_pp"]),
        bp_entry,
        {"name": "lsap", "route": "cuda",
         "source": "egtr_tpu_torch/csrc/lsap.cu",
         "replaces": "egtr_tpu/ops/matcher.py:77",
         "replaces_note": "device code outside Pallas: the in-jit "
                          "Jonker-Volgenant solver _lsa_single, vmapped by "
                          "hungarian_match",
         "launches": exact_train["lsap_launches"],
         "launches_training": exact_train["lsap_launches"],
         "launches_driver": driver["lsap_launches"],
         "max_abs_err": max(r["max_abs_err"] for r in lsap["rows"]),
         "ms": lsap["main"]["ms"], "plain_ms": lsap["main"]["plain_ms"],
         "plain_device": "cpu",
         "bound_ms": lsap["main"]["bound_ms"],
         "bound_by": lsap["main"]["bound_by"], "library_ms": None,
         "graph_ms": lsap["main"]["graph_ms"],
         "route_main": lsap["main"]["route"],
         "parent_graph_ms": lsap["main"]["parent_graph_ms"],
         "parent_origin": lsap["parent_origin"],
         "host_scipy_ms": lsap["main"]["host_scipy_ms"],
         "bit_equal_to_plain": all(r["bit_equal_to_plain"]
                                   for r in lsap["rows"]),
         "optimal_vs_scipy": all(r["optimal_vs_scipy"]
                                 for r in lsap["rows"]),
         "calls": lsap["rows"]},
        {"name": "frozen_bn", "route": "cuda",
         "source": "egtr_tpu_torch/csrc/frozen_bn.cu",
         "replaces": "egtr_tpu/models/backbone.py:71",
         "replaces_note": "device code outside Pallas: XLA's fusion of "
                          "FrozenBatchNorm, the ReLU and the residual add, "
                          "one pass a site",
         "launches": sum(fbn_launches.values()),
         **{f"launches_{k}": v for k, v in fbn_launches.items()},
         "launches_training": exact_train["frozen_bn_launches"],
         "sites_per_forward": fbn["sites_per_forward"],
         "max_abs_err": max(r["max_abs_err"] for r in fbn["rows"]),
         "bit_equal_to_plain": all(r["bit_equal"] and r["bit_equal_in_place"]
                                   for r in fbn["rows"]),
         # a trunk's sites summed, at the offline bucket; the serving
         # bucket's beside them
         "ms": fbn_main["graph_ms"], "graph_ms": fbn_main["graph_ms"],
         "plain_ms": fbn_main["plain_ms"], "bound_ms": fbn_main["bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "times_bound": fbn_main["times_bound"],
         "trunks": fbn["trunks"], "calls": fbn["rows"]},
    ], "serve_ms_per_request": {"exact": exact_ms, "served": served_ms,
                                "tile": tile_ms},
        "request_graphs": request_graphs,
        "train_graphs": train_graphs,
        "serve_ms_per_request_in_turns": side_by_side,
        "train": {"ms_per_step": exact_train["ms_per_step"],
                  "accumulated_step_ms":
                      exact_train["accumulated_step_ms"][0],
                  "max_memory_allocated_gb":
                      exact_train["max_memory_allocated_gb"]},
        "train_adaptation": {
            label: {k: v for k, v in run.items() if k != "counts"}
            for label, run in (("point", adapt), ("tile", adapt_tile),
                               ("point_int8", adapt_int8))},
        "train_f32": {"exact": train_errs, "adaptation": adapt_errs},
        "driver": {k: v for k, v in driver.items()
                   if k not in ("counts", "entries")},
        "evaluate": {label: {k: v for k, v in run.items() if k != "counts"}
                     for label, run in evaluate["runs"].items()},
        "evaluate_test_bucket": evaluate["bucket"],
        "sg_eval_host_ms": evaluate["sg_eval"],
        "pretrain": {k: v for k, v in pretrain.items() if k != "counts"},
        "experiment": {
            **{k: v for k, v in experiment.items() if k != "counts"},
            "runs": {label: {k: v for k, v in run.items()
                             if k != "counts"}
                     for label, run in experiment["runs"].items()},
            "sweep": {k: v for k, v in experiment["sweep"].items()
                      if k != "counts"}},
        "open_images": open_images,
        "two_stage": {"train": {k: v for k, v in two_stage["train"].items()
                                if k != "counts"},
                      "f32": two_stage["f32"]},
        "remat": {"train": {label: {k: v for k, v in run.items()
                                    if k != "counts"}
                            for label, run in remat["train"].items()},
                  "f32_grads": remat["f32_grads"],
                  "k1_per_microbatch": remat["k1_per_microbatch"]},
        "approx_topk": approx_topk}
    # each kernel's launches in every rank of the data-parallel paths
    ddp_paths = {
        "ddp": ddp["counts_per_rank"],
        "ddp_bf16": ddp["bf16_counts_per_rank"],
        "ddp_adaptation": ddp_adapt["counts_per_rank"],
        **{f"ddp_{k}": v for k, v in ddp_drivers["counts_per_rank"].items()},
        **{f"ddp_dryrun_{k}": [r["launches"]] for k, r in
           ddp_dryruns.items()},
        "nccl_programs_replay": nccl["counts_per_rank"],
        "tp": tp["counts_per_rank"],
        "tp_bf16": tp["bf16_counts_per_rank"],
        "tp_train": tp["train_counts_per_rank"]}
    for entry in kernels["kernels"]:
        for path, ranks in ddp_paths.items():
            per_rank = [counts.get(entry["name"], 0) for counts in ranks]
            if any(per_rank):
                entry[f"launches_{path}_per_rank"] = per_rank
    kernels["data_parallel"] = {
        "ddp": {k: v for k, v in ddp.items() if "counts" not in k},
        "adaptation": {k: v for k, v in ddp_adapt.items()
                       if "counts" not in k},
        "drivers": {k: v for k, v in ddp_drivers.items()
                    if "counts" not in k},
        "dryruns": {k: {"backend": r["backend"], "metrics": r["metrics"],
                        "mesh": r["mesh"], "captured": r["captured"],
                        "seconds": r["seconds"]}
                    for k, r in ddp_dryruns.items()}}
    kernels["data_parallel"]["nccl_programs"] = {
        k: v for k, v in nccl.items() if k != "counts_per_rank"}
    kernels["tensor_parallel"] = {k: v for k, v in tp.items()
                                  if "counts" not in k}
    kernels["launch_counting"] = {
        "how": "measured on the card (torch.profiler trace of the card's "
               "activity, graph replays included; CardLaunches): one "
               "process, the drivers' ranks (c), the NCCL rank (j); by "
               "wrapper: the ranks of (a), (b), (d)-(f), whose steps hold "
               "gloo collectives and run eagerly",
        **TRACE_COST}
    print(f"launch measurement: {TRACE_COST['traces']} traces read in "
          f"{TRACE_COST['seconds']:.1f} s", flush=True)
    print(json.dumps(kernels))
    print(f"total {time.perf_counter() - t_start:.1f} s; card: {card}",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
