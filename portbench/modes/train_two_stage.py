"""Training two-stage, box-refined EGTR: the ``train`` mode's optimizer step
(``egtr_tpu_torch.train.train_step.make_train_step``, its captured
microbatch and apply programs) on a configuration with ``two_stage`` and
``with_box_refine``; the traffic parameters are ``train``'s.

The output check is ``train``'s, against ``reference/two_stage.py``, with
the program's discrete choices judged apart. Each microbatch selects 300 of
the encoder's 22,323 tokens by a score whose near-ties bfloat16 reorders,
and assigns the targets among all of them (the matcher at Q = S): a
reference that chose for itself would often follow other queries, and the
gap would be that choice, not the arithmetic. So the check reads the
program's choices, and the reference continues from them (no gradient flows
through an index):

- the choices are recomputed after the window by the port's own forward,
  run eagerly at the parameters each warm step began from (snapshots taken
  in set-up, outside its time) and at the program's dropout positions:
  the proposal indices and the proposals' assignment
  (``ops.criterion.match`` on the binarised targets, as the criterion
  calls it);
- ``replay_gap``: the recomputed forwards' loss against the program's, the
  largest relative gap of the warm steps, which holds the recomputation to
  the program's run (what stands in the program's place and is not that run
  reads far above it);
- ``proposal_gap``: how far below its own 300th best score the reference
  scores the worst token the program chose, over the scores' spread;
- ``enc_match_gap``: how much more the program's assignment costs at the
  reference's costs than the reference's optimum, over the boxes times the
  costs' spread;
- ``loss``, ``grad1``, ``change3`` and their medians as ``train`` reads
  them, the reference following the program's choices.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from portbench import serving
from portbench.modes import train
from portbench.modes.train import position, step_numbers
from portbench.reference.train import param_label
from portbench.reference.two_stage import TwoStageStep


class Runner(train.Runner):
    def setup(self):
        self.snapshots: List[dict] = []
        super().setup()

    def step_once(self, record=True):
        loss = super().step_once(record)
        if not record and len(self.snapshots) < self.warm - 1:
            # the parameters the next warm step begins from
            with self.timer.exclude():
                model = self.program_state["model"]
                self.snapshots.append(
                    {n: p.detach().to("cpu", copy=True)
                     for n, p in model.named_parameters()})
        return loss

    def slice_info(self):
        from portbench import flops_two_stage

        info = super().slice_info()
        info["flops_per_image"] = flops_two_stage.step_flops(
            self.m, self.bucket, 1, True)
        return info

    # -- the output check --------------------------------------------------
    def program_choices(self):
        """The program's choices of each warm step's microbatches:
        ``[step][microbatch] -> {"proposals": [B,k], "enc_assign": per image
        (proposal indices, target indices)}``, by the port's forward run
        eagerly as the program ran it. Keeps each warm step's recomputed
        loss in ``replayed``."""
        from egtr_tpu_torch.models.egtr import EgtrModel
        from egtr_tpu_torch.ops import criterion

        cfg = serving.egtr_config(self.spec.config)
        dev = self.device
        with torch.device(dev):
            model = EgtrModel(cfg)
        model.train()
        gen = torch.Generator(device=dev)
        states = [self.p0] + self.snapshots
        out_choices, self.replayed = [], []
        for s in range(self.warm):
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(states[s][n])
            seek = self.seeker(s, gen)
            per, step_loss, step_choices = -1, 0.0, []
            for a, mb in enumerate(self.batches[s % self.pool]):
                seek(a, per)
                start = position(gen) if dev.type == "cuda" else 0
                out = model(mb["pixel_values"], mb["pixel_mask"],
                            generator=gen)
                if dev.type == "cuda":
                    per = position(gen) - start
                labels = mb["labels"]
                with torch.no_grad():
                    total, _ = criterion.sgg_criterion(
                        out, labels, cfg, train=True, generator=gen)
                    binary = dict(labels, class_labels=torch.zeros_like(
                        labels["class_labels"]))
                    res = criterion.match(
                        out["enc_outputs_class"],
                        torch.sigmoid(out["enc_outputs_coord_logits"]),
                        binary, cfg)
                step_loss += float(total) / self.A
                nb = labels["num_boxes"].cpu().tolist()
                qi = res.query_index.cpu()
                step_choices.append({
                    "proposals": out["proposal_indices"].detach().cpu(),
                    "enc_assign": [(qi[b, :n].numpy(), np.arange(n))
                                   for b, n in enumerate(nb)]})
                del out, total, res
            out_choices.append(step_choices)
            self.replayed.append(step_loss)
        del model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return out_choices

    def replay_gap(self, losses) -> float:
        """The recomputed losses (``program_choices``) against ``losses``,
        the warm steps' of the program or of what stands in its place: the
        largest relative gap."""
        return max(abs(r - x) / abs(x) for r, x in zip(self.replayed, losses))

    def reference_steps(self, quant=None, choices=None):
        """The reference's three steps: (losses, first gradient by leaf,
        change by leaf, the worst gaps, the choices it followed).
        ``choices``: the selection and assignment to continue from
        (``program_choices``' form; None: its own)."""
        dev = self.device
        gen = torch.Generator(device=dev)
        params = {n: t.to(dev) for n, t in self.p0.items()}
        step = TwoStageStep(params, self.m, self.recipe, quant)
        del params
        losses, g1, followed = [], None, []
        gaps = {"proposal_gap": 0.0, "enc_match_gap": 0.0}
        with serving.float32_exact():
            for s in range(self.warm):
                mbs = []
                for a, ref in enumerate(self.ref_batches[s]):
                    rows = ref["rows"]
                    mb = {"pixel_values": self.images[rows],
                          "pixel_mask": self.masks[rows],
                          "targets": [{k: torch.as_tensor(v, device=dev)
                                       for k, v in tg.items()}
                                      for tg in ref["targets"]]}
                    if choices is not None:
                        mb.update(choices[s][a])
                    mbs.append(mb)
                out = step(mbs, gen, self.seeker(s, gen))
                losses.append(out["loss"])
                followed.append(out["choices"])
                for k in gaps:
                    gaps[k] = max(gaps[k], out[k])
                if s == 0:
                    g1 = {n: g.cpu() for n, g in out["grads"].items()
                          if param_label(n) != "frozen"}
        change = {n: (p.detach().cpu() - self.p0[n])
                  for n, p in step.params.items()}
        return losses, g1, change, gaps, followed

    def numbers(self, side, ref):
        """``train.step_numbers`` of ``side`` against ``ref`` (each as
        ``reference_steps`` returns it, ``side``'s gaps unused) and ``ref``'s
        gaps, which judge the choices it followed."""
        got = step_numbers(side[:3], ref[:3])
        got.update(ref[3])
        return got

    def check(self):
        choices = self.program_choices()
        ref = self.reference_steps(choices=choices)
        prog_change = {n: self.p3[n] - self.p0[n] for n in self.p0}
        got = self.numbers((self.warm_losses, self.g1, prog_change), ref)
        got["replay_gap"] = self.replay_gap(self.warm_losses)
        return [(name, got[name], float(lim))
                for name, lim in self.spec.traffic["limits"].items()]
