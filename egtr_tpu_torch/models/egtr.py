"""EGTR scene-graph-generation model (PyTorch port of ``egtr_tpu/models/egtr.py``).

Reference: ``DetrForSceneGraphGeneration`` (model/egtr.py:122-540). The
detection path is :class:`~egtr_tpu_torch.models.detr.DeformableDetrBase`;
this module adds the relation head over the decoder self-attention (q, k).

The head keeps the JAX package's factorized gate: the gate
``sigmoid(w_g · [q_i; k_j])`` is rank-1 over (i, j) and the first layer of
both 3-layer MLP heads is linear in ``[gq; gk]``, so with

    ga[i,l] = q_l(i)·w_g[:d],    gb[j,l] = k_l(j)·w_g[d:]
    gate[i,j,l] = sigmoid(ga[i,l] + gb[j,l] + b_g)
    Aq[i,l] = W1a q_l(i),        Bk[j,l] = W1b k_l(j)

the first hidden layer is ``h1[i,j] = sum_l gate[i,j,l] (Aq[i,l] + Bk[j,l]) + b1``
and the largest live tensor is [B, Q, Q, d] instead of [B, Q, Q, L+1, 2d].
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import EgtrConfig
from .detr import DeformableDetrBase, torch_dtype
from .layers import Dense, Initialized, _matmul_f32, normal_init, zeros


def compute_freq_dists(fg_matrix, eps: float, use_log_softmax: bool):
    """Frequency-bias buffers from the train-set triplet counts.

    Reference: egtr.py:169-194. NOTE the reference expression
    ``fg_matrix + eps / (fg_matrix.sum(2, keepdims=True) + eps)`` adds
    ``eps/(sum+eps)`` to the raw counts (python operator precedence); it is
    reproduced verbatim since released checkpoints bake it in.
    Returns (rel_dist [R], triplet_dist [C+1, C+1, R]).
    """
    fg = torch.as_tensor(np.asarray(fg_matrix), dtype=torch.float32)
    rel_dist = fg.sum(dim=(0, 1)) / (fg.sum() + eps)
    triplet = fg + eps / (fg.sum(dim=2, keepdim=True) + eps)
    if use_log_softmax:
        triplet_dist = triplet.log_softmax(-1)
    else:
        triplet_dist = triplet.log()
    return rel_dist, triplet_dist


class EgtrHead(Initialized):
    """Relation + connectivity head over decoder (q, k) by-products."""

    def __init__(self, config: EgtrConfig):
        super().__init__()
        cfg = self.config = config
        E, L, R = cfg.d_model, cfg.decoder_layers, cfg.num_rel_labels
        dtype = self.dtype = torch_dtype(cfg.compute_dtype)
        for l in range(L):
            self.add_module(f"proj_q_{l}", Dense(E, E, dtype))
            self.add_module(f"proj_k_{l}", Dense(E, E, dtype))
        self.final_sub_proj = Dense(E, E, dtype)
        self.final_obj_proj = Dense(E, E, dtype)
        # raw parameters in the JAX layout [in, out], as the flax tree has them
        self.param("rel_predictor_gate_kernel", (2 * E, 1), normal_init(0.02))
        self.param("rel_predictor_gate_bias", (1,), zeros)
        self.param("rel_predictor_layers_0_kernel", (2 * E, E),
                   normal_init(0.02))
        self.param("rel_predictor_layers_0_bias", (E,), zeros)
        self.rel_predictor_layers_1 = Dense(E, E, dtype)
        self.rel_predictor_layers_2 = Dense(E, R, dtype)
        self.param("connectivity_layers_0_kernel", (2 * E, E),
                   normal_init(0.02))
        self.param("connectivity_layers_0_bias", (E,), zeros)
        self.connectivity_layers_1 = Dense(E, E, dtype)
        self.connectivity_layers_2 = Dense(E, 1, dtype)

    def _pairwise(self, gate_c, Qs, Ks, w1, b1):
        """First MLP layer over all (i, j) pairs, factorized:
        sum_l gate[i,j,l] (Qs[i,l] W1a + Ks[j,l] W1b) + b1, float32."""
        E = self.config.d_model
        Aq = torch.matmul(Qs, w1[:E].to(Qs.dtype))            # [B,Q,L+1,E]
        Bk = torch.matmul(Ks, w1[E:].to(Ks.dtype))
        # [B,i,j,l] @ [B,i,l,d] -> [B,i,j,d]
        hq = _matmul_f32(gate_c, Aq.to(self.dtype))
        # [B,j,i,l] @ [B,j,l,d] -> [B,j,i,d] -> [B,i,j,d]
        hk = _matmul_f32(gate_c.transpose(1, 2), Bk.to(self.dtype))
        return hq + hk.transpose(1, 2) + b1

    def forward(self, attention_queries, attention_keys, last_hidden_state,
                logits, triplet_dist: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """attention_queries/keys: [B, L, H, Q, Dh] stacked per decoder layer;
        last_hidden_state [B, Q, E]; logits [B, Q, C];
        triplet_dist [C+1, C+1, R] log-frequency bias (or None).

        Returns dict(pred_rel_logits, pred_connectivity_logits, rel_gate_mean).
        """
        cfg = self.config
        E, L = cfg.d_model, cfg.decoder_layers
        dtype = self.dtype
        B, _, H, Q, Dh = attention_queries.shape

        def merge_heads(t):  # [B,L,H,Q,Dh] -> [B,L,Q,E]
            return t.permute(0, 1, 3, 2, 4).reshape(B, L, Q, E)

        qs_raw = merge_heads(attention_queries) * cfg.head_dim ** 0.5
        ks_raw = merge_heads(attention_keys)
        qs = [getattr(self, f"proj_q_{l}")(qs_raw[:, l]) for l in range(L)]
        ks = [getattr(self, f"proj_k_{l}")(ks_raw[:, l]) for l in range(L)]
        qs.append(self.final_sub_proj(last_hidden_state))
        ks.append(self.final_obj_proj(last_hidden_state))
        Qs = torch.stack(qs, dim=2)                           # [B,Q,L+1,E]
        Ks = torch.stack(ks, dim=2)

        wg = self.rel_predictor_gate_kernel
        ga = _matmul_f32(Qs, wg[:E].to(Qs.dtype))[..., 0]     # [B,Q,L+1]
        gb = _matmul_f32(Ks, wg[E:].to(Ks.dtype))[..., 0]
        gate = torch.sigmoid(ga[:, :, None, :] + gb[:, None, :, :]
                             + self.rel_predictor_gate_bias[0])  # [B,Q,Q,L+1]
        gate_c = gate.to(dtype)

        h1 = self._pairwise(gate_c, Qs, Ks, self.rel_predictor_layers_0_kernel,
                            self.rel_predictor_layers_0_bias).to(dtype)
        h = F.relu(self.rel_predictor_layers_1(F.relu(h1)))
        pred_rel = self.rel_predictor_layers_2(h).float()     # [B,Q,Q,R]

        # frequency bias (Neural Motifs; egtr.py:405-413)
        if cfg.use_freq_bias and triplet_dist is not None:
            node = logits.argmax(-1)                          # [B,Q]
            # one row lookup per (subject, object) pair; index_select's
            # gradient is an index_add, where the gradient of advanced
            # indexing sorts all B*Q*Q pairs
            n_cls = triplet_dist.shape[0]
            pair = (node[:, :, None] * n_cls + node[:, None, :]).reshape(-1)
            bias = triplet_dist.reshape(n_cls * n_cls, -1).index_select(0, pair)
            pred_rel = pred_rel + bias.reshape(B, Q, Q, -1)

        # connectivity head shares the gated source (egtr.py:218-223,416)
        c1 = self._pairwise(gate_c, Qs, Ks, self.connectivity_layers_0_kernel,
                            self.connectivity_layers_0_bias)
        c = F.relu(self.connectivity_layers_1(F.relu(c1.to(dtype))))
        pred_connectivity = self.connectivity_layers_2(c).float()

        return {
            "pred_rel_logits": pred_rel,
            "pred_connectivity_logits": pred_connectivity,
            "rel_gate_mean": gate.mean(dim=(0, 1, 2)),        # [L+1]
        }


class EgtrModel(Initialized):
    """Full EGTR: Deformable-DETR base + relation head.

    Parameters are created empty: fill them with
    ``layers.init_params(model, generator)`` or load a state dict
    (``utils.convert.state_dict_from_jax``).

    Outputs mirror DetrSceneGraphGenerationOutput (egtr.py:53-119). As in
    ``egtr_tpu/models/egtr.py:194-203``, ``pred_rel`` is the sigmoid of the
    logit-adjusted relation logits while ``pred_rel_logits`` is returned
    unadjusted.
    """

    def __init__(self, config: EgtrConfig):
        super().__init__()
        cfg = self.config = config
        self.model = DeformableDetrBase(cfg)
        R, C = cfg.num_rel_labels, cfg.num_labels
        # frequency-bias tables, loaded from fg_matrix (egtr.py:169-194);
        # frozen by the optimizer's labels
        self.param("rel_dist", (R,), zeros)
        self.param("triplet_dist", (C + 1, C + 1, R), zeros)
        self.relation_head = EgtrHead(cfg)

    def forward(self, pixel_values: torch.Tensor,
                pixel_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """``generator`` feeds the dropout masks in ``train()`` mode."""
        cfg = self.config
        base_out = self.model(pixel_values, pixel_mask, generator)
        head_out = self.relation_head(
            base_out["attention_queries"], base_out["attention_keys"],
            base_out["last_hidden_state"], base_out["logits"],
            triplet_dist=self.triplet_dist if cfg.use_freq_bias else None)
        pred_rel_logits = head_out["pred_rel_logits"]
        if cfg.logit_adjustment:
            # post-hoc logit adjustment (egtr.py:507-512)
            pred_rel_logits = pred_rel_logits - cfg.logit_adj_tau * torch.log(
                self.rel_dist)
        return {
            **base_out,
            "pred_rel_logits": head_out["pred_rel_logits"],
            "pred_connectivity_logits": head_out["pred_connectivity_logits"],
            "pred_rel": pred_rel_logits.sigmoid(),
            "pred_connectivity": head_out["pred_connectivity_logits"].sigmoid(),
            "rel_gate_mean": head_out["rel_gate_mean"],
        }
