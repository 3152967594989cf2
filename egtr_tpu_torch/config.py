"""Model / loss configuration for the PyTorch port of EGTR.

The port's own copy of ``egtr_tpu/config.py``: the same fields, defaults,
validation and JSON round-trip, so one ``config.json`` means the same thing
to both packages. Mirrors the hyperparameter surface of the reference
``DeformableDetrConfig`` (reference: model/deformable_detr.py:72-267) plus the
EGTR fields the reference attaches at runtime (train_egtr.py:230-252).

Every field is ported, forward and backward. ``rel_sample_approx_topk``
selects ``jax.lax.approx_max_k`` in the JAX package (about 95% recall on the
TPU); the port takes the exact ``torch.topk`` for it, which is what
``approx_max_k`` returns on the CPU.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class EgtrConfig:
    # --- architecture (deformable_detr.py:141-180 defaults) ---
    num_queries: int = 300
    encoder_layers: int = 6
    encoder_ffn_dim: int = 1024
    encoder_attention_heads: int = 8
    decoder_layers: int = 6
    decoder_ffn_dim: int = 1024
    decoder_attention_heads: int = 8
    d_model: int = 256
    dropout: float = 0.1
    attention_dropout: float = 0.0
    activation_dropout: float = 0.0
    activation_function: str = "relu"
    position_embedding_type: str = "sine"
    # timm model name in the reference (deformable_detr.py:748-756); here
    # the supported family is the hand-built frozen-BN ResNet trunk
    # (models/backbone.py) at either depth. Unknown names are rejected in
    # __post_init__ rather than silently falling back to resnet50.
    backbone: str = "resnet50"
    dilation: bool = False
    num_feature_levels: int = 4
    encoder_n_points: int = 4
    decoder_n_points: int = 4
    two_stage: bool = False
    two_stage_num_proposals: int = 300
    with_box_refine: bool = False
    auxiliary_loss: bool = False
    init_std: float = 0.02
    init_xavier_std: float = 1.0

    # --- detection loss / matcher (deformable_detr.py:171-180) ---
    class_cost: float = 1.0
    bbox_cost: float = 5.0
    giou_cost: float = 2.0
    bbox_loss_coefficient: float = 5.0
    giou_loss_coefficient: float = 2.0
    eos_coefficient: float = 0.1
    focal_alpha: float = 0.25

    # --- label spaces ---
    num_labels: int = 150          # VG: 150 object classes
    num_rel_labels: int = 50       # VG: 50 predicate classes

    # --- EGTR additions (train_egtr.py:230-252) ---
    ce_loss_coefficient: float = 2.0
    rel_loss_coefficient: float = 15.0
    connectivity_loss_coefficient: float = 30.0
    smoothing: float = 1e-14
    rel_sample_negatives: Optional[int] = 80
    rel_sample_nonmatching: Optional[int] = 80
    rel_sample_negatives_largest: bool = True
    rel_sample_nonmatching_largest: bool = True
    # Opt-in TPU-native approximate top-k for the hard-negative sampling
    # (jax.lax.approx_max_k, ~95% recall): the exact top-k's full sort of
    # the Q*Q*R candidate scores is ~6% of the exact full-res train step
    # and ~12% of the windowed one. Off by default (reference parity).
    rel_sample_approx_topk: bool = False
    use_freq_bias: bool = True
    use_log_softmax: bool = False
    freq_bias_eps: float = 1e-12
    logit_adjustment: bool = False
    logit_adj_tau: float = 0.3

    # --- TPU-native additions (no reference equivalent) ---
    # Padded number of ground-truth boxes per image; targets are padded/masked
    # to this static size so the whole loss jit-compiles once.
    max_gt_boxes: int = 64
    # Padded number of ground-truth relation triples per image.
    max_gt_rels: int = 192
    # Compute dtype for matmul-heavy paths ("bfloat16" or "float32").
    compute_dtype: str = "float32"
    # Rematerialize encoder/decoder layers in the backward pass (trades
    # recompute for activation memory; jax.checkpoint). Recommended for
    # training at full resolution.
    use_remat: bool = False
    # Remat selectivity when use_remat is on: "full" recomputes the whole
    # layer; "dots" saves MXU outputs (dot_general without batch dims) and
    # the MSDA kernel output (tagged via checkpoint_name) and recomputes
    # only the elementwise chains — near-noremat speed at a fraction of
    # the activation memory.
    remat_policy: str = "full"
    # Deformable-attention sampling implementation: "auto" | "pallas" |
    # "matmul" | "gather". All three are exact grid_sample semantics;
    # "pallas" is the fused MXU kernel (TPU only), "matmul" the XLA
    # separable-hat path, "gather" the round-1 patch-gather. "auto" picks
    # pallas on TPU and matmul elsewhere. See egtr_tpu/ops/msda.py.
    msda_impl: str = "auto"
    # Opt-in banded MSDA approximation for the ENCODER self-attention
    # (decoder queries are not raster-local): levels taller than this
    # window clamp each query tile's sample y to a runtime-selected band
    # of this height, shrinking the kernel's streamed rows from h*D to
    # window*D. 0 = exact. Accuracy caveat: in-image samples offset more
    # than ~window/2 rows from a tile's weighted-mean row are clamped to
    # the band edge (ops/msda_window.py). Typical values: 16 or 32.
    msda_window: int = 0
    # Band-selection granularity for the windowed approximation:
    # "tile" = one runtime band per query tile (all P sampling points
    # clamp into it); "point" = one band per (tile, point) — invariant
    # to each point's mean offset, so trained offsets of any magnitude
    # stay exact as long as nearby queries deform coherently (only the
    # within-tile spread of one point's samples can clamp). Same MXU
    # cost; 2P half-band fetches per tile instead of 2.
    msda_band: str = "tile"
    # Opt-in int8 stage-1 for the pallas MSDA kernel: values quantized
    # symmetrically per (batch, head, level), hat vectors rounded to 7
    # bits, stage-1 dot in the MXU's double-rate int8 mode. Gradients
    # stay exact-bf16 (straight-through). Composes with msda_window.
    msda_int8: bool = False

    def __post_init__(self):
        # Enum-ish string fields are consumed by `==`/`in` checks at use
        # sites (detr.py checks `remat_policy == "dots"`), so a typo'd
        # value (e.g. from a hand-edited config.json) would silently
        # select the default behavior. Reject unknown values up front.
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(
                f"remat_policy must be 'full' or 'dots', got "
                f"{self.remat_policy!r}")
        if self.msda_impl not in ("auto", "pallas", "matmul", "gather"):
            raise ValueError(
                f"msda_impl must be one of auto/pallas/matmul/gather, got "
                f"{self.msda_impl!r}")
        if self.position_embedding_type not in ("sine", "learned"):
            raise ValueError(
                f"position_embedding_type must be 'sine' or 'learned', got "
                f"{self.position_embedding_type!r}")
        if self.msda_window < 0 or self.msda_window % 2:
            raise ValueError(
                "msda_window must be 0 (exact) or a positive even band "
                f"height (band = 2 half-band blocks), got "
                f"{self.msda_window}")
        if self.msda_band not in ("tile", "point"):
            raise ValueError(
                f"msda_band must be 'tile' or 'point', got "
                f"{self.msda_band!r}")
        if self.activation_function not in ("relu", "gelu", "silu"):
            raise ValueError(
                f"activation_function must be one of relu/gelu/silu, got "
                f"{self.activation_function!r}")
        if self.backbone not in _BACKBONE_BLOCKS:
            raise ValueError(
                f"backbone must be one of "
                f"{sorted(_BACKBONE_BLOCKS)}, got {self.backbone!r}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.decoder_attention_heads

    @property
    def backbone_blocks(self) -> Tuple[int, int, int, int]:
        """Bottleneck block counts per stage for ``backbone``."""
        return _BACKBONE_BLOCKS[self.backbone]

    def replace(self, **kw) -> "EgtrConfig":
        return dataclasses.replace(self, **kw)

    # --- (de)serialization so configs round-trip like HF save_pretrained
    #     (reference: pretrain_detr.py:490, evaluate_egtr.py:225-227) ---
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "EgtrConfig":
        """Tolerant load: unknown keys are dropped, so this reads both our
        own config.json and the reference's HF-format config.json (the
        architecture field names match by construction). HF configs often
        carry the label space as ``id2label`` instead of ``num_labels``."""
        d = json.loads(s)
        if "num_labels" not in d and isinstance(d.get("id2label"), dict):
            d["num_labels"] = len(d["id2label"])
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "EgtrConfig":
        with open(path) as f:
            return cls.from_json(f.read())


# Supported backbone trunks -> bottleneck block counts per stage. Both are
# the torchvision/timm ResNet v1.5 family, so checkpoints convert with the
# same key map and the C3/C4/C5 channel counts are identical.
_BACKBONE_BLOCKS = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
}

# Feature-level channel counts of the ResNet C3/C4/C5 outputs consumed by the
# input projections (reference: deformable_detr.py:1988-2026).
RESNET50_STAGE_CHANNELS: Tuple[int, int, int] = (512, 1024, 2048)
