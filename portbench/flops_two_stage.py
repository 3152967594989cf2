"""Model FLOPs of two-stage, box-refined EGTR: ``flops.forward_flops``
(whose decoder, heads and relation head already read the decoder's Q from
``num_queries``, the proposals' count) plus the query init over the
encoder's S tokens, which the one-stage count has no part for:

- ``enc_output`` over S: 2 S E^2;
- the proposals' class head over S: 2 S E C;
- their box MLP over S: 2 S (2 E^2 + 4 E);
- ``pos_trans`` over Q: 2 Q (2E)^2.

The decoder's per-layer box heads, which refine the reference boxes, are
the heads ``forward_flops`` counts already (the refinement runs each layer's
head once more on the same hidden state: a copy of the same work, not
counted, as the count does not change with how the program computes the
work). The top-k, the sine embedding and the norms are not counted.
"""

from __future__ import annotations

from typing import Dict, Tuple

from . import flops


def proposal_flops(m: Dict, hw: Tuple[int, int]) -> int:
    """The query init's FLOPs of one image."""
    E, C, Q = m["d_model"], m["num_labels"], m["two_stage_num_proposals"]
    S = sum(h * w for h, w in flops.level_shapes(hw, m["num_feature_levels"]))
    return (2 * S * E * E + 2 * S * E * C + 2 * S * (2 * E * E + 4 * E)
            + 2 * Q * (2 * E) ** 2)


def forward_flops(m: Dict, hw: Tuple[int, int]) -> Dict[str, int]:
    """FLOPs of one image's forward by part, ``proposals`` among them."""
    return {**flops.forward_flops(m, hw), "proposals": proposal_flops(m, hw)}


def step_flops(m: Dict, hw: Tuple[int, int], images: int,
               train: bool) -> float:
    """Model FLOPs of ``images`` images: their forward, three times it in
    training (``flops.step_flops``'s rule)."""
    total = sum(forward_flops(m, hw).values()) * images
    return float(total * (3 if train else 1))
