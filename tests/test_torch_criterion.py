"""The port's losses, matcher and criteria against the JAX package's, on the CPU.

Identical outputs and targets, drawn from a numpy seed, go through
``egtr_tpu.ops.{boxes,losses,matcher,criterion}`` and their ports. The JAX
criteria are jitted once per case. Random continuous costs have no ties, so
scipy's assignment (the port) and the in-jit Jonker-Volgenant solver (JAX)
must agree exactly. Tolerance: float32, the two sides differ in the order of
summation and in libm (log, exp, sigmoid): rtol 1e-5, atol 1e-6 on values of
order 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egtr_tpu.config import EgtrConfig as JaxConfig
from egtr_tpu.ops import boxes as jax_boxes
from egtr_tpu.ops import criterion as jax_criterion
from egtr_tpu.ops import losses as jax_losses
from egtr_tpu.ops import matcher as jax_matcher
from egtr_tpu_torch.config import EgtrConfig
from egtr_tpu_torch.ops import boxes, criterion, losses, matcher

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6

B, Q, C, R, G, LAYERS = 3, 12, 7, 5, 6, 3
CFG = dict(num_queries=Q, num_labels=C, num_rel_labels=R, decoder_layers=LAYERS,
           max_gt_boxes=G, max_gt_rels=4, auxiliary_loss=True)


def close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=kw.pop("rtol", RTOL),
                               atol=kw.pop("atol", ATOL), **kw)


def tj(tree):
    """numpy tree -> (torch tree, jax tree)."""
    if isinstance(tree, dict):
        pairs = {k: tj(v) for k, v in tree.items()}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    return torch.from_numpy(tree), jnp.asarray(tree)


def make_case(seed):
    rng = np.random.default_rng(seed)

    def boxes_(*shape):
        cxcy = rng.uniform(0.25, 0.75, shape + (2,))
        wh = rng.uniform(0.1, 0.4, shape + (2,))
        return np.concatenate([cxcy, wh], -1).astype(np.float32)

    outputs = {
        "logits": rng.standard_normal((B, Q, C)).astype(np.float32),
        "pred_boxes": boxes_(B, Q),
        "all_logits": rng.standard_normal((B, LAYERS, Q, C)).astype(np.float32),
        "all_pred_boxes": boxes_(B, LAYERS, Q),
        "pred_rel_logits": rng.standard_normal((B, Q, Q, R)).astype(np.float32),
        "pred_connectivity_logits": rng.standard_normal(
            (B, Q, Q, 1)).astype(np.float32),
    }
    num_boxes = np.array([4, 6, 0], np.int32)  # partly padded, full, empty
    rel = np.zeros((B, G, G, R), np.float32)
    rel[0, 0, 1, 1] = rel[0, 2, 3, 4] = rel[0, 1, 0, 2] = 1.0
    # six true entries: above max_gt_rels = 4, so the fixed-K cap binds
    for s, o, r in ((0, 1, 0), (1, 2, 1), (2, 3, 2), (3, 4, 3), (4, 5, 4),
                    (5, 0, 0)):
        rel[1, s, o, r] = 1.0
    targets = {
        "class_labels": rng.integers(0, C, (B, G)).astype(np.int32),
        "boxes": boxes_(B, G),
        "num_boxes": num_boxes,
        "rel": rel,
    }
    # pad slots as the data pipeline fills them
    for b in range(B):
        targets["boxes"][b, num_boxes[b]:] = (0.5, 0.5, 1.0, 1.0)
        targets["class_labels"][b, num_boxes[b]:] = 0
    return outputs, targets


def test_box_ops_match_jax():
    rng = np.random.default_rng(0)
    a = np.sort(rng.uniform(0, 1, (2, 5, 2, 2)), axis=2).transpose(
        0, 1, 3, 2).reshape(2, 5, 4).astype(np.float32)[..., [0, 2, 1, 3]]
    b = np.sort(rng.uniform(0, 1, (2, 4, 2, 2)), axis=2).transpose(
        0, 1, 3, 2).reshape(2, 4, 4).astype(np.float32)[..., [0, 2, 1, 3]]
    (ta, tb), (ja, jb) = zip(tj(a), tj(b))
    close(boxes.box_area(ta), jax_boxes.box_area(ja))
    iou, union = boxes.box_iou(ta, tb)
    jiou, junion = jax_boxes.box_iou(ja, jb)
    close(iou, jiou)
    close(union, junion)
    close(boxes.generalized_box_iou(ta, tb),
          jax_boxes.generalized_box_iou(ja, jb))
    assert boxes.generalized_box_iou(ta, tb).shape == (2, 5, 4)


def test_loss_primitives_match_jax():
    rng = np.random.default_rng(1)
    x = (4 * rng.standard_normal((3, 6, 5))).astype(np.float32)
    z = (rng.uniform(0, 1, (3, 6, 5)) > 0.7).astype(np.float32)
    (tx, tz), (jx, jz) = zip(tj(x), tj(z))
    close(losses.bce_with_logits(tx, tz), jax_losses.bce_with_logits(jx, jz))
    close(losses.bce_with_logits(tx, tz),
          torch.nn.functional.binary_cross_entropy_with_logits(
              tx, tz, reduction="none"))
    for alpha in (0.25, -1.0):
        close(losses.sigmoid_focal_loss_elementwise(tx, tz, alpha),
              jax_losses.sigmoid_focal_loss_elementwise(jx, jz, alpha))
    close(losses.sigmoid_focal_loss(tx, tz, 7.0),
          jax_losses.sigmoid_focal_loss(jx, jz, 7.0))
    close(losses.dice_loss(tx, tz, 7.0), jax_losses.dice_loss(jx, jz, 7.0))


@pytest.mark.parametrize("smoothing", [1e-14, 0.0])
def test_cost_matrix_and_matcher_match_jax(smoothing):
    """Same cost matrix (pad columns at _PAD_COST), then the same
    query_index, matching_cost and gt_index, pad slots included."""
    outputs, targets = make_case(2)
    (to, jo), (tt, jt) = tj(outputs), tj(targets)
    valid = np.arange(G)[None] < targets["num_boxes"][:, None]
    kw = dict(class_cost=2.0, bbox_cost=5.0, giou_cost=2.0,
              smoothing=smoothing)
    cost = matcher.compute_cost_matrix(
        to["logits"], to["pred_boxes"], tt["class_labels"], tt["boxes"],
        torch.from_numpy(valid), **kw)
    jcost = jax_matcher.compute_cost_matrix(
        jo["logits"], jo["pred_boxes"], jt["class_labels"], jt["boxes"],
        jnp.asarray(valid), **kw)
    assert cost.shape == (B, Q, G) and cost.dtype == torch.float32
    close(cost, jcost, rtol=1e-5, atol=1e-5)
    assert (cost[~torch.from_numpy(valid)[:, None, :].expand(B, Q, G)]
            == matcher._PAD_COST).all()

    # both solvers on the very same numbers
    res = matcher.hungarian_match(torch.from_numpy(np.array(jcost)),
                                  tt["num_boxes"])
    jres = jax_matcher.hungarian_match(jcost, jt["num_boxes"])
    np.testing.assert_array_equal(res.query_index.numpy(),
                                  np.asarray(jres.query_index))
    np.testing.assert_array_equal(res.gt_index.numpy(),
                                  np.asarray(jres.gt_index))
    assert (res.query_index.numpy()[~valid] == -1).all()
    close(res.matching_cost.numpy()[valid],
          np.asarray(jres.matching_cost)[valid], rtol=0, atol=0)


def test_matcher_is_optimal_and_refuses_too_many_targets():
    rng = np.random.default_rng(3)
    cost = torch.from_numpy(rng.uniform(0, 1, (1, 5, 3)).astype(np.float32))
    res = matcher.hungarian_match(cost, torch.tensor([3]))
    import itertools
    best = min(sum(cost[0, q, g].item() for g, q in enumerate(perm))
               for perm in itertools.permutations(range(5), 3))
    assert res.matching_cost.sum().item() == pytest.approx(best, rel=1e-6)
    with pytest.raises(ValueError, match="as many queries"):
        matcher.hungarian_match(cost.transpose(1, 2), torch.tensor([3]))


CRITERIA = {
    "sgg_train": ("sgg", True, False),
    "sgg_train_valid": ("sgg", True, True),
    "sgg_eval": ("sgg", False, False),
    "sgg_eval_valid": ("sgg", False, True),
    "detection": ("detection", None, False),
    "detection_valid": ("detection", None, True),
}


@pytest.mark.parametrize("case", sorted(CRITERIA))
def test_criterion_matches_jax(case):
    task, train, with_valid = CRITERIA[case]
    outputs, targets = make_case(4)
    (to, jo), (tt, jt) = tj(outputs), tj(targets)
    valid = np.array([True, True, False]) if with_valid else None
    tv = None if valid is None else torch.from_numpy(valid)
    jv = None if valid is None else jnp.asarray(valid)
    cfg, jcfg = EgtrConfig(**CFG), JaxConfig(**CFG)
    if task == "sgg":
        total, terms = criterion.sgg_criterion(to, tt, cfg, train, valid=tv)
        jtotal, jterms = jax.jit(
            lambda o, t, v: jax_criterion.sgg_criterion(
                o, t, jcfg, train, valid=v))(jo, jt, jv)
    else:
        total, terms = criterion.detection_criterion(to, tt, cfg, valid=tv)
        jtotal, jterms = jax.jit(
            lambda o, t, v: jax_criterion.detection_criterion(
                o, t, jcfg, valid=v))(jo, jt, jv)
    assert set(terms) == set(jterms)
    for k in sorted(jterms):
        close(terms[k], jterms[k], err_msg=k)
    close(total, jtotal)
    if task == "sgg" and train:
        # image 1 has 6 > max_gt_rels true entries
        assert float(terms["rel_sample_capped_frac"]) > 0


def test_valid_mask_equals_dropping_the_rows():
    """The masked loss over a padded batch is the loss over its real rows."""
    outputs, targets = make_case(5)
    to, tt = tj(outputs)[0], tj(targets)[0]
    cfg = EgtrConfig(**CFG)
    valid = torch.tensor([True, True, False])
    masked, terms = criterion.sgg_criterion(to, tt, cfg, False, valid=valid)
    real, rterms = criterion.sgg_criterion(
        {k: v[:2] for k, v in to.items()}, {k: v[:2] for k, v in tt.items()},
        cfg, False)
    close(masked, real)
    for k in rterms:
        close(terms[k], rterms[k], err_msg=k)


def test_criterion_gradient_matches_jax():
    """d total / d (logits, boxes, relation logits) on the training path:
    the top-k selection, the gathers at clamped -1 indices and the masks
    must route the same gradient."""
    outputs, targets = make_case(6)
    (to, jo), (tt, jt) = tj(outputs), tj(targets)
    cfg, jcfg = EgtrConfig(**CFG), JaxConfig(**CFG)
    leaves = {k: v.requires_grad_() for k, v in to.items()}
    total, _ = criterion.sgg_criterion(leaves, tt, cfg, True)
    grads = torch.autograd.grad(total, list(leaves.values()))
    jgrads = jax.jit(jax.grad(
        lambda o: jax_criterion.sgg_criterion(o, jt, jcfg, True)[0]))(jo)
    for k, g in zip(leaves, grads):
        close(g, jgrads[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_uniform_sampling_needs_a_generator():
    outputs, targets = make_case(7)
    to, tt = tj(outputs)[0], tj(targets)[0]
    # one sampled negative per true entry, so the draw matters
    cfg = EgtrConfig(**CFG, rel_sample_negatives=1,
                     rel_sample_negatives_largest=False)
    with pytest.raises(ValueError, match="generator is required"):
        criterion.sgg_criterion(to, tt, cfg, True)
    g = torch.Generator().manual_seed(0)
    a, _ = criterion.sgg_criterion(to, tt, cfg, True, generator=g)
    b, _ = criterion.sgg_criterion(to, tt, cfg, True,
                                   generator=torch.Generator().manual_seed(0))
    c, _ = criterion.sgg_criterion(to, tt, cfg, True, generator=g)
    assert torch.isfinite(a) and a == b and a != c


def test_approx_topk_is_refused():
    outputs, targets = make_case(8)
    to, tt = tj(outputs)[0], tj(targets)[0]
    cfg = EgtrConfig(**CFG, rel_sample_approx_topk=True)
    with pytest.raises(NotImplementedError, match="rel_sample_approx_topk"):
        criterion.sgg_criterion(to, tt, cfg, True)


def test_nonmatching_cost_matches_jax():
    assert criterion.nonmatching_cost(EgtrConfig()) == pytest.approx(
        jax_criterion.nonmatching_cost(JaxConfig()), rel=1e-12)
