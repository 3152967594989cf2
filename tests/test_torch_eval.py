"""The port's evaluators (egtr_tpu_torch.evaluation) against the JAX
package's, on the CPU: the same seeded predictions give the same metrics,
and merging two evaluators' states refuses repeated image ids."""

import numpy as np
import pytest

from egtr_tpu.evaluation import coco_map as jax_coco_map
from egtr_tpu.evaluation import postprocess as jax_post
from egtr_tpu.evaluation import sg_eval as jax_sg
from egtr_tpu.evaluation.coco_eval import CocoEvaluator as JaxCocoEvaluator
from egtr_tpu_torch.evaluation import coco_map, postprocess, sg_eval
from egtr_tpu_torch.evaluation.coco_eval import CocoEvaluator

N_CLASSES, N_PRED, Q = 6, 5, 12
PREDICATES = [f"p{i}" for i in range(N_PRED)]


def scene(rng, image_id):
    """One image: ground truth and a noisy top-k prediction of it, in the
    evaluators' entry layout (absolute xyxy boxes)."""
    n = int(rng.integers(2, 6))
    xy = rng.uniform(0, 300, (n, 2))
    wh = rng.uniform(20, 120, (n, 2))
    gt_boxes = np.concatenate([xy, xy + wh], 1)
    gt_classes = rng.integers(0, N_CLASSES, n)
    pairs = [(s, o) for s in range(n) for o in range(n) if s != o]
    pick = rng.choice(len(pairs), size=min(len(pairs), int(rng.integers(1, 5))),
                      replace=False)
    gt_rels = np.array([[*pairs[i], rng.integers(0, N_PRED)] for i in pick])
    # predictions: the gt boxes jittered (some beyond IoU 0.5) and extras
    pred_boxes = np.concatenate([
        gt_boxes + rng.normal(0, 12, gt_boxes.shape),
        rng.uniform(0, 400, (Q - n, 4))], 0)
    pred_boxes[:, 2:] = np.maximum(pred_boxes[:, 2:], pred_boxes[:, :2] + 1)
    pred_classes = np.concatenate([
        np.where(rng.random(n) < 0.8, gt_classes,
                 rng.integers(0, N_CLASSES, n)),
        rng.integers(0, N_CLASSES, Q - n)])
    k = 30
    single_inds = np.stack([rng.integers(0, Q, k), rng.integers(0, Q, k)], 1)
    single_inds[:len(gt_rels)] = gt_rels[:, :2]
    rel_vec = rng.random((k, N_PRED))
    hit = rng.random(len(gt_rels)) < 0.7
    rel_vec[np.arange(len(gt_rels))[hit], gt_rels[hit, 2]] += 1.0
    mult_inds = np.concatenate([single_inds, rng.integers(0, N_PRED, (k, 1))],
                               1)
    mult_inds[:len(gt_rels), 2] = np.where(rng.random(len(gt_rels)) < 0.7,
                                           gt_rels[:, 2], mult_inds[
                                               :len(gt_rels), 2])
    gt = {"gt_relations": gt_rels, "gt_boxes": gt_boxes,
          "gt_classes": gt_classes}
    base = {"pred_boxes": pred_boxes, "pred_classes": pred_classes,
            "obj_scores": rng.random(Q)}
    single = dict(base, pred_rel_inds=single_inds, rel_scores=rel_vec)
    multiple = dict(base, pred_rel_inds=mult_inds,
                    rel_scores=rng.random(k))
    return image_id, gt, single, multiple


def scenes(seed, n=12):
    rng = np.random.default_rng(seed)
    return [scene(rng, 100 + i) for i in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scene_graph_recall_and_mean_recall_match_jax(seed):
    for multiple_preds in (False, True):
        ours = sg_eval.SceneGraphEvaluator(multiple_preds=multiple_preds)
        ref = jax_sg.SceneGraphEvaluator(multiple_preds=multiple_preds)
        per_ours = {p: sg_eval.SceneGraphEvaluator(multiple_preds)
                    for p in PREDICATES}
        per_ref = {p: jax_sg.SceneGraphEvaluator(multiple_preds)
                   for p in PREDICATES}
        for image_id, gt, single, mult in scenes(seed):
            entry = mult if multiple_preds else single
            ours.evaluate_entry(gt, entry, image_id=image_id)
            ref.evaluate_entry(gt, entry)
            sg_eval.evaluate_per_predicate(gt, entry, per_ours, PREDICATES,
                                           image_id=image_id)
            jax_sg.evaluate_per_predicate(gt, entry, per_ref, PREDICATES)
        got, want = ours.aggregate(), ref.aggregate()
        assert got == want and 0.0 < got["R@100"] <= 1.0
        assert ours.recalls == ref.recalls
        mr = sg_eval.evaluate_mean_recall(
            {p: e.aggregate() for p, e in per_ours.items()}, N_PRED)
        assert mr == jax_sg.evaluate_mean_recall(
            {p: e.aggregate() for p, e in per_ref.items()}, N_PRED)
        assert set(mr) == {"mR@20", "mR@50", "mR@100"}


def test_matching_helpers_match_jax():
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 50, (7, 4))
    a[:, 2:] += a[:, :2]
    b = rng.uniform(0, 50, (5, 4))
    b[:, 2:] += b[:, :2]
    np.testing.assert_array_equal(sg_eval.bbox_overlaps_plus1(a, b),
                                  jax_sg.bbox_overlaps_plus1(a, b))
    x1, x2 = rng.integers(0, 3, (9, 3)), rng.integers(0, 3, (6, 3))
    np.testing.assert_array_equal(sg_eval.intersect_2d(x1, x2),
                                  jax_sg.intersect_2d(x1, x2))
    with pytest.raises(ValueError, match="same #columns"):
        sg_eval.intersect_2d(x1, x2[:, :2])
    scores = rng.random((4, 3, 2))
    np.testing.assert_array_equal(sg_eval.argsort_desc(scores),
                                  jax_sg.argsort_desc(scores))
    for image_id, gt, single, mult in scenes(4, n=4):
        rels = np.column_stack((single["pred_rel_inds"],
                                single["rel_scores"].argmax(1)))
        for phrdet in (False, True):
            args = (gt["gt_relations"], gt["gt_boxes"], gt["gt_classes"],
                    rels, mult["pred_boxes"], mult["pred_classes"], 0.5,
                    phrdet)
            assert sg_eval.evaluate_recall(*args) == \
                jax_sg.evaluate_recall(*args)
    boxes = rng.uniform(0, 1, (8, 4))
    np.testing.assert_array_equal(
        postprocess.rescale_boxes_np(boxes, (480, 640)),
        jax_post.rescale_boxes_np(boxes, (480, 640)))


def coco_images(seed, n=15):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        g = int(rng.integers(0, 5))
        xy = rng.uniform(0, 400, (g, 2))
        gt = np.concatenate([xy, xy + rng.uniform(5, 200, (g, 2))], 1)
        gl = rng.integers(1, 4, g)
        d = int(rng.integers(0, 8))
        det = np.concatenate([gt + rng.normal(0, 8, gt.shape),
                              rng.uniform(0, 500, (max(d - g, 0), 4))], 0)[:d]
        det[:, 2:] = np.maximum(det[:, 2:], det[:, :2] + 1)
        dl = np.concatenate([gl, rng.integers(1, 4, max(d - g, 0))])[:d]
        out.append((7 + i, gt, gl, det, rng.random(len(det)), dl))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_coco_map_matches_jax(seed):
    ours, ref = CocoEvaluator([1, 2, 3]), JaxCocoEvaluator([1, 2, 3])
    for args in coco_images(seed):
        ours.update(*args)
        ref.update(*args)
    got, want = ours.summarize(), ref.summarize()
    assert got == want and got["AP"] > 0.0
    assert set(got) == {"AP", "AP50", "AP75", "APs", "APm", "APl", "AR@1",
                        "AR@10", "AR@100", "ARs@100", "ARm@100", "ARl@100"}


def test_merged_states_equal_one_evaluator_and_refuse_repeats():
    """Two evaluators over disjoint halves merge into the one-evaluator
    result; a state that repeats an image id is refused (it would count the
    image twice)."""
    sc = scenes(5)
    whole, parts = sg_eval.SceneGraphEvaluator(), [
        sg_eval.SceneGraphEvaluator(), sg_eval.SceneGraphEvaluator()]
    for i, (image_id, gt, single, _) in enumerate(sc):
        whole.evaluate_entry(gt, single, image_id=image_id)
        parts[i % 2].evaluate_entry(gt, single, image_id=image_id)
    before = parts[0].state()
    parts[0].merge_state(parts[1].state())
    assert sorted(parts[0].recalls[100]) == sorted(whole.recalls[100])
    assert parts[0].aggregate() == pytest.approx(whole.aggregate(), rel=1e-12)
    with pytest.raises(ValueError, match="repeats image ids"):
        parts[0].merge_state(parts[1].state())
    assert before["image_ids"] is parts[0].image_ids

    imgs = coco_images(2)
    whole_c, halves = coco_map.CocoMAP([1, 2, 3]), [
        coco_map.CocoMAP([1, 2, 3]), coco_map.CocoMAP([1, 2, 3])]
    for i, (image_id, gt, gl, det, ds, dl) in enumerate(imgs):
        for m in (whole_c, halves[i % 2]):
            m.add_image(image_id, dict(boxes=gt, labels=gl),
                        dict(boxes=det, scores=ds, labels=dl))
    halves[0].merge_state(halves[1].state())
    assert halves[0].accumulate() == whole_c.accumulate()
    with pytest.raises(ValueError, match="repeats image ids"):
        halves[0].merge_state(halves[1].state())
    ev = CocoEvaluator([1, 2, 3])
    ev.update(*imgs[0])
    with pytest.raises(ValueError, match="repeats image ids"):
        ev.merge_state(ev.state())
    # the JAX package merges repeated ids silently (coco_map.py:89)
    jax_map = jax_coco_map.CocoMAP([1, 2, 3])
    jax_map.merge_state(halves[1].state())
    jax_map.merge_state(halves[1].state())
