"""The port's transform library (``egtr_tpu_torch/data/transform_lib.py``)
against the JAX package's (``egtr_tpu/data/transform_lib.py``): every
transform on the same PIL image and target, its random draws from a
generator of the same seed; the images (or arrays) and every target entry
bit-equal, and the generators left in the same state."""

import numpy as np
import pytest
from PIL import Image

from egtr_tpu.data import transform_lib as J
from egtr_tpu_torch.data import transform_lib as T


def make_img(h=60, w=80):
    rng = np.random.default_rng(0)
    return Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


def make_target():
    return {
        "boxes": np.array([[10, 10, 30, 30], [50, 20, 70, 50],
                           [5, 40, 75, 58]], np.float32),
        "labels": np.array([1, 2, 3]),
        "rel": np.array([[0, 1, 3], [2, 1, 0]], np.int32),
        "size": (60, 80),
    }


# each case: transform module -> generator -> (image, target) -> output;
# the array cases start from ToArray's output
CASES = {
    "crop": lambda M, g, i, t: M.crop(i, t, (15, 40, 40, 40)),
    "hflip": lambda M, g, i, t: M.hflip(i, t),
    "resize": lambda M, g, i, t: M.resize(i, t, 45, max_size=70),
    "pad": lambda M, g, i, t: M.pad(i, t, (7, 3)),
    "Compose": lambda M, g, i, t: M.Compose([
        M.RandomHorizontalFlip(g, p=1.0), M.CenterCrop((40, 50)),
        M.ToArray(), M.Normalize()])(i, t),
    "RandomCrop": lambda M, g, i, t: M.RandomCrop((30, 40), g)(i, t),
    "RandomSizeCrop": lambda M, g, i, t: M.RandomSizeCrop(20, 50, g)(i, t),
    "CenterCrop": lambda M, g, i, t: M.CenterCrop((41, 57))(i, t),
    "RandomHorizontalFlip": lambda M, g, i, t: M.Compose(
        [M.RandomHorizontalFlip(g)] * 5)(i, t),
    "RandomResize": lambda M, g, i, t: M.RandomResize(
        [32, 48, 64], g, max_size=90)(i, t),
    "RandomPad": lambda M, g, i, t: M.RandomPad(9, g)(i, t),
    "RandomSelect": lambda M, g, i, t: M.Compose([M.RandomSelect(
        M.RandomCrop((30, 30), g), M.RandomResize([40], g), g)] * 3)(i, t),
    "ToArray": lambda M, g, i, t: M.ToArray()(i, t),
    "RandomErasing": lambda M, g, i, t: M.Compose(
        [M.ToArray(), M.RandomErasing(g, p=1.0)])(i, t),
    "Normalize": lambda M, g, i, t: M.Compose(
        [M.ToArray(), M.Normalize()])(i, t),
}


def _same(a, b, what):
    if isinstance(a, Image.Image):
        assert a.mode == b.mode and a.size == b.size, what
        a, b = np.asarray(a), np.asarray(b)
    if isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


@pytest.mark.parametrize("name", sorted(CASES))
def test_transform_matches_jax(name):
    outs, gens = {}, {}
    for side, M in (("port", T), ("jax", J)):
        gens[side] = np.random.default_rng(3)
        outs[side] = CASES[name](M, gens[side], make_img(), make_target())
    (img, tgt), (ref_img, ref_tgt) = outs["port"], outs["jax"]
    _same(img, ref_img, "image")
    assert sorted(tgt) == sorted(ref_tgt)
    for key in ref_tgt:
        _same(tgt[key], ref_tgt[key], key)
    assert gens["port"].random() == gens["jax"].random()


def test_transforms_pass_no_target():
    """Without a target every primitive returns None for it, as JAX's."""
    for side in (T, J):
        for fn in (lambda M: M.crop(make_img(), None, (0, 0, 10, 10)),
                   lambda M: M.hflip(make_img(), None),
                   lambda M: M.resize(make_img(), None, 30),
                   lambda M: M.pad(make_img(), None, (2, 2))):
            assert fn(side)[1] is None
