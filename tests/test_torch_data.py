"""The port's data pipeline (egtr_tpu_torch.data, scripts.make_synth_vg)
against the JAX package's, on the CPU.

One synthetic Visual Genome directory, written by the port's generator,
feeds both packages; every array they produce must be equal: preprocessing
(train, with the same seeded generator, and eval), buckets, collate, the
dataset's annotations and statistics, and the loader's batches over two
epochs. The generator's files are byte-equal to the repo's
``scripts/make_synth_vg.py``'s for the same seed.
"""

import filecmp
import importlib.util
import threading
import time
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from egtr_tpu.data import transforms as jax_transforms
from egtr_tpu.data import visual_genome as jax_vg
from egtr_tpu.data.loader import Loader as JaxLoader
from egtr_tpu_torch.data import transforms, visual_genome
from egtr_tpu_torch.data.loader import Loader
from egtr_tpu_torch.scripts.make_synth_vg import make_synth_vg

REPO = Path(__file__).resolve().parents[1]
# the synthetic images' size: the DETR scales resize them to 480-800 rows
HW = (60, 100)


@pytest.fixture(scope="module")
def vg_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("synth_vg")
    make_synth_vg(str(out), n_train=6, n_val=3, n_test=2, height=HW[0],
                  width=HW[1], seed=0)
    return str(out)


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, path
    np.testing.assert_array_equal(a, b, err_msg=path)


def _assert_sample_equal(a, b):
    assert a.size == b.size and a.orig_size == b.orig_size
    assert a.image_id == b.image_id
    for field in ("image", "boxes", "class_labels", "rel"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(x, y, err_msg=field)


def test_generator_files_equal_the_repo_scripts(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "repo_make_synth_vg", REPO / "scripts" / "make_synth_vg.py")
    repo_gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(repo_gen)
    ours, theirs = tmp_path / "port", tmp_path / "repo"
    make_synth_vg(str(ours), 3, 2, 1, 48, 80, seed=5)
    (theirs / "images").mkdir(parents=True)
    rng = np.random.default_rng(5)
    rel = {"rel_categories": repo_gen.REL_NAMES}
    for split, n in (("train", 3), ("val", 2), ("test", 1)):
        rel[split] = repo_gen.make_split(str(theirs), split, n, 48, 80, rng)
    (theirs / "rel.json").write_text(__import__("json").dumps(rel))
    names = sorted(p.relative_to(ours).as_posix() for p in ours.rglob("*")
                   if p.is_file())
    assert names == sorted(p.relative_to(theirs).as_posix()
                           for p in theirs.rglob("*") if p.is_file())
    assert len(names) == 3 + 2 + 1 + 4
    match, mismatch, errors = filecmp.cmpfiles(ours, theirs, names,
                                               shallow=False)
    assert mismatch == [] and errors == [] and len(match) == len(names)


def test_size_with_aspect_ratio_matches_jax():
    for w in (1, 60, 100, 333, 640, 1000, 1024):
        for h in (1, 60, 100, 300, 480, 768):
            for size, max_size in ((800, 1333), (600, 1000), (480, None)):
                assert transforms.size_with_aspect_ratio(
                    w, h, size, max_size) == \
                    jax_transforms.size_with_aspect_ratio(w, h, size,
                                                          max_size)


@pytest.mark.parametrize("use_crop", [False, True])
def test_preprocess_matches_jax(vg_dir, use_crop):
    """Train (hflip, the two resize branches, the crop) from generators of
    the same seed, and eval, sample by sample."""
    ours = visual_genome.VGDataset(vg_dir, "train")
    for image_id in ours.ids:
        info = ours._img_by_id[image_id]
        img = Image.open(f"{vg_dir}/images/{info['file_name']}").convert("RGB")
        boxes, labels, rel = ours.raw_annotations(image_id)
        for seed in range(4):
            kw = dict(train=True, use_crop=use_crop, image_id=image_id,
                      max_size=1333)
            got = transforms.preprocess(img, boxes, labels, rel,
                                        rng=np.random.default_rng(seed), **kw)
            ref = jax_transforms.preprocess(img, boxes, labels, rel,
                                            rng=np.random.default_rng(seed),
                                            **kw)
            _assert_sample_equal(got, ref)
        kw = dict(train=False, size=800, max_size=1333, image_id=image_id)
        _assert_sample_equal(transforms.preprocess(img, boxes, labels, rel,
                                                   **kw),
                             jax_transforms.preprocess(img, boxes, labels, rel,
                                                       **kw))
    with pytest.raises(ValueError, match="rng"):
        transforms.preprocess(img, boxes, labels, rel, train=True)


def test_buckets_and_collate_match_jax(vg_dir):
    for max_size in (1000, 1333):
        assert transforms.default_buckets(max_size) == \
            jax_transforms.default_buckets(max_size)
    buckets = transforms.default_buckets()
    for h, w in ((480, 800), (768, 1280), (800, 1333), (1333, 800),
                 (1100, 1100), (600, 1344)):
        assert transforms.pick_bucket(h, w, buckets) == \
            jax_transforms.pick_bucket(h, w, buckets)
    with pytest.raises(ValueError, match="no bucket"):
        transforms.pick_bucket(1400, 100, buckets)
    ds = visual_genome.VGDataset(vg_dir, "train", train_aug=True, seed=3)
    jds = jax_vg.VGDataset(vg_dir, "train", train_aug=True, seed=3)
    samples = [ds[i] for i in range(4)]
    jsamples = [jds[i] for i in range(4)]
    bucket = transforms.pick_bucket(max(s.image.shape[0] for s in samples),
                                    max(s.image.shape[1] for s in samples),
                                    buckets)
    # max_gt below the boxes of some images: the cut and its relations
    for max_gt in (2, 16):
        _assert_tree_equal(
            transforms.collate(samples, bucket, max_gt, 4),
            jax_transforms.collate(jsamples, bucket, max_gt, 4))
    with pytest.raises(ValueError, match="exceeds bucket"):
        transforms.collate(samples, (8, 8), 4, 4)


def test_dataset_and_statistics_match_jax(vg_dir):
    for split in ("train", "val", "test"):
        ours = visual_genome.VGDataset(vg_dir, split)
        ref = jax_vg.VGDataset(vg_dir, split)
        assert ours.ids == ref.ids and len(ours) == len(ref)
        assert ours.num_classes() == ref.num_classes() == 6
        assert ours.rel_categories == ref.rel_categories
        assert ours.categories == ref.categories
        for i, image_id in enumerate(ours.ids):
            for a, b in zip(ours.raw_annotations(image_id),
                            ref.raw_annotations(image_id)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            assert ours.nominal_size(i) == ref.nominal_size(i)
            _assert_sample_equal(ours[i], ref[i])
        fg = visual_genome.vg_get_statistics(ours)
        np.testing.assert_array_equal(fg, jax_vg.vg_get_statistics(ref))
        assert fg.dtype == np.int64 and fg.shape == (7, 7, 4)
    assert fg.sum() > 0
    train = visual_genome.VGDataset(vg_dir, "train", train_aug=True)
    assert train.train_aug and visual_genome.VGDataset(
        vg_dir, "val", train_aug=True).train_aug is False
    assert train.nominal_size(0) == transforms.size_with_aspect_ratio(
        HW[1], HW[0], 800, 1333)
    assert len(visual_genome.VGDataset(vg_dir, "train", debug=True)) == 6


@pytest.mark.parametrize("split,kw", [
    ("train", dict(batch_size=4, shuffle=True, drop_last=True)),
    ("val", dict(batch_size=2, shuffle=False)),
    ("train", dict(batch_size=4, shuffle=True, process_index=1,
                   process_count=2)),
], ids=["train", "val_padded_tail", "train_second_of_two_processes"])
def test_loader_batches_match_jax(vg_dir, split, kw):
    """Two epochs with one worker: the same batches, in order, from both
    packages (the shuffle of each epoch, the augmentation draws, the
    padded tail with ``valid``, a process's slice and its agreed bucket)."""
    loaders = []
    for vg, loader_cls in ((visual_genome, Loader), (jax_vg, JaxLoader)):
        ds = vg.VGDataset(vg_dir, split, train_aug=True, seed=7)
        loaders.append(loader_cls(ds, max_gt=8, num_rel_labels=4, seed=11,
                                  num_workers=1, **kw))
    ours, ref = loaders
    assert len(ours) == len(ref) and ours.init_shape == ref.init_shape
    _assert_tree_equal(ours.dummy_batch(), ref.dummy_batch())
    n = 0
    for _ in range(2):
        batches = list(ours)
        jbatches = list(ref)
        assert len(batches) == len(jbatches) > 0
        for a, b in zip(batches, jbatches):
            _assert_tree_equal(a, b)
            n += 1
    if split == "val":
        assert batches[-1]["valid"].tolist() == [True, False]
    assert n == 2 * len(ours)


def test_loader_fits_a_sample_to_an_agreed_bucket_as_jax(vg_dir):
    """A decoded sample larger than a pinned bucket is downscaled the same
    way (PIL on float planes) by both packages."""
    kw = dict(batch_size=2, shuffle=False, max_gt=8, num_rel_labels=4,
              prefetch=0, fixed_bucket=(400, 640))
    ours = Loader(visual_genome.VGDataset(vg_dir, "val"), **kw)
    ref = JaxLoader(jax_vg.VGDataset(vg_dir, "val"), **kw)
    with pytest.warns(UserWarning, match="downscaled"):
        got = list(ours)
    with pytest.warns(UserWarning, match="downscaled"):
        want = list(ref)
    for a, b in zip(got, want):
        _assert_tree_equal(a, b)
    # three images and the pad row that repeats the last
    assert ours._clamped == ref._clamped == 4


def test_loader_surfaces_worker_errors(vg_dir):
    class Broken(visual_genome.VGDataset):
        def __getitem__(self, idx):
            if idx == 1:
                raise KeyError("broken sample")
            return super().__getitem__(idx)

    loader = Loader(Broken(vg_dir, "val"), 1, shuffle=False, max_gt=8,
                    num_rel_labels=4, num_workers=2)
    with pytest.raises(KeyError, match="broken sample"):
        list(loader)
    with pytest.raises(ValueError, match="divide evenly"):
        Loader(Broken(vg_dir, "val"), 3, shuffle=False, max_gt=8,
               num_rel_labels=4, process_count=2)


def test_shared_augmentation_generator_depends_on_thread_timing(vg_dir):
    """The dataset's one generator serves every worker thread, as in the JAX
    package (visual_genome.py:34,100 with loader.py:227-235): with two
    workers, which batch draws first decides its augmentation. Here the
    first batch's decode is held back until the second batch has drawn, and
    the first batch then differs from a one-worker run's."""
    second_drew = threading.Event()

    class Slow(visual_genome.VGDataset):
        def __getitem__(self, idx):
            if idx in (0, 1):
                second_drew.wait(timeout=20)
            sample = super().__getitem__(idx)
            if idx == 2:
                second_drew.set()
            return sample

    def first_batch(num_workers, cls):
        ds = cls(vg_dir, "train", train_aug=True, seed=1)
        loader = Loader(ds, 2, shuffle=False, max_gt=8, num_rel_labels=4,
                        num_workers=num_workers)
        return list(loader)[0]

    one = first_batch(1, visual_genome.VGDataset)
    t0 = time.perf_counter()
    two = first_batch(2, Slow)
    assert time.perf_counter() - t0 < 20 and second_drew.is_set()
    differs = (one["pixel_values"].shape != two["pixel_values"].shape
               or not np.array_equal(one["pixel_values"],
                                     two["pixel_values"]))
    assert differs
