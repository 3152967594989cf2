"""The port's assignment solver against the JAX package's, on the CPU.

``matcher.hungarian_match`` on CPU tensors runs the kernel's plain version
(``matcher.lsap_plain``), which follows the JAX package's in-jit
Jonker-Volgenant solver operation for operation: the same numpy-seeded costs
must give ``query_index``, ``matching_cost`` and ``gt_index`` equal bit for
bit, ties included. scipy's ``linear_sum_assignment`` is the oracle of the
total cost only (1e-6 relative): on ties it may pick another assignment of
the same cost. The kernel itself (``csrc/lsap.cu``) runs on the card only;
here its launch helper and input checks are tested in plain Python.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from egtr_tpu.ops import matcher as jax_matcher
from egtr_tpu_torch.ops import matcher, msda_cuda

torch.set_num_threads(1)


def both(cost: np.ndarray, num_boxes: np.ndarray):
    port = matcher.hungarian_match(torch.from_numpy(cost),
                                   torch.from_numpy(num_boxes))
    ref = jax_matcher.hungarian_match(jnp.asarray(cost),
                                      jnp.asarray(num_boxes))
    return port, ref


def assert_bit_equal(port, ref, num_boxes):
    np.testing.assert_array_equal(port.query_index.numpy(),
                                  np.asarray(ref.query_index))
    np.testing.assert_array_equal(port.gt_index.numpy(),
                                  np.asarray(ref.gt_index))
    # the costs' bits, pad slots included (both gather column 0 there)
    np.testing.assert_array_equal(
        port.matching_cost.numpy().view(np.int32),
        np.asarray(ref.matching_cost).view(np.int32))
    G = port.query_index.shape[1]
    pad = np.arange(G)[None] >= num_boxes[:, None]
    assert (port.query_index.numpy()[pad] == -1).all()


def assert_optimal(port, cost, num_boxes):
    for b, nb in enumerate(num_boxes):
        rows, cols = linear_sum_assignment(cost[b].T[:nb])
        best = float(cost[b].T[rows, cols].astype(np.float64).sum())
        got = port.query_index.numpy()[b, :nb]
        assert len(set(got.tolist())) == nb and (got >= 0).all()
        total = float(cost[b].T[np.arange(nb), got].astype(np.float64).sum())
        assert total == pytest.approx(best, rel=1e-6, abs=1e-9)
        # gt_index is the inverse map of the solved slots
        inv = np.full(cost.shape[1], -1)
        inv[got] = np.arange(nb)
        np.testing.assert_array_equal(port.gt_index.numpy()[b], inv)


@pytest.mark.parametrize("shape,seed", [
    ((4, 200, 64), 0),     # the one-stage training microbatch
    ((2, 300, 64), 1),     # two stages: Q 300
    ((3, 24, 24), 2),      # G = Q: every query takes a slot
    ((2, 3000, 16), 3),    # two stages' proposal matching: Q = S tokens
])
def test_random_costs_bit_equal_to_jax(shape, seed):
    B, Q, G = shape
    rng = np.random.default_rng(seed)
    cost = rng.standard_normal(shape).astype(np.float32) * 3.0
    num_boxes = rng.integers(1, G, B).astype(np.int32)
    num_boxes[0] = G            # nb = G
    num_boxes[-1] = 0           # nb = 0
    port, ref = both(cost, num_boxes)
    assert_bit_equal(port, ref, num_boxes)
    assert_optimal(port, cost, num_boxes)


def test_matching_costs_of_the_criterion_bit_equal_to_jax():
    """Costs as the criterion builds them (pad columns at _PAD_COST, the
    smoothing shift), at the training shape."""
    rng = np.random.default_rng(4)
    B, Q, G = 2, 200, 64
    num_boxes = np.array([17, 64], np.int32)
    cost = (rng.uniform(-2, 8, (B, Q, G)) + 18.4).astype(np.float32)
    cost[np.broadcast_to(np.arange(G)[None, None] >= num_boxes[:, None, None],
                         cost.shape)] = matcher._PAD_COST
    port, ref = both(cost, num_boxes)
    assert_bit_equal(port, ref, num_boxes)
    assert_optimal(port, cost, num_boxes)


@pytest.mark.parametrize("seed", [5, 6])
def test_ties_bit_equal_to_jax(seed):
    """Equal entries everywhere: integer costs from {0, 1, 2}, duplicate
    query rows and a column of one value."""
    rng = np.random.default_rng(seed)
    B, Q, G = 3, 40, 16
    cost = rng.integers(0, 3, (B, Q, G)).astype(np.float32)
    cost[:, 10] = cost[:, 3]         # duplicate queries
    cost[:, 20:24] = cost[:, 0:1]
    cost[:, :, 5] = 1.0              # a slot every query reaches alike
    num_boxes = np.array([16, 9, 1], np.int32)
    port, ref = both(cost, num_boxes)
    assert_bit_equal(port, ref, num_boxes)
    assert_optimal(port, cost, num_boxes)


def test_ties_follow_jax_where_scipy_differs():
    """A tied case where scipy picks another optimal assignment than the
    JAX solver: the port gives JAX's."""
    rng = np.random.default_rng(0)
    cost = rng.integers(0, 3, (2, 12, 6)).astype(np.float32)
    num_boxes = np.array([6, 4], np.int32)
    port, ref = both(cost, num_boxes)
    assert_bit_equal(port, ref, num_boxes)
    assert_optimal(port, cost, num_boxes)
    differs = False
    for b, nb in enumerate(num_boxes):
        _, cols = linear_sum_assignment(cost[b].T[:nb])
        differs |= not np.array_equal(cols, port.query_index.numpy()[b, :nb])
    assert differs


def test_all_pad_and_single_row():
    cost = np.random.default_rng(7).random((2, 5, 3)).astype(np.float32)
    num_boxes = np.array([0, 1], np.int32)
    port, ref = both(cost, num_boxes)
    assert_bit_equal(port, ref, num_boxes)
    assert (port.gt_index.numpy()[0] == -1).all()
    assert port.query_index.numpy()[1, 0] == cost[1, :, 0].argmin()


def test_plain_version_refuses_cuda_and_too_many_targets():
    cost = torch.zeros((1, 3, 4))
    with pytest.raises(ValueError, match="as many queries"):
        matcher.hungarian_match(cost, torch.tensor([2]))
    with pytest.raises(ValueError, match="as many queries"):
        matcher.lsap_plain(cost, torch.tensor([2]))
    meta = torch.zeros((1, 4, 3), device="meta")
    with pytest.raises(ValueError, match="CPU version"):
        matcher.lsap_plain(meta, torch.tensor([2]))


def test_launch_geometry():
    """One block an image; the query columns rounded up to whole warps, at
    most 1024 threads, each thread the fewest columns (a power of two) that
    cover Q: the two-stage proposal matching has Q = S."""
    assert msda_cuda.lsap_geometry(4, 200, 64) == (4, 224, 1)
    assert msda_cuda.lsap_geometry(2, 300, 64) == (2, 320, 1)
    assert msda_cuda.lsap_geometry(1, 32, 32) == (1, 32, 1)
    assert msda_cuda.lsap_geometry(3, 1, 0) == (3, 32, 1)
    assert msda_cuda.lsap_geometry(1, 1024, 64) == (1, 1024, 1)
    assert msda_cuda.lsap_geometry(1, 1025, 64) == (1, 1024, 2)
    # the training bucket's tokens (800x1344: S = 22,323)
    assert msda_cuda.lsap_geometry(2, 22323, 64) == (2, 1024, 32)
    for B, Q, G in ((1, 1000, 8), (2, 5000, 64), (1, 32768, 1024)):
        _, threads, cpt = msda_cuda.lsap_geometry(B, Q, G)
        assert threads % 32 == 0 and threads * cpt >= Q
        assert cpt == 1 or threads * cpt // 2 < Q
    with pytest.raises(ValueError, match="1..32768 queries"):
        msda_cuda.lsap_geometry(1, 32769, 64)
    with pytest.raises(ValueError, match="G <= Q"):
        msda_cuda.lsap_geometry(1, 8, 9)
    with pytest.raises(ValueError, match="G <= 1024"):
        msda_cuda.lsap_geometry(1, 4096, 1025)


def test_kernel_input_checks():
    cost = torch.zeros((2, 8, 4))
    nb = torch.zeros((2,), dtype=torch.int32)
    msda_cuda.check_inputs_lsap(cost, nb)
    with pytest.raises(TypeError, match="float32"):
        msda_cuda.check_inputs_lsap(cost.double(), nb)
    with pytest.raises(ValueError, match=r"\[B,Q,G\]"):
        msda_cuda.check_inputs_lsap(cost[0], nb)
    with pytest.raises(ValueError, match="as many queries"):
        msda_cuda.check_inputs_lsap(cost.transpose(1, 2).contiguous(), nb)
    with pytest.raises(TypeError, match="int32"):
        msda_cuda.check_inputs_lsap(cost, nb.long())
    with pytest.raises(ValueError, match=r"num_boxes must be \[2\]"):
        msda_cuda.check_inputs_lsap(cost, nb[:1])
    with pytest.raises(ValueError, match="contiguous"):
        msda_cuda.check_inputs_lsap(
            torch.zeros((2, 4, 8)).transpose(1, 2)[:, :, :4], nb)
    # the wrapper takes CUDA tensors on one card only
    with pytest.raises(ValueError, match="CUDA tensors"):
        msda_cuda.lsap(cost, nb)
