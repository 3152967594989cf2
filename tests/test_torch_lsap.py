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


# (B, Q, G) -> (route, cluster, columns a thread, cost rows in shared
# memory): the criterion's shapes (Q 200 one stage, 300 two stages, Q = S
# = 22,323 the two-stage proposal matching at 800x1344), the warp route's
# largest Q at G 64, and shapes past it
GEOMETRY = [
    ((4, 200, 64), ("warp", 1, 7, 64)),
    ((2, 300, 64), ("warp", 1, 10, 64)),
    ((1, 32, 32), ("warp", 1, 1, 32)),
    ((3, 1, 0), ("warp", 1, 1, 0)),
    ((2, 37, 37), ("warp", 1, 2, 37)),
    ((1, 866, 64), ("warp", 1, 28, 64)),
    ((1, 867, 64), ("warp", 1, 28, 64)),
    ((1, 1025, 64), ("cluster", 2, 3, 64)),
    ((1, 3000, 16), ("cluster", 1, 12, 16)),
    ((1, 5000, 16), ("cluster", 2, 12, 16)),
    ((2, 22323, 64), ("cluster", 16, 6, 39)),
    ((1, 65536, 64), ("cluster", 16, 16, 13)),
    ((1, 32768, 1024), ("cluster", 16, 8, 24)),
]


@pytest.mark.parametrize("shape,want", GEOMETRY,
                         ids=[f"{b}x{q}x{g}" for (b, q, g), _ in GEOMETRY])
def test_launch_geometry(shape, want):
    """The route by Q and G: the warp route where the image's transposed
    cost fits a block's 227 KB of shared memory and one warp covers Q with
    a template's columns, else a cluster of the fewest blocks (at most 16)
    whose slices hold every cost row, or 16 holding what fits; the
    shared-memory bytes of each layout within the budget; every column
    owned by one thread once."""
    B, Q, G = shape
    geom = msda_cuda.lsap_geometry(B, Q, G)
    assert (geom.route, geom.cluster, geom.cpt, geom.rows) == want
    assert geom.smem % 16 == 0 and geom.smem <= msda_cuda.LSAP_SMEM_BYTES
    assert list(geom.c_array) == [
        msda_cuda.LSAP_ROUTES.index(geom.route), geom.cluster, geom.threads,
        geom.cpt, geom.width, geom.pitch, geom.rows, geom.smem]
    if geom.route == "warp":
        cpts = msda_cuda.LSAP_WARP_CPTS
        assert geom.width == Q and geom.pitch == Q | 1 and geom.rows == G
        assert geom.smem >= msda_cuda.lsap_warp_smem(Q, G)
        assert 32 * geom.cpt >= Q
        assert geom.threads == msda_cuda.LSAP_STAGE_THREADS
    else:
        cpts = msda_cuda.LSAP_CLUSTER_CPTS
        assert geom.threads == msda_cuda.LSAP_CLUSTER_THREADS
        assert geom.width == -(-Q // geom.cluster)
        assert geom.width * (geom.cluster - 1) < Q  # no block without columns
        assert geom.threads * geom.cpt >= geom.width
        assert geom.pitch % 32 == 1 and geom.pitch >= geom.width
        assert geom.smem >= msda_cuda.lsap_cluster_smem(
            geom.width, geom.pitch, geom.rows, G)
        # one more row would not fit
        assert geom.rows == G or msda_cuda.lsap_cluster_smem(
            geom.width, geom.pitch, geom.rows + 1,
            G) > msda_cuda.LSAP_SMEM_BYTES
        # the warp route does not fit, and fewer blocks would not hold
        # every row
        assert (msda_cuda.lsap_warp_smem(Q, G) > msda_cuda.LSAP_SMEM_BYTES
                or 32 * max(msda_cuda.LSAP_WARP_CPTS) < Q)
    # the fewest columns a thread among the kernel's templates
    need = -(-geom.width // (geom.threads if geom.route == "cluster"
                             else 32))
    assert geom.cpt == min(c for c in cpts if c >= need)


@pytest.mark.parametrize("shape,match", [
    ((1, 65537, 64), "1..65536 queries"),
    ((1, 0, 0), "1..65536 queries"),
    ((1, 8, 9), "G <= Q"),
    ((1, 4096, 1025), "G <= 1024"),
])
def test_launch_geometry_refusals(shape, match):
    with pytest.raises(ValueError, match=match):
        msda_cuda.lsap_geometry(*shape)


def _order_key(x: np.ndarray) -> np.ndarray:
    """lsap.cu's order_key: float32 bits made monotone, -0 read as +0."""
    bits = (x.astype(np.float32) + np.float32(0.0)).view(np.uint32)
    return np.where(bits & 0x80000000, ~bits, bits | 0x80000000)


def emulate_lsap(cost: np.ndarray, num_boxes: np.ndarray, geom):
    """The kernels' search as lsap.cu lays it out, in numpy float32: each
    thread's first minimum by order key over its columns, the slots of the
    warps (and, on the cluster route, of the blocks) reduced by (key,
    column), the dual update from ``reach`` and the walk through ``from``
    (what the kernel records when a step reaches a row) instead of the
    columns' paths."""
    B, Q, G = cost.shape
    f32 = np.float32
    threads = 32 if geom.route == "warp" else geom.threads
    width = Q if geom.route == "warp" else geom.width
    # a thread's columns in order of c, one row a (block, thread), -1 pads
    owner = np.full((geom.cluster * threads, geom.cpt), -1)
    for block in range(geom.cluster):
        for t in range(threads):
            for c in range(geom.cpt):
                j = block * width + t + c * threads
                if t + c * threads < width and j < Q:
                    owner[block * threads + t, c] = j
    NONE = np.uint64(0xFFFFFFFF)
    out_q = np.full((B, G), -1, np.int64)
    out_c = np.zeros((B, G), np.float32)
    out_g = np.full((B, Q), -1, np.int64)
    for b in range(B):
        costT = cost[b].T.astype(f32)
        nb = int(np.clip(num_boxes[b], 0, G))
        u = np.zeros(G, f32)
        v = np.zeros(Q, f32)
        row4col = np.full(Q, -1)
        col4row = np.full(G, -1)
        for cur in range(nb):
            spc = np.full(Q, np.inf, f32)
            path = np.full(Q, -1)
            done = np.zeros(Q, bool)
            reach = np.zeros(G, f32)
            came_from = np.full(G, -1)
            visited = {cur}
            i, min_val = cur, f32(0)
            while True:
                r = ((min_val + costT[i]) - u[i]) - v
                upd = ~done & (r < spc)
                spc = np.where(upd, r, spc)
                path = np.where(upd, i, path)
                keys = _order_key(spc).astype(np.uint64)
                live = owner >= 0
                live[live] = ~done[owner[live]]
                k = np.where(live, keys[np.clip(owner, 0, None)], NONE)
                # each thread's first minimum (its columns rise with c), then
                # the slots' (warps', blocks') by (key, column)
                pick = k.argmin(1)
                rows = np.arange(len(owner))
                k_t, col_t = k[rows, pick], owner[rows, pick]
                has = k_t != NONE
                q = int(col_t[has][np.lexsort((col_t[has], k_t[has]))[0]])
                min_val = spc[q]
                done[q] = True
                nxt = row4col[q]
                if nxt < 0:
                    sink, sink_from = q, path[q]
                    break
                visited.add(nxt)
                reach[nxt], came_from[nxt] = spc[q], path[q]
                i = nxt
            for k in sorted(visited):
                u[k] = (u[k] + min_val) if k == cur else (
                    (u[k] + min_val) - reach[k])
            v = np.where(done, v - (min_val - spc), v)
            j, ii = sink, sink_from
            while ii >= 0:
                jn, fn = col4row[ii], came_from[ii]
                row4col[j] = ii
                col4row[ii] = j
                if ii == cur:
                    break
                j, ii = jn, fn
        out_q[b] = col4row
        out_c[b] = costT[np.arange(G), np.clip(col4row, 0, None)]
        out_g[b] = row4col
    return out_q, out_c, out_g


@pytest.mark.parametrize("shape,ties,seed", [
    ((2, 200, 64), False, 10),   # the warp route, one-stage microbatch
    ((2, 200, 64), True, 11),
    ((2, 300, 24), True, 12),    # the warp route, two stages' Q
    ((2, 1100, 64), False, 13),  # the cluster route, two blocks
    ((2, 1100, 32), True, 14),   # the cluster route, one block
])
def test_kernel_search_emulated_bit_equal_to_jax(shape, ties, seed):
    """The redesigned kernels' search (``emulate_lsap``: order keys with -0
    read as +0, the slots' first minimum, ``reach`` and ``from`` in place of
    the columns' spc and path) gives JAX's assignment and costs bit for
    bit, on costs with signed zeros, ties and nb from 0 to G."""
    B, Q, G = shape
    rng = np.random.default_rng(seed)
    if ties:
        cost = rng.integers(0, 3, shape).astype(np.float32)
        cost[:, 10] = cost[:, 3]
        cost[:, :, 5] = 1.0
    else:
        cost = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    cost[:, ::7, ::3] = -0.0
    cost[:, 1::7, ::3] = 0.0
    num_boxes = np.linspace(0, G, B).round().astype(np.int32)
    num_boxes[-1] = G
    geom = msda_cuda.lsap_geometry(B, Q, G)
    got = emulate_lsap(cost, num_boxes, geom)
    ref = jax_matcher.hungarian_match(jnp.asarray(cost),
                                      jnp.asarray(num_boxes))
    np.testing.assert_array_equal(got[0], np.asarray(ref.query_index))
    np.testing.assert_array_equal(got[2], np.asarray(ref.gt_index))
    np.testing.assert_array_equal(
        got[1].view(np.int32), np.asarray(ref.matching_cost).view(np.int32))


def test_order_key_orders_as_floats_with_signed_zeros_equal():
    x = np.array([-np.inf, -3.5, -1e-30, -0.0, 0.0, 1e-30, 2.0, np.inf],
                 np.float32)
    keys = _order_key(x)
    assert (np.diff(keys.astype(np.int64)) >= 0).all()
    assert keys[3] == keys[4]
    assert len(set(keys.tolist())) == len(x) - 1


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
