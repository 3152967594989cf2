"""``utils/aot.py`` (per-shape CUDA graphs) and the capturable optimizer, on
the CPU.

The capture itself needs the card (chip_smoke.py's phases h and i); here:
the dispatch key (``flatten`` / ``signature``, and the ranks'
``portable_signature``), ``maybe_aot`` staying eager on the CPU and, in a
process group, for a function with collectives under gloo, the wrappers
counting eager launches only, and the optimizer a captured step runs
against optax over three steps with a changing ``lr_scale``, as the JAX
step scales its updates.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed

from egtr_tpu.train import optim as jax_optim
from egtr_tpu_torch.ops import msda, msda_cuda
from egtr_tpu_torch.utils import aot
from egtr_tpu_torch.train.optim import Optimizer

torch.set_num_threads(1)


def test_signature_covers_shape_dtype_device_structure_and_none():
    x = torch.zeros((2, 3))
    base = aot.signature(({"a": x, "b": [x, None]}, 1.0))
    assert base == aot.signature(({"a": torch.ones((2, 3)),
                                   "b": [torch.ones((2, 3)), None]}, 1.0))
    others = [
        ({"a": torch.zeros((2, 4)), "b": [x, None]}, 1.0),           # shape
        ({"a": x.double(), "b": [x, None]}, 1.0),                    # dtype
        ({"a": torch.zeros((2, 3), device="meta"), "b": [x, None]}, 1.0),
        ({"a": x, "b": [x, x]}, 1.0),                                # None
        ({"a": x, "b": (x, None)}, 1.0),                             # tuple
        ({"b": [x, None], "a": x}, 1.0),                             # order
        ({"a": x, "b": [x, None]}, 0.5),                             # value
        ({"a": x, "c": [x, None]}, 1.0),                             # key
    ]
    keys = {base, *(aot.signature(o) for o in others)}
    assert len(keys) == len(others) + 1
    # a generator by identity
    g1, g2 = torch.Generator(), torch.Generator()
    assert aot.signature((x, g1)) == aot.signature((x, g1))
    assert aot.signature((x, g1)) != aot.signature((x, g2))


def test_signature_holds_the_module_state_a_capture_reads(monkeypatch):
    x = torch.zeros(3)
    key = aot.signature((x,))
    monkeypatch.setattr(msda, "FWD_BATCH_P", not msda.FWD_BATCH_P)
    assert aot.signature((x,)) != key
    monkeypatch.undo()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        not torch.backends.cuda.matmul.allow_tf32)
    assert aot.signature((x,)) != key


def test_flatten_unflatten_round_trip():
    tree = {"pixel_values": torch.ones(2), "labels": {
        "boxes": torch.zeros((2, 4)), "n": [torch.arange(3), 7, None]},
        "t": (torch.zeros(1), "s")}
    leaves, treedef = aot.flatten(tree)
    assert len(leaves) == 4
    back = aot.unflatten(treedef, [t + 1 for t in leaves])
    assert back["labels"]["n"][1:] == [7, None] and back["t"][1] == "s"
    assert isinstance(back["t"], tuple) and isinstance(back["labels"]["n"],
                                                       list)
    torch.testing.assert_close(back["labels"]["boxes"], torch.ones((2, 4)))
    torch.testing.assert_close(back["pixel_values"], torch.full((2,), 2.0))


def test_maybe_aot_is_the_function_itself_on_the_cpu():
    calls = []

    def fn(x, scale):
        calls.append(x)
        return {"y": x * scale}

    assert aot.maybe_aot(fn, "t", device="cpu") is fn
    assert aot.maybe_aot(fn, "t", device=torch.device("cpu")) is fn
    # without a device: CPU tensors run the function eagerly, no program
    wrapped = aot.maybe_aot(fn, "t")
    out = wrapped(torch.ones(2), 3.0)
    torch.testing.assert_close(out["y"], torch.full((2,), 3.0))
    assert len(calls) == 1 and wrapped.programs == {}


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("collectives", [False, True])
@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_maybe_aot_is_the_function_itself_in_a_process_group(
        tmp_path, monkeypatch, capsys, backend, collectives, device):
    """The rule in a process group: ``fn`` itself where the device is not
    a card, or where ``fn`` holds a collective that the group's backend
    cannot capture (gloo), said once; else the dispatch to programs, under
    NCCL with collectives too (the backend is reported as NCCL to a gloo
    group here: the CPU cannot make an NCCL one)."""
    def fn(x):
        return x + 1

    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1)
    try:
        if backend == "nccl":
            monkeypatch.setattr(torch.distributed, "get_backend",
                                lambda group=None: "nccl")
        got = aot.maybe_aot(fn, "t", device=device, collectives=collectives)
        eager = device == "cpu" or (collectives and backend == "gloo")
        assert (got is fn) == eager
        said = capsys.readouterr().out
        assert said.count("[aot] t: eager, gloo collectives") == int(
            device == "cuda" and collectives and backend == "gloo")
        if not eager:
            # CPU arguments run the function, with no program and no
            # agreement of the ranks
            torch.testing.assert_close(got(torch.ones(2)),
                                       torch.full((2,), 2.0))
            assert got.programs == {}
    finally:
        monkeypatch.undo()
        torch.distributed.destroy_process_group()
    assert aot.maybe_aot(fn, "t") is not fn


def test_portable_signature_leaves_out_the_rank_s_own_device_and_generator():
    """What the ranks compare before a capture: the device's type, not its
    index, and a generator by its kind; shapes and dtypes as ``signature``
    keys them."""
    x = torch.zeros((2, 3))
    a = aot.portable_signature(({"x": x}, torch.Generator(), 1.0))
    assert a == aot.portable_signature(({"x": torch.ones((2, 3))},
                                        torch.Generator(), 1.0))
    assert a != aot.portable_signature(({"x": torch.zeros((2, 4))},
                                        torch.Generator(), 1.0))
    assert a != aot.portable_signature(({"x": x.double()},
                                        torch.Generator(), 1.0))
    assert "(2, 3)" in a and "'cpu'" in a and "generator" in a


def test_a_launch_under_capture_is_not_counted(monkeypatch):
    """A wrapper counts its eager launches only: a call while a CUDA graph
    is captured records the kernel, and the graph's replays launch it
    without the wrapper (chip_smoke counts those on the card)."""
    msda_cuda.reset_launches()
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    msda_cuda._count("msda_fwd")
    msda_cuda._count("lsap")
    msda_cuda._count("msda_fwd_win", launched=False)  # no work, no launch
    capturing[0] = True
    msda_cuda._count("msda_fwd")
    assert {k: v for k, v in msda_cuda.launches.items() if v} == {
        "msda_fwd": 1, "lsap": 1}
    msda_cuda.reset_launches()
    # the counters carry the matcher's kernel beside the MSDA kernels
    assert set(msda_cuda.launches) == set(msda_cuda.KERNELS) | {"lsap"}


def _tree():
    rng = np.random.default_rng(0)
    return {"params": {
        "class_embed": {"kernel": rng.standard_normal((4, 3))},
        "backbone": {"layer2_0": {"conv2": {"kernel":
                                            rng.standard_normal((5,))}},
                     "bn1": {"scale": rng.standard_normal((3,))}}}}


def test_optimizer_matches_optax_with_a_changing_lr_scale():
    """Three steps, lr_scale 1, 0.5 (a tensor) and 0.1, against optax's
    chain (clip over every leaf, frozen ones included, then AdamW per
    group) with the updates scaled as the JAX step scales them."""
    import jax
    import optax

    tree = jax.tree_util.tree_map(lambda a: a.astype(np.float32), _tree())
    lrs = dict(lr=1e-2, lr_backbone=1e-3)
    tx = jax_optim.make_optimizer(weight_decay=1e-4, grad_clip=0.1, **lrs)
    jlabels = jax.tree_util.tree_map_with_path(
        lambda path, _: jax_optim.param_label(path), tree)
    paths = {"class_embed.kernel": ("class_embed", "kernel"),
             "backbone.conv2": ("backbone", "layer2_0", "conv2", "kernel"),
             "backbone.bn1": ("backbone", "bn1", "scale")}

    def get(t, path):
        for k in path:
            t = t[k]
        return t

    labels = {n: get(jlabels["params"], p) for n, p in paths.items()}
    assert labels == {"class_embed.kernel": "main",
                      "backbone.conv2": "backbone", "backbone.bn1": "frozen"}
    named = [(n, torch.nn.Parameter(torch.from_numpy(
        np.array(get(tree["params"], p))))) for n, p in paths.items()]
    opt = Optimizer(named, labels, {"main": lrs["lr"],
                                    "backbone": lrs["lr_backbone"]},
                    weight_decay=1e-4, grad_clip=0.1)
    assert not opt.capturable  # torch.optim has no capturable CPU AdamW
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = tx.init(params)
    rng = np.random.default_rng(1)
    opt.zero_grad()
    buffers = [p.grad.data_ptr() for _, p in named]
    for scale in (1.0, torch.tensor(0.5), 0.1):
        grads = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
        opt.zero_grad()
        for n, p in named:
            p.grad += torch.from_numpy(np.array(get(grads["params"],
                                                    paths[n])))
        norm = opt.step(scale)
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray,
                                                          grads),
                                   state, params)
        updates = jax.tree_util.tree_map(lambda u: u * float(scale), updates)
        params = optax.apply_updates(params, updates)
        np.testing.assert_allclose(
            float(norm), float(optax.global_norm(grads)), rtol=1e-6)
        for n, p in named:
            # float32, and torch decays before the Adam step (first order
            # in lr * wd = 1e-6)
            np.testing.assert_allclose(
                p.detach().numpy(), np.asarray(get(params["params"],
                                                   paths[n])),
                rtol=2e-6, atol=2e-7, err_msg=n)
    # the frozen leaf never moved; the gradient buffers kept their storage
    np.testing.assert_array_equal(named[2][1].detach().numpy(),
                                  tree["params"]["backbone"]["bn1"]["scale"])
    assert [p.grad.data_ptr() for _, p in named] == buffers


def test_load_or_compile_needs_a_card():
    with pytest.raises(ValueError, match="one card"):
        aot.load_or_compile(lambda x: x, torch.zeros(2), tag="t")


def test_init_state_is_the_first_steps_state():
    """``Optimizer.init_state`` makes every gradient and AdamW's state
    ahead of the first step, as the train step does before its programs'
    first warm-up: the steps after it match an optimizer whose state the
    first step made, bit for bit, and they keep the storage it made."""
    rng = np.random.default_rng(3)
    shapes = {"class_embed.kernel": (6, 4), "backbone.conv2": (3, 3, 2),
              "backbone.bn1": (5,)}
    labels = {"class_embed.kernel": "main", "backbone.conv2": "backbone",
              "backbone.bn1": "frozen"}
    start = {n: rng.standard_normal(s).astype(np.float32)
             for n, s in shapes.items()}
    grads = [{n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()} for _ in range(3)]

    def run(early):
        named = [(n, torch.nn.Parameter(torch.from_numpy(start[n].copy())))
                 for n in shapes]
        opt = Optimizer(named, labels, {"main": 1e-2, "backbone": 1e-3},
                        weight_decay=1e-4, grad_clip=0.1)
        # the frozen leaf has a gradient and no optimizer state
        updated = [p for _, p in named[:2]]
        if early:
            opt.init_state()
            assert all(p.grad is not None for _, p in named)
            assert [len(opt.adamw.state[p]) for _, p in named] == [3, 3, 0]
            made = [(p.grad.data_ptr(), opt.adamw.state[p]["exp_avg"]
                     .data_ptr()) for p in updated]
        for g in grads:
            opt.zero_grad()
            for n, p in named:
                p.grad += torch.from_numpy(g[n])
            opt.step(0.5)
        if early:
            assert made == [(p.grad.data_ptr(), opt.adamw.state[p]["exp_avg"]
                             .data_ptr()) for p in updated]
        return named, opt

    (early, opt_e), (lazy, opt_l) = run(True), run(False)
    for (n, a), (_, b) in zip(early, lazy):
        assert torch.equal(a, b), n
        sa, sb = opt_e.adamw.state[a], opt_l.adamw.state[b]
        assert sa.keys() == sb.keys()
        for k in sa:
            assert sa[k].dtype == sb[k].dtype and sa[k].device == sb[k].device
            assert torch.equal(sa[k], sb[k]), (n, k)
