"""The port's command lines against the JAX package's: options the JAX
drivers and probe take are parsed by the port's, and set the same
configuration fields (on the CPU, without running a step)."""

import pytest

from egtr_tpu_torch.scripts import perf_train_step, pretrain_detr, train_egtr

DRIVER_ARGS = ["--data_path", "data", "--output_path", "out"]


@pytest.mark.parametrize("driver", [train_egtr, pretrain_detr],
                         ids=["train_egtr", "pretrain_detr"])
@pytest.mark.parametrize("value,want", [(None, True), ("false", False),
                                        ("true", True)])
def test_drivers_accept_precompile(driver, value, want):
    """``--precompile`` (the JAX drivers' concurrent compile of the
    evaluation program) is accepted, and does nothing in the port."""
    argv = DRIVER_ARGS + ([] if value is None else ["--precompile", value])
    assert driver.parse_args(argv).precompile is want


@pytest.mark.parametrize("argv,want", [
    ([], (False, "full", False)),
    (["--remat", "1"], (True, "full", False)),
    (["--remat", "0"], (False, "full", False)),
    (["--remat", "1", "--remat-policy", "dots"], (True, "dots", False)),
    (["--approx-topk"], (False, "full", True)),
    (["--tiny", "--remat", "1", "--approx-topk"], (True, "full", True)),
])
def test_perf_train_step_takes_the_jax_probes_options(argv, want):
    """``--remat``, ``--remat-policy`` and ``--approx-topk`` set
    ``use_remat``, ``remat_policy`` and ``rel_sample_approx_topk``, as
    scripts/perf_train_step.py sets them (``--remat`` off by "0")."""
    cfg = perf_train_step.probe_config(perf_train_step.parse_args(argv))
    assert (cfg.use_remat, cfg.remat_policy,
            cfg.rel_sample_approx_topk) == want


def test_perf_train_step_refuses_an_unknown_remat_policy():
    with pytest.raises(SystemExit):
        perf_train_step.parse_args(["--remat-policy", "some"])
