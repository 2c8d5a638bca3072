"""The port's pipeline with manual tensor parallelism
(`repro_torch.distributed.pipeline_tp`) on CPU meshes against the
reference on the CPU, with `test_torch_pipeline.py`'s config, inputs and
tolerances: against `jax.value_and_grad` of `loss_fn` on (2, 2), (1, 2)
and (4, 1) meshes, and with one stage against the reference's own
`pipeline_tp_loss_and_grads` on a (1, 1) jax mesh (both take the stage's
gradient with respect to the bf16 stash slices, so the input gradient is
rounded to bf16 alike). The replicated weights' gradients (`wk`, `wv`, the
norms) are summed over the TP ranks exactly once: a (1, 2) run equals the
(1, 1) run to float32 rounding."""

import numpy as np
import pytest
import torch

from repro.distributed import pipeline_tp as jpptp
from repro_torch.distributed import pipeline_tp as pptp

from test_torch_pipeline import (  # noqa: F401  (tests/ is on sys.path)
    GRAD_ERR, LOSS_ERR, MESHES, ONE_STAGE_GRAD_ERR, ONE_STAGE_LOSS_ERR, assert_close,
    assert_padding_zero, reference_case, run_port)


@pytest.fixture(scope="module")
def case():
    return reference_case(jpptp.pipeline_tp_loss_and_grads)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_pipeline_tp_matches_value_and_grad(case, shape):
    got = run_port(pptp.pipeline_tp_loss_and_grads, case, shape)
    assert_close(got, case[5], case[0].n_layers, LOSS_ERR, GRAD_ERR, shape)
    assert_padding_zero(got[1], case[0].n_layers)


@pytest.mark.parametrize("shape", [(1, 1), (1, 2)], ids=["1x1", "1x2"])
def test_pipeline_tp_one_stage_matches_the_reference_pipeline_tp(case, shape):
    got = run_port(pptp.pipeline_tp_loss_and_grads, case, shape)
    assert_close(got, case[6], case[0].n_layers, ONE_STAGE_LOSS_ERR, ONE_STAGE_GRAD_ERR, shape)


def test_replicated_weights_summed_over_ranks_once(case):
    one = run_port(pptp.pipeline_tp_loss_and_grads, case, (1, 1))[1]
    two = run_port(pptp.pipeline_tp_loss_and_grads, case, (1, 2))[1]
    for k in pptp.REPLICATED:
        a, b = two["layers"][k].numpy(), one["layers"][k].numpy()
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6 * np.abs(b).max(), err_msg=k)
    np.testing.assert_allclose(two["final_norm"].numpy(), one["final_norm"].numpy(),
                               rtol=1e-5, atol=1e-7)


def test_pipeline_tp_repeats_bit_equal(case):
    a = run_port(pptp.pipeline_tp_loss_and_grads, case, (2, 2))
    b = run_port(pptp.pipeline_tp_loss_and_grads, case, (2, 2))
    assert torch.equal(a[0], b[0])
    for k in a[1]["layers"]:
        assert torch.equal(a[1]["layers"][k], b[1]["layers"][k]), k
    for k in ("embed", "lm_head", "final_norm"):
        assert torch.equal(a[1][k], b[1][k]), k


def test_heads_split_by_whole_kv_groups(case):
    """Rank r's query heads must read the kv heads they read unsplit
    (h % Hkv): each rank's head count is a multiple of Hkv."""
    _, tcfg, *_ = case
    import dataclasses
    bad = dataclasses.replace(tcfg, n_heads=4, n_kv=4)
    with pytest.raises(ValueError, match="kv groups"):
        run_port(pptp.pipeline_tp_loss_and_grads, (case[0], bad) + case[2:], (1, 2))
