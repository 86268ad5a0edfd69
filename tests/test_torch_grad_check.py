"""The float64 reference of the card's training-gradient check and its
planted-fault control, on the CPU (tests/torch_grad_check.py; the card test
is tests/test_torch_cuda.py::test_tiny_model_training_gradients_on_card_match_cpu).

The reference runs the tiny model's forward+backward under ``Float64``; the
CPU's fp32 plain route must sit near it on every gradient tensor, and a dk
scaled by 1.01 in one attention backward call must fail the check that the
card's kernels pass."""

import functools

import numpy as np
import pytest
import torch

import torch_grad_check as gc

DRAWS = ["jax", "untruncated"]


@functools.lru_cache(maxsize=None)
def _routes(draw: str):
    cfg = gc.train_cfg()
    batch, targets = gc.train_arrays()
    ref = gc.training_grads(cfg, gc.fresh_model(cfg, "cpu", draw).double(), batch, targets,
                            torch.float64)
    return ref, gc.training_grads(cfg, gc.fresh_model(cfg, "cpu", draw), batch, targets)


def test_float64_reference_computes_in_float64_throughout():
    """Every op of the reference's forward and backward (the autograd
    Functions' backward, the bottleneck's recompute and the backbone's
    checkpoint recompute included) returns float64 but one: the batch-size
    count ``accumulate_grads`` makes with ``torch.full`` (an integer, exact
    in float32)."""
    cfg = gc.train_cfg()
    batch, targets = gc.train_arrays()
    model = gc.fresh_model(cfg, "cpu", "jax").double()
    ops = gc.Float32Ops()
    with ops:
        gc.training_grads(cfg, model, batch, targets, torch.float64)
    assert dict(ops.ops) == {"aten.full.default": 1}
    assert {p.grad.dtype for p in model.parameters() if p.grad is not None} == {torch.float64}


@pytest.mark.parametrize("draw", DRAWS)
def test_cpu_fp32_gradients_sit_near_the_float64_reference(draw):
    """The CPU's fp32 gradients against the reference: loss within 1e-6,
    median relative L2 error per tensor below 1e-5 and every tensor whose
    exact gradient is not 0 below 1e-3 (readings: medians 4.6e-7 / 8.2e-7,
    largest 1.7e-5 / 1.2e-5), and not 0 (fp32 did round)."""
    (loss64, ref), (loss32, grads) = _routes(draw)
    assert abs(loss32 - loss64) <= 1e-6 * abs(loss64)
    errs = gc.route_errors(grads, ref)
    # a gradient that is 0 by symmetry (a key projection's bias under the
    # softmax, the span head's bias under log_softmax) reads rounding
    # noise against rounding noise
    real = sorted(e for e in errs.values() if e < 1)
    assert len(real) >= len(errs) - 12
    assert 1e-9 < real[len(real) // 2] < 1e-5 and real[-1] < 1e-3


@pytest.mark.parametrize("draw", DRAWS)
def test_planted_k2_fault_fails_the_gradient_check(draw):
    """dk x 1.01 in the third attention backward call (the last
    spatial-decoder layer's cross-attention, first microbatch) fails the
    check with the CPU's clean route as the plain one; at the untruncated
    draw it also fails the elementwise check it replaced (atol 2e-4 / rtol
    1e-3 against the clean route)."""
    (_, ref), (_, clean) = _routes(draw)
    cfg = gc.train_cfg()
    batch, targets = gc.train_arrays()
    with gc.planted_k2_fault(call=2) as calls:
        _, bad = gc.training_grads(cfg, gc.fresh_model(cfg, "cpu", draw), batch, targets)
    assert calls == [(24, 11, 32)]
    failed = gc.check_failures(gc.route_errors(bad, ref), [gc.route_errors(clean, ref)])
    assert any(".layers.1.ca_kcontent_proj.weight" in n for n, _, _ in failed), failed[:3]
    assert not gc.check_failures(gc.route_errors(clean, ref), [gc.route_errors(clean, ref)])
    if draw == "untruncated":
        assert any(g is not None and not np.allclose(bad[n].numpy(), g.numpy(), atol=2e-4,
                                                     rtol=1e-3) for n, g in clean.items())
