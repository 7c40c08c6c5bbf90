"""The PyTorch port's losses against the JAX package's, on the CPU:
values and gradients, saturated probabilities included (p = 0, p = 1,
p = 1 + ulp, p = -ulp), where ``nn.BCELoss`` would raise and a plain log
would give inf or NaN. A subnormal p is held to the value only: XLA:CPU
flushes it to 0, where the clip's gradient halves, and torch keeps it.

Tolerance: rtol 1e-6 (float32 on both sides, one reduction of a few
hundred elements; the saturated cases are exact: the -100 clamp and its
zero gradient, and the half gradient at the clip's bounds that
``jnp.clip`` gives).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2img_ekl_tpu.train import losses as jl
from text2img_ekl_tpu_torch.train import losses as tl
from torch_port_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-7)
ULP = np.float32(np.spacing(np.float32(1.0)))
SATURATED = np.array([0.0, 1.0, 1.0 + ULP, -ULP, 1.0 - ULP / 2, 0.5,
                      0.25], np.float32)


def _value_and_grad(jfn, tfn, *args):
    """Loss and gradient w.r.t. the first argument in both frameworks."""
    jv, jg = jax.value_and_grad(jfn)(*map(jnp.asarray, args))
    t0 = torch.tensor(args[0], requires_grad=True)
    tv = tfn(t0, *map(torch.tensor, args[1:]))
    (tg,) = torch.autograd.grad(tv, t0)
    return (np.asarray(jv), np.asarray(jg)), (tv.detach().numpy(),
                                              tg.numpy())


def _assert_pair(ref, got):
    for r, g in zip(ref, got):
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g, r, **TOL)


@pytest.mark.parametrize('target', ['zeros', 'ones', 'soft'])
@pytest.mark.parametrize('p', ['random', 'saturated'])
def test_bce_matches_jax(p, target):
    rng = np.random.default_rng(0)
    probs = (rng.uniform(0, 1, 64).astype(np.float32) if p == 'random'
             else SATURATED)
    tgt = {'zeros': np.zeros_like(probs), 'ones': np.ones_like(probs),
           'soft': rng.uniform(0, 1, probs.shape).astype(np.float32)}[target]
    ref, got = _value_and_grad(jl.bce, tl.bce, probs, tgt)
    _assert_pair(ref, got)


def test_bce_saturates_at_100_per_element():
    for p, t in ((0.0, 1.0), (1.0, 0.0), (1.0 + ULP, 0.0), (-ULP, 1.0),
                 (1e-40, 1.0)):
        v = tl.bce(torch.tensor([p]), torch.tensor([t]))
        assert float(v) == pytest.approx(100.0)


def test_ce_and_kl_and_nll_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((4, 9)).astype(np.float32)
    logq = np.asarray(jax.nn.log_softmax(logits, axis=-1))
    p = np.eye(9, dtype=np.float32)[[0, 3, 8, 8]]
    _assert_pair(*_value_and_grad(jl.ce_loss, tl.ce_loss, logq, p))
    mu = rng.standard_normal((4, 16)).astype(np.float32)
    logvar = (0.3 * rng.standard_normal((4, 16))).astype(np.float32)
    _assert_pair(*_value_and_grad(jl.kl_loss, tl.kl_loss, mu, logvar))
    _assert_pair(*_value_and_grad(lambda lv, m: jl.kl_loss(m, lv),
                                  lambda lv, m: tl.kl_loss(m, lv),
                                  logvar, mu))
    targets = np.array([0, 3, 8, 2])
    np.testing.assert_allclose(
        tl.nll_loss(torch.tensor(logq), torch.tensor(targets)).numpy(),
        np.asarray(jl.nll_loss(jnp.asarray(logq), jnp.asarray(targets))),
        **TOL)


def test_color_consistency_matches_jax():
    """Values and gradients w.r.t. the higher stage (the lower one is
    stop-gradient'ed in both); images NHWC in JAX, NCHW in the port."""
    rng = np.random.default_rng(2)
    lo = np.tanh(rng.standard_normal((2, 8, 8, 3))).astype(np.float32)
    hi = np.tanh(rng.standard_normal((2, 16, 16, 3))).astype(np.float32)
    mu, cov = jl.compute_mean_covariance(jnp.asarray(hi))
    tmu, tcov = tl.compute_mean_covariance(
        torch.tensor(hi).permute(0, 3, 1, 2))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(mu), **TOL)
    np.testing.assert_allclose(tcov.numpy(), np.asarray(cov), rtol=1e-5,
                               atol=1e-7)

    def jfn(h, low):
        return jl.color_consistency_loss([low, h], 0.5)

    def tfn(h, low):
        return tl.color_consistency_loss(
            [low.permute(0, 3, 1, 2), h.permute(0, 3, 1, 2)], 0.5)

    # the low stage at the high stage's size, as the stages are compared
    low = np.repeat(np.repeat(lo, 2, axis=1), 2, axis=2)
    (jv, jg), (tv, tg) = _value_and_grad(jfn, tfn, hi, low)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, rtol=1e-4, atol=1e-9)
