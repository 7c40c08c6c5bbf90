"""Capsule routing of the PyTorch port against the JAX package (CPU).

The kernels' own reference is the JAX package's plain routing
(``dynamic_routing(compute_votes(x, W))``) and its ``jax.vjp``; the
port's plain routing and its autograd (K2's plain twin) are held to
them, and the port's autograd Function on a CPU tensor must give the
plain results. Inputs come from a numpy seed, with unit-variance weights
(scaled by 1/sqrt(in_length / 8) at the D-like in_length) so that routing
is neither uniform nor saturated and the outputs reach O(0.1).
Tolerance: |d| <= 1e-5 |ref| + 1e-6 max|ref| for outputs, and 1e-4 |ref|
+ 1e-5 max|ref| for gradients -- both sides compute in float32 on the
CPU and the einsums contract in different orders; the gradients sum over
more terms and pass the softmax pullback's differences of row sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2img_ekl_tpu.ops import capsule as jcap
from text2img_ekl_tpu_torch.ops import capsule as tcap
from text2img_ekl_tpu_torch.ops import capsule_cuda as cc
from text2img_ekl_tpu_torch.ops.capsule_cuda import capsule_routing
from torch_port_threads import one_torch_thread  # noqa: F401


def assert_close(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())


def _inputs(shape_x, shape_w, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape_x, dtype=np.float32)
    w = rng.standard_normal(shape_w, dtype=np.float32)
    return x, w


@pytest.mark.parametrize('shape', [
    ((2, 48, 8), (64, 32, 8)),     # G head, narrow
    ((3, 13, 8), (37, 16, 8)),     # ragged
    ((2, 6, 8), (10, 6, 4, 8)),    # unshared weight
])
@pytest.mark.parametrize('iters', [1, 3])
def test_dynamic_routing_matches_jax(shape, iters):
    x, w = _inputs(*shape)
    ref = jcap.dynamic_routing(jcap.compute_votes(jnp.asarray(x),
                                                  jnp.asarray(w)), iters)
    out = tcap.dynamic_routing(tcap.compute_votes(torch.from_numpy(x),
                                                  torch.from_numpy(w)), iters)
    assert_close(out, ref)


def test_k_means_routing_matches_jax():
    x, w = _inputs((2, 12, 8), (20, 16, 8), seed=1)
    ref = jcap.capsule_linear(jnp.asarray(x), jnp.asarray(w), 3, 'k_means')
    out = tcap.capsule_linear(torch.from_numpy(x), torch.from_numpy(w), 3,
                              'k_means')
    assert_close(out, ref)


def test_squash_matches_jax():
    s = 10 * np.random.default_rng(2).standard_normal((4, 8, 16),
                                                      dtype=np.float32)
    assert_close(tcap.squash(torch.from_numpy(s)),
                 jcap.squash(jnp.asarray(s)))


def test_kernel_wrapper_on_cpu_is_the_plain_routing():
    x, w = _inputs((3, 48, 8), (100, 32, 8), seed=3)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    before = cc.launches()
    out = capsule_routing(xt, wt, 3)
    assert cc.launches() == before  # the CPU launches nothing
    assert torch.equal(out, tcap.capsule_linear(xt, wt, 3, 'dynamic'))


def test_kernel_wrapper_refuses_other_devices_and_gradients():
    """Other devices raise; on the CPU a gradient flows through the
    Function's plain backward (no kernel, no launch) and equals the plain
    routing's autograd exactly."""
    x = torch.zeros((2, 6, 8), device='meta')
    w = torch.zeros((10, 32, 8), device='meta')
    with pytest.raises(ValueError, match='CPU or on one CUDA device'):
        capsule_routing(x, w)
    xn, wn = _inputs((2, 6, 8), (10, 32, 8), seed=6)
    before = cc.launches()
    wg = torch.from_numpy(wn).requires_grad_(True)
    (dw,) = torch.autograd.grad(
        capsule_routing(torch.from_numpy(xn), wg).sum(), wg)
    wp = torch.from_numpy(wn).requires_grad_(True)
    (ref,) = torch.autograd.grad(
        tcap.capsule_linear(torch.from_numpy(xn), wp, 3).sum(), wp)
    assert torch.equal(dw, ref)
    assert cc.launches() == before


GRAD_SHAPES = [
    ((2, 48, 8), (64, 32, 8)),      # G-like: in_length 8, out_length 32
    ((2, 16, 64), (201, 16, 64)),   # D-like: 16 capsules of 64 -> 201 of 16
]


def _grad_inputs(shape, seed):
    x, w = _inputs(*shape, seed=seed)
    w = w / np.float32(np.sqrt(shape[1][-1] / 8))
    dv = np.random.default_rng(seed + 1).standard_normal(
        (shape[0][0],) + shape[1][:2], dtype=np.float32)
    return x, w, dv


def assert_grad_close(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize('shape', GRAD_SHAPES, ids=['G', 'D'])
@pytest.mark.parametrize('iters', [1, 3])
def test_plain_routing_gradients_match_jax_vjp(shape, iters):
    """K2's plain twin: autograd through the port's plain routing against
    jax.vjp of the JAX package's, dx and dW."""
    x, w, dv = _grad_inputs(shape, seed=7)

    def ref(x_, w_):
        return jcap.dynamic_routing(jcap.compute_votes(x_, w_), iters)

    _, vjp = jax.vjp(ref, jnp.asarray(x), jnp.asarray(w))
    ref_dx, ref_dw = vjp(jnp.asarray(dv))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    out = tcap.dynamic_routing(tcap.compute_votes(xt, wt), iters)
    dx, dw = torch.autograd.grad(out, (xt, wt), torch.from_numpy(dv))
    assert_grad_close(dx, ref_dx)
    assert_grad_close(dw, ref_dw)


@pytest.mark.parametrize('shape', GRAD_SHAPES, ids=['G', 'D'])
def test_autograd_function_on_cpu_is_the_plain_autograd(shape):
    """The Function's forward and backward on CPU tensors are the plain
    routing and its autograd; needs_input_grad is honoured."""
    x, w, dv = _grad_inputs(shape, seed=8)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    out = cc.CapsuleRoutingFunction.apply(xt, wt, 3)
    dx, dw = torch.autograd.grad(out, (xt, wt), torch.from_numpy(dv))
    xp = torch.from_numpy(x).requires_grad_(True)
    wp = torch.from_numpy(w).requires_grad_(True)
    ref = tcap.capsule_linear(xp, wp, 3, 'dynamic')
    rdx, rdw = torch.autograd.grad(ref, (xp, wp), torch.from_numpy(dv))
    assert torch.equal(out, ref)
    assert torch.equal(dx, rdx) and torch.equal(dw, rdw)
    frozen = torch.from_numpy(w)  # needs no gradient
    (dx_only,) = torch.autograd.grad(
        cc.CapsuleRoutingFunction.apply(xt, frozen, 3), (xt,),
        torch.from_numpy(dv))
    assert torch.equal(dx_only, rdx)


@pytest.mark.parametrize('use_kernel', [False, True])
def test_capsule_linear_module_matches_jax_module(use_kernel):
    x, _ = _inputs((2, 48, 8), (1, 1, 1), seed=4)
    jmod = jcap.CapsuleLinear(out_capsules=64, in_length=8, out_length=32)
    vs = jmod.init({'params': jax.random.PRNGKey(0)}, jnp.asarray(x))
    tmod = tcap.CapsuleLinear(64, 8, 32, use_kernel=use_kernel)
    assert tuple(tmod.weight.shape) == vs['params']['weight'].shape
    with torch.no_grad():
        tmod.weight.copy_(torch.tensor(np.asarray(vs['params']['weight'])))
        out = tmod(torch.from_numpy(x))
    assert_close(out, jmod.apply(vs, x))


def test_capsule_linear_init_is_orthogonal_over_out_capsules():
    w = tcap.CapsuleLinear(16, 8, 32).weight.detach().reshape(16, -1)
    np.testing.assert_allclose((w @ w.T).numpy(), np.eye(16), atol=1e-5)
