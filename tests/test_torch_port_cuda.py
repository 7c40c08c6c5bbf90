"""The port's capsule-routing kernels on the card (marker ``cuda``).

Run on a machine with an NVIDIA H100:
``pytest --noconftest -m cuda tests/test_torch_port_cuda.py`` (the
suite's conftest imports JAX, which the card's machine does not have).
Each test skips where ``torch.cuda.is_available()`` is false.

K1 (both forms) is held to the plain routing at the JAX Pallas kernel's
own bar (rtol 1e-4, atol 1e-5 at unit-scale outputs, tests/test_capsule.py),
with the atol scaled to the output's largest magnitude: both compute in
float32, the kernels sum in another order (the factored form through the
input length, the votes form through a tiled product). Weights are
unit-variance (scaled by 1/sqrt(in_length / 8), so that votes stay
unit-scale at in_length 512), where the routing is well conditioned; much larger
weights saturate the softmax and float32 itself drifts past 1e-4.

K2 is held to autograd through the plain routing at |d| <= 1e-3 |ref| +
1e-4 max|ref| for dx and for dW: the backward sums over more terms (dW
over every sample and input capsule) and the softmax pullback subtracts
nearly equal row sums, so float32 orders differ by more than the forward.
The JAX package's own bar for its fused backward is 2e-2 mean relative
error (tests/test_capsule_pallas_bwd.py).
"""

import os

import numpy as np
import pytest
import torch

from text2img_ekl_tpu_torch.config import cfg_from_file
from text2img_ekl_tpu_torch.ops import capsule_cuda as cc
from text2img_ekl_tpu_torch.ops.capsule import capsule_linear
from text2img_ekl_tpu_torch.ops.capsule_cuda import capsule_routing
from text2img_ekl_tpu_torch.train.state import create_train_state
from text2img_ekl_tpu_torch.train.step import make_train_step

pytestmark = pytest.mark.cuda

K2_RTOL, K2_ATOL = 1e-3, 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device('cuda')
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev


def _inputs(shape_x, shape_w, device, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape_x, dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal(shape_w, dtype=np.float32)
                         / np.float32(np.sqrt(shape_w[-1] / 8)))
    return x.to(device), w.to(device)


def assert_k1_close(out, ref):
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())


def assert_k2_close(out, ref):
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    np.testing.assert_allclose(out, ref, rtol=K2_RTOL,
                               atol=K2_ATOL * np.abs(ref).max())


@pytest.mark.parametrize('shape', [
    (320, 48, 8, 1024, 32),   # flagship G head, 32 images x 10 captions
    (3, 13, 8, 1000, 32),     # ragged: odd capsule counts
    (2, 16, 8, 512, 16),      # out_length 16 (the EXCHANGE branches)
    (1, 48, 8, 6000, 32),     # more output capsules than fit 48 KB of smem
    (32, 16, 512, 201, 16),   # flagship D class head (votes form)
    (3, 5, 24, 37, 16),       # votes form, ragged
])
def test_k1_matches_plain_routing(card, shape):
    bsz, in_caps, in_len, out_caps, out_len = shape
    x, w = _inputs((bsz, in_caps, in_len), (out_caps, out_len, in_len), card)
    kernel = (cc.routing_fwd_factored if in_len == 8 else
              cc.routing_fwd_votes)
    before = kernel.launches
    with torch.no_grad():
        out = capsule_routing(x, w, 3)
        ref = capsule_linear(x, w, 3, 'dynamic')
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert out.shape == (bsz, out_caps, out_len)
    assert_k1_close(out, ref)


@pytest.mark.parametrize('in_len', [8, 64])
def test_k1_iteration_counts(card, in_len):
    x, w = _inputs((4, 16, in_len), (256, 32, in_len), card, seed=1)
    with torch.no_grad():
        for iters in (1, 2, 5):
            assert_k1_close(capsule_routing(x, w, iters),
                            capsule_linear(x, w, iters, 'dynamic'))


def _plain_grads(x, w, dv, iters):
    xd = x.detach().requires_grad_(True)
    wd = w.detach().requires_grad_(True)
    out = capsule_linear(xd, wd, iters, 'dynamic')
    return torch.autograd.grad(out, (xd, wd), dv)


@pytest.mark.parametrize('shape', [
    (32, 48, 8, 1024, 32),    # flagship G head
    (32, 16, 512, 201, 16),   # flagship D class head
    (3, 13, 8, 1000, 32),     # factored, ragged
    (3, 5, 24, 37, 16),       # votes, ragged
])
@pytest.mark.parametrize('iters', [1, 3])
def test_k2_matches_plain_autograd(card, shape, iters):
    bsz, in_caps, in_len, out_caps, out_len = shape
    x, w = _inputs((bsz, in_caps, in_len), (out_caps, out_len, in_len), card,
                   seed=2)
    rng = np.random.default_rng(3)
    dv = torch.from_numpy(rng.standard_normal((bsz, out_caps, out_len),
                                              dtype=np.float32)).to(card)
    kernel = (cc.routing_bwd_factored if in_len == 8 else
              cc.routing_bwd_votes)
    before = kernel.launches
    xk = x.clone().requires_grad_(True)
    wk = w.clone().requires_grad_(True)
    dx, dw = torch.autograd.grad(capsule_routing(xk, wk, iters), (xk, wk), dv)
    ref_dx, ref_dw = _plain_grads(x, w, dv, iters)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert_k2_close(dx, ref_dx)
    assert_k2_close(dw, ref_dw)
    # no weight gradient when the weight needs none
    dx_only, dw_none = kernel(x, w, dv, iters, True, False)
    assert dw_none is None
    assert_k2_close(dx_only, ref_dx)


def test_kernels_raise_on_what_they_do_not_take(card):
    x, w = _inputs((2, 6, 8), (10, 32, 8), card)
    with torch.no_grad():
        with pytest.raises(TypeError):
            capsule_routing(x.double(), w.double())
        with pytest.raises(ValueError):  # out_length 8
            capsule_routing(x, w[:, :8].contiguous())
        with pytest.raises(ValueError):  # in_length mismatch
            capsule_routing(x[..., :4].contiguous(), w)
        with pytest.raises(ValueError):  # not contiguous
            capsule_routing(x.transpose(0, 1), w)
        with pytest.raises(ValueError):  # x on the card, weight on the CPU
            capsule_routing(x, w.cpu())
        with pytest.raises(ValueError):  # factored form: > 512 in capsules
            capsule_routing(torch.zeros((1, 600, 8), device=card), w)


def test_tiny_step_on_the_card_matches_the_cpu(card):
    """One training step at GF/DF_DIM 8, batch 4, float32 (TF32 off), from
    the same seeded weights, batch and draws: every metric within 1e-3
    relative (cuDNN and oneDNN sum convolutions in other orders), and the
    kernels, not the plain routing, ran on the card."""
    cfg = cfg_from_file(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'cfg',
        'birds_2stg_splitz_cap_ca.realcls.yml'))
    cfg.GAN.GF_DIM = cfg.GAN.DF_DIM = 8
    cfg.TRAIN.BATCH_SIZE = 4
    cfg.TPU_COMPUTE_DTYPE = 'float32'
    rng = np.random.default_rng(0)
    labels = rng.integers(0, cfg.GAN.ENTITY_DIM, 4)
    host = {
        'real': tuple(rng.integers(0, 256, (4, 3, s, s), dtype=np.uint8)
                      for s in cfg.branch_sizes()),
        'wrong': tuple(rng.integers(0, 256, (4, 3, s, s), dtype=np.uint8)
                       for s in cfg.branch_sizes()),
        'txt': rng.standard_normal((4, cfg.TEXT.DIMENSION),
                                   dtype=np.float32),
        'cls_onehot': np.eye(cfg.GAN.ENTITY_DIM, dtype=np.float32)[labels],
        'real_cp': np.eye(cfg.GAN.ENTITY_DIM + 1, dtype=np.float32)[labels]}
    draws = {'noise': rng.standard_normal((4, cfg.GAN.Z_DIM),
                                          dtype=np.float32),
             'eps': rng.standard_normal((4, cfg.GAN.EMBEDDING_DIM),
                                        dtype=np.float32),
             'eps_cls': rng.standard_normal((4, cfg.GAN.MANIFD_DIM),
                                            dtype=np.float32)}
    metrics = {}
    for dev in ('cpu', card):
        def put(a):
            if isinstance(a, tuple):
                return tuple(torch.from_numpy(x).to(dev) for x in a)
            return torch.from_numpy(a).to(dev)

        state = create_train_state(cfg, dev, seed=0)
        cc.reset_launches()
        m, fakes = make_train_step(cfg)(
            state, {k: put(v) for k, v in host.items()}, 0,
            {k: put(v) for k, v in draws.items()})
        metrics[str(dev)] = {k: float(v) for k, v in m.items()}
    assert cc.launches() == {'K1-G': 1, 'K1-D': 8, 'K2-G': 1, 'K2-D': 6}
    for k, v in metrics['cpu'].items():
        np.testing.assert_allclose(metrics['cuda'][k], v, rtol=1e-3,
                                   atol=1e-5, err_msg=k)
