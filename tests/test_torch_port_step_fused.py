"""One training step of the PyTorch port with ``TPU_FUSED_BN_GLU`` and
``TPU_PALLAS_DW`` on, against the JAX package's ``make_train_step`` with
both on, on the CPU.

The setting of ``tests/test_torch_port_step.py`` (the flagship training
config at GF/DF_DIM 8, batch 4, float32, uint8 input, the same weights,
batch and draws; its ``run_steps``), with the two switches set on the
loaded config. The JAX step runs its fused BN+GLU and its 3x3 weight
gradient as Pallas kernels in interpret mode; the port runs their plain
twins on CPU tensors (``bn_glu_reference``, ``dw3x3_reference``).

Compared after the step, at that file's step-1 bars: every metric, the G
and D BatchNorm running statistics and the fakes (rtol 1e-4, atol 1e-5);
G's Adam first moments per tensor (||d|| <= 1e-2 ||ref|| + 1e-5
max|ref|). And the port's op counts in the step: one fused BN+GLU per
4-D BN+GLU tail of G (8), one weight-gradient call per G conv whose
shapes lie inside JAX's ``dw_supported`` (7 at GF_DIM 8).
"""

import numpy as np
import pytest
import torch

from test_torch_port_step import (MOMENT_ATOL, MOMENT_RTOL, STEP1, run_steps,
                                  small_cfg)
from text2img_ekl_tpu.nn import blocks as jblocks
from text2img_ekl_tpu.ops import conv_dw as jconv_dw
from text2img_ekl_tpu_torch.nn import blocks as tblocks
from text2img_ekl_tpu_torch.ops import bn_glu, conv_dw
from torch_port_threads import one_torch_thread  # noqa: F401

JAX_GLOBALS = ('BN_DTYPE', 'SPLIT_JOINT_CONV', 'FUSED_BN_GLU', 'SUBPIXEL_UP',
               'PALLAS_DW')


def _fused_cfg():
    cfg = small_cfg()
    cfg.TPU_FUSED_BN_GLU = True
    cfg.TPU_PALLAS_DW = True
    return cfg


@pytest.fixture(scope='module')
def run():
    """One step of each framework with both switches on; the port's calls
    of the two ops are counted."""
    saved = {k: getattr(jblocks, k) for k in JAX_GLOBALS}
    calls = {'bn_glu': 0, 'dw3x3': 0}
    real_bn_glu, real_dw = bn_glu.fused_bn_glu, conv_dw.dw3x3

    def count_bn_glu(*a):
        calls['bn_glu'] += 1
        return real_bn_glu(*a)

    def count_dw(*a):
        calls['dw3x3'] += 1
        return real_dw(*a)

    bn_glu.fused_bn_glu, conv_dw.dw3x3 = count_bn_glu, count_dw
    try:
        out = run_steps(_fused_cfg(), 1)
        assert jblocks.FUSED_BN_GLU and jblocks.PALLAS_DW
    finally:
        bn_glu.fused_bn_glu, conv_dw.dw3x3 = real_bn_glu, real_dw
        for k, v in saved.items():
            setattr(jblocks, k, v)
    out['calls'] = calls
    return out


def test_fused_metrics_match_jax(run):
    jm, tm = run['jax'][0]['metrics'], run['port'][0]['metrics']
    assert set(jm) == set(tm)
    for k, v in jm.items():
        np.testing.assert_allclose(tm[k], v, err_msg=k, **STEP1)


def test_fused_batchnorm_statistics_match_jax(run):
    j, t = run['jax'][0], run['port'][0]
    pairs = [(j['g_stats'], t['g_stats'])] + list(zip(j['d_stats'],
                                                      t['d_stats']))
    for want, got in pairs:
        assert set(want) == set(got) and want
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k,
                                       **STEP1)


def test_fused_fakes_match_jax(run):
    want, got = run['jax'][0]['fakes'], run['port'][0]['fakes']
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **STEP1)


def test_fused_g_adam_first_moments_match_jax(run):
    want, got = run['jax'][0]['g_mu'], run['port'][0]['g_mu']
    assert set(want) == set(got) and want
    net_max = max(float(v.abs().max()) for v in want.values())
    for k, v in want.items():
        err = float(torch.linalg.vector_norm(got[k] - v))
        bound = MOMENT_RTOL * float(torch.linalg.vector_norm(v)) + \
            MOMENT_ATOL * net_max
        assert err <= bound, (k, err, bound)


def test_fused_step_op_counts(run):
    """8 fused tails per G forward; a weight-gradient call for every G conv
    that JAX routes to its Pallas dW: inside dw_supported, and not the
    joint conv, which JAX computes tile-free (TPU_SPLIT_JOINTCONV)."""
    G = run['port_state'].G
    shapes = {}

    def record(name):
        def hook(m, args):
            x = args[0]
            shapes[name] = (x.shape[2], x.shape[3], x.shape[1],
                            m.out_channels)
        return hook

    hooks = [m.register_forward_pre_hook(record(name))
             for name, m in G.named_modules()
             if isinstance(m, tblocks.Conv3x3)]
    cfg = _fused_cfg()
    b = cfg.TRAIN.BATCH_SIZE
    try:
        with torch.no_grad():
            G(torch.zeros(b, cfg.GAN.Z_DIM), torch.zeros(b, cfg.TEXT.DIMENSION),
              torch.eye(cfg.GAN.ENTITY_DIM)[:b])
    finally:
        for h in hooks:
            h.remove()
    want_dw = sum(jconv_dw.dw_supported(*s) for name, s in shapes.items()
                  if 'jointConv' not in name)
    fused = sum(isinstance(m, tblocks.FusedBatchNormGLU) for m in G.modules())
    assert (fused, want_dw) == (8, 7)
    assert run['calls'] == {'bn_glu': fused, 'dw3x3': want_dw}
