"""One and two training steps of the PyTorch port against the JAX package's
``make_train_step``, on the CPU.

The flagship training config (``cfg/birds_2stg_splitz_cap_ca.realcls.yml``:
split-z CA, capsule heads on G and on both joint Ds, EKL class losses,
UNCOND_LOSS 1) cut to GF_DIM and DF_DIM 8 and a batch of 4, float32,
uint8 input. JAX's ``create_train_state`` initialises every network; the
weights are bridged into the port's ``create_train_state`` modules. Both
run the same uint8 batch with the same draws: the noise is JAX's
``normal(split(rng, 3)[0])``, and the CA and VC eps are read back from a
train-mode G call with the step's own keys.

Compared after each step: every metric, the G and D BatchNorm running
statistics, the top-stage fakes; after step 1, Adam's first moments
(optax ``mu`` and torch ``exp_avg``, both 0.5 * gradient), which hold the
gradients without the sign flips of Adam's first update on the
parameters.

Tolerances, float32 on both sides with convolutions summed in other
orders by XLA:CPU and oneDNN (the blocks agree to ~1e-6 relative,
tests/test_torch_port_discriminator.py):
  * step 1: metrics, statistics and fakes rtol 1e-4 (+ atol 1e-5 for
    values near zero). First moments, per tensor: ||d||_2 <= 1e-2 ||ref||_2
    + 1e-5 max|ref over the network|. Most entries agree to ~1e-5, but a
    LeakyReLU whose input lies within float32 rounding of zero (1.9e-7 at
    the 128 px D's first conv for this batch) takes the other slope in one
    framework, moving one pixel's whole contribution to one weight row;
    and the moments of biases that feed a BatchNorm are zero in exact
    arithmetic and float32 noise (~1e-7) here;
  * step 2: metrics and statistics rtol 1e-3: Adam's first update is
    lr * sign(g) wherever |g| >> eps, so a gradient entry near zero whose
    sign differs between the frameworks moves its parameter 2 lr apart, and
    step 2 runs on those parameters.

Resume: one more port state is saved with ``save_train_state`` after step
1 and restored into a fresh state of another seed before step 2. Its
step 2 is bit-identical to the uninterrupted port run's (one CPU thread):
metrics, fakes, BatchNorm statistics, and the whole state after it
(parameters, buffers, Adam moments and steps); and within the step-2 bar
of JAX's.
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2img_ekl_tpu.config import cfg_from_file
from text2img_ekl_tpu.models import discriminator as jdisc
from text2img_ekl_tpu.models import generator as jgen
from text2img_ekl_tpu.train import state as jstate
from text2img_ekl_tpu.train import step as jstep
from text2img_ekl_tpu_torch.io_utils.weights import (
    jax_generator_to_state_dict, jax_joint_d_to_state_dict)
from text2img_ekl_tpu_torch.io_utils.checkpoint import (restore_train_state,
                                                        save_train_state)
from text2img_ekl_tpu_torch.train.state import (create_train_state,
                                                train_state_dict)
from text2img_ekl_tpu_torch.train.step import make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, 'cfg', 'birds_2stg_splitz_cap_ca.realcls.yml')
B = 4
STEPS = 2
STEP1 = dict(rtol=1e-4, atol=1e-5)
STEP2 = dict(rtol=1e-3, atol=1e-4)
MOMENT_RTOL, MOMENT_ATOL = 1e-2, 1e-5


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU (the
    port's files took 3x longer under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cfg():
    cfg = cfg_from_file(CFG)
    cfg.GAN.GF_DIM = 8
    cfg.GAN.DF_DIM = 8
    cfg.TRAIN.BATCH_SIZE = B
    cfg.TPU_COMPUTE_DTYPE = 'float32'
    cfg.TPU_BN_DTYPE = 'float32'
    cfg.TPU_UINT8_INPUT = True
    return cfg


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _jax_draws(G, variables, rng, batch, z_dim):
    """The noise and CA/VC eps that one JAX step draws from ``rng``."""
    k_noise, k_rep, k_prior = jax.random.split(jnp.asarray(rng), 3)
    noise = jax.random.normal(k_noise, (B, z_dim), jnp.float32)
    _, inter = G.apply(variables, noise, batch['txt'], batch['cls_onehot'],
                       train=True, rngs={'reparam': k_rep,
                                         'cls_prior': k_prior},
                       capture_intermediates=True,
                       mutable=['batch_stats', 'intermediates'])

    def eps(net):
        c, mu, _, std = inter['intermediates'][net]['__call__'][0]
        return (np.asarray(c) - np.asarray(mu)) / np.asarray(std)

    return {'noise': _t(noise), 'eps': _t(eps('ca_net1')),
            'eps_cls': _t(eps('vc_net2'))}


def _port_batch(batch):
    return {'real': tuple(_t(x).permute(0, 3, 1, 2).contiguous()
                          for x in batch['real']),
            'wrong': tuple(_t(x).permute(0, 3, 1, 2).contiguous()
                           for x in batch['wrong']),
            'txt': _t(batch['txt']), 'cls_onehot': _t(batch['cls_onehot']),
            'real_cp': _t(batch['real_cp'])}


def _stats(sd):
    return {k: v.detach().clone() for k, v in sd.items() if '.running_' in k}


def _moments(module, opt):
    names = {p: n for n, p in module.named_parameters()}
    return {names[p]: s['exp_avg'].clone() for p, s in opt.state.items()}


@pytest.fixture(scope='module')
def runs():
    """Both frameworks, STEPS steps each, from the same weights."""
    return run_steps(small_cfg(), STEPS)


def run_steps(cfg, steps, port_cfgs=(), compiler_options=None):
    """``steps`` steps of JAX's make_train_step and of the port's from the
    same weights, batch and draws: per step the metrics, fakes and BN
    statistics of both, after step 1 the Adam first moments; and the
    port's final state. Each of ``port_cfgs`` runs the port's step once
    more from the same weights, batch and draws (its records under
    'port_cfgs'). From step 2 on, a port state saved after step 1 and
    restored into a fresh state of seed 1 takes the same steps (its
    records under 'resumed', None at step 1; its final state under
    'resumed_state'). ``compiler_options`` compiles JAX's step with those
    XLA options."""
    cond_width = jstep.cond_code_width(cfg)
    G = jgen.build_generator(cfg, train_flag=True)
    Ds = jdisc.build_discriminators(cfg, cond_width)
    jst = jstate.create_train_state(cfg, G, Ds, jax.random.PRNGKey(0),
                                    cond_width)
    batch = jstep.make_synthetic_batch(cfg, B, seed=3)
    assert batch['real'][0].dtype == jnp.uint8
    sizes = cfg.branch_sizes()

    def port_state(c):
        st = create_train_state(c, 'cpu', seed=0)
        st.G.load_state_dict(jax_generator_to_state_dict(
            {'params': jst.g_params, 'batch_stats': jst.g_batch_stats}),
            strict=True)
        for D, p, s, size in zip(st.Ds, jst.d_params, jst.d_batch_stats,
                                 sizes):
            D.load_state_dict(jax_joint_d_to_state_dict(
                {'params': p, 'batch_stats': s}, size), strict=True)
        return st

    tst = port_state(cfg)
    extra = [(make_train_step(c), port_state(c)) for c in port_cfgs]
    jfn = jstep.make_train_step(cfg, G, Ds)
    if compiler_options:
        jitted = jfn

        def jfn(*args):
            return jitted.lower(*args).compile(
                compiler_options=compiler_options)(*args)
    tfn = make_train_step(cfg)
    tbatch = _port_batch(batch)
    out = {'jax': [], 'port': [], 'sizes': sizes,
           'port_cfgs': [[] for _ in port_cfgs], 'resumed': [None]}
    rst = None
    for n in range(steps):
        rng = np.array([1, n], np.uint32)
        draws = _jax_draws(G, {'params': jst.g_params,
                               'batch_stats': jst.g_batch_stats},
                           rng, batch, cfg.GAN.Z_DIM)
        jst, jm, jfakes = jfn(jst, batch, rng)
        jax_rec = {
            'metrics': {k: float(v) for k, v in jm.items()},
            'fakes': np.asarray(jfakes).transpose(0, 3, 1, 2),
            'g_stats': _stats(jax_generator_to_state_dict(
                {'params': jst.g_params, 'batch_stats': jst.g_batch_stats})),
            'd_stats': [_stats(jax_joint_d_to_state_dict(
                {'params': p, 'batch_stats': s}, size)) for p, s, size in
                zip(jst.d_params, jst.d_batch_stats, sizes)],
        }
        def port_step(fn, st):
            tm, tfakes = fn(st, tbatch, seed=n, draws=draws)
            rec = {
                'metrics': {k: float(v) for k, v in tm.items()},
                'fakes': tfakes.numpy(),
                'g_stats': _stats(st.G.state_dict()),
                'd_stats': [_stats(D.state_dict()) for D in st.Ds],
            }
            if n == 0:
                rec['g_mu'] = _moments(st.G, st.g_opt)
                rec['d_mu'] = [_moments(D, o)
                               for D, o in zip(st.Ds, st.d_opts)]
            return rec

        port_rec = port_step(tfn, tst)
        if n == 0 and steps > 1:
            rst = create_train_state(cfg, 'cpu', seed=1)
            with tempfile.TemporaryDirectory() as tmp:
                save_train_state(os.path.join(tmp, 'state_epoch0'), tst)
                restore_train_state(os.path.join(tmp, 'state_epoch0'), rst)
        elif n > 0:
            out['resumed'].append(port_step(tfn, rst))
        if n == 0:
            jax_rec['g_mu'] = jax_generator_to_state_dict(
                {'params': jst.g_opt_state[0].mu})
            jax_rec['d_mu'] = [jax_joint_d_to_state_dict(
                {'params': o[0].mu}, size)
                for o, size in zip(jst.d_opt_states, sizes)]
        out['jax'].append(jax_rec)
        out['port'].append(port_rec)
        for recs, (fn, st) in zip(out['port_cfgs'], extra):
            recs.append(port_step(fn, st))
    out['port_state'] = tst
    out['resumed_state'] = rst
    return out


def _tol(n):
    return STEP1 if n == 0 else STEP2


@pytest.mark.parametrize('n', range(STEPS))
def test_metrics_match_jax(runs, n):
    jm, tm = runs['jax'][n]['metrics'], runs['port'][n]['metrics']
    assert set(jm) == set(tm)
    for k, v in jm.items():
        np.testing.assert_allclose(tm[k], v, err_msg=k, **_tol(n))


@pytest.mark.parametrize('n', range(STEPS))
def test_batchnorm_statistics_match_jax(runs, n):
    j, t = runs['jax'][n], runs['port'][n]
    pairs = [(j['g_stats'], t['g_stats'])] + list(zip(j['d_stats'],
                                                      t['d_stats']))
    for want, got in pairs:
        assert set(want) == set(got) and want
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k,
                                       **_tol(n))


@pytest.mark.parametrize('n', range(STEPS))
def test_fakes_match_jax(runs, n):
    want, got = runs['jax'][n]['fakes'], runs['port'][n]['fakes']
    assert got.shape == want.shape == (B, 3, runs['sizes'][-1],
                                       runs['sizes'][-1])
    np.testing.assert_allclose(got, want, **_tol(n))


@pytest.mark.parametrize('net', ['G', 'D0', 'D1'])
def test_adam_first_moments_match_jax(runs, net):
    j, t = runs['jax'][0], runs['port'][0]
    if net == 'G':
        want, got = j['g_mu'], t['g_mu']
    else:
        want, got = j['d_mu'][int(net[1])], t['d_mu'][int(net[1])]
    assert set(want) == set(got) and want
    net_max = max(float(v.abs().max()) for v in want.values())
    for k, v in want.items():
        err = float(torch.linalg.vector_norm(got[k] - v))
        bound = MOMENT_RTOL * float(torch.linalg.vector_norm(v)) + \
            MOMENT_ATOL * net_max
        assert err <= bound, (k, err, bound)


def _flat(tree, prefix=''):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, '%s/%s' % (prefix, k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, '%s/%d' % (prefix, i))
    else:
        yield prefix, tree


@pytest.mark.parametrize('n', range(1, STEPS))
def test_resumed_step_is_bit_identical(runs, n):
    """save -> fresh state (seed 1) -> restore -> step equals the
    uninterrupted port step bit for bit, and JAX's within STEP2."""
    got, want, jax_rec = runs['resumed'][n], runs['port'][n], runs['jax'][n]
    assert got['metrics'] == want['metrics']
    np.testing.assert_array_equal(got['fakes'], want['fakes'])
    for g, w in zip([got['g_stats']] + got['d_stats'],
                    [want['g_stats']] + want['d_stats']):
        assert g.keys() == w.keys() and all(torch.equal(g[k], w[k])
                                            for k in w)
    for k, v in jax_rec['metrics'].items():
        np.testing.assert_allclose(got['metrics'][k], v, err_msg=k, **STEP2)
    np.testing.assert_allclose(got['fakes'], jax_rec['fakes'], **STEP2)
    for k, v in jax_rec['g_stats'].items():
        np.testing.assert_allclose(got['g_stats'][k].numpy(), v.numpy(),
                                   err_msg=k, **STEP2)


def test_resumed_state_is_bit_identical(runs):
    """After the last step, the resumed state equals the uninterrupted one:
    step, parameters, BatchNorm buffers, Adam moments and Adam steps."""
    want = dict(_flat(train_state_dict(runs['port_state'])))
    got = dict(_flat(train_state_dict(runs['resumed_state'])))
    assert got.keys() == want.keys()
    kinds = {k.split('/')[-1].split('.')[-1] for k in want}
    assert {'exp_avg', 'exp_avg_sq', 'step', 'running_mean'} <= kinds
    for k, v in want.items():
        if torch.is_tensor(v):
            assert v.dtype == got[k].dtype and torch.equal(v, got[k]), k
        else:
            assert v == got[k], k
    assert runs['resumed_state'].step == STEPS


def test_step_refuses_what_is_not_ported():
    for key, value, item in (('TPU_GROUPED_D', True, 'M13'),
                             ('TPU_REMAT_G', 'full', 'M14'),
                             ('TPU_GRAD_ACCUM', 2, 'M13'),
                             ('TPU_SUBPIXEL_UP', True, 'M14'),
                             ('DATASET_NAME', 'coco', 'M12')):
        cfg = small_cfg()
        setattr(cfg, key, value)
        with pytest.raises(NotImplementedError, match=item):
            make_train_step(cfg)


def test_step_accepts_the_kernel_switches():
    cfg = small_cfg()
    cfg.TPU_FUSED_BN_GLU = cfg.TPU_PALLAS_DW = True
    assert callable(make_train_step(cfg))
