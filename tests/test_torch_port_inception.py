"""The PyTorch port's InceptionV3 and its preprocessing, held to the JAX
package's on the CPU.

The three flavors' towers (slim, torch, fid) run the same weights (the
port's seeded random tower, BatchNorm drawn away from the identity) in the
JAX layout and through ``io_utils.weights.inception_from_flax``, at the
smallest
input that keeps every VALID layer non-empty (75 px) and at 299 px; every
preprocessing function runs the same uint8 or [-1, 1] images, upscaled
from 64, 128 and 256 px, downscaled from 320 px, and through the TF1
legacy resize. The bf16 towers, the in-training IS stream's, run against
JAX's bf16 tower, whole and block by block. Images are NHWC on the JAX
side and NCHW on the port's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text2img_ekl_tpu.models import inception_v3 as jinc
from text2img_ekl_tpu_torch.io_utils import weights
from text2img_ekl_tpu_torch.models import inception_v3 as tinc
from torch_port_threads import one_torch_thread  # noqa: F401

# pool_3 and logits: |d| <= 1e-4 max|ref| (float32 convolutions summed in
# another order); preprocessing: |d| <= 1e-5 on [-1, 1] values
TOWER_TOL = 1e-4
PRE_TOL = 1e-5
NUM_CLASSES = 51


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _set(tree, path, value):
    for p in path[:-1]:
        tree = tree[p]
    tree[path[-1]] = value


def _jax_layout(num_classes, flavor):
    """{path: shape} of the JAX tower's variables, traced, not compiled."""
    tree = jax.eval_shape(jinc.make_inception(num_classes, flavor).init,
                          jax.random.PRNGKey(0),
                          jnp.zeros((1, 299, 299, 3), jnp.float32))
    return {p: tuple(v.shape) for p, v in _flat(tree)}


@pytest.fixture(scope='module', params=['slim', 'torch', 'fid'])
def towers(request):
    """(flavor, JAX variables as numpy, the JAX apply, the port tower).
    The port's seeded random weights, with BatchNorm drawn away from the
    identity, go to the JAX layout (whose paths and shapes must be the JAX
    tower's) and come back through ``inception_from_flax``."""
    flavor = request.param
    sd = weights.random_inception(1, NUM_CLASSES, flavor)
    gen = torch.Generator().manual_seed(0)
    for k, v in sd.items():
        if k.endswith(('running_mean', 'bn.bias')):
            sd[k] = torch.randn(v.shape, generator=gen) * 0.1
        elif k.endswith(('running_var', 'bn.weight')):
            sd[k] = torch.rand(v.shape, generator=gen) + 0.5
    variables = weights.inception_to_flax(sd)
    assert {p: v.shape for p, v in _flat(variables)} == \
        _jax_layout(NUM_CLASSES, flavor)
    model = tinc.make_inception(NUM_CLASSES, flavor)
    model.load_state_dict(weights.inception_from_flax(variables, flavor))
    apply = jax.jit(jinc.make_inception(NUM_CLASSES, flavor).apply)
    return flavor, variables, apply, model.eval()


@pytest.mark.parametrize('size, batch', [(75, 3), (299, 2)])
def test_tower_matches_jax(towers, size, batch):
    flavor, variables, apply, model = towers
    x = np.random.default_rng(size).uniform(
        -1, 1, (batch, size, size, 3)).astype(np.float32)
    logits, ep = apply(variables, jnp.asarray(x))
    with torch.no_grad():
        t_logits, t_ep = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for name, ref, got in (('logits', logits, t_logits),
                           ('pool_3', ep['pool_3'], t_ep['pool_3']),
                           ('mixed_17x17x768e', ep['mixed_17x17x768e'],
                            t_ep['mixed_17x17x768e'].permute(0, 2, 3, 1))):
        ref = np.asarray(ref)
        err = np.abs(got.numpy() - ref).max()
        assert err <= TOWER_TOL * np.abs(ref).max(), (flavor, name, err)


def test_flavors_differ_where_they_should():
    """At 139 px (a 3x3 grid in the last blocks) the border-inclusive
    pools (torch) and the mixed_10 max pool (fid) change pool_3 against
    slim on the same weights: the switches are live, not decorations."""
    sd = weights.random_inception(7, 51, 'torch')
    pool3 = {}
    x = torch.rand(1, 3, 139, 139) * 2 - 1
    for flavor in ('slim', 'torch', 'fid'):
        model = tinc.make_inception(51, flavor)
        model.load_state_dict({k: v for k, v in sd.items()
                               if k in model.state_dict()})
        with torch.no_grad():
            pool3[flavor] = model.eval()(x)[1]['pool_3']
    assert (pool3['slim'] - pool3['torch']).abs().max() > 1e-4
    assert (pool3['slim'] - pool3['fid']).abs().max() > 1e-4


def test_weights_bridge_round_trips():
    """inception_from_flax(inception_to_flax(sd)) == sd, bit for bit, and
    a tree of another flavor is refused."""
    sd = weights.random_inception(2, 7, 'torch')
    back = weights.inception_from_flax(weights.inception_to_flax(sd),
                                       'torch')
    assert list(back) == list(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    with pytest.raises(KeyError, match='not a .slim. tower'):
        weights.inception_from_flax(weights.inception_to_flax(sd), 'slim')


def test_random_inception_is_seeded_and_shared_by_flavors():
    a = weights.random_inception(7, 51, 'slim')
    b = weights.random_inception(7, 1008, 'fid')
    c = weights.random_inception(8, 51, 'slim')
    t = weights.random_inception(7, 1000, 'torch')
    for k, v in a.items():
        if k.startswith('logits'):
            continue
        assert torch.equal(v, b[k]) and torch.equal(v, t[k])
    assert not torch.equal(a['conv0.conv.weight'], c['conv0.conv.weight'])
    assert set(t) - set(a) == {k.replace('bias', 'weight')
                               for k in a if k.endswith('bn.bias')}
    model = tinc.make_inception(51)
    model.load_state_dict(a, strict=True)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize('h, w', [(64, 64), (128, 128), (256, 256),
                                  (320, 320), (320, 200), (299, 299)])
def test_preprocessing_matches_jax(h, w):
    """jax.image.resize's bilinear (half-pixel centres; antialiased where
    an axis shrinks) and the frozen graph's TF1 resize + normalisation."""
    rng = np.random.default_rng(h * 1000 + w)
    u8 = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    pm1 = rng.uniform(-1, 1, (2, h, w, 3)).astype(np.float32)
    cases = ((jinc.preprocess_uint8, tinc.preprocess_uint8, u8),
             (jinc.preprocess_frozen, tinc.preprocess_frozen, u8),
             (jinc.preprocess_gan_output, tinc.preprocess_gan_output, pm1))
    for jfn, tfn, x in cases:
        ref = np.asarray(jfn(jnp.asarray(x)))
        got = _nhwc(tfn(_nchw(x)))
        assert got.shape == ref.shape == (2, 299, 299, 3)
        assert np.abs(got - ref).max() <= PRE_TOL, (jfn.__name__, h, w)


@pytest.mark.parametrize('size', [(299, 299), (37, 311), (64, 64)])
def test_tf1_resize_matches_jax(size):
    x = np.random.default_rng(3).uniform(
        -1, 1, (2, 100, 90, 3)).astype(np.float32)
    ref = np.asarray(jinc.resize_bilinear_tf1(jnp.asarray(x), size))
    got = _nhwc(tinc.resize_bilinear_tf1(_nchw(x), size))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= PRE_TOL


# the bf16 towers (the in-training IS stream's), against JAX's compiled
# with xla_allow_excess_precision off, so that every bf16 op rounds as the
# port's eager ops do. Block by block, each fed JAX's own input and given
# JAX's rounding of the branch pool: at least 95 % of the outputs
# bit-identical (measured 97.3 % or more; 90.5 % or more with the port's
# own pool; a block that kept float32 or rounded elsewhere would share
# almost none); the
# whole tower: pool_3 and logits within 2e-2 of max|ref| (measured 1.0e-2
# to 1.3e-2 at 75 px; JAX's bf16 tower sits 0.8e-2 to 1.4e-2 from its own
# float32 one, and its default compile 0.9e-2 to 1.4e-2 from the strict)
BF16_SAME = 0.95
BF16_TOWER_TOL = 2e-2
_BLOCKS = ('conv0', 'conv1', 'conv2', 'conv3', 'conv4',
           'mixed_35x35x256a', 'mixed_35x35x288a', 'mixed_35x35x288b',
           'mixed_17x17x768a', 'mixed_17x17x768b', 'mixed_17x17x768c',
           'mixed_17x17x768d', 'mixed_17x17x768e', 'mixed_8x8x1280a',
           'mixed_8x8x2048a', 'mixed_8x8x2048b')


def _xla_cpu_branch_pool(x, torch_pool):
    """The branch pool as JAX's bf16 tower computes it on XLA:CPU: the
    3x3 window summed in bf16, rounding after every add in row-major
    order, then divided (by 9 in bf16, or by the cells in the window in
    float32 and cast to bf16 by the next conv). The port sums the window
    in float32 and rounds once, which moves 35-87 % of the pool's outputs
    by an ulp."""
    import torch.nn.functional as F
    h, w = x.shape[2:]
    pad = F.pad(x, (1, 1, 1, 1))
    total = torch.zeros_like(x)
    for i in range(3):
        for j in range(3):
            total = total + pad[:, :, i:i + h, j:j + w]
    if torch_pool:
        return total / 9
    ones = F.pad(torch.ones(1, 1, h, w), (1, 1, 1, 1))
    cells = sum(ones[:, :, i:i + h, j:j + w]
                for i in range(3) for j in range(3))
    return (total.float() / cells).to(x.dtype)


def test_bf16_tower_matches_jax(towers, monkeypatch):
    flavor, variables, _, _ = towers
    x = np.random.default_rng(75).uniform(
        -1, 1, (2, 75, 75, 3)).astype(np.float32)
    jm = jinc.make_inception(NUM_CLASSES, flavor, dtype=jnp.bfloat16)
    run = jax.jit(lambda v, a: jm.apply(v, a, capture_intermediates=True,
                                        mutable=['intermediates']))
    (logits, ep), st = run.lower(variables, jnp.asarray(x)).compile(
        compiler_options={'xla_allow_excess_precision': False})(
        variables, jnp.asarray(x))
    inter = st['intermediates']
    model = tinc.make_inception(NUM_CLASSES, flavor, dtype=torch.bfloat16)
    model.load_state_dict(weights.inception_from_flax(variables, flavor))
    model.eval()
    with torch.no_grad():
        t_logits, t_ep = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for name, ref, got in (('logits', logits, t_logits),
                           ('pool_3', ep['pool_3'], t_ep['pool_3'])):
        ref = np.asarray(ref)
        assert got.dtype == torch.float32 and ref.dtype == np.float32
        err = np.abs(got.numpy() - ref).max()
        assert err <= BF16_TOWER_TOL * np.abs(ref).max(), (flavor, name, err)

    def nchw(a):
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).permute(
            0, 3, 1, 2).to(torch.bfloat16)

    monkeypatch.setattr(tinc, '_branch_pool', _xla_cpu_branch_pool)
    prev = nchw(jnp.asarray(x).astype(jnp.bfloat16))
    with torch.no_grad():
        for name in _BLOCKS:
            if name in ('conv3', 'mixed_35x35x256a'):
                prev = tinc._max_pool(prev)
            got = getattr(model, name)(prev)
            ref = nchw(inter[name]['__call__'][0])
            assert got.dtype == torch.bfloat16
            same = (got == ref).float().mean().item()
            assert same >= BF16_SAME, (flavor, name, same)
            prev = ref
        # pool_3 rounds to bf16 before it widens, as jnp.mean of bf16 does
        pool3 = prev.mean((2, 3)).float()
        assert torch.equal(pool3, torch.from_numpy(np.asarray(ep['pool_3'])))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_float32_tower_turns_tf32_off(dtype, monkeypatch):
    """Under PyTorch's defaults cuDNN runs float32 convolutions in TF32: a
    float32 tower turns TF32 off for its forward and the resize's products
    and gives the process its settings back; a bf16 tower leaves them."""
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', True)
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision('high')
    seen = []
    try:
        model = tinc.make_inception(7, dtype=dtype).eval()
        for m in (model.conv0.conv, model.logits):
            m.register_forward_hook(lambda *_: seen.append(
                (torch.backends.cudnn.allow_tf32,
                 torch.get_float32_matmul_precision())))
        real = tinc._on_device
        monkeypatch.setattr(tinc, '_on_device', lambda *a: seen.append(
            (torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())) or real(*a))
        with torch.no_grad():
            model(tinc.preprocess_gan_output(torch.zeros(1, 3, 64, 64)))
        after = (torch.backends.cudnn.allow_tf32,
                 torch.get_float32_matmul_precision())
    finally:
        torch.set_float32_matmul_precision(precision)
    resize = [(False, 'highest')] * 2
    if dtype == torch.float32:
        assert seen == resize + [(False, 'highest')] * 2
    else:
        assert seen == resize + [(True, 'high')] * 2
    assert after == (True, 'high')


def test_bf16_tower_casts_as_flax_does():
    """A bf16 tower runs its convs in bf16 and returns float32 pool_3 and
    logits near the float32 tower's."""
    sd = weights.random_inception(7, 51)
    f32 = tinc.make_inception(51)
    bf16 = tinc.make_inception(51, dtype=torch.bfloat16)
    f32.load_state_dict(sd)
    bf16.load_state_dict(sd)
    assert bf16.conv0.conv.weight.dtype == torch.bfloat16
    assert bf16.conv0.bn.running_var.dtype == torch.float32
    x = torch.rand(2, 3, 75, 75) * 2 - 1
    with torch.no_grad():
        a, ea = f32.eval()(x)
        b, eb = bf16.eval()(x)
    assert b.dtype == eb['pool_3'].dtype == torch.float32
    assert eb['mixed_17x17x768e'].dtype == torch.bfloat16
    # bf16 keeps 8 bits of mantissa through 94 convs: a few percent
    assert (a - b).abs().max() <= 5e-2 * a.abs().max()
