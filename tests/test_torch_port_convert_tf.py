"""The PyTorch port's readers of TensorFlow's weight files and its name
maps, held to the JAX package's on the CPU.

A TF-slim checkpoint is written by ``tf.compat.v1.train.Saver`` in the
format the fine-tuned IS model ships in (the vendored slim tower's scopes,
EMA shadows holding the weights and zeros in the raw slots, a
``global_step``), and a frozen graph by ``tools/fabricate_frozen_pb.py``
(loaded by path). The port's pure-Python readers must return what the
JAX package's TensorFlow-based loaders return, key for key and bit for
bit, also with ``tensorflow`` and ``google.protobuf`` blocked from import;
the converted towers must agree with JAX's converted towers, and the
fabricated graph's own pool_3 and softmax when TensorFlow runs it. The
torchvision map runs a state dict under torchvision's key names.
"""

import hashlib
import importlib.util
import os
import shutil
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

tf = pytest.importorskip('tensorflow')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from text2img_ekl_tpu.eval import convert_tf as jconv  # noqa: E402
from text2img_ekl_tpu.eval.inception_score import \
    InceptionScorer as JInceptionScorer  # noqa: E402
from text2img_ekl_tpu.models import inception_v3 as jinc  # noqa: E402
from text2img_ekl_tpu_torch.eval import convert_tf as tconv  # noqa: E402
from text2img_ekl_tpu_torch.eval import tf_files  # noqa: E402
from text2img_ekl_tpu_torch.io_utils import weights  # noqa: E402
from text2img_ekl_tpu_torch.models import inception_v3 as tinc  # noqa: E402
from torch_port_threads import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_CLASSES = 51
# converted towers: pool_3 and logits |d| <= 1e-4 max|ref| (float32 convs
# in another order); against TensorFlow running the graph, the same bar
TOWER_TOL = 1e-4


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _assert_same_dicts(got, want):
    """Key for key, dtype, shape and bytes (object arrays by value)."""
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if w.dtype == object:
            assert g.tolist() == w.tolist(), k
        else:
            assert g.tobytes() == w.tobytes(), k


@pytest.fixture(scope='module')
def slim_ckpt(tmp_path_factory):
    """(checkpoint prefix, the tower's variables in the JAX layout)."""
    sd = weights.random_inception(3, NUM_CLASSES, 'slim')
    gen = torch.Generator().manual_seed(1)
    for k, v in sd.items():
        if k.endswith(('running_mean', 'bn.bias')):
            sd[k] = torch.randn(v.shape, generator=gen) * 0.1
        elif k.endswith('running_var'):
            sd[k] = torch.rand(v.shape, generator=gen) + 0.5
    variables = weights.inception_to_flax(sd)
    entries = {'global_step': np.int64(12345)}
    for path, value in _flat(variables):
        name = jconv._flax_path_to_slim(path)
        if path[0] == 'params':   # trainable: the EMA shadow holds it
            entries[name] = np.zeros_like(value)
            entries[name + '/ExponentialMovingAverage'] = value
        else:
            entries[name] = value
    prefix = str(tmp_path_factory.mktemp('slim') / 'model.ckpt')
    with tf.Graph().as_default():
        var_list = {name: tf.Variable(val, name='v%d' % i)
                    for i, (name, val) in enumerate(entries.items())}
        saver = tf.compat.v1.train.Saver(var_list=var_list)
        with tf.compat.v1.Session() as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            saver.save(sess, prefix)
    return prefix, variables


@pytest.fixture(scope='module')
def frozen_pb(tmp_path_factory):
    """(pb path, softmax tensor name) of the fabricated 2015 graph."""
    spec = importlib.util.spec_from_file_location(
        'fabricate_frozen_pb', os.path.join(REPO, 'tools',
                                            'fabricate_frozen_pb.py'))
    fab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fab)
    path = str(tmp_path_factory.mktemp('pb') / 'classify_image_graph_def.pb')
    return path, fab.write_frozen_pb(path, seed=0)


def test_slim_reader_matches_jax(slim_ckpt):
    prefix, variables = slim_ckpt
    got = tconv.load_slim_checkpoint(prefix, NUM_CLASSES)
    _assert_same_dicts(got, jconv.load_slim_checkpoint(prefix, NUM_CLASSES))
    # the EMA shadows won over the zeroed raw slots
    assert got['conv0/weights'].tobytes() == \
        variables['params']['conv0']['Conv_0']['kernel'].tobytes()
    raw = tconv.load_slim_checkpoint(prefix, NUM_CLASSES, use_ema=False)
    _assert_same_dicts(raw, jconv.load_slim_checkpoint(
        prefix, NUM_CLASSES, use_ema=False))
    assert not raw['conv0/weights'].any()


def test_frozen_reader_matches_jax(frozen_pb):
    path, _ = frozen_pb
    got = tconv.load_frozen_graph_weights(path)
    _assert_same_dicts(got, jconv.load_frozen_graph_weights(path))
    assert got['softmax/weights'].shape == (2048, 1008)


def test_const_decoding_matches_make_ndarray(tmp_path):
    """Consts of every dtype and value field tf.make_ndarray reads, from
    tensor_content and from the repeated *_val fields (the last value
    repeated to fill the shape, empty fields as zeros), and a
    BatchNormWithGlobalNormalization node that says gamma is not applied.
    """
    consts = {
        'f': np.arange(6, dtype=np.float32).reshape(2, 3),
        'd': np.float64(-2.5), 'i': np.array([-3, 4], np.int32),
        'i8': np.array([-7, 2 ** 40], np.int64),
        'u8': np.array([0, 255], np.uint8), 'h': np.float16(1.5),
        'b': np.array([True, False]),
        'c': np.array([1 + 2j], np.complex64),
        's': np.array([b'ab', b''], dtype=object),
        'u32': np.array([2 ** 32 - 1], np.uint32)}
    g = tf.compat.v1.GraphDef()
    for name, value in consts.items():
        n = g.node.add()
        n.name, n.op = name, 'Const'
        n.attr['value'].tensor.CopyFrom(tf.make_tensor_proto(value))
    for name, dtype, shape, field, vals in (
            ('fill_f', 1, [2, 3], 'float_val', [1.5, -2.0]),
            ('fill_i', 3, [4], 'int_val', [-9]),
            ('fill_s', 7, [3], 'string_val', [b'x']),
            ('zeros', 1, [2, 2], None, []),
            ('scalar_h', 19, [], 'half_val', [0x3C00])):
        n = g.node.add()
        n.name, n.op = name, 'Const'
        t = n.attr['value'].tensor
        t.dtype = dtype
        for s in shape:
            t.tensor_shape.dim.add().size = s
        if field:
            getattr(t, field).extend(vals)
    bn = g.node.add()
    bn.name, bn.op = 'bn', 'BatchNormWithGlobalNormalization'
    bn.attr['scale_after_normalization'].b = False
    g.node.add(name='input', op='Placeholder')
    path = tmp_path / 'g.pb'
    path.write_bytes(g.SerializeToString())
    got = tconv.load_frozen_graph_weights(str(path))
    _assert_same_dicts(got, jconv.load_frozen_graph_weights(str(path)))
    assert bool(got['__scale_after_normalization__']) is False
    assert got['fill_f'].tolist() == [[1.5, -2.0, -2.0], [-2.0, -2.0, -2.0]]


def _jax_tower(variables, flavor, num_classes, x_nhwc):
    logits, ep = jax.jit(jinc.make_inception(num_classes, flavor).apply)(
        variables, jnp.asarray(x_nhwc))
    return np.asarray(logits), np.asarray(ep['pool_3'])


def _port_tower(sd, flavor, num_classes, x_nhwc):
    model = tinc.make_inception(num_classes, flavor)
    model.load_state_dict(sd)
    with torch.no_grad():
        logits, ep = model.eval()(torch.from_numpy(x_nhwc).permute(
            0, 3, 1, 2))
    return logits.numpy(), ep['pool_3'].numpy()


def _close(got, ref, tol=TOWER_TOL):
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def test_converted_slim_tower_matches_jax(slim_ckpt):
    prefix, variables = slim_ckpt
    tf_vars = tconv.load_slim_checkpoint(prefix, NUM_CLASSES)
    template = tconv.flax_template(NUM_CLASSES, 'slim')
    got = tconv.slim_vars_to_flax(tf_vars, template)
    want = jconv.slim_vars_to_flax(tf_vars, template)
    _assert_same_dicts(dict(_flat(got)), dict(_flat(want)))
    _assert_same_dicts(dict(_flat(got)), dict(_flat(variables)))
    x = np.random.default_rng(0).uniform(
        -1, 1, (2, 299, 299, 3)).astype(np.float32)
    ref = _jax_tower(want, 'slim', NUM_CLASSES, x)
    out = _port_tower(weights.inception_from_flax(got), 'slim', NUM_CLASSES,
                      x)
    for g, r in zip(out, ref):
        _close(g, r)


def test_converted_frozen_tower_matches_jax_and_the_graph(frozen_pb):
    """The port's 'fid' tower on the converted graph, behind the frozen
    input chain, against JAX's converted tower and against TensorFlow
    running the fabricated graph itself on 0..255 pixels at 'ExpandDims'.
    """
    path, softmax_name = frozen_pb
    sd, n = tconv.frozen_pb_to_inception(path)
    assert n == 1008
    consts = jconv.load_frozen_graph_weights(path)
    want = jconv.frozen_graph_to_flax(consts, tconv.flax_template(n, 'fid'))
    _assert_same_dicts(dict(_flat(weights.inception_to_flax(sd))),
                       dict(_flat(want)))
    pix = np.random.default_rng(1).uniform(
        0, 255, (2, 80, 96, 3)).astype(np.float32)
    x = np.asarray(jinc.preprocess_frozen(jnp.asarray(pix)))
    ref_logits, ref_pool3 = _jax_tower(want, 'fid', n, x)
    t_x = tinc.preprocess_frozen(torch.from_numpy(pix).permute(0, 3, 1, 2))
    logits, pool3 = _port_tower(sd, 'fid', n,
                                t_x.permute(0, 2, 3, 1).numpy())
    _close(logits, ref_logits)
    _close(pool3, ref_pool3)
    graph_def = tf.compat.v1.GraphDef()
    with open(path, 'rb') as f:
        graph_def.ParseFromString(f.read())
    with tf.Graph().as_default() as g:
        tf.import_graph_def(graph_def, name='')
        with tf.compat.v1.Session(graph=g) as sess:
            tf_pool3, tf_sm = sess.run(['pool_3:0', softmax_name],
                                       {'ExpandDims:0': pix})
    _close(pool3, tf_pool3.reshape(2, -1))
    sm = torch.softmax(torch.from_numpy(logits), -1).numpy()
    assert np.abs(sm - tf_sm).max() <= 1e-5


def _digest(tree) -> str:
    h = hashlib.sha256()
    for k in sorted(tree):
        h.update(k.encode())
        h.update(np.ascontiguousarray(tree[k]).tobytes())
    return h.hexdigest()


def test_readers_need_neither_tensorflow_nor_protobuf(slim_ckpt,
                                                      frozen_pb):
    """A fresh interpreter with tensorflow, google.protobuf and JAX
    blocked from import reads both files to the same bytes."""
    prefix, _ = slim_ckpt
    path, _ = frozen_pb
    code = (
        "import sys, hashlib, numpy as np\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('tensorflow', 'jax', 'flax') or "
        "name.startswith('google.protobuf'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from text2img_ekl_tpu_torch.eval import convert_tf as c\n"
        "def digest(t):\n"
        "    h = hashlib.sha256()\n"
        "    for k in sorted(t):\n"
        "        h.update(k.encode())\n"
        "        h.update(np.ascontiguousarray(t[k]).tobytes())\n"
        "    return h.hexdigest()\n"
        "print(digest(c.load_slim_checkpoint(sys.argv[1])))\n"
        "print(digest(c.load_frozen_graph_weights(sys.argv[2])))\n"
        "sd, n = c.frozen_pb_to_inception(sys.argv[2])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('tensorflow', 'jax') or m.startswith('google.protobuf'))\n"
        "print(n, bad)\n")
    env = dict(os.environ, OMP_NUM_THREADS='1')
    proc = subprocess.run([sys.executable, '-c', code, prefix, path],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.split('\n')
    assert lines[0] == _digest(jconv.load_slim_checkpoint(prefix))
    assert lines[1] == _digest(jconv.load_frozen_graph_weights(path))
    assert lines[2] == '1008 []'


def test_reader_refusals(slim_ckpt, tmp_path):
    """A missing file, a V1 single-file checkpoint, a Snappy-compressed
    block and a corrupted block each raise and say which."""
    prefix, _ = slim_ckpt
    with pytest.raises(FileNotFoundError, match='TF-slim checkpoint'):
        tconv.load_slim_checkpoint(str(tmp_path / 'nothing'))
    v1 = tmp_path / 'model.ckpt-1'
    v1.write_bytes(b'\0' * 64)
    with pytest.raises(ValueError, match='V1'):
        tconv.load_slim_checkpoint(str(v1))
    copy = str(tmp_path / 'copy.ckpt')
    for suffix in ('.index', '.data-00000-of-00001'):
        shutil.copy(prefix + suffix, copy + suffix)
    data = bytearray(open(copy + '.index', 'rb').read())
    # the index block's trailer: its handle is the footer's second one
    footer = data[-48:]
    _, p = tf_files._varint(footer, 0)
    _, p = tf_files._varint(footer, p)
    off, p = tf_files._varint(footer, p)
    size, _ = tf_files._varint(footer, p)
    assert data[off + size] == 0   # TensorFlow wrote it uncompressed
    snappy = bytearray(data)
    snappy[off + size] = 1
    open(copy + '.index', 'wb').write(snappy)
    with pytest.raises(NotImplementedError, match='Snappy'):
        tconv.load_slim_checkpoint(copy)
    corrupt = bytearray(data)
    corrupt[off] ^= 0xFF
    open(copy + '.index', 'wb').write(corrupt)
    with pytest.raises(ValueError, match='CRC32C'):
        tconv.load_slim_checkpoint(copy)
    crc, = struct.unpack_from('<I', data, off + size + 1)
    assert tf_files._unmask(crc) == tf_files.crc32c(data[off:off + size + 1])


def test_torchvision_map_matches_jax():
    """A state dict under torchvision's inception_v3 key names (with the
    aux head and the BatchNorm counters it carries, which the map skips)
    -> the same 'torch'-flavor tree as the JAX package's map."""
    sd = weights.random_inception(5, 1000, 'torch')
    gen = torch.Generator().manual_seed(2)
    tv = {}
    for key, value in sd.items():
        head, rest = key.split('.', 1)
        name = '%s.%s' % (tconv._TORCHVISION_TOP[head], rest)
        tv[name] = torch.randn(value.shape, generator=gen)
        if rest.endswith('bn.running_var'):
            tv[name].abs_()
            tv[name.replace('running_var', 'num_batches_tracked')] = \
                torch.tensor(3)
    tv['AuxLogits.fc.weight'] = torch.zeros(1000, 768)
    template = tconv.flax_template(1000, 'torch')
    got = tconv.torchvision_state_to_flax(tv, template)
    want = jconv.torchvision_state_to_flax(
        {k: v.numpy() for k, v in tv.items()}, template)
    _assert_same_dicts(dict(_flat(got)), dict(_flat(want)))
    port = weights.inception_from_flax(got, 'torch')
    assert torch.equal(port['conv0.conv.weight'],
                       tv['Conv2d_1a_3x3.conv.weight'])
    assert torch.equal(port['logits.weight'], tv['fc.weight'])


def test_cli_scores_a_converted_checkpoint(slim_ckpt, tmp_path, capsys):
    """inception_score_torch with --checkpoint_dir prints the IS that the
    JAX package's scorer gives on the JAX-converted weights."""
    import inception_score_torch
    prefix, _ = slim_ckpt
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (6, 64, 64, 3), dtype=np.uint8)
    from PIL import Image
    for i, img in enumerate(images):
        Image.fromarray(img).save(tmp_path / ('%d.png' % i))
    inception_score_torch.main(['--image_folder', str(tmp_path),
                                '--checkpoint_dir', prefix, '--splits', '2',
                                '--device', 'cpu'])
    out = capsys.readouterr().out
    assert 'random' not in out and 'images: 6' in out
    jvars = jconv.slim_vars_to_flax(
        jconv.load_slim_checkpoint(prefix, NUM_CLASSES),
        tconv.flax_template(NUM_CLASSES, 'slim'))
    mean, std = JInceptionScorer(jvars, NUM_CLASSES).score_images(images, 2)
    assert printed_is(out) == pytest.approx((mean, std), abs=PRINT_TOL)


# the CLIs print IS and FID with 4 decimals: the printed value is within
# half a unit of the last digit (5e-5) and 1e-6 of JAX's
PRINT_TOL = 5e-5 + 1e-6


def printed_is(out):
    line = [ln for ln in out.splitlines() if ln.startswith('IS: ')][-1]
    mean, std = line[4:].split(' +- ')
    return float(mean), float(std)
