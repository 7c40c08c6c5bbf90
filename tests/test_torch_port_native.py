"""The port's native host paths on the CPU: the batch JPEG decode pipeline
(``csrc/dataloader.cpp``, ``data/native_loader.py``,
``TextDataset.batch_items``, the loader's native branch) and the async PNG
writer (``csrc/imagewriter.cpp``, ``io_utils/native_writer.py``,
``save_single_images``, ``evaluate``'s flush).

The decoder is held bit for bit to the JAX package's: its library is built
from the JAX package's own ``native/dataloader.cpp`` into a temporary
directory (the JAX binding's ``_SO`` and ``_lib`` patched in memory only),
and the two ``TextDataset.batch_items`` must give the same keys, wrong
keys, captions, classes and pixels, float32 and uint8, train and test
pairs, with and without CUB bounding boxes, at two seeds. The writer must
give the JAX package's file names and pixels (the JAX side through PIL).
Tests skip only where this host has no g++, or no header or library that
a native source needs (``ops/_build.py::host_probe``).
"""

import os
import pickle
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

import text2img_ekl_tpu.data.native_loader as jnative
from text2img_ekl_tpu.data import datasets as jdatasets
from text2img_ekl_tpu.io_utils import images as jimages
from text2img_ekl_tpu_torch.config import cfg_from_file
from text2img_ekl_tpu_torch.data import DataLoader, TextDataset
from text2img_ekl_tpu_torch.data import datasets as tdatasets
from text2img_ekl_tpu_torch.data import transforms as tT
from text2img_ekl_tpu_torch.data.native_loader import (NativeDecoder,
                                                       NativeUnavailable)
from text2img_ekl_tpu_torch.io_utils import images as timages
from text2img_ekl_tpu_torch.io_utils import native_writer
from text2img_ekl_tpu_torch.ops import _build
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL_CFG = os.path.join(REPO, 'cfg',
                        'birds_2stg_splitz_cap_ca_eval.realcls.yml')
# base 16, two branches: 16 and 32 px pyramids, oversize 38
BASE, BRANCHES = 16, 2
N_IMAGES = 6


@pytest.fixture(scope='module')
def probe():
    return _build.host_probe()


def _require(probe, header):
    if probe['g++'] is None:
        pytest.skip('this host has no g++')
    lib = 'lib' + dict(_build.HOST_DEPS.values())[header]
    missing = [what for what, ok in ((header, probe['headers'][header]),
                                     (lib, probe['libraries'][lib]))
               if not ok]
    if missing:
        pytest.skip('g++ finds no %s here' % ' and no '.join(missing))


@pytest.fixture(scope='module')
def decoder_ok(probe):
    _require(probe, 'jpeglib.h')


@pytest.fixture(scope='module')
def writer_ok(probe):
    _require(probe, 'png.h')


def _write_pickle(path, obj):
    with open(path, 'wb') as f:
        pickle.dump(obj, f, protocol=2)


def _noise_jpeg(path, i):
    rng = np.random.default_rng(i)
    arr = rng.integers(0, 255, (90 + i * 7, 120 + i * 5, 3), dtype=np.uint8)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path, quality=95)


def _fabricate(root, bbox):
    """N_IMAGES noise JPEGs with their pickles, train and test splits: a
    CUB layout with images.txt and bounding_boxes.txt under a 'birds'
    directory, or the plain <DATA_DIR>/<key>.jpg layout."""
    names = ['%03d.C%d/img_%d' % (i % 3 + 1, i % 3, i)
             for i in range(N_IMAGES)]
    if bbox:
        cub = os.path.join(root, 'CUB_200_2011')
        os.makedirs(cub)
        with open(os.path.join(cub, 'images.txt'), 'w') as f:
            f.writelines('%d %s.jpg\n' % (i + 1, n)
                         for i, n in enumerate(names))
        with open(os.path.join(cub, 'bounding_boxes.txt'), 'w') as f:
            f.writelines('%d %.1f %.1f %.1f %.1f\n'
                         % (i + 1, 4 + 3 * i, 6 + i, 70 - 2 * i, 55 + i)
                         for i in range(N_IMAGES))
        image_dir = os.path.join(cub, 'images')
    else:
        image_dir = root
    for i, n in enumerate(names):
        _noise_jpeg(os.path.join(image_dir, n + '.jpg'), i)
    emb = np.random.default_rng(1).standard_normal(
        (N_IMAGES, 10, 8)).astype(np.float32)
    for split in ('train', 'test'):
        os.makedirs(os.path.join(root, split))
        _write_pickle(os.path.join(root, split, 'filenames.pickle'), names)
        _write_pickle(os.path.join(root, split,
                                   'char-CNN-RNN-embeddings.pickle'), emb)
        _write_pickle(os.path.join(root, split, 'class_info.pickle'),
                      [i % 3 + 1 for i in range(N_IMAGES)])
    return root


@pytest.fixture(scope='module')
def data_dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp('native_data')
    return {True: _fabricate(str(base / 'birds'), bbox=True),
            False: _fabricate(str(base / 'flowers'), bbox=False)}


@pytest.fixture(scope='module')
def jax_decoder_lib(tmp_path_factory, decoder_ok):
    """The JAX package's decoder library, built from its untouched
    native/dataloader.cpp into a temporary directory: the binding's _SO
    and _lib are patched in memory and restored at teardown."""
    so = tmp_path_factory.mktemp('jax_native') / 'libt2i_dataloader.so'
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, '_SO', str(so))
        mp.setattr(jnative, '_lib', None)
        jnative.get_lib()
        assert so.exists()
        yield


def _recording(dataset, calls):
    """Record the paths each decode_batch of ``dataset`` is handed."""
    dec = dataset._native_decoder()
    real = dec.decode_batch

    def decode_batch(paths, **kw):
        calls.append(list(paths))
        return real(paths, **kw)

    dec.decode_batch = decode_batch


def _assert_batches_equal(ours, ref):
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        if isinstance(v, tuple):
            assert len(ours[k]) == len(v)
            for a, b in zip(ours[k], v):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b, err_msg=k)
        elif isinstance(v, list):
            assert ours[k] == v
        else:
            assert ours[k].dtype == v.dtype
            np.testing.assert_array_equal(ours[k], v, err_msg=k)


@pytest.mark.parametrize('seed', [0, 5])
@pytest.mark.parametrize('bbox', [True, False], ids=['bbox', 'no_bbox'])
@pytest.mark.parametrize('uint8', [False, True], ids=['float32', 'uint8'])
@pytest.mark.parametrize('split', ['train', 'test'])
def test_batch_items_bit_for_bit_with_jax(jax_decoder_lib, data_dirs, split,
                                          uint8, bbox, seed):
    train = split == 'train'
    kw = dict(base_size=BASE, branch_num=BRANCHES, entity_dim=20,
              train_pairs=train, seed=seed, native_decode=True,
              uint8_output=uint8)
    ours = TextDataset(data_dirs[bbox], split, **kw)
    ref = jdatasets.TextDataset(data_dirs[bbox], split, **kw)
    assert (ours.bbox is None) == (not bbox)
    ours_paths, ref_paths = [], []
    _recording(ours, ours_paths)
    _recording(ref, ref_paths)
    for b, idx in enumerate(([3, 0, 5, 1], [2, 4, 3, 3])):
        batch_seed = seed + (1 << 20) + b  # the loader's (epoch 1, batch b)
        got = ours.batch_items(np.asarray(idx), seed=batch_seed)
        want = ref.batch_items(np.asarray(idx), seed=batch_seed)
        _assert_batches_equal(got, want)
        # the keys and the wrong keys the decoder was handed
        assert ours_paths[-1] == ref_paths[-1]
        assert len(ours_paths[-1]) == (2 if train else 1) * len(idx)
        assert got['imgs'][-1].shape == (4, 32, 32, 3)
    assert ours.rng.bit_generator.state == ref.rng.bit_generator.state
    assert ours.native_batches == 2


def test_native_eval_crop_close_to_pil(decoder_ok, data_dirs):
    """Eval mode (no randomness): the native pipeline within the JAX
    package's own bar of the PIL pipeline (tests/test_native_loader.py),
    mean |d| < 0.1 on [-1, 1] pixels."""
    path = os.path.join(data_dirs[False], '001.C0/img_0.jpg')
    outs = NativeDecoder([32, 64], num_threads=1).decode_batch(
        [path], train=False, seed=0)
    img = tT.build_eval_transform(64)(Image.open(path).convert('RGB'))
    ref = tT.multiscale_pyramid(img, [32, 64])
    for got, want in zip(outs, ref):
        diff = np.abs(got[0] - want).mean()
        assert diff < 0.1, diff


@pytest.mark.parametrize('uint8', [False, True], ids=['float32', 'uint8'])
def test_loader_native_branch_zero_fills_a_missing_file(
        decoder_ok, data_dirs, tmp_path, capsys, uint8):
    root = str(tmp_path / 'flowers')
    shutil.copytree(data_dirs[False], root)
    os.remove(os.path.join(root, '003.C2/img_2.jpg'))
    kw = dict(base_size=BASE, branch_num=BRANCHES, train_pairs=False,
              native_decode=True, uint8_output=uint8)
    ds = TextDataset(root, 'test', **kw)
    loader = DataLoader(ds, 3, shuffle=False, num_workers=1, seed=11)
    batches = list(loader)
    assert len(batches) == 2 and ds.native_batches == 2
    assert '!! native decoder: 1/3 images failed' in capsys.readouterr().out
    fill = 128 if uint8 else 0.0
    for level in batches[0]['imgs']:
        assert level.dtype == (np.uint8 if uint8 else np.float32)
        assert (level[2] == fill).all()
        assert not (level[:2] == fill).all()
    # the loader's seed for (epoch 0, batch b) is seed + b
    again = TextDataset(root, 'test', **kw)
    for b, batch in enumerate(batches):
        _assert_batches_equal(
            batch, again.batch_items(np.arange(3 * b, 3 * b + 3),
                                     seed=11 + b))


def test_loader_falls_back_to_pil_only_on_native_unavailable(
        data_dirs, monkeypatch, capsys):
    kw = dict(base_size=BASE, branch_num=BRANCHES, train_pairs=True)
    pil_loader = DataLoader(TextDataset(data_dirs[True], 'train', **kw), 3,
                            num_workers=1, seed=3)
    pil = [list(pil_loader) for _ in range(2)]  # epochs 0 and 1

    def unavailable(self):
        raise NativeUnavailable('g++ finds no jpeglib.h')

    monkeypatch.setattr(tdatasets.TextDataset, '_native_decoder',
                        unavailable)
    loader = DataLoader(TextDataset(data_dirs[True], 'train',
                                    native_decode=True, **kw), 3,
                        num_workers=1, seed=3)
    for want in pil:
        got = list(loader)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            _assert_batches_equal(a, b)
    out = capsys.readouterr().out
    assert out.count('!! native decode unavailable, using PIL: g++ finds '
                     'no jpeglib.h') == 1

    def broken(self):
        raise RuntimeError('a fault of the decoder')

    monkeypatch.setattr(tdatasets.TextDataset, '_native_decoder', broken)
    with pytest.raises(RuntimeError, match='a fault of the decoder'):
        list(DataLoader(TextDataset(data_dirs[True], 'train',
                                    native_decode=True, **kw), 3,
                        num_workers=1))


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            out[os.path.relpath(path, root)] = np.asarray(Image.open(path))
    return out


@pytest.mark.parametrize('dtype', ['float32', 'uint8'])
def test_save_single_images_matches_jax(writer_ok, tmp_path, monkeypatch,
                                        dtype):
    rng = np.random.default_rng(2)
    images = rng.uniform(-1.2, 1.2, (3, 8, 8, 3)).astype(np.float32)
    if dtype == 'uint8':
        images = timages.pm1_to_uint8(images)
    names = ['001.A/img_0', '001.A/img_1', '002.B/img_2']
    classes = [4, 4, 7]
    before = native_writer.batches
    monkeypatch.setenv('T2I_NATIVE_WRITE', '1')
    timages.save_single_images(images, names, str(tmp_path / 'ours'), 2,
                               classes, 8, 5)
    assert native_writer.batches == before + 1
    assert timages.flush_writes() == 0
    monkeypatch.setenv('T2I_NATIVE_WRITE', '0')
    jimages.save_single_images(images, names, str(tmp_path / 'jax'), 'test',
                               2, classes, 8, 5)
    ours, ref = _files(tmp_path / 'ours'), _files(tmp_path / 'jax')
    assert sorted(ours) == sorted(ref) == [
        'single_samples/001.A/img_0_8_class4_sid2_nid5.png',
        'single_samples/001.A/img_1_8_class4_sid2_nid5.png',
        'single_samples/002.B/img_2_8_class7_sid2_nid5.png']
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])


def test_writer_grey_errors_and_mismatch(writer_ok, tmp_path):
    grey = np.random.default_rng(3).integers(0, 256, (2, 5, 7), np.uint8)
    paths = [str(tmp_path / ('g%d.png' % i)) for i in range(2)]
    native_writer.write_png_batch(grey, paths)
    assert native_writer.flush() == 0
    for img, p in zip(grey, paths):
        got = Image.open(p)
        assert got.mode == 'L'
        np.testing.assert_array_equal(np.asarray(got), img)
    # an unwritable path is counted once, and flush resets the count
    rgb = np.zeros((2, 4, 4, 3), np.uint8)
    native_writer.write_png_batch(
        rgb, [str(tmp_path / 'ok.png'), str(tmp_path / 'no' / 'x.png')])
    assert native_writer.flush() == 1
    assert native_writer.flush() == 0
    assert os.path.exists(tmp_path / 'ok.png')
    with pytest.raises(ValueError, match='got 1 paths for 2 images'):
        native_writer.write_png_batch(rgb, [str(tmp_path / 'a.png')])
    with pytest.raises(ValueError, match='uint8'):
        native_writer.write_png_batch(rgb.astype(np.float32),
                                      [str(tmp_path / 'a.png')] * 2)


def test_evaluate_reports_failed_writes_in_jax_words(writer_ok, tmp_path,
                                                     capsys, monkeypatch):
    from text2img_ekl_tpu_torch.data import SyntheticTextDataset
    from text2img_ekl_tpu_torch.models.generator import build_generator
    from text2img_ekl_tpu_torch.train.trainer import CondGANTrainer
    monkeypatch.setenv('T2I_NATIVE_WRITE', '1')
    cfg = cfg_from_file(EVAL_CFG)
    cfg.GAN.GF_DIM = 8
    cfg.TRAIN.BATCH_SIZE = 2
    torch.manual_seed(0)
    net_g = tmp_path / 'run7' / 'Model' / 'netG_epoch_3.pth'
    net_g.parent.mkdir(parents=True)
    torch.save(build_generator(cfg, train_flag=False).state_dict(), net_g)
    cfg.TRAIN.NET_G = str(net_g)
    ds = SyntheticTextDataset(num_items=2, base_size=64, branch_num=2,
                              entity_dim=cfg.GAN.ENTITY_DIM,
                              text_dim=cfg.TEXT.DIMENSION, train_pairs=False)
    trainer = CondGANTrainer(
        cfg, str(tmp_path / 'out'), device='cpu',
        data_loader=DataLoader(ds, 2, shuffle=False, num_workers=1))
    before = native_writer.batches
    save_dir = trainer.evaluate(max_batches=1)
    assert native_writer.batches == before + 10  # a batch per caption
    assert 'Save images ok; Number of images: 20' in capsys.readouterr().out
    files = sorted(os.listdir(os.path.join(save_dir, 'single_samples',
                                           'synthetic')))
    assert len(files) == 20
    # two of the same files made unwritable: directories in their place
    for name in files[:2]:
        path = os.path.join(save_dir, 'single_samples', 'synthetic', name)
        os.remove(path)
        os.makedirs(path)
    trainer.evaluate(max_batches=1)
    out = capsys.readouterr().out
    assert '!! 2 image writes failed' in out
    assert ('Save images DONE WITH ERRORS; Number of images written: 18 '
            '(of 20 sampled)') in out
    assert native_writer.flush() == 0


def _tool(name):
    """A script of tools/, loaded by path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, 'tools', name + '.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_loader_bench_times_every_path(decoder_ok, capsys):
    lines = _tool('bench_loader_torch').main(
        ['--n', '8', '--bs', '4', '--workers', '2'])
    assert [ln['path'] for ln in lines] == [
        'pil', 'native', 'pil+uint8', 'native+uint8']
    for ln in lines:
        assert ln['value'] == max(ln['runs']) > 0 and len(ln['runs']) == 2
        assert ln['jpegs_per_sec'] == 2 * ln['value']
        assert ln['cpu_count'] == os.cpu_count()
    assert capsys.readouterr().out.count('"metric": "loader_items_per_sec"') \
        == 4


def test_eval_bench_measures_both_writers(writer_ok, tmp_path):
    cfg = cfg_from_file(EVAL_CFG)
    cfg.GAN.GF_DIM = 8
    cfg.TRAIN.BATCH_SIZE = 2
    env = os.environ.get('T2I_NATIVE_WRITE')
    res = _tool('bench_eval_torch').measure(
        cfg, 2, device='cpu', direct=False, work=str(tmp_path / 'work'))
    assert res['images'] == 2 * 2 * 10 and res['native_unavailable'] is None
    assert {r: len(t) for r, t in res['seconds'].items()} == {
        'none': 2, 'native': 2, 'pil': 2}
    for r in ('none', 'native', 'pil'):
        assert res['%s_images_per_s' % r] > 0
    assert not os.path.exists(tmp_path / 'work')
    assert os.environ.get('T2I_NATIVE_WRITE') == env
