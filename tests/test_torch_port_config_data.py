"""The PyTorch port's own config and data modules against the JAX
package's, on the CPU.

Every ``cfg/*.yml`` loads to the same values through both (compared with
``dataclasses.asdict``), with the same strict-merge errors. The transforms
agree on a seeded PIL image, and the synthetic dataset, a CUB-layout
``TextDataset`` written to a temporary directory, and the loader's batches
agree with the JAX package's for the same seeds, float and uint8, train
and test pairs. Everything is exact: the same numpy and PIL calls run on
the same inputs.
"""

import dataclasses
import glob
import os
import pickle

import numpy as np
import pytest
from PIL import Image

from text2img_ekl_tpu import config as jconfig
from text2img_ekl_tpu import data as jdata
from text2img_ekl_tpu.data import transforms as jT
from text2img_ekl_tpu_torch import config as tconfig
from text2img_ekl_tpu_torch import data as tdata
from text2img_ekl_tpu_torch.data import transforms as tT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = sorted(glob.glob(os.path.join(REPO, 'cfg', '*.yml')))


@pytest.mark.parametrize('path', CFGS, ids=os.path.basename)
def test_every_config_loads_to_the_same_values(path):
    try:
        ref = jconfig.cfg_from_file(path)
    except (KeyError, ValueError) as e:  # a file the strict merge refuses
        with pytest.raises(type(e), match=str(e.args[0])):
            tconfig.cfg_from_file(path)
        return
    ours = tconfig.cfg_from_file(path)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.imsize == ref.imsize
    assert ours.branch_sizes() == ref.branch_sizes()


def test_defaults_and_strict_merge_errors_match():
    assert dataclasses.asdict(tconfig.Config()) == \
        dataclasses.asdict(jconfig.Config())
    for bad, err in (({'NOT_A_KEY': 1}, KeyError),
                     ({'TRAIN': {'BATCH_SIZE': 'x'}}, ValueError),
                     ({'GAN': 3}, ValueError)):
        for mod in (jconfig, tconfig):
            with pytest.raises(err):
                mod.cfg_from_dict(bad)
    merged = {'TRAIN': {'DISCRIMINATOR_LR': 1}, 'TREE': {'BRANCH_NUM': 3}}
    assert dataclasses.asdict(tconfig.cfg_from_dict(merged)) == \
        dataclasses.asdict(jconfig.cfg_from_dict(merged))


def _seeded_image(seed=0, size=(150, 110)):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 256, (size[1], size[0], 3),
                                        dtype=np.uint8))


@pytest.mark.parametrize('which', ['train', 'eval'])
def test_transforms_match(which):
    img = _seeded_image()
    build = {'train': ('build_train_transform'),
             'eval': ('build_eval_transform')}[which]
    for seed in range(4):  # covers both flips of the train transform
        ours = getattr(tT, build)(128)(img, np.random.default_rng(seed))
        ref = getattr(jT, build)(128)(img, np.random.default_rng(seed))
        np.testing.assert_array_equal(np.asarray(ours), np.asarray(ref))
    bbox = [10, 12, 60, 40]
    np.testing.assert_array_equal(np.asarray(tT.bbox_crop(img, bbox)),
                                  np.asarray(jT.bbox_crop(img, bbox)))
    for as_uint8 in (False, True):
        for a, b in zip(tT.multiscale_pyramid(img, [64, 128], as_uint8),
                        jT.multiscale_pyramid(img, [64, 128], as_uint8)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _assert_items_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], (list, tuple)):
            assert len(a[k]) == len(b[k])
            for x, y in zip(a[k], b[k]):
                assert np.asarray(x).dtype == np.asarray(y).dtype, k
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        else:
            np.testing.assert_array_equal(np.asarray(a[k]),
                                          np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize('uint8', [False, True])
@pytest.mark.parametrize('train_pairs', [True, False])
def test_synthetic_dataset_items_match(train_pairs, uint8):
    kw = dict(num_items=6, base_size=64, branch_num=2, entity_dim=20,
              text_dim=16, train_pairs=train_pairs, uint8_output=uint8)
    ours = tdata.SyntheticTextDataset(**kw)
    ref = jdata.SyntheticTextDataset(**kw)
    assert len(ours) == len(ref)
    for i in (0, 3, 5):
        _assert_items_equal(ours.item(i, np.random.default_rng(i)),
                            ref.item(i, np.random.default_rng(i)))
        if uint8:
            assert ours.item(i, np.random.default_rng(0))['imgs'][0].dtype \
                == np.uint8


@pytest.mark.parametrize('uint8', [False, True])
def test_loader_batches_match(uint8):
    kw = dict(num_items=10, base_size=64, branch_num=2, entity_dim=20,
              text_dim=16, train_pairs=True, uint8_output=uint8)
    ours = tdata.DataLoader(tdata.SyntheticTextDataset(**kw), 3,
                            shuffle=True, num_workers=2, seed=4)
    ref = jdata.DataLoader(jdata.SyntheticTextDataset(**kw), 3,
                           shuffle=True, num_workers=2, seed=4)
    assert len(ours) == len(ref) == 3
    for _ in range(2):  # two epochs: the reshuffle follows the same seeds
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            _assert_items_equal(a, b)


def _write_pickle(path, obj):
    with open(path, 'wb') as f:
        pickle.dump(obj, f, protocol=2)


@pytest.fixture(scope='module')
def cub_dir(tmp_path_factory):
    """A 4-image CUB layout with textured JPEGs: images.txt and
    bounding_boxes.txt, train and test pickles."""
    root = tmp_path_factory.mktemp('data') / 'birds'
    cub = root / 'CUB_200_2011'
    names = ['001.A/A_%d' % i for i in range(2)] + \
        ['002.B/B_%d' % i for i in range(2)]
    os.makedirs(cub, exist_ok=True)
    with open(cub / 'images.txt', 'w') as f:
        f.writelines('%d %s.jpg\n' % (i + 1, n) for i, n in enumerate(names))
    with open(cub / 'bounding_boxes.txt', 'w') as f:
        f.writelines('%d %.1f %.1f %.1f %.1f\n' % (i + 1, 5 + i, 8, 60, 50)
                     for i in range(len(names)))
    for i, n in enumerate(names):
        path = cub / 'images' / (n + '.jpg')
        os.makedirs(path.parent, exist_ok=True)
        _seeded_image(i, (90, 80)).save(path, quality=95)
    emb = np.random.default_rng(0).standard_normal(
        (len(names), 10, 16)).astype(np.float32)
    for split in ('train', 'test'):
        os.makedirs(root / split, exist_ok=True)
        _write_pickle(root / split / 'filenames.pickle', names)
        _write_pickle(root / split / 'char-CNN-RNN-embeddings.pickle', emb)
        _write_pickle(root / split / 'class_info.pickle', [1, 1, 2, 2])
    return str(root)


@pytest.mark.parametrize('uint8', [False, True])
@pytest.mark.parametrize('split', ['train', 'test'])
def test_text_dataset_items_match(cub_dir, split, uint8):
    train = split == 'train'
    kw = dict(base_size=64, branch_num=2, entity_dim=20, train_pairs=train,
              uint8_output=uint8)
    ours = tdata.TextDataset(
        cub_dir, split, transform=(tT.build_train_transform(128) if train
                                   else tT.build_eval_transform(128)), **kw)
    ref = jdata.TextDataset(
        cub_dir, split, transform=(jT.build_train_transform(128) if train
                                   else jT.build_eval_transform(128)), **kw)
    for i in range(len(ref)):
        _assert_items_equal(ours.item(i, np.random.default_rng(i)),
                            ref.item(i, np.random.default_rng(i)))
