"""The PyTorch port's entry points on the CPU: the evaluate loop and a
bounded training run end to end at a tiny size, the refusals of the CLI,
the trainer and chip_smoke, and that no port module, nor main_torch, the
scoring CLIs or chip_smoke, imports JAX, anything of the JAX package,
TensorFlow or protobuf."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from text2img_ekl_tpu_torch.config import cfg_from_file
from text2img_ekl_tpu_torch.data import DataLoader, SyntheticTextDataset
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL_CFG = os.path.join(REPO, 'cfg',
                        'birds_2stg_splitz_cap_ca_eval.realcls.yml')
TRAIN_CFG = os.path.join(REPO, 'cfg', 'birds_2stg_splitz_cap_ca.realcls.yml')


def _run(args, cwd=REPO, **env):
    full_env = {k: v for k, v in os.environ.items() if k != 'T2I_JAX_CACHE'}
    full_env['OMP_NUM_THREADS'] = '1'  # see one_torch_thread
    full_env.update(env)
    return subprocess.run([sys.executable] + args, cwd=cwd, env=full_env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax():
    """Every port module and entry point imports in an interpreter where
    JAX, the JAX package, TensorFlow and protobuf cannot be imported, and
    none of them is loaded afterwards."""
    code = (
        "import pkgutil, importlib, sys\n"
        "BANNED = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', "
        "'text2img_ekl_tpu', 'tensorflow')\n"
        "def banned(name):\n"
        "    return name.split('.')[0] in BANNED or "
        "name.startswith('google.protobuf')\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if banned(name):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import text2img_ekl_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods + ['text2img_ekl_tpu_torch.ops.capsule_variants', "
        "'main_torch', 'chip_smoke', 'tools.profile_torch_sampler', "
        "'tools.bench_capsule_torch', 'tools.bench_conv_dw_torch', "
        "'tools.bench_loader_torch', 'tools.bench_eval_torch', "
        "'inception_score_torch', 'fid_torch', 'is_of_dir_torch']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if banned(m))\n"
        "need = {'text2img_ekl_tpu_torch.io_utils.checkpoint', "
        "'text2img_ekl_tpu_torch.io_utils.logging', "
        "'text2img_ekl_tpu_torch.models.inception_v3', "
        "'text2img_ekl_tpu_torch.eval.convert_tf', "
        "'text2img_ekl_tpu_torch.eval.tf_files', "
        "'text2img_ekl_tpu_torch.eval.inception_score', "
        "'text2img_ekl_tpu_torch.eval.fid', "
        "'text2img_ekl_tpu_torch.ops._build', "
        "'text2img_ekl_tpu_torch.io_utils.native_writer', "
        "'text2img_ekl_tpu_torch.data.native_loader'}\n"
        "print(len(mods), need <= set(mods), bad)\n")
    proc = _run(['-c', code])
    assert proc.returncode == 0, proc.stderr
    n, covered, bad = proc.stdout.split(maxsplit=2)
    assert int(n) >= 30 and covered == 'True' and bad.strip() == '[]', \
        proc.stdout


def _tiny_cfg(tmp_path, **test):
    from text2img_ekl_tpu_torch.models.generator import build_generator
    cfg = cfg_from_file(EVAL_CFG)
    cfg.GAN.GF_DIM = 8
    cfg.TRAIN.BATCH_SIZE = 2
    for k, v in test.items():
        setattr(cfg.TEST, k, v)
    torch.manual_seed(0)
    net_g = tmp_path / 'run7' / 'Model' / 'netG_epoch_12.pth'
    net_g.parent.mkdir(parents=True)
    torch.save(build_generator(cfg, train_flag=False).state_dict(), net_g)
    cfg.TRAIN.NET_G = str(net_g)
    return cfg


def _loader(cfg, items):
    ds = SyntheticTextDataset(num_items=items, base_size=64, branch_num=2,
                              entity_dim=cfg.GAN.ENTITY_DIM,
                              text_dim=cfg.TEXT.DIMENSION, train_pairs=False)
    return DataLoader(ds, cfg.TRAIN.BATCH_SIZE, shuffle=False,
                      drop_last=True, num_workers=1)


@pytest.mark.parametrize('share', [False, True])
def test_evaluate_writes_the_reference_pngs(tmp_path, share):
    from text2img_ekl_tpu_torch.train.trainer import CondGANTrainer
    cfg = _tiny_cfg(tmp_path, CLS_SHARE=share)
    out = tmp_path / 'out'
    trainer = CondGANTrainer(cfg, str(out), data_loader=_loader(cfg, 6),
                             device='cpu')
    save_dir = trainer.evaluate(max_batches=2)
    prior = 'clsprior-share' if share else 'clsprior-random'
    assert save_dir == str(out / 'eval' / (
        'Testset_evalmode_fixednoise_%s_12_run7' % prior))
    files = sorted(os.listdir(os.path.join(save_dir, 'single_samples',
                                           'synthetic')))
    assert len(files) == 2 * 2 * 10
    cls0 = trainer.data_loader.dataset.class_id[0] - 1
    assert files[0] == '000000_128_class%d_sid0_nid0.png' % cls0
    img = np.asarray(Image.open(os.path.join(save_dir, 'single_samples',
                                             'synthetic', files[0])))
    assert img.shape == (128, 128, 3) and img.dtype == np.uint8
    assert img.std() > 0


def test_evaluate_stops_at_sample_num(tmp_path):
    """The offline protocol passes over the split again with the next
    noise id until exactly TEST.SAMPLE_NUM images are written."""
    from text2img_ekl_tpu_torch.train.trainer import CondGANTrainer
    cfg = _tiny_cfg(tmp_path, SAMPLE_NUM=50)
    trainer = CondGANTrainer(cfg, str(tmp_path / 'out'),
                             data_loader=_loader(cfg, 2), device='cpu')
    save_dir = trainer.evaluate()
    files = os.listdir(os.path.join(save_dir, 'single_samples', 'synthetic'))
    assert len(files) == 50
    assert sum('_nid2.png' in f for f in files) == 10


def test_eval_trainer_honours_the_kernel_switches(tmp_path):
    """An eval-mode trainer built from a config with TPU_FUSED_BN_GLU runs
    the generator's eight BN+GLU tails fused, as the JAX package does; the
    unfused generator's file loads into it (strict)."""
    from text2img_ekl_tpu_torch.nn.blocks import FusedBatchNormGLU
    from text2img_ekl_tpu_torch.train.trainer import CondGANTrainer
    cfg = _tiny_cfg(tmp_path)
    cfg.TPU_FUSED_BN_GLU = True
    trainer = CondGANTrainer(cfg, str(tmp_path / 'out'),
                             data_loader=_loader(cfg, 2), device='cpu')
    assert sum(isinstance(m, FusedBatchNormGLU)
               for m in trainer.G.modules()) == 8
    save_dir = trainer.evaluate(max_batches=1)
    files = os.listdir(os.path.join(save_dir, 'single_samples', 'synthetic'))
    assert len(files) == 2 * 10


@pytest.mark.parametrize('bn_dtype', ['bfloat16', 'float32'])
def test_trainer_builds_batchnorm_in_the_config_dtype(tmp_path, bn_dtype):
    """TPU_BN_DTYPE reaches every BatchNorm of the generator an eval-mode
    trainer builds, and of both networks of a training state: their
    outputs take that type, as the JAX package's policy casts them."""
    from text2img_ekl_tpu_torch.nn.blocks import BatchNorm
    from text2img_ekl_tpu_torch.train.state import create_train_state
    from text2img_ekl_tpu_torch.train.trainer import CondGANTrainer
    cfg = _tiny_cfg(tmp_path)
    cfg.TPU_BN_DTYPE = bn_dtype
    trainer = CondGANTrainer(cfg, str(tmp_path / 'out'),
                             data_loader=_loader(cfg, 2), device='cpu')
    cfg.TRAIN.FLAG = True
    cfg.GAN.DF_DIM = 8
    state = create_train_state(cfg, 'cpu', seed=0)
    want = getattr(torch, bn_dtype)
    for net in [trainer.G, state.G] + list(state.Ds):
        bns = [m for m in net.modules() if isinstance(m, BatchNorm)]
        assert bns and all(m.bn_dtype == want for m in bns)
    bn = next(m for m in trainer.G.modules() if isinstance(m, BatchNorm))
    assert bn.eval()(torch.randn(2, bn.weight.numel())).dtype == want


def test_cli_refuses_what_is_not_ported_or_not_there(tmp_path, monkeypatch):
    import main_torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            main_torch.main(['--cfg', EVAL_CFG, '--synthetic'])
    cfg_path = tmp_path / 'tiny_coco.yml'
    cfg_path.write_text(TINY_TRAIN_YML + "DATASET_NAME: 'coco'\n")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match='COCO.*M12'):
        main_torch.main(['--cfg', str(cfg_path), '--device', 'cpu',
                         '--synthetic'])
    cfg = _tiny_cfg(tmp_path)
    cfg.TEST.EVAL_MODE = False
    from text2img_ekl_tpu_torch.train.trainer import CondGANTrainer
    trainer = CondGANTrainer(cfg, str(tmp_path / 'out'),
                             data_loader=_loader(cfg, 2), device='cpu')
    with pytest.raises(NotImplementedError, match='train-mode sampling'):
        trainer.evaluate(max_batches=1)


TINY_TRAIN_YML = """
TRAIN:
    FLAG: True
    BATCH_SIZE: 4
    MAX_EPOCH: 300
    SNAPSHOT_INTERVAL: 10
    COEFF:
      UNCOND_LOSS: 1.0
    G_CAPSULE: True
    D_CAPSULE: True
GAN:
    EMBEDDING_DIM: 128
    ENTITY_DIM: 200
    MANIFD_DIM: 128
    DF_DIM: 8
    GF_DIM: 8
    Z_DIM: 128
    R_NUM: 2
    B_CONDITION: True
TREE:
    BRANCH_NUM: 2
WORKERS: 1
TPU_COMPUTE_DTYPE: 'float32'
"""


def test_cli_trains_a_bounded_run(tmp_path, monkeypatch, capsys):
    """main_torch with TRAIN.FLAG True at GF/DF_DIM 8: the epoch line,
    the epoch grids, and networks that moved."""
    import main_torch
    cfg_path = tmp_path / 'tiny_train.yml'
    cfg_path.write_text(TINY_TRAIN_YML)
    monkeypatch.chdir(tmp_path)
    main_torch.main(['--cfg', str(cfg_path), '--device', 'cpu',
                     '--synthetic', '--max_steps', '2', '--manualSeed', '1'])
    out = capsys.readouterr().out
    assert '[0/300][BN=128][2 stages]' in out and 'Loss_D_all' in out
    grids = [os.path.basename(p) for p in (tmp_path / 'output').glob(
        '*/Image/*.png')]
    assert sorted(grids) == ['epoch_000_fake_samples0.png',
                             'epoch_000_fake_samples1.png',
                             'real_samples.png']


def test_train_moves_the_networks_and_refuses_unbounded_runs(tmp_path):
    """Bounded and unbounded runs train, write the snapshots of their
    snapshot epochs and auto-resume from the newest; a run that pools
    3,000 fakes for the IS stream and one with BIG_EVAL, which the trainer
    refused before the Inception tower was ported, run. The one run still
    refused is one whose loader yields no batch: without max_steps it
    would go through its epochs taking no step."""
    from text2img_ekl_tpu_torch.train.state import create_train_state
    from text2img_ekl_tpu_torch.train.trainer import CondGANTrainer
    cfg = cfg_from_file(TRAIN_CFG)
    cfg.GAN.GF_DIM = cfg.GAN.DF_DIM = 8
    cfg.TRAIN.BATCH_SIZE = 4
    cfg.TPU_COMPUTE_DTYPE = 'float32'
    ds = SyntheticTextDataset(num_items=8, base_size=64, branch_num=2,
                              entity_dim=cfg.GAN.ENTITY_DIM,
                              text_dim=cfg.TEXT.DIMENSION, train_pairs=True,
                              uint8_output=True)
    loader = DataLoader(ds, 4, shuffle=True, num_workers=1)
    trainer = CondGANTrainer(cfg, str(tmp_path), data_loader=loader,
                             device='cpu')
    before = create_train_state(cfg, 'cpu', seed=0)
    state = trainer.train(max_steps=3)   # crosses an epoch (2 batches)
    assert state.step == 3
    assert all(np.isfinite(v) for v in trainer.last_metrics.values())
    for a, b in [(before.G, state.G)] + list(zip(before.Ds, state.Ds)):
        assert any(not torch.equal(p, q) for p, q in
                   zip(a.parameters(), b.parameters()))
    assert len(os.listdir(trainer.image_dir)) == 1 + 2 * 2  # 2 epochs
    assert os.listdir(trainer.model_dir) == []
    # with one batch an epoch, a run that reaches the snapshot of epoch 9
    # trains and writes it (fresh: no snapshot to resume from yet)
    one = DataLoader(SyntheticTextDataset(
        num_items=4, base_size=64, branch_num=2,
        entity_dim=cfg.GAN.ENTITY_DIM, text_dim=cfg.TEXT.DIMENSION,
        train_pairs=True, uint8_output=True), 4, num_workers=1)
    trainer = CondGANTrainer(cfg, str(tmp_path / 'one'), data_loader=one,
                             device='cpu')
    state = trainer.train(max_steps=10)
    assert state.step == 10
    assert os.listdir(trainer.model_dir) == ['state_epoch9']
    # a run without max_steps trains to MAX_EPOCH, resuming at epoch 10
    cfg.TRAIN.MAX_EPOCH = 12
    cfg.TRAIN.SNAPSHOT_INTERVAL = 2
    state = trainer.train(max_steps=None)
    assert state.step == 12
    assert sorted(os.listdir(trainer.model_dir)) == ['state_epoch11',
                                                     'state_epoch9']
    # a fresh run whose loader claims 1,500 batches an epoch pools 3,000
    # fakes (batch 4, every 2nd step) in its epoch by the count that used
    # to refuse it; it trains (one batch), and so does BIG_EVAL
    cfg.TRAIN.MAX_EPOCH = 1
    for name in ('stream', 'big_eval'):
        cfg.TRAIN.BIG_EVAL = name == 'big_eval'
        trainer = CondGANTrainer(cfg, str(tmp_path / name), data_loader=one,
                                 device='cpu')
        trainer.num_batches = 1500
        assert trainer.train().step == 1
    trainer.num_batches = 0
    with pytest.raises(ValueError, match='yields no batch'):
        trainer.train(max_steps=None)


def test_cli_trains_to_max_epoch_without_max_steps(tmp_path, monkeypatch,
                                                  capsys):
    """main_torch without --max_steps trains to TRAIN.MAX_EPOCH and writes
    the snapshot of its last epoch (8 synthetic items: 2 batches an
    epoch)."""
    import main_torch
    from text2img_ekl_tpu_torch.train import trainer as trainer_mod
    cfg_path = tmp_path / 'tiny_train.yml'
    cfg_path.write_text(TINY_TRAIN_YML.replace('MAX_EPOCH: 300',
                                               'MAX_EPOCH: 2').replace(
        'SNAPSHOT_INTERVAL: 10', 'SNAPSHOT_INTERVAL: 2'))
    real = trainer_mod.SyntheticTextDataset
    monkeypatch.setattr(trainer_mod, 'SyntheticTextDataset',
                        lambda num_items, **kw: real(num_items=8, **kw))
    monkeypatch.chdir(tmp_path)
    main_torch.main(['--cfg', str(cfg_path), '--device', 'cpu',
                     '--synthetic', '--manualSeed', '1'])
    out = capsys.readouterr().out
    assert '[1/2][BN=2][2 stages]' in out and 'Snapshot: save model ok' in out
    runs = list((tmp_path / 'output').iterdir())
    assert len(runs) == 1
    assert sorted(os.listdir(runs[0] / 'Model')) == ['state_epoch1']


def test_chip_smoke_refuses_without_a_card_or_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    proc = _run(['chip_smoke.py'])
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    shutil.copy(os.path.join(REPO, 'chip_smoke.py'), tmp_path)
    proc = _run(['chip_smoke.py'], cwd=str(tmp_path))
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
