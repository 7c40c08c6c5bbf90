"""The port's spans (``text2img_ekl_tpu_torch/spans.py``) on the CPU.

Off, a span is one shared null context that touches neither CUDA nor the
profiler. Under a CPU ``torch.profiler`` session, one training step at
GF/DF_DIM 8 and a batch of 4 (``test_torch_port_step.small_cfg``, one torch
thread) records one ``step`` unit with its phases in order, every span
nested inside its parent and the capsule op under the phase that ran it;
a caption sampler call records one ``sample.call`` unit; the buffer drops
and counts units past its capacity; and ``TPU_PROFILE`` writes the
trainer's Chrome trace with its spans. The card's side (device
milliseconds, the backward on autograd's device thread) is in
``tests/test_torch_port_cuda.py``.
"""

import json
import os
import threading
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_port_step import REPO, small_cfg
from text2img_ekl_tpu_torch import spans
from text2img_ekl_tpu_torch.config import cfg_from_file
from text2img_ekl_tpu_torch.data import DataLoader, SyntheticTextDataset
from text2img_ekl_tpu_torch.models.generator import build_generator
from text2img_ekl_tpu_torch.train.sample import caption_sample
from text2img_ekl_tpu_torch.train.state import create_train_state
from text2img_ekl_tpu_torch.train.step import make_train_step
from torch_port_threads import one_torch_thread  # noqa: F401

EVAL_CFG = os.path.join(REPO, 'cfg',
                        'birds_2stg_splitz_cap_ca_eval.realcls.yml')
B = 4
PHASES = ['step.g_forward', 'step.d_passes', 'step.d_backward',
          'step.d_adam', 'step.d_passes', 'step.d_backward', 'step.d_adam',
          'step.g_loss', 'step.g_backward', 'step.g_adam']


@pytest.fixture(autouse=True)
def _empty_buffer():
    spans.clear()
    yield
    spans.clear()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _batch(cfg, rng):
    labels = rng.integers(0, cfg.GAN.ENTITY_DIM, B)

    def images():
        return tuple(torch.from_numpy(rng.integers(0, 256, (B, 3, s, s),
                                                   dtype=np.uint8))
                     for s in cfg.branch_sizes())

    return {'real': images(), 'wrong': images(),
            'txt': torch.from_numpy(rng.standard_normal(
                (B, cfg.TEXT.DIMENSION), dtype=np.float32)),
            'cls_onehot': torch.from_numpy(np.eye(
                cfg.GAN.ENTITY_DIM, dtype=np.float32)[labels]),
            'real_cp': torch.from_numpy(np.eye(
                cfg.GAN.ENTITY_DIM + 1, dtype=np.float32)[labels])}


@pytest.fixture(scope='module')
def traced_step():
    """One tiny step under a CPU profiler: (its units, the profiler's
    event names)."""
    cfg = small_cfg()
    state = create_train_state(cfg, 'cpu', seed=0)
    batch = _batch(cfg, np.random.default_rng(0))
    spans.clear()
    with _cpu_profile() as prof:
        make_train_step(cfg)(state, batch, 0)
    got = spans.units('step')
    spans.clear()
    return got, {e.name for e in prof.events()}


def test_off_is_the_shared_null_context(monkeypatch):
    assert not torch.autograd._profiler_enabled()

    def refuse(*a, **kw):
        raise AssertionError('a span touched CUDA or the profiler while off')

    monkeypatch.setattr(torch.cuda, 'Event', refuse)
    monkeypatch.setattr(spans, '_Range', refuse)
    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    monkeypatch.setattr(torch.cuda, 'is_initialized', refuse)
    assert spans.span('step', rows=4) is spans.NULL
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for i in range(1000):
            with spans.span('capsule.fwd', head='G', kernel='K1-G') as s:
                assert s is None
        grown = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    assert grown < 512
    monkeypatch.undo()
    assert spans.units('capsule.fwd') == [] and spans.dropped() == 0


def test_one_step_records_one_unit_with_its_phases_in_order(traced_step):
    units, _ = traced_step
    assert len(units) == 1
    sp = units[0]['spans']
    root = sp[0]
    assert root['name'] == 'step' and root['parent'] is None
    assert root['attrs'] == {'rows': B}
    assert all(s['unit'] == root['id'] == units[0]['unit'] for s in sp)
    phases = [s for s in sp if s['parent'] == root['id']]
    assert [s['name'] for s in phases] == PHASES
    assert [s['attrs'].get('d') for s in phases] == \
        [None, 0, 0, 0, 1, 1, 1, None, None, None]
    # the CPU has no device clock
    assert all(s['device_ms'] is None for s in sp)


def test_children_nest_inside_their_parents(traced_step):
    sp = traced_step[0][0]['spans']
    by_id = {s['id']: s for s in sp}
    for s in sp[1:]:
        p = by_id[s['parent']]
        assert p['host_start_ns'] <= s['host_start_ns'] <= \
            s['host_end_ns'] <= p['host_end_ns'], (s['name'], p['name'])
    phases = [s for s in sp if s['parent'] == sp[0]['id']]
    for a, b in zip(phases, phases[1:]):
        assert a['host_end_ns'] <= b['host_start_ns']


def test_the_capsule_op_sits_under_the_phase_that_ran_it(traced_step):
    sp = traced_step[0][0]['spans']
    by_id = {s['id']: s for s in sp}

    def under(name):
        return sorted((by_id[s['parent']]['name'], s['attrs']['head'])
                      for s in sp if s['name'] == name)

    # G's head in G's forward and backward; each D's class head on the
    # real, wrong and fake passes, backward through real and fake; G's
    # loss through both Ds
    assert under('capsule.fwd') == sorted(
        [('step.g_forward', 'G')] + [('step.d_passes', 'D')] * 6
        + [('step.g_loss', 'D')] * 2)
    assert under('capsule.bwd') == sorted(
        [('step.d_backward', 'D')] * 4 + [('step.g_backward', 'D')] * 2
        + [('step.g_backward', 'G')])
    assert {s['attrs']['kernel'] for s in sp
            if s['name'].startswith('capsule.')} == {'plain'}


def test_span_names_reach_the_profilers_events(traced_step):
    names = traced_step[1]
    assert {'step', 'capsule.fwd', 'capsule.bwd'} | set(PHASES) <= names


def test_a_caption_sample_call_records_one_unit():
    cfg = cfg_from_file(EVAL_CFG)
    cfg.GAN.GF_DIM = 8
    cfg.TPU_COMPUTE_DTYPE = 'float32'
    G = build_generator(cfg, train_flag=False).eval()
    gen = torch.Generator().manual_seed(0)
    n_cap, bsz = 2, 3
    noise = torch.randn(bsz, cfg.GAN.Z_DIM, generator=gen)
    emb = torch.randn(n_cap, bsz, cfg.TEXT.DIMENSION, generator=gen)
    with _cpu_profile():
        out = caption_sample(G, noise, emb, generator=gen)
    assert out.shape[:2] == (n_cap, bsz) and out.dtype == torch.uint8
    units = spans.units('sample.call')
    assert len(units) == 1
    sp = units[0]['spans']
    assert sp[0]['attrs'] == {'rows': n_cap * bsz}
    assert [s['name'] for s in sp] == ['sample.call', 'capsule.fwd']
    assert sp[1]['parent'] == sp[0]['id'] and sp[1]['attrs']['head'] == 'G'


def test_the_buffer_drops_and_counts_units_past_its_capacity(monkeypatch):
    monkeypatch.setattr(spans, 'CAPACITY', 3)
    with _cpu_profile():
        for i in range(5):
            with spans.span('unit', i=i):
                with spans.span('inner'):
                    pass
    got = spans.units('unit')
    assert [u['spans'][0]['attrs']['i'] for u in got] == [0, 1, 2]
    assert [u['spans'][0]['attrs']['i'] for u in spans.units('unit', 2)] \
        == [0, 1]
    assert spans.units('inner') == []  # not a root
    assert spans.dropped() == 2
    spans.clear()
    assert spans.units('unit') == [] and spans.dropped() == 0


def test_timing_events_are_taken_from_the_pool(monkeypatch):
    """On the card a span takes two timing events. A dropped unit's events
    and, on ``clear()``, the buffer's go back to the pool, and a span takes
    from the pool before it makes a new event (CUDA faked here)."""
    made = []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            made.append(self)

        def record(self, stream=None):
            pass

        def elapsed_time(self, other):
            return 1.0

    def units(n):
        for _ in range(n):
            with spans.span('unit'):
                with spans.span('inner'):
                    pass

    monkeypatch.setattr(spans, 'CAPACITY', 1)
    monkeypatch.setattr(spans, '_free', [])
    with _cpu_profile():
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, 'is_initialized', lambda: True)
            m.setattr(torch.cuda, 'current_stream', lambda: None)
            m.setattr(torch.cuda, 'synchronize', lambda: None)
            m.setattr(torch.cuda, 'Event', Event)
            units(3)  # the second and third are dropped
            assert len(made) == 8 and len(spans._free) == 4
            (kept,) = spans.units('unit')
            assert [s['device_ms'] for s in kept['spans']] == [1.0, 1.0]
            spans.clear()
            assert len(spans._free) == 8
            units(3)
            assert len(made) == 8 and spans.dropped() == 2


def test_a_span_on_another_thread_joins_the_open_unit():
    """As autograd's device thread does on the card: a thread with no span
    open takes the innermost span most recently opened elsewhere."""
    seen = []

    def other():
        # this thread has no profiler state of its own, as a plain thread:
        # open the span directly
        with spans.Span('capsule.bwd', {'head': 'D'}) as s:
            seen.append(s)

    with _cpu_profile():
        with spans.span('step'):
            with spans.span('step.d_backward', d=0) as phase:
                t = threading.Thread(target=other)
                t.start()
                t.join()
    (unit,) = spans.units('step')
    assert seen[0].parent is phase and seen[0].unit == phase.unit
    assert [s['name'] for s in unit['spans']] == \
        ['step', 'step.d_backward', 'capsule.bwd']


def test_tpu_profile_writes_the_trainers_trace(tmp_path):
    """Eight steps with TPU_PROFILE: steps 3-7 of the first epoch go to a
    Chrome trace under Log/profile/ that holds the loop's and the step's
    spans."""
    from text2img_ekl_tpu_torch.train.trainer import CondGANTrainer
    cfg = small_cfg()
    cfg.TPU_PROFILE = True
    cfg.TPU_IS_EVERY = 0
    ds = SyntheticTextDataset(num_items=8 * B, base_size=64, branch_num=2,
                              entity_dim=cfg.GAN.ENTITY_DIM,
                              text_dim=cfg.TEXT.DIMENSION, train_pairs=True,
                              uint8_output=True)
    trainer = CondGANTrainer(cfg, str(tmp_path),
                             data_loader=DataLoader(ds, B, num_workers=1),
                             device='cpu')
    trainer.train(max_steps=8)
    assert not torch.autograd._profiler_enabled()
    prof_dir = os.path.join(trainer.log_dir, 'profile')
    (name,) = os.listdir(prof_dir)
    assert name == 'epoch0_steps3-7.json'
    with open(os.path.join(prof_dir, name)) as f:
        events = json.load(f)['traceEvents']
    names = [e.get('name') for e in events]
    assert names.count('train.iter') == 5 and names.count('step') == 5
    assert 'train.batch' in names and 'step.g_backward' in names
    # the trainer's roots are its iterations: a step is not a unit there
    assert len(spans.units('train.iter')) == 5 and spans.units('step') == []
