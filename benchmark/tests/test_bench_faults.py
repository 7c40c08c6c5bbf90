"""``correct`` comes out false when the timed path is broken underneath a
run, once for each fault a cell can have, and true for the unbroken run;
and the control, the reference computed with fp8 products in the port's
place, fails each cell's limits. Runs on the CPU through the harness's
``run_cell``, which skips the look for a card and drives the rest of a
run, at a small width (the sampler's control at the full width)."""

import contextlib

import pytest
import torch

from bench_small import TRAIN, run_small, small_cell  # noqa: I100 (first)
import compare
import program
import readings


@contextlib.contextmanager
def patched(name, wrap):
    saved = getattr(program, name)
    setattr(program, name, wrap(saved))
    try:
        yield
    finally:
        setattr(program, name, saved)


def unchanged_state(make):
    """A step that leaves the networks' parameters as it found them."""
    def make_fault(cfg):
        step = make(cfg)

        def fault(state, batch, seed, draws=None):
            nets = [state.G] + list(state.Ds)
            before = [[p.detach().clone() for p in n.parameters()]
                      for n in nets]
            out = step(state, batch, seed, draws)
            with torch.no_grad():
                for n, saved in zip(nets, before):
                    for p, s in zip(n.parameters(), saved):
                        p.copy_(s)
            return out
        return fault
    return make_fault


def altered_update(make):
    """A step whose update of one leaf, G's last convolution, comes out
    doubled."""
    def make_fault(cfg):
        step = make(cfg)

        def fault(state, batch, seed, draws=None):
            w = dict(state.G.named_parameters())['img_net2.img.0.weight']
            before = w.detach().clone()
            out = step(state, batch, seed, draws)
            with torch.no_grad():
                w.add_(w - before)
            return out
        return fault
    return make_fault


def half_sample(fn):
    def get():
        sample = fn()

        def fault(G, noise, emb, **kw):
            kw = {k: v[:, :v.shape[1] // 2] if v.dim() == 3
                  else v[:v.shape[0] // 2] for k, v in kw.items()}
            return sample(G, noise[:noise.shape[0] // 2],
                          emb[:, :emb.shape[1] // 2], **kw)
        return fault
    return get


def altered_image(fn):
    def get():
        sample = fn()

        def fault(*a, **kw):
            out = sample(*a, **kw).clone()
            out[0, 0] = out[0, 1]
            return out
        return fault
    return get


def stale_answer(fn):
    def get():
        sample, first = fn(), []

        def fault(*a, **kw):
            out = sample(*a, **kw)
            if not first:
                first.append(out)
            return first[0]
        return fault
    return get


TRAIN_FAULTS = {'unchanged state': ('make_train_step', unchanged_state),
                'half of the batch': ('make_train_step',
                                      readings.half_batch_step),
                'altered update': ('make_train_step', altered_update)}
SAMPLE_FAULTS = {'half of the batch': ('caption_sample', half_sample),
                 'altered image': ('caption_sample', altered_image),
                 'stale answer': ('caption_sample', stale_answer)}


@pytest.mark.parametrize('workload', TRAIN)
def test_unbroken_train_run_is_correct(workload):
    out, lines = run_small(small_cell(workload, policy='float32'))
    assert out['correct'], lines


@pytest.mark.parametrize('workload', TRAIN)
@pytest.mark.parametrize('fault', sorted(TRAIN_FAULTS))
def test_train_fault_is_caught(workload, fault):
    name, wrap = TRAIN_FAULTS[fault]
    with patched(name, wrap):
        out, lines = run_small(small_cell(workload, policy='float32'))
    assert not out['correct'], lines


def test_unbroken_sample_run_is_correct():
    out, lines = run_small(small_cell('cub-splitz-cap-ca.sample-320',
                                      policy='float32'))
    assert out['correct'], lines


@pytest.mark.parametrize('fault', sorted(SAMPLE_FAULTS))
def test_sample_fault_is_caught(fault):
    name, wrap = SAMPLE_FAULTS[fault]
    with patched(name, wrap):
        out, lines = run_small(small_cell('cub-splitz-cap-ca.sample-320',
                                          policy='float32'))
    assert not out['correct'], lines


@pytest.mark.parametrize('workload', TRAIN)
def test_the_control_fails_the_train_limits(workload):
    cell = small_cell(workload)
    numbers = readings.control_reading(cell)
    correct, lines = compare.judge(
        {k: v for k, v in numbers.items() if k in cell.limits}, cell.limits)
    assert not correct, lines


def test_the_control_fails_the_sample_limit():
    cell = small_cell('cub-splitz-cap-ca.sample-320', width=64)
    numbers = readings.control_reading(cell)
    correct, lines = compare.judge(numbers, cell.limits)
    assert not correct, lines
