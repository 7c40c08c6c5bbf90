"""The plain reference against the port on the CPU at a small width,
under the port's float32 policy: the same weights and inputs give the
same losses, first gradients, changes and sampler images."""

from bench_small import TRAIN, small_cell  # noqa: I100 (first)
import pytest
import torch

import compare
import loops


@pytest.mark.parametrize('workload', TRAIN)
def test_train_step_agrees(workload):
    torch.manual_seed(0)
    cell = small_cell(workload, policy='float32')
    train = loops.Train(cell)
    train.setup()
    train.release()
    ref = train.reference(cell.reference.Precision('float32'))
    for p, r in zip(train.prog['losses'][:1], ref['losses'][:1]):
        for k in ('errD', 'errG'):
            assert abs(p[k] - r[k]) <= 1e-5 * abs(r[k])
    numbers = compare.train_numbers(train.prog, ref)
    assert numbers['grad_gap_d'] < 1e-4
    assert numbers['grad_gap_g'] < 1e-3
    assert numbers['change_gap'] < 0.05
    assert set(train.prog['grads']) == set(ref['grads'])


def test_sampler_agrees():
    cell = small_cell('cub-splitz-cap-ca.sample-320', policy='float32')
    sample = loops.Sample(cell)
    sample.setup()
    out = sample.call(0)
    with cell.reference.reference_mode():
        ref = sample.reference_images(0, cell.reference.Precision('float32'))
    assert out.shape == ref.shape == (2, 4, 128, 128, 3)
    assert (out.int() - ref.int()).abs().max() <= 1
    assert compare.image_gap(out, ref) < 0.01
