"""The work counted from shapes against torch.utils.flop_counter on the
plain reference, at a small width on the CPU, for both configurations:
a training step and a sampler call."""

from bench_small import TRAIN, small_cell  # noqa: I100 (first)
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import inputs
import work


@pytest.mark.parametrize('workload', TRAIN)
def test_train_step_flops_match_the_counter(workload):
    cell = small_cell(workload, batch=2)
    R, d = cell.reference, cell.reference.dims(cell.config)
    weights = R.make_weights(cell.config, inputs.generator(1, 'weights',
                                                           'cpu'), 'cpu')
    slot = inputs.train_batches(d, 2, 1, inputs.generator(1, 'train_batches',
                                                          'cpu'), 'cpu')[0]
    step = R.TrainStep(cell.config, weights)
    with FlopCounterMode(display=False) as counter:
        step(slot['batch'], slot['draws'])
    # the reference runs G forward twice (its graph is built again for
    # G's backward, so that it never lives beside a D's)
    g_again = sum(2 * p[0] for p in work.generator_products(
        d, 2, True, d['g_cap']))
    assert counter.get_total_flops() == work.train_step_flops(d, 2) + g_again


def test_sample_call_flops_match_the_counter():
    cell = small_cell('cub-splitz-cap-ca.sample-320')
    R, d = cell.reference, cell.reference.dims(cell.config)
    P = R.make_weights(cell.config, inputs.generator(1, 'weights', 'cpu'),
                       'cpu', eval_build=True)['G']
    x = inputs.sample_inputs(d, 3, 2, 1, inputs.generator(1, 'sample_inputs',
                                                          'cpu'), 'cpu')[0]
    with FlopCounterMode(display=False) as counter:
        R.sample(cell.config, P, x['noise'], x['emb'], x['cls_prior'],
                 x['eps'])
    assert counter.get_total_flops() == work.sample_call_flops(d, 6, True)


def test_full_width_counts_and_capsule_launches():
    cell = small_cell('cub-splitz-cap-ca.train-b512', width=64)
    d = cell.reference.dims(cell.config)
    per_image = work.train_step_flops(d, 256) / 256
    assert 52.0e9 < per_image < 52.5e9
    launches = work.capsule_launches(d, 256, True, True)
    assert {k: n for k, (_, n) in launches.items()} == {
        'K1-G': 1, 'K2-G': 1, 'K1-D': 8, 'K2-D': 4, 'K2-D dx': 2}
    # the capsule layers' least time grows with the batch and is positive
    assert 0 < work.capsule_least_s(d, 32, True, True) \
        < work.capsule_least_s(d, 256, True, True)
    assert torch.isfinite(torch.tensor(work.capsule_least_s(d, 320, False,
                                                            True)))
