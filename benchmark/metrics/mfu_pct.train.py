"""The model's operations a step (counted from the configuration's
shapes by the benchmark, whatever runs them) times the step rate of the
run's untraced window, over the card's bf16 peak of 989 TFLOP/s."""

BF16_FLOPS = 989e12


def read(trace, run):
    if run['kind'] != 'train' or not run.get('units_per_s'):
        return None
    return 100.0 * run['flops_per_unit'] * run['units_per_s'] / BF16_FLOPS
