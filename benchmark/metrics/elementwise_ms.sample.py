"""Device time a call in ATen's elementwise and reduce kernels: the
blocks' eager BatchNorm, GLU, LeakyReLU, casts and sums."""

PATTERNS = ('elementwise_kernel', 'reduce_kernel')


def read(trace, run):
    if trace is None or run['kind'] != 'sample':
        return None
    return 1e3 * trace.seconds(PATTERNS) / trace.units
