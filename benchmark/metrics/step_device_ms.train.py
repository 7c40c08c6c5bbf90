"""Device time a training step: every kernel in the trace, over the steps
it covers."""


def read(trace, run):
    if trace is None or run['kind'] != 'train':
        return None
    return 1e3 * trace.kernel_seconds() / trace.units
