"""Device milliseconds a sampler call in which no kernel runs: the
``sample.call`` span's device time less the trace's busy time a call.
The card waits on the call's own host work there."""

import spanread


def read(trace, run):
    if run['kind'] != 'sample':
        return None
    ms = spanread.mean_device_ms(trace, 'sample.call', ('sample.call',))
    if ms is None:
        return None
    return ms - 1e3 * trace.busy_s / trace.units
