"""Host milliseconds a sampler call from its start to its return: the
host time of the port's ``sample.call`` span, in which the call enqueues
its work and does not wait for it."""

import spanread


def read(trace, run):
    if run['kind'] != 'sample':
        return None
    got = spanread.units(trace, 'sample.call')
    if got is None:
        return None
    roots = [u['spans'][0] for u in got]
    return sum(r['host_end_ns'] - r['host_start_ns']
               for r in roots) / 1e6 / len(roots)
