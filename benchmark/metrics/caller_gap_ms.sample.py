"""Device milliseconds between two sampler calls: from the CUDA event
that closes one ``sample.call`` span to the one that opens the next,
averaged over the calls after the first. The card waits on its caller
there."""

import spanread


def read(trace, run):
    if run['kind'] != 'sample':
        return None
    got = spanread.units(trace, 'sample.call')
    if got is None or len(got) < 2:
        return None
    roots = [u['spans'][0] for u in got]
    if any(r['device_start_ms'] is None for r in roots):
        return None
    gaps = [b['device_start_ms'] - a['device_end_ms']
            for a, b in zip(roots, roots[1:])]
    return sum(gaps) / len(gaps)
