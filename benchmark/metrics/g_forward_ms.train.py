"""Milliseconds a training step in G's forward, on the card's clock: the
port's ``step.g_forward`` span (G, its images and the fused mu), from the
CUDA event that opens it to the one that closes it. That is the card's
wall time in the phase, idle included, not its kernels' busy time."""

import spanread


def read(trace, run):
    if run['kind'] != 'train':
        return None
    return spanread.mean_device_ms(trace, 'step', ('step.g_forward',))
