"""Milliseconds a training step in the discriminators' update without
Adam, on the card's clock: the port's ``step.d_passes`` (three passes and
errD) and ``step.d_backward`` spans of every D, each from the CUDA event
that opens it to the one that closes it. That is the card's wall time in
the phases, idle included, not their kernels' busy time."""

import spanread


def read(trace, run):
    if run['kind'] != 'train':
        return None
    return spanread.mean_device_ms(trace, 'step',
                                   ('step.d_passes', 'step.d_backward'))
