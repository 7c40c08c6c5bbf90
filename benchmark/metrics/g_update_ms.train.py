"""Milliseconds a training step in G's loss through the updated
discriminators and its backward, on the card's clock: the port's
``step.g_loss`` and ``step.g_backward`` spans, each from the CUDA event
that opens it to the one that closes it. That is the card's wall time in
the phases, idle included, not their kernels' busy time."""

import spanread


def read(trace, run):
    if run['kind'] != 'train':
        return None
    return spanread.mean_device_ms(trace, 'step',
                                   ('step.g_loss', 'step.g_backward'))
