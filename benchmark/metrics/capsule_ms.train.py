"""Milliseconds a training step in the capsule op, every head, forward and
backward, on the card's clock: the port's ``capsule.fwd`` and
``capsule.bwd`` spans (K1 and K2 on the card), each from the CUDA event
that opens it to the one that closes it, idle included."""

import spanread


def read(trace, run):
    if run['kind'] != 'train':
        return None
    return spanread.mean_device_ms(trace, 'step',
                                   ('capsule.fwd', 'capsule.bwd'))
