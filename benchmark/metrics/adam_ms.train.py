"""Milliseconds a training step in the Adam updates, on the card's clock:
the port's ``step.d_adam`` spans of every D and its ``step.g_adam`` span,
each from the CUDA event that opens it to the one that closes it. That is
the card's wall time in the updates, idle included."""

import spanread


def read(trace, run):
    if run['kind'] != 'train':
        return None
    return spanread.mean_device_ms(trace, 'step',
                                   ('step.d_adam', 'step.g_adam'))
