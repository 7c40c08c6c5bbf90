"""The share of the traced window in which no kernel runs on the card."""


def read(trace, run):
    if trace is None or run['kind'] != 'train':
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
