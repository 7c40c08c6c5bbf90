"""Device time a training step in the layout conversions around the bf16
cuDNN convolutions."""

PATTERNS = ('nchwToNhwc', 'nhwcToNchw')


def read(trace, run):
    if trace is None or run['kind'] != 'train':
        return None
    return 1e3 * trace.seconds(PATTERNS) / trace.units
