"""The capsule layers' least time a call (from the heads' shapes and the
launches the model's structure needs, benchmark/work.py) over their
device time a call in the trace. The kernels are the port's capsule
routing kernels, found by name."""

PATTERNS = ('routing_fwd_factored_cluster_kernel',
            'routing_votes_fwd_cluster_kernel',
            'routing_bwd_factored_cluster_kernel',
            'routing_bwd_cluster_kernel', 'dw_factored_kernel',
            'w_planes_kernel', 'gemm_tf32x3::')


def read(trace, run):
    if trace is None or run['kind'] != 'sample':
        return None
    device_s = trace.seconds(PATTERNS)
    if device_s <= 0 or not run.get('capsule_least_s'):
        return None
    return 100.0 * run['capsule_least_s'] * trace.units / device_s
