"""bfs_kernels_roofline: the least time of the traced slice's BFS kernel
calls (`bounds.bound` of each `kernels.ops` call's inputs, over the HBM
bandwidth) as a share of the device time the port's BFS kernels took in
that slice (`bounds.KERNEL_SYMBOLS`). Closed-loop cells."""


def read(r):
    if r.device is None or r.bound_s is None or r.device["kernel_s"] <= 0:
        return None
    return 100.0 * r.bound_s / r.device["kernel_s"]
