"""setup_s: process start to the first timed query: the graph made on
the device and copied to the host, the port's session (tiles, hash, CSR,
kernels) and the warm-up of the cell's shapes. Host clock; every cell."""


def read(r):
    return r.setup_s
