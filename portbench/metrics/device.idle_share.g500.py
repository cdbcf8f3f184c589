"""device.idle_share.g500: the share of the traced slice in which no
operation ran on the device (1 - the union of the device-op intervals
over the slice's wall)."""


def read(r):
    if r.device is None or r.device["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - r.device["busy_s"] / r.device["window_s"])
