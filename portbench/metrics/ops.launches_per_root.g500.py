"""ops.launches_per_root.g500: kernel launches of the window
(`kernels.ops.LAUNCHES`, an exact count) over the roots it searched.
Closed-loop cells."""


def read(r):
    launches = sum(r.launches.values())
    if r.loop != "closed" or r.roots <= 0 or launches <= 0:
        return None
    return launches / r.roots
