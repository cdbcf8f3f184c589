"""What the per-layer readers take from the port's own spans
(`repro_torch.runtime.trace`): the finished spans that start in a run's
window, their summed seconds by name, and a part of them as a share of
the summed `engine.query` spans. Each reader returns None on an open-loop
run, on a port without the recorder (as versions before it are), and
where a span of the window was dropped from the recorder's ring."""


def window(r):
    """The port's finished spans that start in [r.start, r.close), or
    None (see the module's docstring)."""
    if r.loop != "closed":
        return None
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    if trace.lost(r.start):
        return None
    return trace.spans(r.start, r.close)


def seconds(spans, name: str) -> float:
    return sum(s.end - s.start for s in spans if s.name == name)


def share(r, name: str, minus=None):
    """Σ `name` (less Σ `minus`) over Σ `engine.query`, in %; None where
    the window holds no `name` span (a path that has no such span, as
    the partitioned search has no `finalize` or `driver.init`)."""
    got = window(r)
    if got is None or not any(s.name == name for s in got):
        return None
    query = seconds(got, "engine.query")
    if query <= 0:
        return None
    part = seconds(got, name) - (seconds(got, minus) if minus else 0.0)
    return 100.0 * part / query


def per_level_ms(r, name: str):
    """Σ `name` over the levels searched (each driver run's distinct
    `level` attributes of `level.wait`), in ms."""
    got = window(r)
    if got is None:
        return None
    levels = {(s.parent, s.attrs.get("level")) for s in got
              if s.name == "level.wait"}
    if not levels:
        return None
    return 1e3 * seconds(got, name) / len(levels)
