"""The port's serving queues against the JAX package's, on the CPU: the
same calls on `BoundedPriorityQueue`, `ClientCaps`, `RetryPolicy` and
`CircuitBreaker` give the same outputs and raise the same typed errors."""
import threading
import time

import numpy as np
import pytest

from repro.engine import queueing as JQ
from repro_torch.engine import queueing as TQ


def _outcome(fn):
    """A call's return value, or its error's type name and message."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("err", type(e).__name__, str(e))


def _queue_script(mod, seed):
    """A seeded run of puts, forced puts, pops, batch pops, removes and a
    close on one queue; every outcome recorded."""
    rng = np.random.default_rng(seed)
    q = mod.BoundedPriorityQueue(5)
    out = []
    for i in range(60):
        op = rng.integers(6)
        if op <= 1:
            item = (str(rng.choice(list("xyz"))), int(rng.integers(1, 4)), i)
            out.append(_outcome(lambda: q.put(
                item, priority=int(rng.integers(3)),
                force=bool(rng.random() < 0.2))))
        elif op == 2:
            out.append(_outcome(lambda: q.get(timeout=0)))
        elif op == 3:
            out.append(_outcome(lambda: q.get_batch(
                0, key=lambda it: it[0], max_items=int(rng.integers(1, 5)),
                weight=lambda it: it[1],
                max_weight=int(rng.integers(1, 8)))))
        elif op == 4:
            out.append(_outcome(lambda: q.remove(lambda it: it[2] % 3 == 0)))
        else:
            out.append(("len", len(q), q.high_water))
    out.append(_outcome(q.close))
    out.append(_outcome(lambda: q.put(("x", 1, -1))))
    out.append(_outcome(lambda: q.get(0)))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_queue_gives_the_same_outputs(seed):
    assert _queue_script(TQ, seed) == _queue_script(JQ, seed)


def _window_script(mod):
    """`get_batch` with a window: a late compatible item joins, a stop
    predicate ends the wait, a non-extendable head never waits."""
    q = mod.BoundedPriorityQueue(8)
    q.put(("x", 0))
    t = threading.Timer(0.05, lambda: q.put(("x", 1)))
    t.start()
    got = [it[1] for it in q.get_batch(
        1.0, key=lambda it: it[0], max_items=2, window_s=2.0)]
    t.join()
    q.put(("y", 2))
    t0 = time.monotonic()
    stopped = [it[1] for it in q.get_batch(
        1.0, key=lambda it: it[0], max_items=4, window_s=5.0,
        stop_wait=lambda popped: True)]
    q.put(("z", 3))
    head = [it[1] for it in q.get_batch(
        1.0, key=lambda it: it[0], max_items=4, window_s=5.0,
        extendable=lambda it: False)]
    return got, stopped, head, time.monotonic() - t0 < 4.0


def test_batch_window_behaves_alike():
    assert _window_script(TQ) == _window_script(JQ) == \
        ([0, 1], [2], [3], True)


def test_batch_pop_error_carries_the_popped_items():
    for mod in (TQ, JQ):
        q = mod.BoundedPriorityQueue(4)
        q.put(1)
        q.put(2)

        def bad_key(it):
            if it == 2:
                raise KeyError("boom")
            return 0
        with pytest.raises(mod.BatchPopError) as e:
            q.get_batch(0, key=bad_key, max_items=4)
        assert e.value.items == [1]


def _caps_script(mod):
    caps = mod.ClientCaps(2)
    out = [_outcome(lambda: caps.acquire(c)) for c in "aabab"]
    out.append(caps.inflight("a"))
    caps.release("a")
    caps.release("z")
    out += [_outcome(lambda: caps.acquire("a")), caps.inflight("a"),
            caps.inflight("b"), caps.max_inflight]
    out.append(_outcome(lambda: mod.ClientCaps(0)))
    return out


def test_client_caps_alike():
    mine, ref = _caps_script(TQ), _caps_script(JQ)
    assert mine == ref
    assert ("err", "ServerOverloaded",
            "server overloaded (client_inflight): client 'a' has 2 queries "
            "in flight (cap 2)") in mine


@pytest.mark.parametrize("kw", [
    {}, dict(max_retries=0), dict(backoff_initial_s=0.5,
                                  backoff_multiplier=3.0, backoff_max_s=4.0),
    dict(backoff_multiplier=1.0), dict(max_retries=-1),
    dict(backoff_multiplier=0.5), dict(backoff_initial_s=-1.0)])
def test_retry_backoff_alike(kw):
    def run(mod):
        pol = _outcome(lambda: mod.RetryPolicy(**kw))
        if pol[0] == "err":
            return pol
        p = pol[1]
        return (p.max_retries, [p.backoff(a) for a in range(0, 12)])
    assert run(TQ) == run(JQ)


def _breaker_script(mod, clock):
    """Failures, successes, aborts and probes against a fake clock."""
    br = mod.CircuitBreaker(threshold=3, reset_after_s=1.0)
    out = []
    steps = ["fail", "fail", "ok", "fail", "fail", "fail", "allow", "tick",
             "allow", "allow", "abort", "allow", "fail", "allow", "tick",
             "allow", "ok", "allow", "fail", "fail", "fail", "tick", "allow",
             "ok"]
    for s in steps:
        if s == "fail":
            br.record_failure()
        elif s == "ok":
            br.record_success()
        elif s == "abort":
            br.record_abort()
        elif s == "tick":
            clock[0] += 1.5
        else:
            out.append(br.allow())
        out.append((s, br.snapshot()))
    out.append(_outcome(lambda: mod.CircuitBreaker(threshold=0)))
    return out


def test_circuit_breaker_alike(monkeypatch):
    clock = [100.0]
    for mod in (TQ, JQ):
        monkeypatch.setattr(mod.time, "monotonic", lambda: clock[0])
    clock[0] = 100.0
    mine = _breaker_script(TQ, clock)
    clock[0] = 100.0
    ref = _breaker_script(JQ, clock)
    assert mine == ref
    states = {x[1]["state"] for x in mine
              if isinstance(x, tuple) and isinstance(x[1], dict)}
    assert states == {"closed", "open", "half_open"}


def test_typed_errors_alike():
    for name in ("QueueFull", "QueueClosed", "BatchPopError",
                 "ServerOverloaded", "SessionUnavailable"):
        assert getattr(TQ, name).__mro__[1].__name__ == \
            getattr(JQ, name).__mro__[1].__name__
    for mod in (TQ, JQ):
        e = mod.ServerOverloaded("queue_full", "depth 3")
        assert (e.reason, e.detail, str(e)) == (
            "queue_full", "depth 3", "server overloaded (queue_full): depth 3")
        e = mod.SessionUnavailable("g", "open", "3 failures")
        assert (e.session, e.state) == ("g", "open")
