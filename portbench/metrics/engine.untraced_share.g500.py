"""engine.untraced_share.g500: the self time of the port's `engine.query`
spans that start in the window (each one's duration less the union of
its direct children's intervals), summed, as a share of their durations
summed: the part of a query that no span inside it explains
(`portbench.program_spans`)."""
from portbench.program_spans import seconds, window


def read(r):
    got = window(r)
    if got is None:
        return None
    queries = {s.id: s for s in got if s.name == "engine.query"}
    total = seconds(got, "engine.query")
    if total <= 0:
        return None
    children = {q: [] for q in queries}
    for s in got:
        if s.parent in children:
            children[s.parent].append((s.start, s.end))
    covered = 0.0
    for qid, kids in children.items():
        q = queries[qid]
        reach = q.start
        for a, b in sorted(kids):
            a, b = max(a, reach), min(b, q.end)
            if b > a:
                covered += b - a
                reach = b
    return 100.0 * (total - covered) / total
