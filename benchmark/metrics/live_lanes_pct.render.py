"""Percent of the lanes a render issues at its bounces that are still
alive there (their walk can still hit): 100 * sum of the program's
"lanes.live.<bounce>" tallies over sum of its "lanes.issued.<bounce>"
counts, over the window (benchmark/program_spans.py)."""
from benchmark import program_spans


def read(run):
    c = program_spans.counters(run)
    if not c:
        return None
    issued = sum(v for k, v in c.items() if k.startswith("lanes.issued."))
    live = sum(v for k, v in c.items() if k.startswith("lanes.live."))
    return 100.0 * live / issued if issued else None
