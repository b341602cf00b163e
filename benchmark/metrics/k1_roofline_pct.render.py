"""K1's share of its roofline in a render: the least time its work needs at
the card's peak memory bandwidth (benchmark/roofline.py), over its device
time a render.  The work is counted from the reference's own trace of the
sampled pixels (rays at each bounce, scaled to the image), never from the
program."""
from benchmark import roofline


def read(run):
    c = run.ctx.counters
    if run.trace is None or "rays.closest" not in c:
        return None
    s = sum(v for name, v in run.trace["per_name"].items() if "bvh_traverse" in name)
    if s <= 0:
        return None
    nbytes = roofline.k1_bytes(c["rays.closest"], c["rays.shadow"], c["num_tris"],
                               c["bounces"])
    return roofline.least_seconds(nbytes) / (s / run.units) * 100.0
