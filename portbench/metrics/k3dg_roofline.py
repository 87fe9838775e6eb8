"""K3dg's share of its DRAM bound, in percent, over the profiled episode:
the sum over its launches of each launch's bound (6 field passes x 4 B x
lanes x m^3 over 3.35 TB/s, ``roofline.py``, at the lanes and m of that
launch's call) over the sum of their device times.  The launches are the
port's ``cheb_iter_dg`` calls, matched by count to the trace's ChebDiag
kernels; where the counts differ the share is not read."""

from portbench import roofline

WRAPPER = "cheb_iter_dg"
KERNEL = "ChebDiag"


def read(run: dict):
    trace = run["trace"]
    if not trace:
        return None
    calls = [c for c in trace["launches"] if c["kernel"] == WRAPPER]
    hits = [v for k, v in trace["kernels"].items() if KERNEL in k]
    count = sum(c for c, _ in hits)
    seconds = sum(s for _, s in hits)
    if not calls or count != len(calls) or seconds <= 0:
        return None
    bound = sum(roofline.bound_s(WRAPPER, c["lanes"], c["m"] ** 3, c["p"])[0] for c in calls)
    return 100.0 * bound / seconds
