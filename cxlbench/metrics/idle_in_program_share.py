"""Share of the device's idle time in the traced window that the program's
own spans cover on the host: the union of every ``repro.*`` marker (the
routed lookup ``repro.interleave.bag_reduce``, Python's collections
``repro.gc.gen<N>``, ...), so the rest of the idle time lies in the
benchmark's loop and its waits.  The reader of
``idle_in_program_share.<cells>``, and of the idle arithmetic the other
``idle_in_*`` readers share."""
from cxlbench.devtrace import union

PREFIX = "repro."


def idle(tr) -> list[tuple[float, float]]:
    """The window's intervals in which nothing ran on the device."""
    gaps, last = [], tr.t0
    for a, b in tr.busy() + [(tr.t1, tr.t1)]:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    return gaps


def overlap(xs, ys) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share_in(tr, keep):
    """Share of the window's idle time inside the spans whose name
    ``keep`` accepts; None without a trace or without such a span."""
    if tr is None:
        return None
    spans = [(a, b) for n, a, b in tr.spans if keep(n)]
    if not spans:
        return None
    gaps = idle(tr)
    total = sum(b - a for a, b in gaps)
    if total <= 0:
        return 0.0
    return overlap(gaps, union(spans)) / total


def read(run):
    return idle_share_in(run.devtrace, lambda n: n.startswith(PREFIX))
