"""Host time of a ``bag_reduce`` call (enqueue, not the card's work): the
mean of the spans around the calls of the untraced stretch."""


def read(run):
    spans = run.spans.of("bag_reduce")
    if not spans:
        return None
    return sum(s.seconds for s in spans) / len(spans) * 1e6
