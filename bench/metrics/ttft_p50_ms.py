"""Median time to first token over every request sent inside the window,
in ms: from its due time (open loop) or its send (closed loop) to the end
of the step that produced its first token. A request with no first token
by the end of the drain counts as infinitely late."""
from harness.observed import percentile


def read(run):
    v = percentile(run.ttfts(), 50)
    return None if v is None else v * 1e3
