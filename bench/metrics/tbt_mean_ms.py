"""Mean of every gap between consecutive tokens of every request, the later
token inside the window, in ms (a prefill and the first decode share a
step, so each request's first gap is 0): the mean inter-token latency, in
which each step's time counts once for every token it produced."""


def read(run):
    gaps = run.tbts()
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
