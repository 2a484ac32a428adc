"""The share of the traced slice in which no operation ran on the device,
in %: 1 less the union of the device's operation intervals over the
slice."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
