"""Median wait in the engine's queue, in ms: from a request's send (its due
time in an open loop) to the start of the step that prefilled it, over the
requests sent inside the window that were prefilled, outside the traced
slice."""
from harness.observed import percentile


def read(run):
    prof = {s.idx for s in run.record.steps if s.profiled}
    waits = [run.record.step_at[s.prefill_step].t0 - s.sent
             for s in run.attempted()
             if s.prefill_step >= 0 and s.prefill_step not in prof]
    v = percentile(waits, 50)
    return None if v is None else v * 1e3
