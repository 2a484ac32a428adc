"""Model operations of the decoded tokens of the decode-only steps (steps
with no prefill) over those steps' wall time and the bf16 peak, in %;
outside the traced slice."""
from harness.work import BF16_FLOPS


def read(run):
    steps = [s for s in run.steps(profiled=False) if not s.prefills]
    wall = sum(s.t1 - s.t0 for s in steps)
    if not steps or wall <= 0:
        return None
    return 100.0 * run.step_flops(steps)[1] / (wall * BF16_FLOPS)
