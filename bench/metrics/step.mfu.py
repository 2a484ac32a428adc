"""All model operations of the steps inside the window (prompts and
decoded tokens) over their wall time and the bf16 peak, in %; outside the
traced slice."""
from harness.work import BF16_FLOPS


def read(run):
    steps = run.steps(profiled=False)
    wall = sum(s.t1 - s.t0 for s in steps)
    if not steps or wall <= 0:
        return None
    return 100.0 * sum(run.step_flops(steps)) / (wall * BF16_FLOPS)
