"""Model operations of the prompts prefilled inside the window over the
prefill's share of the wall time and the bf16 peak, in %: the wall of the
steps that prefilled, less as many mean decode-only steps (the decode each
of them ran too); outside the traced slice."""
from harness.work import BF16_FLOPS


def read(run):
    steps = run.steps(profiled=False)
    pre = [s for s in steps if s.prefills]
    dec = [s for s in steps if not s.prefills]
    if not pre or not dec:
        return None
    mean_dec = sum(s.t1 - s.t0 for s in dec) / len(dec)
    wall = sum(s.t1 - s.t0 for s in pre) - len(pre) * mean_dec
    if wall <= 0:
        return None
    return 100.0 * run.step_flops(pre)[0] / (wall * BF16_FLOPS)
