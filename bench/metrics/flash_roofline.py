"""The flash attention kernel's share of its roofline in the traced slice,
in %: the least time of every layer's causal attention over each prompt
prefilled there (``work.attention_work``) over the device time of the
``flash_wgmma`` kernels."""
from harness.work import attention_work, bound


def read(run):
    if run.trace is None:
        return None
    dev = run.trace.kernel_s(r"flash_wgmma")
    if dev <= 0:
        return None
    w = run.work
    idx = {s.idx for s in run.record.steps if s.profiled}
    t = sum(bound(*attention_work(s.plan.prompt.size, s.plan.prompt.size,
                                  w.hq, w.hkv, w.hd))
            for st, reqs in run.prefills().items() if st in idx
            for s in reqs) * run.port["num_layers"]
    return 100.0 * t / dev
