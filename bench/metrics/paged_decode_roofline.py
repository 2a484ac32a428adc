"""The paged decode kernel's share of its roofline in the traced slice, in
%: the least time its calls could take (every layer of every decode call,
from the real rows' bytes and operations: ``work.paged_decode_work``) over
the device time of its two kernels (``decode_split``, ``decode_combine``)."""
from harness.work import bound, paged_decode_work


def read(run):
    if run.trace is None:
        return None
    dev = run.trace.kernel_s(r"decode_split|decode_combine")
    if dev <= 0:
        return None
    p, w = run.port, run.work
    steps = [s for s in run.record.steps if s.profiled]
    t = sum(bound(*paged_decode_work(ctxs, w.hq, w.hkv, w.hd,
                                     run.cell["page_size"]))
            for ctxs in run.decode_contexts(steps)) * p["num_layers"]
    return 100.0 * t / dev
