"""The yardstick's arithmetic against hand counts at a tiny size: the
percentile, the operation and byte counts, the metric readers over a
hand-built run, and the trace's busy time, idle gaps and kernel names."""
import numpy as np
import pytest

import benchkit
from harness import registry, work
from harness.observed import Run, percentile
from harness.serve import Record, Served, Step
from harness.trace import TraceData, short
from harness.traffic import Planned


def test_percentile():
    assert percentile([], 50) is None
    assert percentile([1, 2, 3, 4], 50) == 2.5
    assert percentile(list(range(11)), 90) == pytest.approx(9.0)


def test_model_work_by_hand():
    w = work.ModelWork(benchkit.DENSE)
    # per layer: q 64x64, k and v 64x32 each, o 64x64, SwiGLU 3 x 64x128
    per_layer = 64 * 64 * 2 + 2 * 64 * 32 + 3 * 64 * 128
    assert w.matmul_params == per_layer
    # 2 layers x (2 flops a weight + 4 * 4 heads * 16 * 10 keys) + logits
    assert w.token_flops(10) == 2 * (2 * per_layer + 4 * 4 * 16 * 10) \
        + 2 * 64 * 256
    assert w.prefill_flops(3) == 2 * (2 * per_layer * 3 + 4 * 4 * 16 * 6) \
        + 2 * 64 * 256
    m = work.ModelWork(benchkit.MOE)
    assert m.matmul_params == 64 * 64 * 4 + 64 * 8 + 2 * 3 * 64 * 32


def test_kernel_work_by_hand():
    b, f = work.attention_work(4, 4, 2, 1, 8)
    assert b == (2 * 4 * 2 * 8 + 2 * 4 * 1 * 8) * 2
    assert f == 4 * 2 * 8 * (1 + 2 + 3 + 4)
    b, f = work.paged_decode_work([5, 17], 4, 2, 16, 16)
    assert f == 4 * 4 * 16 * 22
    assert b == 2 * (2 * 4 * 16 * 2) + 22 * 2 * 2 * 16 * 2 + (1 + 2) * 4
    assert work.bound(3.35e12, 0) == pytest.approx(1.0)
    assert work.bound(0, 989e12) == pytest.approx(1.0)


def _run(trace=None):
    """Two steps of one tenant: step 1 prefills a (prompt 3) and decodes its
    token 1; step 2 decodes a's token 2 and b's token 1 (b prefilled in
    step 2 too, prompt 5)."""
    class R:
        def __init__(self, times, gen, slot):
            self.token_times, self.generated = times, gen
            self.finished, self.slot, self.t_first_token = True, slot, 1
    pa = Planned("a", 0, np.zeros(3, np.int32), 3, due=0.0)
    pb = Planned("b", 0, np.zeros(5, np.int32), 2, due=0.05)
    a = Served(pa, "t.0", 0.0, True, R([1, 1, 2], [7, 8, 9], 0), 0, 1)
    b = Served(pb, "t.0", 0.05, True, R([2, 2], [3, 4], 1), 1, 2)
    steps = [Step(1, 0.0, 0.1, prefills=1), Step(2, 0.1, 0.3, prefills=1)]
    rec = Record(steps, [a, b], 0.3, 0.3, 0.0, [], [0.0, 0.0], 0, [])
    return Run(rec, benchkit.CELLS["tiny-dense.open"], benchkit.OPEN_MIX,
               benchkit.DENSE, 0.3, 12.5, trace=trace)


def test_readers_on_a_hand_built_run():
    run = _run()
    read = lambda n: registry.metric(n).read(run)
    # first tokens at 0.1 (a, due 0) and 0.3 (b, due 0.05)
    assert read("ttft_p50_ms") == pytest.approx(
        np.percentile([100.0, 250.0], 50))
    # gaps: a 0, 0.2; b 0
    assert read("tbt_mean_ms") == pytest.approx(200.0 / 3)
    assert read("output_tokens_per_s") == pytest.approx(5 / 0.3)
    assert read("setup_s") == 12.5
    assert read("engine.queue_wait_ms_p50") == pytest.approx(
        np.median([0.0, 50.0]))
    # decode calls: step 1 one row (a), step 2 two rows (a, b)
    assert read("engine.decode_batch_mean") == pytest.approx(1.5)
    assert read("decode.graph_captures") == 0
    assert read("decode.mfu") is None          # no decode-only step
    assert read("prefill.mfu") is None
    w = run.work
    flops = w.prefill_flops(3) + w.prefill_flops(5) + w.token_flops(4) \
        + w.token_flops(5) + w.token_flops(6)
    assert read("step.mfu") == pytest.approx(
        100 * flops / (0.3 * work.BF16_FLOPS))
    for n in ("paged_decode_roofline", "flash_roofline",
              "device.idle_share"):
        assert read(n) is None                 # untraced
    # a closed-loop cell's name for a quantity reads the same reader
    assert read("step.mfu.batch") == read("step.mfu")


def test_trace_readers():
    ops = [("void decode_split<bf16, 4>(int)", 0, 10),
           ("decode_combine<bf16>", 10, 12), ("flash_wgmma<2>", 30, 50),
           ("Memcpy HtoD", 45, 60)]
    spans = [("bench.step", 0, 100), ("engine.prefill", 20, 40),
             ("bench.wait", 100, 130)]
    t = TraceData(ops, spans, 0, 100)
    assert t.busy_intervals() == [(0, 12), (30, 60)]
    assert t.busy_s == pytest.approx(42e-9)
    assert t.window_s == pytest.approx(100e-9)
    assert t.kernel_s("decode_split|decode_combine") == pytest.approx(12e-9)
    assert dict(map(tuple, t.idle_by_host())) == pytest.approx(
        {"engine.prefill": 18e-9, "bench.step": 40e-9})
    assert short("void decode_split<__nv_bfloat16, 4, 2, 8>(float const*)") \
        == "decode_split"
    run = _run(trace=t)
    for s in run.record.steps:
        s.profiled = True
    idle = registry.metric("device.idle_share").read(run)
    assert idle == pytest.approx(58.0)
    pd = registry.metric("paged_decode_roofline").read(run)
    ctx = [[4], [5, 6]]
    bound = sum(work.bound(*work.paged_decode_work(c, 4, 2, 16, 4))
                for c in ctx) * 2
    assert pd == pytest.approx(100 * bound / 12e-9)
    fl = registry.metric("flash_roofline").read(run)
    fb = (work.bound(*work.attention_work(3, 3, 4, 2, 16))
          + work.bound(*work.attention_work(5, 5, 4, 2, 16))) * 2
    assert fl == pytest.approx(100 * fb / 20e-9)
