"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device and the CUDA
toolkit. It imports the port (``src/repro_torch``) and nothing of JAX or of
the JAX package, and exits non-zero, printing no result line, when there is
no CUDA device or any phase fails. Phases:

0. device: the card's name and power limit (nvidia-smi); TF32 off.
1. build: the hand-written CUDA kernels, from ``src/repro_torch/kernels/csrc``.
2. kernels: each attention kernel against its plain PyTorch version at
   llama3-8b head shapes (Hq 32, Hkv 8, D 128, page 16), f32 within 1e-4
   and bf16 within 2e-2: paged decode and prefill on wide page tables
   (N 192) and on phase 3's own (N 36: decode at contexts 513-544 and on
   the splits' edges, prefill at its two 256-token chunks); ssd_scan
   against its plain version at xLSTM width (T 512, H 4, dk 512, dv 513,
   bf16 q/k), at a ragged T 509 and at Mamba's widths (H 128, dk 16,
   dv 64), within 1e-4 * max(1, max|plain|) for y and the final state,
   and the state continuation (kernel over T, one plain decode step,
   against the kernel over T + 1); each kernel's time (CUDA events; the
   attention kernels' calls replayed from CUDA graphs), the plain
   version's time, the least time the card could take (bound) and, for
   flash, the time of one PyTorch SDPA call as a yardstick; paged decode's time is that of its two launches (the KV
   splits and their combine), also split between them by the profiler,
   and at ctx 2048; paged prefill also at the check's shape (two 256-token
   chunks at q_start 768 and 2048). The build prints each kernel's
   registers and spills (ptxas).
3. serve: llama3-8b at full width and depth (32 layers, bf16, seeded random
   weights) through ``ServingEngine`` in mirage mode with a paged tenant:
   8 prompts of 512 tokens, 32 new tokens each, once with monolithic
   prefill (flash kernel) and once with 256-token chunks (paged prefill
   kernel); both decode through the paged decode kernel.
4. remap: two llama3-8b-width tenants cut to 2 layers, one trace with a
   small KV pool (the controller remaps parameter memory into the pool and
   the donor's layers stream from pinned host memory) and with an ample
   pool; the generated tokens must be identical.
5. xlstm serve: xlstm-1.3b at full width and depth (48 layers, bf16) as a
   dense recurrent tenant, 8 prompts of 512 tokens, 32 new tokens each,
   monolithic prefill (the ssd_scan kernel in its 42 mLSTM layers); each
   prompt's first-token logits against a prefill of all but its last token
   followed by one decode step; a few decode steps timed, then profiled
   (launches, device time and the device's idle share).
6. xlstm remap: two full-depth xlstm-1.3b tenants, a small KV budget (the
   controller remaps repeats of one tenant, which then streams them from
   pinned host memory) and an ample one; identical tokens.
7. the kernels line (JSON) and, last, the result line (JSON).
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa: E402,E501
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.paged_attention import ops as paged_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402
from repro_torch.models.blocks import ssd_decode_step  # noqa: E402
from repro_torch.models import attention_ops as plain  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.serving import ServingEngine, TenantConfig  # noqa: E402
from repro_torch.serving.traces import tiny_trace  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
F32_FLOPS = 67e12                  # f32 outside the tensor cores
HQ, HKV, D, PAGE = 32, 8, 128, 16  # llama3-8b attention, engine page
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Phase 3 compares the first-token logits of the monolithic (flash) and the
# chunked (paged prefill) runs. Both are bf16 end to end: every activation
# is rounded to 8 significant bits (2^-9 ~ 2e-3 relative) at each of the
# 32 layers' attention outputs, residual adds and projections, and the two
# kernels sum in a different order, so the roundings differ and compound
# through the stack. 5e-2 of the largest logit bounds that budget.
LOGIT_RTOL = 5e-2

SOURCES = {
    "paged_decode_attention": (
        "src/repro_torch/kernels/csrc/paged_decode.cu",
        "src/repro/kernels/paged_attention/kernel.py:231"),
    "paged_prefill_attention": (
        "src/repro_torch/kernels/csrc/paged_prefill.cu",
        "src/repro/kernels/paged_attention/kernel.py:172"),
    "flash_attention": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:96"),
    "ssd_scan": (
        "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan/kernel.py:76"),
}
# ssd_scan against its plain version: y and the final state within
# SSD_RTOL * max(1, max|plain|). Both run f32 arithmetic on the same
# (bf16-rounded) inputs; they differ in the chunk (64 tokens in the kernel,
# the largest divisor of T up to 128 in the plain version) and in summation
# order, ~1e-6 relative per product over sums of up to dk = 512 terms.
SSD_RTOL = 1e-4


# the serve phase's requests: prompt tokens and new tokens each
PROMPT, NEW = 512, 32
# the xlstm remap phase's requests and KV budgets (tight, ample)
REMAP_PROMPT, REMAP_NEW, REMAP_PAGES = 96, 16, (16, 256)
# where phases 3 and 4 run: always the card here; a CPU rehearsal of the
# script's control flow at a tiny size sets "cpu"
DEVICE = "cuda"


def _sync() -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def _reset_peak() -> None:
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _peak() -> int:
    return torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


# ----------------------------------------------------------------- timing
def time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graphed(fn, calls: int):
    """``calls`` calls of ``fn`` captured in one CUDA graph, and a callable
    that replays them: timing it measures the device's work alone, without
    the host's cost of each call (the wrapper's checks and its launch),
    which is longer than a short kernel's run."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    return g.replay


def device_ms(fn, calls: int, reps: int) -> float:
    """Milliseconds a call of ``fn`` keeps the device busy: ``calls`` calls
    replayed from a CUDA graph ``reps`` times, over CUDA events."""
    return time_ms(graphed(fn, calls), reps) / calls


def time_turns(fns, reps, rounds: int = 2):
    """Each callable of ``fns`` (name -> fn) timed ``rounds`` times over
    ``reps`` launches (an int, or name -> int), in turns (a b, then b a,
    ...), so that a change of clock or power between them falls on all
    alike. Returns (name -> mean ms, name -> each ms)."""
    each = {name: [] for name in fns}
    order = list(fns)
    for fn in fns.values():     # clocks up and caches warm before the turns
        time_ms(fn, 3, warmup=5)
    for r in range(rounds):
        for name in order if r % 2 == 0 else order[::-1]:
            n = reps[name] if isinstance(reps, dict) else reps
            each[name].append(time_ms(fns[name], n))
    return {n: sum(t) / len(t) for n, t in each.items()}, each


def host_us_per_call(fn, reps: int = 200) -> float:
    """Host microseconds a call takes to return (checks, encoding and
    enqueue; the device runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def _fmt(times) -> str:
    return "/".join(f"{t:.4f}" for t in times)


# The kernels' times on the parent commit (PERF.md, NVIDIA H100 80GB HBM3 at
# 700 W), printed beside this run's; keyed by (kernel, shape). The
# attention kernels: by CUDA-graph replay (tools/kernel_ab.py, parent and
# change in turns); ssd_scan: eager calls of the parent's own
# chip_smoke.py, which its length kept device-bound.
EARLIER_MS = {("flash_attention", 512): 0.0136,
              ("flash_attention", 2048): 0.0856,
              ("ssd_scan", "xlstm"): 0.1358, ("ssd_scan", "mamba"): 0.0883,
              ("paged_prefill_attention", None): 0.1285,
              ("paged_prefill_attention", 2): 0.6543,
              ("paged_decode_attention", None): 0.0710,
              ("paged_decode_attention", 2048): 0.2579}


def _earlier(name, shape, ms: float) -> str:
    old = EARLIER_MS.get((name, shape))
    return "" if old is None else f"; before: {old} ms ({old / ms:.2f}x)"


def bound(nbytes: float, flops: float, f32_flops: float = 0.0):
    """(ms, "bytes" | "operations"): the larger of bytes over the memory
    rate and operations over their peak: ``flops`` on bf16 operands at the
    bf16 tensor-core rate, ``f32_flops`` at the f32 rate."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_f = flops / BF16_FLOPS + f32_flops / F32_FLOPS
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def visible(qpos: int, kv_limit: int, window: int, causal: bool = True) -> int:
    """Keys a query at ``qpos`` sees below ``kv_limit``."""
    hi = min(kv_limit, qpos + 1) if causal else kv_limit
    lo = max(0, qpos - window + 1) if window > 0 else 0
    return max(hi - lo, 0)


def attention_work(sq: int, sk: int, hq: int, hkv: int, d: int,
                   causal: bool = True, window: int = 0):
    """(bytes, flops) of one bf16 attention call at batch 1: Q, K and V read
    and O written once; Q K^T and P V are 4 D flops per query head and key
    that its query sees."""
    seen = sum(visible(i, sk, window, causal) for i in range(sq))
    return (2 * sq * hq * d + 2 * sk * hkv * d) * 2, 4 * hq * d * seen


# -------------------------------------------------------------- phase 0, 1
def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        raise SystemExit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} count="
        f"{torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")


def phase_build():
    t0 = time.perf_counter()
    path = build.build()
    build.load()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.build_seconds if build.build_seconds else 0:.2f} s)")
    for src, text in sorted(build.compile_log.items()):
        for k in ptxas_summary(text):
            log(f"[build] ptxas {src} {k['kernel']}: {k['registers']} "
                f"registers, {k['smem']} bytes static smem, spill stores "
                f"{k['spill_stores']} bytes, spill loads {k['spill_loads']} "
                f"bytes" + (", wgmma serialized (C7512)"
                            if k["wgmma_serialized"] else ""))


_TEMPLATE_ARGS = {"f": "float", "13__nv_bfloat16": "bf16"}


def kernel_name(mangled: str) -> str:
    """A readable name for a mangled kernel of this repo: the function's
    identifier (the one after its namespace) and its template arguments
    (types, ints and bools)."""
    names, i = [], mangled.find("N") + 1
    while i < len(mangled) and mangled[i].isdigit() and len(names) < 2:
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        names.append(mangled[j:j + n])
        i = j + n
    if len(names) < 2:
        return mangled
    m = re.match(r"I((?:Li-?\d+E|Lb[01]E|f|13__nv_bfloat16)+)E", mangled[i:])
    if not m:
        return names[1]
    args = [a or ("true" if b == "1" else "false") if not t else
            _TEMPLATE_ARGS[t] for a, b, t in
            re.findall(r"Li(-?\d+)E|Lb([01])E|(f|13__nv_bfloat16)",
                       m.group(1))]
    return f"{names[1]}<{', '.join(args)}>"


def ptxas_summary(log_text: str):
    """Per kernel in ``nvcc -Xptxas -v`` output: its registers, static
    shared memory, spilled bytes, and whether ptxas serialised its wgmma
    instructions for want of registers (warning C7512)."""
    serial = set(re.findall(r"C7512\).*function '(\w+)'", log_text))
    out, cur = [], None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"kernel": kernel_name(m.group(1)), "registers": 0,
                   "smem": 0, "spill_stores": 0, "spill_loads": 0,
                   "wgmma_serialized": m.group(1) in serial}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(m.group(1)) if m else 0
    return out


# ---------------------------------------------------------------- phase 2
def _pool(n_pages: int, dt, gen, layers: int = 1):
    shape = (layers, n_pages, PAGE, HKV, D)
    return (torch.randn(shape, generator=gen, device="cuda").to(dt),
            torch.randn(shape, generator=gen, device="cuda").to(dt))


def _page_table(b: int, n: int, n_pages: int, gen):
    perm = torch.randperm(n_pages, generator=gen, device="cuda")
    return perm[:b * n].view(b, n).to(torch.int32).contiguous()


def _err(out, ref) -> float:
    return (out.float() - ref.float()).abs().max().item()


def check_decode(gen, rows):
    """Long contexts on a wide table (N=192: 12 splits of 256 keys), with
    and without a window; then the serve phase's own table (N=36 for its
    576-token contexts: 5 splits of 128 keys), contexts over the range its
    decode steps reach (513-544), on and beside the splits' edges."""
    cases = ((192, [1, 17, 100, 513, 2048, 2500, 3000, 16], (0, 1000)),
             (36, [513, 520, 528, 537, 544, 512, 384, 129], (0,)))
    b = 8
    for n, lens, windows in cases:
        for dt in (torch.float32, torch.bfloat16):
            kp, vp = (x[0] for x in _pool(b * n + 1, dt, gen))
            pt = _page_table(b, n, b * n + 1, gen)
            q = torch.randn(b, HQ, D, generator=gen, device="cuda").to(dt)
            ctx = torch.tensor(lens, dtype=torch.int32, device="cuda")
            for window in windows:
                out = paged_ops.paged_decode_attention(q, kp, vp, pt, ctx,
                                                       window=window)
                ref = plain.paged_decode_attention(q, kp, vp, pt, ctx,
                                                   window=window)
                torch.cuda.synchronize()
                e = _err(out, ref)
                rows["paged_decode_attention"].append(e)
                log(f"[kernels] paged_decode {str(dt)[6:]} B={b} N={n} ctx="
                    f"{lens} window={window} max_err={e:.3g}")
                if not e < TOL[dt]:
                    fail(f"paged_decode {dt} N={n} window={window}: {e} >= "
                         f"{TOL[dt]}")


def check_prefill(gen, rows):
    """Two 256-token chunks deep into wide tables (q_start 768 and 2048,
    N=192), with and without a window; then the serve phase's chunks of a
    512-token prompt (one sequence, q_start 0 and 256, N=36)."""
    cases = ((2, 192, ([768, 2048],), (0, 300)),
             (1, 36, ([0], [256]), (0,)))
    for b, n, starts, windows in cases:
        for dt in (torch.float32, torch.bfloat16):
            kp, vp = (x[0] for x in _pool(b * n + 1, dt, gen))
            pt = _page_table(b, n, b * n + 1, gen)
            q = torch.randn(b, 256, HQ, D, generator=gen,
                            device="cuda").to(dt)
            for start in starts:
                q_start = torch.tensor(start, dtype=torch.int32,
                                       device="cuda")
                ctx = q_start + 256
                for window in windows:
                    out = paged_ops.paged_prefill_attention(
                        q, kp, vp, pt, q_start, ctx, window=window)
                    ref = plain.paged_prefill_attention(
                        q, kp, vp, pt, q_start, ctx, window=window)
                    torch.cuda.synchronize()
                    e = _err(out, ref)
                    rows["paged_prefill_attention"].append(e)
                    log(f"[kernels] paged_prefill {str(dt)[6:]} B={b} N={n} "
                        f"Sq=256 q_start={start} window={window} "
                        f"max_err={e:.3g}")
                    if not e < TOL[dt]:
                        fail(f"paged_prefill {dt} N={n} q_start={start} "
                             f"window={window}: {e} >= {TOL[dt]}")


def check_flash(gen, rows):
    cases = ((2048, True, 0, "causal"), (2000, True, 0, "padded"),
             (1024, False, 0, "bidirectional"), (2048, True, 512, "window"))
    for dt in (torch.float32, torch.bfloat16):
        for s, causal, window, what in cases:
            q = torch.randn(1, s, HQ, D, generator=gen, device="cuda").to(dt)
            k = torch.randn(1, s, HKV, D, generator=gen, device="cuda").to(dt)
            v = torch.randn(1, s, HKV, D, generator=gen, device="cuda").to(dt)
            out = flash_ops.flash_attention(q, k, v, causal=causal,
                                            window=window)
            ref = plain.flash_attention(q, k, v, causal=causal,
                                        window=window)
            torch.cuda.synchronize()
            e = _err(out, ref)
            rows["flash_attention"].append(e)
            log(f"[kernels] flash {str(dt)[6:]} S={s} {what} max_err={e:.3g}")
            if not e < TOL[dt]:
                fail(f"flash {dt} {what}: {e} >= {TOL[dt]}")


def time_kernels(gen):
    """Each kernel at the shapes phase 3 gives it, in bf16: decode of the
    8-request batch mid-generation (ctx 528), the second 256-token chunk
    of a 512-token prompt, and the monolithic prefill of a 512-token
    prompt; then, for the record, decode at ctx 2048 and prefill at the
    check's shape. Paged inputs rotate over the layers' pools, as the
    decode step does, so the L2 cache does not hold them between
    launches. Times are of calls replayed from a CUDA graph (the host's
    cost of an eager call, printed beside, is longer than these kernels).
    Paged decode's time covers both of its launches (the splits and their
    combine); the profiler splits it between them."""
    dt, layers = torch.bfloat16, 32
    out = {}
    # paged decode: B=8, ctx 528, pool as the serve phase lays it out
    b, n = 8, 40
    kp, vp = _pool(b * n + 1, dt, gen, layers)
    pt = _page_table(b, n, b * n + 1, gen)
    q = torch.randn(b, HQ, D, generator=gen, device="cuda").to(dt)
    ctx = torch.full((b,), 528, dtype=torch.int32, device="cuda")
    it = iter(range(1 << 30))

    def dec(fn):
        def call():
            i = next(it) % kp.shape[0]
            return fn(q, kp[i], vp[i], pt, ctx)
        return call
    eager_ms = {"paged_decode_attention":
                time_ms(dec(paged_ops.paged_decode_attention), 200)}
    ms = device_ms(dec(paged_ops.paged_decode_attention), layers, 20)
    plain_ms = time_ms(dec(plain.paged_decode_attention), 10)
    keys = 528 * b
    nbytes = (2 * q.numel() + 2 * keys * HKV * D) * 2 + pt.numel() * 4 + b * 4
    out["paged_decode_attention"] = (
        ms, plain_ms, *bound(nbytes, 4 * HQ * D * keys), None,
        "B=8 ctx=528 bf16")
    decode_parts = device_us(dec(paged_ops.paged_decode_attention))
    # paged prefill: chunk 256 at q_start 256 of a 512-token prompt
    n = 40
    kp, vp = _pool(n + 1, dt, gen, layers)
    pt = _page_table(1, n, n + 1, gen)
    q = torch.randn(1, 256, HQ, D, generator=gen, device="cuda").to(dt)
    q_start = torch.tensor([256], dtype=torch.int32, device="cuda")
    ctx = q_start + 256

    def pre(fn):
        def call():
            i = next(it) % kp.shape[0]
            return fn(q, kp[i], vp[i], pt, q_start, ctx)
        return call
    eager_ms["paged_prefill_attention"] = time_ms(
        pre(paged_ops.paged_prefill_attention), 100)
    ms = device_ms(pre(paged_ops.paged_prefill_attention), layers, 20)
    plain_ms = time_ms(pre(plain.paged_prefill_attention), 10)
    seen = sum(visible(256 + i, 512, 0) for i in range(256))
    nbytes = (2 * q.numel() + 2 * 512 * HKV * D) * 2 + pt.numel() * 4 + 8
    out["paged_prefill_attention"] = (
        ms, plain_ms, *bound(nbytes, 4 * HQ * D * seen), None,
        "Sq=256 q_start=256 ctx=512 bf16")
    for name, (ms, pms, bms, by, lib, shape) in out.items():
        log(f"[kernels] time {name} ({shape}): {ms:.4f} ms (graph replay; "
            f"eager calls {eager_ms[name]:.4f} ms), plain {pms:.4f} ms, "
            f"bound {bms:.4f} ms ({by}), {bms / ms:.3f} of it, library "
            f"{'none' if lib is None else f'{lib:.4f} ms'}"
            + _earlier(name, None, ms))
    log("[kernels] paged_decode_attention (B=8 ctx=528) device time by "
        "launch: " + ", ".join(f"{k} {us:.2f} us" for k, us in decode_parts))
    # the long-context shapes of the checks, for the record
    b, n, layers = 8, 192, 4
    kp, vp = _pool(b * n + 1, dt, gen, layers)
    pt = _page_table(b, n, b * n + 1, gen)
    q = torch.randn(b, HQ, D, generator=gen, device="cuda").to(dt)
    ctx = torch.full((b,), 2048, dtype=torch.int32, device="cuda")
    ms = device_ms(dec(paged_ops.paged_decode_attention), layers, 20)
    bms, by = bound((2 * q.numel() + 2 * 2048 * b * HKV * D) * 2,
                    4 * HQ * D * 2048 * b)
    parts = device_us(dec(paged_ops.paged_decode_attention))
    log(f"[kernels] time paged_decode_attention (B=8 ctx=2048 bf16): "
        f"{ms:.4f} ms, bound {bms:.4f} ms ({by}), {bms / ms:.3f} of it"
        + _earlier("paged_decode_attention", 2048, ms) + "; by launch: "
        + ", ".join(f"{k} {us:.2f} us" for k, us in parts))
    n = 192
    kp, vp = _pool(2 * n + 1, dt, gen, layers)
    pt = _page_table(2, n, 2 * n + 1, gen)
    q = torch.randn(2, 256, HQ, D, generator=gen, device="cuda").to(dt)
    q_start = torch.tensor([768, 2048], dtype=torch.int32, device="cuda")
    ctx = q_start + 256
    ms = device_ms(pre(paged_ops.paged_prefill_attention), layers, 20)
    seen = sum(visible(s0 + i, s0 + 256, 0) for s0 in (768, 2048)
               for i in range(256))
    bms, by = bound((2 * q.numel() + 2 * (1024 + 2304) * HKV * D) * 2,
                    4 * HQ * D * seen)
    log(f"[kernels] time paged_prefill_attention (B=2 Sq=256 q_start="
        f"[768, 2048] bf16): {ms:.4f} ms, bound {bms:.4f} ms ({by}), "
        f"{bms / ms:.3f} of it" + _earlier("paged_prefill_attention", 2, ms))
    out["flash_attention"] = time_flash(gen)
    return out


def time_flash(gen):
    """Flash at the monolithic prefill of one 512-token prompt (the serve
    phase's shape) and at S=2048, in turns with one PyTorch SDPA call on the
    same inputs, both replayed from CUDA graphs; the eager call's time; the
    plain version once; the host cost of the tensor maps each call
    encodes."""
    row = None
    for s in (512, 2048):
        q, k, v = (torch.randn(1, s, h, D, generator=gen, device="cuda")
                   .to(torch.bfloat16) for h in (HQ, HKV, HKV))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        calls = 20 if s == 512 else 10

        def kernel():
            return flash_ops.flash_attention(q, k, v)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
        ms, turns = time_turns({"kernel": graphed(kernel, calls),
                                "sdpa": graphed(sdpa, calls)}, 10)
        ms = {n: t / calls for n, t in ms.items()}
        turns = {n: [t / calls for t in ts] for n, ts in turns.items()}
        eager = time_ms(kernel, 100 if s == 512 else 30)
        plain_ms = time_ms(lambda: plain.flash_attention(q, k, v), 5)
        nbytes, flops = attention_work(s, s, HQ, HKV, D)
        bms, by = bound(nbytes, flops)
        enc_ns = flash_kernel.encode_ns(q, k, v)
        host_us = host_us_per_call(kernel)
        log(f"[kernels] time flash_attention (B=1 S={s} causal bf16): "
            f"{ms['kernel']:.4f} ms (graph replay, turns "
            f"{_fmt(turns['kernel'])}; eager calls {eager:.4f} ms), SDPA "
            f"{ms['sdpa']:.4f} ms (turns {_fmt(turns['sdpa'])}), kernel/SDPA "
            f"{ms['kernel'] / ms['sdpa']:.3f}; plain {plain_ms:.4f} ms; "
            f"bound {bms:.4f} ms ({by}), {bms / ms['kernel']:.3f} of it"
            + _earlier("flash_attention", s, ms["kernel"]))
        log(f"[kernels] flash host cost (S={s}): three tensor maps encoded "
            f"in {enc_ns / 1e3:.3f} us per call; the wrapper's whole host "
            f"time {host_us:.2f} us per call")
        if row is None:
            row = (ms["kernel"], plain_ms, bms, by, ms["sdpa"],
                   f"B=1 S={s} causal bf16")
    return row


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {name: [] for name in SOURCES}
    check_decode(gen, rows)
    check_prefill(gen, rows)
    check_flash(gen, rows)
    check_ssd(gen, rows)
    timing = time_kernels(gen)
    timing["ssd_scan"] = time_ssd(gen)
    return {name: (max(errs), timing[name]) for name, errs in rows.items()}


# ------------------------------------------------------- phase 2: ssd_scan
# (b, T, H, dk, dv, what): the xLSTM prefill, a ragged prompt, Mamba widths
SSD_CASES = ((1, 512, 4, 512, 513, "xlstm"), (1, 509, 4, 512, 513, "ragged"),
             (1, 512, 128, 16, 64, "mamba"))


def ssd_inputs(gen, b, t, h, dk, dv, mlstm: bool):
    """Inputs shaped like the model's: bf16 q/k scaled as mLSTM scales them,
    f32 v (with mLSTM's gated ones column), f32 log decay <= 0."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    q = (randn(b, t, h, dk) * dk ** -0.5).to(torch.bfloat16)
    k = (randn(b, t, h, dk) * dk ** -0.25).to(torch.bfloat16)
    v = randn(b, t, h, dv)
    if mlstm:
        gate = torch.sigmoid(randn(b, t, h))
        v[..., -1] = 1.0
        v = v * gate[..., None]
        log_a = F.logsigmoid(randn(b, t, h) + 3.0)
    else:
        log_a = -F.softplus(randn(b, t, h))
    return q, k, v.contiguous(), log_a.contiguous()


def _rel(out, ref) -> float:
    return _err(out, ref) / max(1.0, ref.abs().max().item())


def check_ssd(gen, rows):
    for b, t, h, dk, dv, what in SSD_CASES:
        q, k, v, la = ssd_inputs(gen, b, t, h, dk, dv, what != "mamba")
        y, f = ssd_ops.ssd_scan(q, k, v, la)
        ry, rf = ssd_scan_ref(q, k, v, la)
        torch.cuda.synchronize()
        ey, ef = _rel(y, ry), _rel(f, rf)
        rows["ssd_scan"] += [_err(y, ry), _err(f, rf)]
        log(f"[kernels] ssd_scan {what} B={b} T={t} H={h} dk={dk} dv={dv}: "
            f"y max_err {_err(y, ry):.3g} (rel {ey:.3g}), final state "
            f"max_err {_err(f, rf):.3g} (rel {ef:.3g})")
        if not (ey <= SSD_RTOL and ef <= SSD_RTOL):
            fail(f"ssd_scan {what}: {ey}, {ef} > {SSD_RTOL}")
    # the state continues the recurrence: kernel over T, one decode step,
    # against the kernel over T + 1
    b, t, h, dk, dv, _ = SSD_CASES[0]
    q, k, v, la = ssd_inputs(gen, b, t + 1, h, dk, dv, True)
    y_all, f_all = ssd_ops.ssd_scan(q, k, v, la)
    _, f_t = ssd_ops.ssd_scan(q[:, :t].contiguous(), k[:, :t].contiguous(),
                              v[:, :t].contiguous(), la[:, :t].contiguous())
    y_step, f_step = ssd_decode_step(q[:, t], k[:, t], v[:, t], la[:, t], f_t)
    torch.cuda.synchronize()
    ey, ef = _rel(y_step, y_all[:, t]), _rel(f_step, f_all)
    log(f"[kernels] ssd_scan state continuation T={t}+1: y rel err {ey:.3g}, "
        f"state rel err {ef:.3g}")
    if not (ey <= SSD_RTOL and ef <= SSD_RTOL):
        fail(f"ssd_scan state continuation: {ey}, {ef} > {SSD_RTOL}")


def ssd_chunk_work(t, dk, dv, chunk):
    """(bf16 flops, f32 flops) of one (batch, head) in the chunked form:
    the scores q.k (bf16 operands) over the causal pairs of each chunk and,
    at f32, those scores times v, the inter-chunk term q.S_prev of every
    chunk after the first and the state update (2 dk dv flops a token
    each)."""
    pairs = sum(n * (n + 1) // 2 for n in
                (min(chunk, t - c0) for c0 in range(0, t, chunk)))
    return (pairs * 2 * dk,
            pairs * 2 * dv + 2 * (t - min(chunk, t)) * dk * dv
            + 2 * t * dk * dv)


def ssd_work(b, t, h, dk, dv):
    """(bytes, bf16 flops, f32 flops) the recurrence needs: each input read
    and each output written once, and the operations of the chunk length
    (1 to T; T is the quadratic form) that takes the least time at the
    card's peak rates."""
    nbytes = (2 * b * t * h * dk * 2 + b * t * h * dv * 4 + b * t * h * 4
              + b * t * h * dv * 4 + b * h * dk * dv * 4)
    bf16, f32 = min((ssd_chunk_work(t, dk, dv, c) for c in range(1, t + 1)),
                    key=lambda w: w[0] / BF16_FLOPS + w[1] / F32_FLOPS)
    return nbytes, b * h * bf16, b * h * f32


def time_ssd(gen):
    """The kernel at the serve phase's shape (one 512-token prompt, one
    mLSTM layer) and at Mamba's widths, in turns with the plain version;
    the device time of each of its launches, from the profiler."""
    out = None
    for b, t, h, dk, dv, what in SSD_CASES[::2]:
        q, k, v, la = ssd_inputs(gen, b, t, h, dk, dv, what != "mamba")
        ms, turns = time_turns({
            "kernel": lambda: ssd_ops.ssd_scan(q, k, v, la),
            "plain": lambda: ssd_scan_ref(q, k, v, la)}, {"kernel": 50,
                                                          "plain": 10})
        bms, by = bound(*ssd_work(b, t, h, dk, dv))
        shape = f"B={b} T={t} H={h} dk={dk} dv={dv} bf16 q/k, f32 v"
        log(f"[kernels] time ssd_scan ({what}, {shape}): {ms['kernel']:.4f} "
            f"ms (turns {_fmt(turns['kernel'])}), plain {ms['plain']:.4f} ms "
            f"(turns {_fmt(turns['plain'])}), bound {bms:.4f} ms ({by}), "
            f"{bms / ms['kernel']:.3f} of it, library none"
            + _earlier("ssd_scan", what, ms["kernel"]))
        parts = device_us(lambda: ssd_ops.ssd_scan(q, k, v, la))
        log(f"[kernels] ssd_scan ({what}) device time by kernel: "
            + ", ".join(f"{name} {us:.2f} us" for name, us in parts))
        if out is None:
            out = (ms["kernel"], ms["plain"], bms, by, None, shape)
    return out


def _kernel_key(key: str) -> str:
    """A profiler kernel name without its namespace, template arguments
    and parameters."""
    key = key.replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", key)[0].split()[-1].split("::")[-1][-40:]


def device_us(fn, calls: int = 10):
    """(kernel name, device microseconds per call) of the kernels ``fn``
    launches, from the profiler."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(_kernel_key(e.key), e.self_device_time_total / calls)
            for e in prof.key_averages() if e.self_device_time_total > 0]


# ---------------------------------------------------------------- phase 3
def _drive(eng, trace):
    """``submit`` then ``run``: first step by step until every request has
    its first token (admission and prefill), then the decode-only rest in
    one call; the two are timed apart."""
    eng.submit(trace)
    _sync()
    t0 = time.perf_counter()
    with warnings.catch_warnings():    # run() warns at its step budget
        warnings.simplefilter("ignore", RuntimeWarning)
        while eng.busy() and not all(r.generated for r in trace):
            eng.run(max_steps=eng.step_idx + 1)
    _sync()
    t1 = time.perf_counter()
    before = sum(len(r.generated) for r in trace)
    eng.run()
    _sync()
    t2 = time.perf_counter()
    return t1 - t0, t2 - t1, sum(len(r.generated) for r in trace) - before


def serve_once(cfg, params, chunk: int):
    name = cfg.name
    eng = ServingEngine(
        {name: TenantConfig(cfg, params, max_batch=8,
                            max_context=PROMPT + NEW + 2 * PAGE,
                            paged=True)},
        mode="mirage", base_kv_pages=512, page_size=PAGE,
        prefill_chunk_tokens=chunk, device=DEVICE, keep_prefill_logits=True)
    trace = tiny_trace([name], n_per_model=8, prompt_len=PROMPT,
                       max_new=NEW, vocab=cfg.vocab_size, seed=0)
    kernels.reset_launch_counts()
    t_pre, t_dec, dec_tokens = _drive(eng, trace)
    counts = kernels.launch_counts()
    gen = {r.rid: list(r.generated) for r in eng.finished}
    kinds = [k for _, k, _ in eng.events]
    log(f"[serve] chunk={chunk}: finished {len(eng.finished)} requests, "
        f"{sum(map(len, gen.values()))} tokens in {eng.step_idx} steps; "
        f"admit+prefill steps {t_pre:.3f} s, decode {dec_tokens} tokens in "
        f"{t_dec:.3f} s = {dec_tokens / t_dec:.1f} tok/s; remaps "
        f"{kinds.count('remap')}; launches {counts}")
    if len(eng.finished) != 8 or any(len(g) != NEW for g in gen.values()):
        fail(f"serve chunk={chunk}: not every request made {NEW} tokens")
    return gen, eng.prefill_logits, counts


def phase_serve(cfg=ARCHS["llama3-8b"]):
    _reset_peak()
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
    _sync()
    n_params = sum(x.numel() for x in tree_leaves(params))
    log(f"[serve] llama3-8b: {cfg.num_layers} layers, d_model {cfg.d_model},"
        f" heads {cfg.num_heads}/{cfg.num_kv_heads}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}; {n_params / 1e9:.3f} B params "
        f"initialised in {time.perf_counter() - t0:.1f} s")
    mono, mono_logits, c_mono = serve_once(cfg, params, 0)
    chunked, chunk_logits, c_chunk = serve_once(cfg, params, PROMPT // 2)
    worst, top = 0.0, 0.0
    for rid, a in mono_logits.items():
        b = chunk_logits[rid]
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            fail(f"serve: non-finite prefill logits for {rid}")
        if a.shape != (cfg.vocab_size,) or not a.abs().max() > 0:
            fail(f"serve: prefill logits of {rid} are {tuple(a.shape)}, "
                 f"max |logit| {a.abs().max().item()}")
        worst = max(worst, ((a - b).abs().max() / a.abs().max()).item())
        top = max(top, a.abs().max().item())
    same = sum(x == y for rid in mono for x, y in zip(mono[rid],
                                                      chunked[rid]))
    total = sum(len(g) for g in mono.values())
    log(f"[serve] prefill logits monolithic vs chunked: max|d|/max|logit| = "
        f"{worst:.3g} (tolerance {LOGIT_RTOL}; max|logit| {top:.3g}); "
        f"generated tokens agreeing: "
        f"{same}/{total} = {same / total:.3f}")
    if not worst <= LOGIT_RTOL:
        fail(f"serve: prefill logits differ by {worst} > {LOGIT_RTOL}")
    log(f"[serve] peak memory {_peak() / 2**30:.2f} GiB")
    launches = {k: c_mono[k] + c_chunk[k] for k in c_mono}
    if DEVICE == "cuda" and not (
            c_mono["flash_attention"] > 0
            and c_mono["paged_decode_attention"] > 0
            and c_chunk["paged_prefill_attention"] > 0
            and c_chunk["paged_decode_attention"] > 0):
        fail(f"serve: a kernel of the path never launched: {c_mono} "
             f"{c_chunk}")
    del params, model
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 4
def remap_once(tenants_params, cfg, base_pages: int):
    eng = ServingEngine(
        {n: TenantConfig(cfg, p, max_batch=4, max_context=128, paged=True)
         for n, p in tenants_params.items()},
        mode="mirage", base_kv_pages=base_pages, page_size=PAGE,
        prefill_chunk_tokens=64, device=DEVICE)
    eng.submit(tiny_trace(list(tenants_params), n_per_model=3,
                          prompt_len=96, max_new=16, vocab=cfg.vocab_size,
                          seed=1))
    eng.run()
    eng.allocator.check_invariants()
    _sync()
    return eng


def phase_remap(cfg=dataclasses.replace(ARCHS["llama3-8b"], num_layers=2)):
    _reset_peak()
    tp = {n: build_model(cfg).init(
        torch.Generator(device=DEVICE).manual_seed(seed), DEVICE)
        for n, seed in (("A", 1), ("B", 2))}
    unit = max(sum(x.numel() * x.element_size()
                   for x in tree_leaves(tp["A"]["blocks"])) // 2, 1)
    pages_per_unit = unit // (PAGE * 1024)
    per_page = 2 * 2 * PAGE * cfg.num_kv_heads * cfg.resolved_head_dim * 2
    per_remap = 2 * pages_per_unit * per_page
    room = 0
    if DEVICE == "cuda":
        room = (torch.cuda.get_device_properties(0).total_memory
                - torch.cuda.memory_allocated()) // per_remap
    log(f"[remap] unit {unit} bytes -> {pages_per_unit} pages per donated "
        f"layer; each remap grows both pools by {per_remap / 2**30:.2f} GiB, "
        f"room for {room} remap events on the card; expected here: one "
        f"pressure episode, so 1 remap (then a revert once calm)")
    results = {}
    for label, base in (("pressure", 16), ("ample", 256)):
        eng = remap_once(tp, cfg, base)
        ev = [(s, k, d) for s, k, d in eng.events if k in ("remap", "revert")]
        gen = {r.rid: list(r.generated) for r in eng.finished}
        log(f"[remap] {label}: base_kv_pages={base} finished "
            f"{len(eng.finished)} requests; remap/revert events {ev}; "
            f"page_id_bound {eng.allocator.page_id_bound}; TransferStats "
            f"{dataclasses.asdict(eng.xfer.stats)}; host->device fetch bytes "
            f"{eng.xfer.host_fetch_bytes}; peak memory "
            f"{_peak() / 2**30:.2f} GiB")
        results[label] = (eng, gen)
        if len(eng.finished) != 6:
            fail(f"remap {label}: {len(eng.finished)} of 6 requests finished")
    p_eng, p_gen = results["pressure"]
    kinds = [k for _, k, _ in p_eng.events]
    if kinds.count("remap") < 1 or (
            DEVICE == "cuda" and p_eng.xfer.host_fetch_bytes <= 0):
        fail("remap: the small pool never remapped or never streamed")
    if p_gen != results["ample"][1]:
        fail(f"remap: generated tokens differ:\n{p_gen}\n"
             f"{results['ample'][1]}")
    if _peak() > 80e9:
        fail("remap: peak memory above 80 GB")
    log(f"[remap] {kinds.count('remap')} remap and {kinds.count('revert')} "
        f"revert events; generated tokens identical to the ample-pool run")


# ---------------------------------------------------------------- phase 5
def _tokens(seq) -> torch.Tensor:
    return torch.from_numpy(np.asarray(seq, np.int64)).to(DEVICE)


def decode_profile(model, params, state, max_context, steps: int = 3):
    """Kernel launches and device idle share of a decode step on the
    tenant's batch state: the step's wall time from ``steps`` plain
    ``decode_step`` calls, its launches and device time from as many more
    under the profiler (whose own cost per launch would inflate the wall
    time)."""
    tokens = torch.zeros(state["pos"].shape[0], dtype=torch.int32,
                         device=DEVICE)
    model.decode_step(params, state, tokens, max_context)      # warm
    _sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        model.decode_step(params, state, tokens, max_context)
    _sync()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            model.decode_step(params, state, tokens, max_context)
        _sync()
        prof_wall = time.perf_counter() - t0
    avg = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in avg
                 if str(getattr(e, "device_type", "")).endswith("CUDA"))
    launches = sum(e.count for e in avg if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    return (launches / steps, wall / steps * 1e3, prof_wall / steps * 1e3,
            dev_us / 1e3 / steps)


def phase_xlstm(cfg=ARCHS["xlstm-1.3b"]):
    _reset_peak()
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(3), DEVICE)
    _sync()
    n_params = sum(x.numel() for x in tree_leaves(params))
    pattern = [ld.mixer for ld in model.impl.pattern]
    n_mlstm = pattern.count("mlstm") * model.repeats
    log(f"[xlstm] {cfg.name}: {cfg.num_layers} layers ({model.repeats} x "
        f"{pattern}), d_model {cfg.d_model}, heads {cfg.num_heads} x "
        f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size}, {cfg.dtype}; "
        f"{n_params / 1e9:.3f} B params initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    max_context = PROMPT + NEW + 2
    eng = ServingEngine(
        {cfg.name: TenantConfig(cfg, params, max_batch=8,
                                max_context=max_context, paged=False)},
        mode="mirage", base_kv_pages=512, page_size=PAGE, device=DEVICE,
        keep_prefill_logits=True)
    trace = tiny_trace([cfg.name], n_per_model=8, prompt_len=PROMPT,
                       max_new=NEW, vocab=cfg.vocab_size, seed=0)
    prompts = {r.rid: np.array(r.prompt) for r in trace}
    kernels.reset_launch_counts()
    t_pre, t_dec, dec_tokens = _drive(eng, trace)
    counts = kernels.launch_counts()
    kinds = [k for _, k, _ in eng.events]
    n_prefills = kinds.count("prefill")
    log(f"[xlstm] finished {len(eng.finished)} requests, "
        f"{sum(len(r.generated) for r in eng.finished)} tokens in "
        f"{eng.step_idx} steps; admit+prefill steps {t_pre:.3f} s, decode "
        f"{dec_tokens} tokens in {t_dec:.3f} s = {dec_tokens / t_dec:.1f} "
        f"tok/s; launches {counts} "
        f"({counts['ssd_scan'] / max(n_prefills, 1):.0f} "
        f"ssd_scan per prompt; {n_mlstm} mLSTM layers)")
    if len(eng.finished) != 8 or any(len(r.generated) != NEW
                                     for r in eng.finished):
        fail(f"xlstm: not every request made {NEW} tokens")
    if "preempt" in kinds or "remap" in kinds:
        fail(f"xlstm: the ample budget preempted or remapped: {kinds}")
    if DEVICE == "cuda" and counts["ssd_scan"] != 8 * n_mlstm:
        fail(f"xlstm: ssd_scan launched {counts['ssd_scan']} times, "
             f"expected {8 * n_mlstm}")
    # the kernel's final state continues the recurrence: prefill of all but
    # the last prompt token, then one decode step of it
    worst, top = 0.0, 0.0
    for rid, prompt in prompts.items():
        a = eng.prefill_logits[rid]
        if a.shape != (cfg.vocab_size,) or not torch.isfinite(a).all() \
                or not a.abs().max() > 0:
            fail(f"xlstm: prefill logits of {rid} are {tuple(a.shape)}, "
                 f"max |logit| {a.abs().max().item()}")
        _, st = model.prefill(params, {"tokens": _tokens(prompt[None, :-1])},
                              max_context)
        b, _ = model.decode_step(params, st, _tokens(prompt[-1:]),
                                 max_context)
        b = b[0].float().cpu()
        worst = max(worst, ((a - b).abs().max() / a.abs().max()).item())
        top = max(top, a.abs().max().item())
    log(f"[xlstm] first-token logits, prefill of P tokens vs prefill of P-1 "
        f"and one decode step: max|d|/max|logit| = {worst:.3g} (tolerance "
        f"{LOGIT_RTOL}; max|logit| {top:.3g})")
    if not worst <= LOGIT_RTOL:
        fail(f"xlstm: prefill/decode logits differ by {worst} > {LOGIT_RTOL}")
    if DEVICE == "cuda":
        t = eng.tenants[cfg.name]
        per_step, step_ms, prof_ms, dev_ms = decode_profile(
            model, params, t.state, max_context)
        log(f"[xlstm] decode step (batch 8): wall {step_ms:.3f} ms; under "
            f"the profiler {prof_ms:.3f} ms, {per_step:.0f} kernel launches, "
            f"device {dev_ms:.3f} ms; device idle share "
            f"{1 - dev_ms / step_ms:.3f} of the unprofiled step")
    log(f"[xlstm] peak memory {_peak() / 2**30:.2f} GiB")
    del eng, params, model
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------- phase 6
def phase_xlstm_remap(cfg=ARCHS["xlstm-1.3b"]):
    _reset_peak()
    model = build_model(cfg)
    tp = {n: model.init(torch.Generator(device=DEVICE).manual_seed(seed),
                        DEVICE) for n, seed in (("X", 4), ("Y", 5))}
    unit = sum(x.numel() * x.element_size()
               for x in tree_leaves(tp["X"]["blocks"])) // model.repeats
    log(f"[xlstm-remap] two {cfg.name} tenants, {model.repeats} repeats of "
        f"{unit} bytes; a remap donates whole repeats "
        f"({unit // (PAGE * 1024)} nominal pages each); dense tenants have no "
        f"pool to grow")
    results = {}
    for label, base in zip(("pressure", "ample"), REMAP_PAGES):
        eng = ServingEngine(
            {n: TenantConfig(cfg, p, max_batch=4,
                             max_context=REMAP_PROMPT + REMAP_NEW + 2,
                             paged=False) for n, p in tp.items()},
            mode="mirage", base_kv_pages=base, page_size=PAGE, device=DEVICE)
        eng.submit(tiny_trace(list(tp), n_per_model=3,
                              prompt_len=REMAP_PROMPT, max_new=REMAP_NEW,
                              vocab=cfg.vocab_size, seed=1))
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        eng.run()
        _sync()
        counts = kernels.launch_counts()
        eng.allocator.check_invariants()
        ev = [(s, k, d) for s, k, d in eng.events
              if k in ("remap", "revert", "preempt")]
        gen = {r.rid: list(r.generated) for r in eng.finished}
        log(f"[xlstm-remap] {label}: base_kv_pages={base} finished "
            f"{len(eng.finished)} requests in {eng.step_idx} steps, "
            f"{time.perf_counter() - t0:.2f} s; events {ev}; TransferStats "
            f"{dataclasses.asdict(eng.xfer.stats)}; host->device fetch bytes "
            f"{eng.xfer.host_fetch_bytes}; ssd_scan launches "
            f"{counts['ssd_scan']}; peak memory {_peak() / 2**30:.2f} GiB")
        results[label] = (eng, gen)
        if len(eng.finished) != 6:
            fail(f"xlstm-remap {label}: {len(eng.finished)} of 6 finished")
        if DEVICE == "cuda" and counts["ssd_scan"] <= 0:
            fail(f"xlstm-remap {label}: ssd_scan never launched")
    p_eng, p_gen = results["pressure"]
    kinds = [k for _, k, _ in p_eng.events]
    st = p_eng.xfer.stats
    if kinds.count("remap") < 1:
        fail("xlstm-remap: the small budget never remapped")
    if DEVICE == "cuda" and not (
            p_eng.xfer.host_fetch_bytes > 0
            and p_eng.xfer.host_fetch_bytes == st.stream_bytes):
        fail(f"xlstm-remap: streamed {p_eng.xfer.host_fetch_bytes} bytes, "
             f"TransferStats.stream_bytes {st.stream_bytes}")
    if p_gen != results["ample"][1]:
        fail(f"xlstm-remap: generated tokens differ:\n{p_gen}\n"
             f"{results['ample'][1]}")
    if _peak() > 80e9:
        fail("xlstm-remap: peak memory above 80 GB")
    log(f"[xlstm-remap] {kinds.count('remap')} remap and "
        f"{kinds.count('revert')} revert events; the donor streamed "
        f"{p_eng.xfer.host_fetch_bytes} bytes host->device (= stream_bytes); "
        f"generated tokens identical to the ample-budget run")
    del results, p_eng, tp, model
    if DEVICE == "cuda":
        torch.cuda.empty_cache()


# ------------------------------------------------------------------- main
def main() -> None:
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    checked = phase_kernels()
    launches = phase_serve()
    phase_remap()
    launches["ssd_scan"] = phase_xlstm()["ssd_scan"]
    phase_xlstm_remap()
    rows = []
    for name, (err, (ms, pms, bms, by, lib, _shape)) in checked.items():
        src, replaces = SOURCES[name]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "max_err": err, "ms": ms, "plain_ms": pms,
            "bound_ms": bms, "bound_by": by, "bound": by,
            "library_ms": lib})
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
