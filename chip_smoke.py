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
   the splits' edges, prefill at its two 256-token chunks); the three
   attention kernels at phase 7's moonshot shape (Hq = Hkv = 16, G = 1)
   and at phase 9's danube shapes (D 120, with and without the 4096-token
   window, a 4608-token prompt), there also row by row within 1e-4 (f32)
   and 2e-2 (bf16) of the row's largest value; flash likewise at phases
   10-12's shapes (``FLASH_SHAPES``: whisper's bidirectional encoder over
   1500 frames, its decoder's causal self-attention and its cross-attention
   of 448 rows against 1500, the same at its engine's one request of 32
   frames and 416 tokens, llava's causal GQA 56/8 prefill of 2880 patch
   rows and 512 tokens), timed beside an SDPA call with the same mask;
   ssd_scan against its plain version at
   xLSTM width (T 512, H 4, dk 512, dv 513, bf16 q/k), at a ragged T 509
   and at Mamba's widths (H 128, dk 16, dv 64), within 1e-4 * max(1,
   max|plain|) for y and the final state, and the state continuation
   (kernel over T, one plain decode step, against the kernel over T + 1);
   each kernel's time (CUDA events; the attention kernels' calls replayed
   from CUDA graphs), the plain version's time, the least time the card
   could take (bound) and, for flash, the time of one causal PyTorch SDPA
   call as a yardstick; paged decode's time is that of its two launches (the KV
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
7. moe: moonshot-v1-16b-a3b at full width and depth (48 layers, 64 experts
   top-6, bf16) as a paged tenant, served as in phase 3 (monolithic and
   256-token chunked prefill); one MoE layer on 512 tokens against the
   same layer in f32 on the CPU; a profile of 3 decode steps against the
   weight-read bound.
8. hybrid: jamba-v0.1-52b at full width cut to 16 of its 32 layers (14
   Mamba with the ssd_scan kernel, 2 attention; 8 MoE) as a dense tenant,
   8 prompts of 512 tokens; one Mamba layer (prefill and decode steps)
   and one MoE layer against the CPU in f32; a decode profile.
9. ring: h2o-danube-3-4b at full width and depth (24 layers, head dim 120,
   4096-token window) as a dense ring tenant, 4 prompts of 4608 tokens
   (the prefill wraps the ring), 16 new tokens; one decode step past the
   window against the paged pool (paged decode kernel); then phase 6's
   remap with two danube tenants.
10. enc-dec: whisper-medium at full width and depth (24 encoder + 24
   decoder layers, bf16): ``Model.prefill`` of 8 requests at 1500 frames
   and 448 prompt tokens, and the same weights cut to 4 + 4 layers against
   the CPU in f32; then a dense tenant through the engine (8 prompts of 416
   tokens, 32 frames each as the engine draws them, 32 new tokens; flash
   in every encoder, decoder-self and cross layer of a prefill), a decode
   profile, and one decode step against a no-cache prefill (this holds the
   cross cache's ``src_len``).
11. whisper remap: phase 6's remap with two full-depth whisper tenants.
12. VLM: llava-next-34b at full width and depth (60 layers, GQA 56/8, 34.39
   B params, bf16) as a dense tenant: 4 requests of 2880 patch rows and
   512 prompt tokens, 16 new tokens; a decode profile; one decode step
   after the prefix against a no-cache prefill of prefix, prompt and token.
13. fleet: (a) llama3-8b at full width and depth (32 layers, bf16, phase
   3's weights) lowered from one ``RuntimeConfig`` to a two-replica
   ``ReplicaGroup`` with a ``FleetPrefixCache`` and a least-loaded router,
   paged tenant, prefix sharing, 128-token chunked prefill; 16 requests of
   4 system prompts of 384 tokens, each shared by 4 requests that add 128
   tokens of their own, 32 new tokens each. A request routed away from
   its group's prefix imports the span's K/V pages from the other replica
   (GH200's link prices import below recompute) and prefills only its own
   128 tokens (paged prefill kernel over the imported pages; paged decode
   after). After each import the importer's pages must equal the donor's
   export exactly, and each such request's first-token logits must lie
   within ``LOGIT_RTOL`` of a lone engine's monolithic prefill (flash).
   (b) phase 4's two 2-layer tenants on a two-replica group with
   coordinated remaps and no Dynamic Reversion: the first replica to remap
   under the tight pool is removed (respill, forced reversion through its
   TransferEngine, teardown), must end with nothing remapped or streaming,
   and its pools must be freed once it is dropped; then a replica joins
   pre-warmed from the survivor's prefix cache and must probe every
   snapshot span as the donor does.
14. the kernels line (JSON; launches summed over phases 3-13; each kernel's
   ``shapes`` lists phase 2's timed shape rows) and, last, the result line
   (JSON).
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time
import warnings
import weakref
from collections import Counter

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.cluster import (  # noqa: E402
    FleetPrefixCache, ReplicaGroup, Router,
)
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import RuntimeConfig as EngineKnobs  # noqa: E402,E501
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa: E402,E501
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.paged_attention import ops as paged_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402
from repro_torch.models.blocks import Mamba, MoE, ssd_decode_step  # noqa: E402,E501
from repro_torch.models import attention_ops as plain  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import dtype_of, tree_leaves, tree_map  # noqa: E402,E501
from repro_torch.serving import (  # noqa: E402
    RuntimeConfig, ServingEngine, TenantConfig, TenantSpec,
)
from repro_torch.serving.engine import stub_frontend_inputs  # noqa: E402
from repro_torch.serving.hw import GH200  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.serving.traces import tiny_trace  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
F32_FLOPS = 67e12                  # f32 outside the tensor cores
HQ, HKV, D, PAGE = 32, 8, 128, 16  # llama3-8b attention, engine page
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# The served models' shapes (``SHAPES``) attend over up to 4608 keys: with
# randn q/k/v an output row there has std ~ sqrt(e / keys) ~ 0.03, so TOL's
# absolute 2e-2 is as large as the values. Those checks also hold each
# output row (the head dim) to ROW_RTOL of its largest |plain value|: a few
# bf16 ulps (2^-8 to 2^-7 of a value each), where one 64-key tile left out
# or a window edge a tile off moves a row by ~0.1 of its largest value.
ROW_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
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


def row_err(out, ref) -> float:
    """The largest error of a row (the last axis) over that row's largest
    |ref|, the worst row's."""
    out, ref = out.float(), ref.float()
    top = ref.abs().amax(-1).clamp_min(1e-30)
    return ((out - ref).abs().amax(-1) / top).max().item()


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
    for shape in SHAPES:
        check_shape(gen, rows, shape)
    for shape in FLASH_SHAPES:
        check_flash_shape(gen, rows, shape)
    timing = time_kernels(gen)
    timing["ssd_scan"] = time_ssd(gen)
    shape_rows = [row for shape in SHAPES for row in time_shape(gen, shape)]
    shape_rows += [time_flash_shape(gen, shape) for shape in FLASH_SHAPES]
    return ({name: (max(errs), timing[name]) for name, errs in rows.items()},
            shape_rows)


# ------------------------------------------- phase 2: phases 7 and 9's shapes
# name -> (Hq, Hkv, D, window, B, decode contexts (the first one timed),
# decode table width N, prefill chunk starts (the last one timed), flash S):
# moonshot's MHA (G = 1) at phase 7's
# shapes; danube's head dim 120 with and without its 4096-token window at
# phase 9's (a 4608-token prompt, decode past it)
SHAPES = {
    "moonshot": (16, 16, 128, 0, 8, [528, 513, 520, 537, 544, 512, 384, 129],
                 36, [0, 256], 512),
    "danube": (32, 8, 120, 0, 4, [4609, 4615, 4100, 17], 290, [4352], 4608),
    "danube_window": (32, 8, 120, 4096, 4, [4609, 4615, 4100, 17], 290,
                      [4352], 4608),
}


def _shape_inputs(gen, shape, dt):
    hq, hkv, d, window, b, lens, n, starts, s = SHAPES[shape]
    kp, vp = (torch.randn((b * n + 1, PAGE, hkv, d), generator=gen,
                          device="cuda").to(dt) for _ in range(2))
    pt = _page_table(b, n, b * n + 1, gen)
    return hq, hkv, d, window, b, lens, n, starts, s, kp, vp, pt


def check_shape(gen, rows, shape):
    """Flash, paged decode and paged prefill at one of ``SHAPES``, f32 and
    bf16, against their plain versions: within TOL and, row by row, within
    ROW_RTOL of the row's largest value."""
    for dt in (torch.float32, torch.bfloat16):
        hq, hkv, d, window, b, lens, n, starts, s, kp, vp, pt = \
            _shape_inputs(gen, shape, dt)
        outs = []
        q = torch.randn(b, hq, d, generator=gen, device="cuda").to(dt)
        ctx = torch.tensor(lens, dtype=torch.int32, device="cuda")
        outs.append(("paged_decode_attention",
                     paged_ops.paged_decode_attention(q, kp, vp, pt, ctx,
                                                      window=window),
                     plain.paged_decode_attention(q, kp, vp, pt, ctx,
                                                  window=window)))
        q = torch.randn(1, 256, hq, d, generator=gen, device="cuda").to(dt)
        for start in starts:
            q_start = torch.tensor([start], dtype=torch.int32, device="cuda")
            args = (q, kp, vp, pt[:1].contiguous(), q_start, q_start + 256)
            outs.append(("paged_prefill_attention",
                         paged_ops.paged_prefill_attention(*args,
                                                           window=window),
                         plain.paged_prefill_attention(*args,
                                                       window=window)))
        q, k, v = (torch.randn(1, s, h, d, generator=gen, device="cuda")
                   .to(dt) for h in (hq, hkv, hkv))
        outs.append(("flash_attention",
                     flash_ops.flash_attention(q, k, v, window=window),
                     plain.flash_attention(q, k, v, window=window)))
        torch.cuda.synchronize()
        errs = [(name, _err(out, ref), row_err(out, ref))
                for name, out, ref in outs]
        for name, e, _ in errs:
            rows[name].append(e)
        log(f"[kernels] {shape} {str(dt)[6:]} (Hq {hq}, Hkv {hkv}, D {d}, "
            f"window {window}): " + ", ".join(
                f"{name} max_err={e:.3g} row_err={r:.3g}"
                for name, e, r in errs)
            + f" (limits {TOL[dt]:g} and {ROW_RTOL[dt]:g} of a row)")
        for name, e, r in errs:
            if not (e < TOL[dt] and r < ROW_RTOL[dt]):
                fail(f"{name} at {shape} {dt}: max_err {e} (limit "
                     f"{TOL[dt]}), row_err {r} (limit {ROW_RTOL[dt]})")


def time_shape(gen, shape):
    """The three attention kernels at one of ``SHAPES`` in bf16, by graph
    replay, beside their plain versions, their bounds and, for flash, one
    causal SDPA call. SDPA takes a window only as a boolean mask, which
    costs it its flash backend, so with a window the causal call (a little
    more work) stays the yardstick and the masked call is printed beside.
    Returns the kernels line's shape rows."""
    dt = torch.bfloat16
    hq, hkv, d, window, b, lens, n, starts, s, kp, vp, pt = \
        _shape_inputs(gen, shape, dt)
    lens = [lens[0]] * b                   # the first context of each row
    q = torch.randn(b, hq, d, generator=gen, device="cuda").to(dt)
    ctx = torch.tensor(lens, dtype=torch.int32, device="cuda")
    keys = sum(min(c, window) if window else c for c in lens)
    out = [("paged_decode_attention", f"B={b} ctx={lens[0]}",
            lambda: paged_ops.paged_decode_attention(q, kp, vp, pt, ctx,
                                                     window=window),
            lambda: plain.paged_decode_attention(q, kp, vp, pt, ctx,
                                                 window=window),
            None, bound((2 * q.numel() + 2 * keys * hkv * d) * 2
                        + pt.numel() * 4, 4 * hq * d * keys))]
    start = starts[-1]
    qp = torch.randn(1, 256, hq, d, generator=gen, device="cuda").to(dt)
    q_start = torch.tensor([start], dtype=torch.int32, device="cuda")
    pre = (qp, kp, vp, pt[:1].contiguous(), q_start, q_start + 256)
    seen = sum(visible(start + i, start + 256, window) for i in range(256))
    lo = max(0, start - window + 1) if window else 0
    out.append(("paged_prefill_attention", f"Sq=256 q_start={start}",
                lambda: paged_ops.paged_prefill_attention(*pre,
                                                          window=window),
                lambda: plain.paged_prefill_attention(*pre, window=window),
                None, bound((2 * qp.numel() + 2 * (start + 256 - lo) * hkv
                             * d) * 2, 4 * hq * d * seen)))
    qf, kf, vf = (torch.randn(1, s, h, d, generator=gen, device="cuda")
                  .to(dt) for h in (hq, hkv, hkv))
    qt, kt, vt = (x.transpose(1, 2) for x in (qf, kf, vf))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    out.append(("flash_attention", f"B=1 S={s}",
                lambda: flash_ops.flash_attention(qf, kf, vf, window=window),
                lambda: plain.flash_attention(qf, kf, vf, window=window),
                sdpa, bound(*attention_work(s, s, hq, hkv, d,
                                            window=window))))
    rows = []
    for name, what, fn, plain_fn, lib, (bms, by) in out:
        calls = 20 if s <= 512 or name != "flash_attention" else 5
        ms = device_ms(fn, calls, 10)
        pms = time_ms(plain_fn, 3, warmup=1)
        lms = device_ms(lib, calls, 10) if lib is not None else None
        rows.append(_shape_row(name, f"{shape} {what}", ms, pms, bms, by,
                               lms))
        masked = ""
        if lib is not None and window:
            i = torch.arange(s, device="cuda")
            mask = (i[None, :] <= i[:, None]) \
                & (i[:, None] - i[None, :] < window)
            masked = "; with the window as a boolean mask {:.4f} ms".format(
                device_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True), calls, 10))
        log(f"[kernels] time {name} at {shape} (Hq {hq}, Hkv {hkv}, D {d}, "
            f"window {window}, {what}, bf16): {ms:.4f} ms (graph replay), "
            f"plain {pms:.4f} ms, bound {bms:.4f} ms ({by}), "
            f"{bms / ms:.3f} of it, library "
            + ("none" if lms is None else
               f"{lms:.4f} ms (SDPA causal{masked})"))
    return rows


def _shape_row(name, shape, ms, plain_ms, bound_ms, bound_by, library_ms):
    return {"name": name, "shape": shape, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


# ---------------------------------------- phase 2: phases 10-12's flash shapes
# name -> (B, Sq, Sk, Hq, Hkv, D, causal): whisper-medium's encoder over
# 1500 frames (bidirectional, Hq = Hkv = 16, D 64) and its decoder's self-
# and cross-attention over a 448-token prompt (the cross against the 1500
# encoder rows), at phase 10's prefill check (a batch of 8); the same at
# the shapes its engine gives them (one request: 32 frames, a 416-token
# prompt); llava-next-34b's prefill of 2880 patch rows and a 512-token
# prompt (causal, GQA 56/8) at phase 12's
FLASH_SHAPES = {
    "whisper_encoder": (8, 1500, 1500, 16, 16, 64, False),
    "whisper_decoder": (8, 448, 448, 16, 16, 64, True),
    "whisper_cross": (8, 448, 1500, 16, 16, 64, False),
    "whisper_engine_encoder": (1, 32, 32, 16, 16, 64, False),
    "whisper_engine_decoder": (1, 416, 416, 16, 16, 64, True),
    "whisper_engine_cross": (1, 416, 32, 16, 16, 64, False),
    "llava_prefix": (1, 3392, 3392, 56, 8, 128, True),
}


def _flash_inputs(gen, shape, dt):
    b, sq, sk, hq, hkv, d, causal = FLASH_SHAPES[shape]
    q = torch.randn(b, sq, hq, d, generator=gen, device="cuda").to(dt)
    k, v = (torch.randn(b, sk, hkv, d, generator=gen, device="cuda").to(dt)
            for _ in range(2))
    return q, k, v, causal


def check_flash_shape(gen, rows, shape):
    """Flash at one of ``FLASH_SHAPES``, f32 and bf16, against its plain
    version: within TOL and, row by row, within ROW_RTOL."""
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, causal = _flash_inputs(gen, shape, dt)
        out = flash_ops.flash_attention(q, k, v, causal=causal)
        ref = plain.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        e, r = _err(out, ref), row_err(out, ref)
        rows["flash_attention"].append(e)
        log(f"[kernels] flash {shape} {str(dt)[6:]} (B, Sq, Sk, Hq, Hkv, D, "
            f"causal = {FLASH_SHAPES[shape]}): max_err={e:.3g} row_err="
            f"{r:.3g} (limits {TOL[dt]:g} and {ROW_RTOL[dt]:g} of a row)")
        if not (e < TOL[dt] and r < ROW_RTOL[dt]):
            fail(f"flash at {shape} {dt}: max_err {e} (limit {TOL[dt]}), "
                 f"row_err {r} (limit {ROW_RTOL[dt]})")


def time_flash_shape(gen, shape):
    """Flash at one of ``FLASH_SHAPES`` in bf16 by graph replay, beside its
    plain version, its bound and one SDPA call with the same mask (none, or
    causal with GQA). Returns the kernels line's shape row."""
    q, k, v, causal = _flash_inputs(gen, shape, torch.bfloat16)
    b, sq, sk, hq, hkv, d, _ = FLASH_SHAPES[shape]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    nbytes, flops = attention_work(sq, sk, hq, hkv, d, causal=causal)
    bms, by = bound(b * nbytes, b * flops)
    calls = 5 if b * sq * sk > 4e6 else 20
    ms = device_ms(lambda: flash_ops.flash_attention(q, k, v, causal=causal),
                   calls, 10)
    pms = time_ms(lambda: plain.flash_attention(q, k, v, causal=causal), 3,
                  warmup=1)
    lms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True), calls, 10)
    log(f"[kernels] time flash_attention at {shape} (B={b}, Sq={sq}, "
        f"Sk={sk}, Hq {hq}, Hkv {hkv}, D {d}, "
        f"{'causal' if causal else 'no mask'}, bf16): {ms:.4f} ms (graph "
        f"replay), plain {pms:.4f} ms, bound {bms:.4f} ms ({by}), "
        f"{bms / ms:.3f} of it, library {lms:.4f} ms (SDPA, "
        f"{'causal' if causal else 'no mask'}), kernel/SDPA {ms / lms:.3f}")
    return _shape_row("flash_attention", f"{shape} B={b} Sq={sq} Sk={sk}",
                      ms, pms, bms, by, lms)


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
def _drive(eng, trace, profile_fn=None):
    """``submit`` then ``run``: first step by step until every request has
    its first token (admission and prefill), then the decode-only rest in
    one call; the two are timed apart. With ``profile_fn``, the first
    decode steps go to it (a function of a one-step callable) before the
    rest is timed, and its result comes back too."""
    eng.submit(trace)
    _sync()
    t0 = time.perf_counter()
    with warnings.catch_warnings():    # run() warns at its step budget
        warnings.simplefilter("ignore", RuntimeWarning)
        while eng.busy() and not all(r.generated for r in trace):
            eng.run(max_steps=eng.step_idx + 1)
        _sync()
        t1 = time.perf_counter()
        prof = profile_fn(lambda: eng.run(max_steps=eng.step_idx + 1)) \
            if profile_fn else None
    before = sum(len(r.generated) for r in trace)
    _sync()
    t2 = time.perf_counter()
    eng.run()
    _sync()
    t3 = time.perf_counter()
    return (t1 - t0, t3 - t2, sum(len(r.generated) for r in trace) - before,
            prof)


def serve_once(cfg, params, chunk: int, tag: str = "serve",
               profile_fn=None):
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
    t_pre, t_dec, dec_tokens, prof = _drive(eng, trace, profile_fn)
    counts = kernels.launch_counts()
    gen = {r.rid: list(r.generated) for r in eng.finished}
    kinds = [k for _, k, _ in eng.events]
    log(f"[{tag}] chunk={chunk}: finished {len(eng.finished)} requests, "
        f"{sum(map(len, gen.values()))} tokens in {eng.step_idx} steps; "
        f"admit+prefill steps {t_pre:.3f} s, decode {dec_tokens} tokens in "
        f"{t_dec:.3f} s = {dec_tokens / t_dec:.1f} tok/s; remaps "
        f"{kinds.count('remap')}; launches {counts}")
    if len(eng.finished) != 8 or any(len(g) != NEW for g in gen.values()):
        fail(f"{tag} chunk={chunk}: not every request made {NEW} tokens")
    return gen, eng.prefill_logits, counts, prof


def compare_prefills(cfg, tag, mono, mono_logits, chunked, chunk_logits):
    """Each request's first-token logits, monolithic against chunked: both
    finite, [V], not all zero. Returns (max |d| / max |logit| over the
    requests, the largest |logit|, tokens agreeing, tokens)."""
    worst, top = 0.0, 0.0
    for rid, a in mono_logits.items():
        b = chunk_logits[rid]
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            fail(f"{tag}: non-finite prefill logits for {rid}")
        if a.shape != (cfg.vocab_size,) or not a.abs().max() > 0:
            fail(f"{tag}: prefill logits of {rid} are {tuple(a.shape)}, "
                 f"max |logit| {a.abs().max().item()}")
        worst = max(worst, ((a - b).abs().max() / a.abs().max()).item())
        top = max(top, a.abs().max().item())
    same = sum(x == y for rid in mono for x, y in zip(mono[rid],
                                                      chunked[rid]))
    return worst, top, same, sum(len(g) for g in mono.values())


def check_paged_launches(tag, c_mono, c_chunk):
    """Each kernel of the paged path launched in its run (flash in the
    monolithic one, paged prefill in the chunked one, paged decode in
    both); returns the two runs' launches summed."""
    if DEVICE == "cuda" and not (
            c_mono["flash_attention"] > 0
            and c_mono["paged_decode_attention"] > 0
            and c_chunk["paged_prefill_attention"] > 0
            and c_chunk["paged_decode_attention"] > 0):
        fail(f"{tag}: a kernel of the path never launched: {c_mono} "
             f"{c_chunk}")
    return {k: c_mono[k] + c_chunk[k] for k in c_mono}


def _free() -> None:
    """Hand the freed phase's device memory back before the next phase
    (phase 13's wrapped replica methods hold their replicas in cycles)."""
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()


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
    mono, mono_logits, c_mono, _ = serve_once(cfg, params, 0)
    chunked, chunk_logits, c_chunk, _ = serve_once(cfg, params, PROMPT // 2)
    worst, top, same, total = compare_prefills(
        cfg, "serve", mono, mono_logits, chunked, chunk_logits)
    log(f"[serve] prefill logits monolithic vs chunked: max|d|/max|logit| = "
        f"{worst:.3g} (tolerance {LOGIT_RTOL}; max|logit| {top:.3g}); "
        f"generated tokens agreeing: "
        f"{same}/{total} = {same / total:.3f}")
    if not worst <= LOGIT_RTOL:
        fail(f"serve: prefill logits differ by {worst} > {LOGIT_RTOL}")
    log(f"[serve] peak memory {_peak() / 2**30:.2f} GiB")
    launches = check_paged_launches("serve", c_mono, c_chunk)
    del params, model
    _free()
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
    kernels.reset_launch_counts()
    eng.run()
    _sync()
    counts = kernels.launch_counts()
    eng.allocator.check_invariants()
    return eng, counts


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
    results, launches = {}, Counter()
    for label, base in (("pressure", 16), ("ample", 256)):
        eng, counts = remap_once(tp, cfg, base)
        launches.update(counts)
        ev = [(s, k, d) for s, k, d in eng.events if k in ("remap", "revert")]
        gen = {r.rid: list(r.generated) for r in eng.finished}
        log(f"[remap] {label}: base_kv_pages={base} finished "
            f"{len(eng.finished)} requests; remap/revert events {ev}; "
            f"page_id_bound {eng.allocator.page_id_bound}; TransferStats "
            f"{dataclasses.asdict(eng.xfer.stats)}; host->device fetch bytes "
            f"{eng.xfer.host_fetch_bytes}; launches {counts}; peak memory "
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
    del results, p_eng, tp
    _free()
    return launches


# ---------------------------------------------------------------- phase 5
def _tokens(seq) -> torch.Tensor:
    return torch.from_numpy(np.asarray(seq, np.int64)).to(DEVICE)


_LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


def _is_expert_bmm(event, expert_shape) -> bool:
    """An ``aten::bmm`` call whose second operand is an expert weight stack
    of ``expert_shape`` (E, d, f): [E, d, f] or [E, f, d]."""
    shapes = getattr(event, "input_shapes", None) or []
    if event.key != "aten::bmm" or len(shapes) < 2 or len(shapes[1]) != 3:
        return False
    e, d, f = expert_shape
    return shapes[1][0] == e and sorted(shapes[1][1:]) == sorted((d, f))


def step_profile(step, steps: int = 3, expert_shape=None,
                 top: int = 6) -> dict:
    """One decode step, ``step()``, profiled: its wall time from ``steps``
    plain calls after a warm one; its launches and device time from as many
    more under the profiler (whose own cost per launch inflates the wall
    time), by kernel (the ``top`` longest) and, with ``expert_shape``, in
    the MoE expert products (the ``aten::bmm`` calls on the expert
    weights)."""
    step()
    _sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    _sync()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=expert_shape is not None) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        _sync()
        prof_wall = time.perf_counter() - t0
    avg = prof.key_averages(group_by_input_shape=expert_shape is not None)
    on_device = [e for e in avg
                 if str(getattr(e, "device_type", "")).endswith("CUDA")]
    expert = None
    if expert_shape is not None:
        expert = sum(getattr(e, "device_time_total", 0) for e in avg
                     if _is_expert_bmm(e, expert_shape)) / 1e3 / steps
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:top]
    return {
        "launches": sum(e.count for e in avg if e.key in _LAUNCH_KEYS) / steps,
        "wall_ms": wall / steps * 1e3, "prof_ms": prof_wall / steps * 1e3,
        "dev_ms": sum(e.self_device_time_total for e in on_device)
        / 1e3 / steps,
        "expert_ms": expert,
        "top": [(_kernel_key(e.key), e.self_device_time_total / 1e3 / steps,
                 e.count / steps) for e in top]}


def log_profile(tag: str, batch: int, prof: dict, bound_ms=None) -> None:
    dev, wall = prof["dev_ms"], prof["wall_ms"]
    split = "" if prof["expert_ms"] is None else (
        f" (expert bmm {prof['expert_ms']:.3f} ms, the rest "
        f"{dev - prof['expert_ms']:.3f} ms)")
    log(f"[{tag}] decode step (batch {batch}): wall {wall:.3f} ms; under "
        f"the profiler {prof['prof_ms']:.3f} ms, {prof['launches']:.0f} "
        f"kernel launches, device {dev:.3f} ms{split}; device idle share "
        f"{1 - dev / wall:.3f} of the unprofiled step"
        + ("" if bound_ms is None else
           f"; weight-read bound {bound_ms:.3f} ms, {bound_ms / dev:.3f} of "
           f"the device time"))
    log(f"[{tag}] device time per step by kernel: " + ", ".join(
        f"{k} {ms:.3f} ms ({n:.0f} calls)" for k, ms, n in prof["top"]))


def weight_read_ms(params, cfg, batch: int) -> float:
    """The least time a decode step of ``batch`` tokens could take where
    it reads every weight once (an MoE layer reads every expert when the
    capacity floor gives each one slots): all parameter bytes but an
    encoder's (decode never runs it), of the embedding table only the
    batch's rows (unless it is the tied output layer too), over the memory
    rate."""
    total = sum(x.numel() * x.element_size() for x in tree_leaves(
        {k: v for k, v in params.items() if k != "encoder"}))
    emb = params["embed"]
    if not cfg.tie_embeddings:
        total -= (emb.shape[0] - batch) * emb.shape[1] * emb.element_size()
    return total / HBM_BYTES_PER_S * 1e3


def _decode_step_fn(model, params, state, max_context: int):
    tokens = torch.zeros(state["pos"].shape[0], dtype=torch.int32,
                         device=DEVICE)
    return lambda: model.decode_step(params, state, tokens, max_context)


def _serve_dense(cfg, params, tag, batch, prompt, new, max_context):
    """``batch`` requests of ``prompt`` tokens, ``new`` new tokens each,
    through the engine as one dense tenant with an ample KV budget: every
    request finished with ``new`` tokens, no preemption or remap, every
    first-token logit row finite and not all zero. Returns the engine and
    the launch counts of its run."""
    eng = ServingEngine(
        {cfg.name: TenantConfig(cfg, params, max_batch=batch,
                                max_context=max_context, paged=False)},
        mode="mirage", base_kv_pages=512, page_size=PAGE, device=DEVICE,
        keep_prefill_logits=True)
    trace = tiny_trace([cfg.name], n_per_model=batch, prompt_len=prompt,
                       max_new=new, vocab=cfg.vocab_size, seed=0)
    kernels.reset_launch_counts()
    t_pre, t_dec, dec_tokens, _ = _drive(eng, trace)
    counts = kernels.launch_counts()
    kinds = [k for _, k, _ in eng.events]
    log(f"[{tag}] dense tenant: finished {len(eng.finished)} requests, "
        f"{sum(len(r.generated) for r in eng.finished)} tokens in "
        f"{eng.step_idx} steps; admit+prefill steps {t_pre:.3f} s, decode "
        f"{dec_tokens} tokens in {t_dec:.3f} s = {dec_tokens / t_dec:.1f} "
        f"tok/s; launches {counts}")
    if len(eng.finished) != batch or any(len(r.generated) != new
                                         for r in eng.finished):
        fail(f"{tag}: not every request made {new} tokens")
    if "preempt" in kinds or "remap" in kinds:
        fail(f"{tag}: the ample budget preempted or remapped: {kinds}")
    for rid, a in eng.prefill_logits.items():
        if a.shape != (cfg.vocab_size,) or not torch.isfinite(a).all() \
                or not a.abs().max() > 0:
            fail(f"{tag}: prefill logits of {rid} are {tuple(a.shape)}, "
                 f"max |logit| {a.abs().max().item()}")
    return eng, counts


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
    eng, counts = _serve_dense(cfg, params, "xlstm", 8, PROMPT, NEW,
                               max_context)
    log(f"[xlstm] {counts['ssd_scan'] / 8:.0f} ssd_scan per prompt; "
        f"{n_mlstm} mLSTM layers")
    if DEVICE == "cuda" and counts["ssd_scan"] != 8 * n_mlstm:
        fail(f"xlstm: ssd_scan launched {counts['ssd_scan']} times, "
             f"expected {8 * n_mlstm}")
    # the kernel's final state continues the recurrence: prefill of all but
    # the last prompt token, then one decode step of it
    worst, top = 0.0, 0.0
    for r in eng.finished:
        rid, prompt = r.rid, np.array(r.prompt)
        a = eng.prefill_logits[rid]
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
        log_profile("xlstm", 8, step_profile(_decode_step_fn(
            model, params, eng.tenants[cfg.name].state, max_context)))
    log(f"[xlstm] peak memory {_peak() / 2**30:.2f} GiB")
    del eng, params, model
    _free()
    return counts


# ------------------------------------------------------------ phases 6, 9
def phase_dense_remap(cfg, tag: str, kernel: str, seeds):
    """Two full-depth dense tenants of ``cfg``: a small KV budget (the
    controller remaps repeats of one tenant, which then streams them from
    pinned host memory) against an ample one; identical tokens. ``kernel``
    is the kernel their prefill must launch."""
    _reset_peak()
    model = build_model(cfg)
    tp = {n: model.init(torch.Generator(device=DEVICE).manual_seed(seed),
                        DEVICE) for n, seed in zip("XY", seeds)}
    unit = sum(x.numel() * x.element_size()
               for x in tree_leaves(tp["X"]["blocks"])) // model.repeats
    log(f"[{tag}] two {cfg.name} tenants, {model.repeats} repeats of "
        f"{unit} bytes; a remap donates whole repeats "
        f"({unit // (PAGE * 1024)} nominal pages each); dense tenants have no "
        f"pool to grow")
    results, launches = {}, Counter()
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
        launches.update(counts)
        eng.allocator.check_invariants()
        ev = [(s, k, d) for s, k, d in eng.events
              if k in ("remap", "revert", "preempt")]
        gen = {r.rid: list(r.generated) for r in eng.finished}
        log(f"[{tag}] {label}: base_kv_pages={base} finished "
            f"{len(eng.finished)} requests in {eng.step_idx} steps, "
            f"{time.perf_counter() - t0:.2f} s; events {ev}; TransferStats "
            f"{dataclasses.asdict(eng.xfer.stats)}; host->device fetch bytes "
            f"{eng.xfer.host_fetch_bytes}; {kernel} launches "
            f"{counts[kernel]}; peak memory {_peak() / 2**30:.2f} GiB")
        results[label] = (eng, gen)
        if len(eng.finished) != 6:
            fail(f"{tag} {label}: {len(eng.finished)} of 6 finished")
        if DEVICE == "cuda" and counts[kernel] <= 0:
            fail(f"{tag} {label}: {kernel} never launched")
    p_eng, p_gen = results["pressure"]
    kinds = [k for _, k, _ in p_eng.events]
    st = p_eng.xfer.stats
    if kinds.count("remap") < 1:
        fail(f"{tag}: the small budget never remapped")
    if DEVICE == "cuda" and not (
            p_eng.xfer.host_fetch_bytes > 0
            and p_eng.xfer.host_fetch_bytes == st.stream_bytes):
        fail(f"{tag}: streamed {p_eng.xfer.host_fetch_bytes} bytes, "
             f"TransferStats.stream_bytes {st.stream_bytes}")
    if p_gen != results["ample"][1]:
        fail(f"{tag}: generated tokens differ:\n{p_gen}\n"
             f"{results['ample'][1]}")
    if _peak() > 80e9:
        fail(f"{tag}: peak memory above 80 GB")
    log(f"[{tag}] {kinds.count('remap')} remap and "
        f"{kinds.count('revert')} revert events; the donor streamed "
        f"{p_eng.xfer.host_fetch_bytes} bytes host->device (= stream_bytes); "
        f"generated tokens identical to the ample-budget run")
    del results, p_eng, tp, model
    _free()
    return launches


def phase_xlstm_remap(cfg=ARCHS["xlstm-1.3b"]):
    return phase_dense_remap(cfg, "xlstm-remap", "ssd_scan", (4, 5))


# ---------------------------------------------------------------- phase 7
# the MoE layer check: tokens, the share of them that must be routed to
# the same top-k set on the card (bf16) as on the CPU (f32), and y on the
# tokens whose kept experts agree, within MOE_RTOL * max|y|
MOE_TOKENS, MOE_SET_AGREE, MOE_RTOL = 512, 0.99, 2e-2


def _layer(params, pos: int, part: str, r: int = 0):
    """Repeat r's parameters of pattern position ``pos``'s ``part``."""
    return {k: v[r] for k, v in params["blocks"][pos][part].items()}


def _init(cfg, seed: int, tag: str, detail: str):
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(seed),
                        DEVICE)
    _sync()
    leaves = tree_leaves(params)
    log(f"[{tag}] {cfg.name}: {cfg.num_layers} layers ({model.repeats} x "
        f"{[f'{ld.mixer}/{ld.ffn}' for ld in model.impl.pattern]}), d_model "
        f"{cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads} x "
        f"{cfg.resolved_head_dim}, {detail}vocab {cfg.vocab_size}, "
        f"{cfg.dtype}; {sum(x.numel() for x in leaves) / 1e9:.3f} B params, "
        f"{sum(x.numel() * x.element_size() for x in leaves) / 1e9:.2f} GB, "
        f"initialised in {time.perf_counter() - t0:.1f} s")
    return model, params


def _rel_err(a, ref) -> float:
    return ((a.float().cpu() - ref).abs().max() / ref.abs().max()).item()


def check_moe_layer(cfg, p, tag: str, seed: int) -> None:
    """One MoE layer on ``MOE_TOKENS`` tokens at full width: on the device
    in the model's dtype, against the same layer on the CPU in f32 (the
    same weights and inputs, widened). A near-tie in the f32 router
    probabilities may route a token differently; y is compared on the
    tokens whose kept experts (after capacity) agree."""
    moe = MoE()
    e = cfg.moe.num_experts
    x = torch.randn(MOE_TOKENS, cfg.d_model, device=DEVICE,
                    generator=torch.Generator(device=DEVICE).manual_seed(seed)
                    ).to(dtype_of(cfg))
    y, aux, counts = moe(p, x, cfg, return_stats=True)
    _, top_e, _, _, slot, cap = moe.route(p, x, cfg)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = {k: v.cpu().float() for k, v in p.items()}
    y32, aux32, counts32 = moe(p32, x.cpu().float(), cfg32, return_stats=True)
    _, top_e32, _, _, slot32, _ = moe.route(p32, x.cpu().float(), cfg32)

    def kept(sl):          # the kept assignments' experts, ascending
        return torch.where(sl < e * cap, sl // cap, -1).cpu()
    same_set = (top_e.sort(-1).values.cpu() == top_e32.sort(-1).values
                ).all(-1)
    agree = same_set & (kept(slot) == kept(slot32)).all(-1)
    top = y32.abs().max().item()
    err = ((y.float().cpu() - y32)[agree].abs().max() / top).item()
    log(f"[{tag}] MoE layer, {MOE_TOKENS} tokens, capacity {cap}: device "
        f"{cfg.dtype} against CPU f32: tokens with another top-"
        f"{cfg.moe.top_k} set {int((~same_set).sum())}, with other kept "
        f"experts {int((~agree).sum())}; on the rest max|dy|/max|y| = "
        f"{err:.3g} (tolerance {MOE_RTOL}; max|y| {top:.3g}); dropped "
        f"assignments {int((slot == e * cap).sum())} / "
        f"{int((slot32 == e * cap).sum())}; aux {aux.item():.5f} / "
        f"{aux32.item():.5f}; counts {counts.int().tolist()} / "
        f"{counts32.int().tolist()}")
    if not torch.isfinite(y).all() or y.shape != x.shape:
        fail(f"{tag}: MoE output {tuple(y.shape)} not finite")
    if same_set.float().mean().item() < MOE_SET_AGREE:
        fail(f"{tag}: {int((~same_set).sum())} of {MOE_TOKENS} tokens routed "
             f"to another top-k set on the CPU")
    if not err <= MOE_RTOL:
        fail(f"{tag}: MoE layer differs by {err} > {MOE_RTOL}")


def phase_moonshot(cfg=ARCHS["moonshot-v1-16b-a3b"]):
    _reset_peak()
    m = cfg.moe
    model, params = _init(cfg, 6, "moe", f"{m.num_experts} experts top-"
                          f"{m.top_k}, d_expert {m.d_expert}, ")
    check_moe_layer(cfg, _layer(params, 0, "ffn"), "moe", 7)
    unit = sum(x.numel() * x.element_size()
               for x in tree_leaves(params["blocks"])) // model.repeats
    page_bytes = 2 * model.repeats * PAGE * cfg.num_kv_heads \
        * cfg.resolved_head_dim * 2
    log(f"[moe] no remap on the card: one donated layer ({unit} bytes) "
        f"would grow the paged pool by {unit // (PAGE * 1024)} nominal pages "
        f"(page_size * 1024 bytes each) of {page_bytes} bytes of K and V "
        f"(all {model.repeats} layers), "
        f"{unit // (PAGE * 1024) * page_bytes / 1e9:.0f} GB")
    expert_shape = (m.num_experts, cfg.d_model, m.d_expert)
    prof_fn = (lambda step: step_profile(step, 3, expert_shape)) \
        if DEVICE == "cuda" else None
    mono, mono_logits, c_mono, prof = serve_once(cfg, params, 0, "moe",
                                                 prof_fn)
    chunked, chunk_logits, c_chunk, _ = serve_once(cfg, params, PROMPT // 2,
                                                   "moe")
    worst, top, same, total = compare_prefills(
        cfg, "moe", mono, mono_logits, chunked, chunk_logits)
    log(f"[moe] prefill logits monolithic vs chunked: max|d|/max|logit| = "
        f"{worst:.3g} (not a check: the capacity depends on a call's token "
        f"count, so a 256-token chunk and the 512-token prompt may drop "
        f"different assignments; max|logit| {top:.3g}); generated tokens "
        f"agreeing: {same}/{total} = {same / total:.3f}")
    if prof is not None:
        log_profile("moe", 8, prof, weight_read_ms(params, cfg, 8))
    log(f"[moe] peak memory {_peak() / 2**30:.2f} GiB")
    launches = check_paged_launches("moe", c_mono, c_chunk)
    del params, model
    _free()
    return launches


# ---------------------------------------------------------------- phase 8
# jamba's depth cut: 2 of its 4 repeats of the 8-layer pattern (16 of 32
# layers: 14 Mamba + 2 attention, 8 MoE; 52 GB in bf16); all 32 layers
# (102.9 GB) do not fit one card
JAMBA_LAYERS = 16
# the Mamba layer check: y and the ssm/conv state, device against CPU f32,
# within MAMBA_RTOL of the largest value
MAMBA_RTOL, MAMBA_STEPS = 2e-2, 4


def check_mamba_layer(cfg, p, tag: str, seed: int) -> None:
    """One Mamba layer, a prefill of ``PROMPT`` tokens (the ``ssd_scan``
    kernel on the card) and ``MAMBA_STEPS`` decode steps, on the device in
    the model's dtype against the same layer on the CPU in f32."""
    mamba = Mamba()
    x = torch.randn(2, PROMPT + MAMBA_STEPS, cfg.d_model, device=DEVICE,
                    generator=torch.Generator(device=DEVICE).manual_seed(seed)
                    ).to(dtype_of(cfg))
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = {k: v.cpu().float() for k, v in p.items()}
    x32 = x.cpu().float()
    y, st = mamba.fwd_seq(p, x[:, :PROMPT], {}, cfg)
    y32, st32 = mamba.fwd_seq(p32, x32[:, :PROMPT], {}, cfg32)
    errs = [("prefill y", _rel_err(y, y32))]
    for i in range(MAMBA_STEPS):
        y, st = mamba.fwd_dec(p, x[:, PROMPT + i], st, {}, cfg)
        y32, st32 = mamba.fwd_dec(p32, x32[:, PROMPT + i], st32, {}, cfg32)
        errs.append((f"decode {i} y", _rel_err(y, y32)))
    errs += [(k, _rel_err(st[k], st32[k])) for k in ("ssm", "conv")]
    log(f"[{tag}] Mamba layer, prefill of {PROMPT} tokens and "
        f"{MAMBA_STEPS} decode steps, device {cfg.dtype} against CPU f32, "
        f"max|d|/max|ref|: " + ", ".join(f"{k} {e:.3g}" for k, e in errs)
        + f" (tolerance {MAMBA_RTOL})")
    for k, e in errs:
        if not e <= MAMBA_RTOL:
            fail(f"{tag}: Mamba layer {k} differs by {e} > {MAMBA_RTOL}")


def phase_jamba(cfg=dataclasses.replace(ARCHS["jamba-v0.1-52b"],
                                        num_layers=JAMBA_LAYERS)):
    _reset_peak()
    m = cfg.moe
    model, params = _init(cfg, 8, "hybrid", f"Mamba d_in "
                          f"{cfg.ssm.expand * cfg.d_model} (d_state "
                          f"{cfg.ssm.d_state}), {m.num_experts} experts top-"
                          f"{m.top_k} d_expert {m.d_expert}, ")
    pattern = model.impl.pattern
    check_mamba_layer(cfg, _layer(params, 0, "mixer"), "hybrid", 9)
    moe_pos = [ld.ffn for ld in pattern].index("moe")
    check_moe_layer(cfg, _layer(params, moe_pos, "ffn"), "hybrid", 10)
    n_mamba = sum(ld.mixer == "mamba" for ld in pattern) * model.repeats
    n_attn = sum(ld.mixer == "attn" for ld in pattern) * model.repeats
    max_context = PROMPT + NEW + 2
    eng, counts = _serve_dense(cfg, params, "hybrid", 8, PROMPT, NEW,
                               max_context)
    log(f"[hybrid] ({n_mamba} Mamba and {n_attn} attention layers a prompt)")
    if DEVICE == "cuda" and (counts["ssd_scan"] != 8 * n_mamba
                             or counts["flash_attention"] != 8 * n_attn):
        fail(f"hybrid: launches {counts}, expected {8 * n_mamba} ssd_scan "
             f"and {8 * n_attn} flash_attention")
    if DEVICE == "cuda":
        log_profile("hybrid", 8, step_profile(
            _decode_step_fn(model, params, eng.tenants[cfg.name].state,
                            max_context), 3,
            (m.num_experts, cfg.d_model, m.d_expert)),
            weight_read_ms(params, cfg, 8))
    log(f"[hybrid] peak memory {_peak() / 2**30:.2f} GiB")
    del eng, params, model
    _free()
    return counts


# ---------------------------------------------------------------- phase 9
# the ring tenant's requests: prompts longer than danube's 4096-token
# window, so the prefill wraps the ring
RING_BATCH, RING_PROMPT, RING_NEW = 4, 4608, 16


def check_ring_against_paged(model, params, prompt, max_context: int):
    """One prompt's prefill, then one decode step of its greedy token past
    the window: against the dense ring (plain decode attention) and against
    the paged pool (the paged decode kernel on the card, with the window).
    Returns max |d| / max |logit|."""
    lm = model.impl
    tokens = _tokens(prompt[None, :])
    s = tokens.shape[1]
    x = lm.embed(params, tokens)
    positions = torch.arange(s, dtype=torch.int32, device=DEVICE)[None]
    xo, _, caches = lm.fwd_seq(params, x, {"positions": positions},
                               collect_cache=True)
    tok = lm.logits_last(params, xo[:, -1]).argmax(-1).to(torch.int32)
    lengths = torch.full((1,), s, dtype=torch.int32, device=DEVICE)
    n = -(-max_context // PAGE)
    table = torch.arange(n, dtype=torch.int32, device=DEVICE)[None]
    paged = lm.paged_state_from_prefill(caches, lengths, table, n + 1, PAGE)
    dense = lm.state_from_prefill(caches, lengths, max_context)
    del caches
    a, _ = lm.decode_step(params, dense, tok, max_context)
    b, _ = lm.decode_step_paged(params, paged, tok)
    a, b = a.float().cpu(), b.float().cpu()
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        fail("ring: non-finite decode logits")
    return ((a - b).abs().max() / a.abs().max()).item()


def phase_danube(cfg=ARCHS["h2o-danube-3-4b"]):
    _reset_peak()
    model, params = _init(cfg, 11, "ring", f"window {cfg.sliding_window}, "
                          f"d_ff {cfg.d_ff}, ")
    max_context = RING_PROMPT + RING_NEW + 2
    pages = -(-max_context // PAGE)
    eng = ServingEngine(
        {cfg.name: TenantConfig(cfg, params, max_batch=RING_BATCH,
                                max_context=max_context, paged=False)},
        mode="mirage", base_kv_pages=2 * RING_BATCH * pages, page_size=PAGE,
        device=DEVICE, keep_prefill_logits=True)
    trace = tiny_trace([cfg.name], n_per_model=RING_BATCH,
                       prompt_len=RING_PROMPT, max_new=RING_NEW,
                       vocab=cfg.vocab_size, seed=0)
    kernels.reset_launch_counts()
    t_pre, t_dec, dec_tokens, _ = _drive(eng, trace)
    counts = kernels.launch_counts()
    kinds = [k for _, k, _ in eng.events]
    ring = model.impl._cache_len(max_context)
    log(f"[ring] dense ring tenant ({ring}-slot ring, prompts of "
        f"{RING_PROMPT} tokens): finished {len(eng.finished)} requests, "
        f"{sum(len(r.generated) for r in eng.finished)} tokens in "
        f"{eng.step_idx} steps; admit+prefill steps {t_pre:.3f} s, decode "
        f"{dec_tokens} tokens in {t_dec:.3f} s = {dec_tokens / t_dec:.1f} "
        f"tok/s; launches {counts}")
    if len(eng.finished) != RING_BATCH or any(
            len(r.generated) != RING_NEW for r in eng.finished):
        fail(f"ring: not every request made {RING_NEW} tokens")
    if "preempt" in kinds or "remap" in kinds:
        fail(f"ring: the ample budget preempted or remapped: {kinds}")
    if DEVICE == "cuda" and \
            counts["flash_attention"] != RING_BATCH * cfg.num_layers:
        fail(f"ring: flash_attention launched {counts['flash_attention']} "
             f"times, expected {RING_BATCH * cfg.num_layers}")
    del eng
    gap = check_ring_against_paged(model, params, np.array(trace[0].prompt),
                                   max_context)
    log(f"[ring] one decode step at position {RING_PROMPT} (past the "
        f"{cfg.sliding_window}-token window), dense ring against paged pool: "
        f"max|d|/max|logit| = {gap:.3g} (tolerance {LOGIT_RTOL})")
    if not gap <= LOGIT_RTOL:
        fail(f"ring: dense ring and paged decode differ by {gap}")
    log(f"[ring] peak memory {_peak() / 2**30:.2f} GiB")
    del params, model
    _free()
    launches = Counter(counts)
    launches.update(phase_dense_remap(cfg, "ring-remap", "flash_attention",
                                      (12, 13)))
    return launches


# ------------------------------------------------------- phases 10 and 12
def decode_vs_no_cache(model, params, batch, max_context: int):
    """One request's ``batch`` prefilled, then one decode step of its greedy
    token, against a prefill of the prompt with that token appended (no
    decode cache). Returns (max |d| / max |logit|, the token)."""
    logits, state = model.prefill(params, batch, max_context)
    tok = logits.argmax(-1).to(torch.int32)
    a, _ = model.decode_step(params, state, tok, max_context)
    del state
    longer = dict(batch, tokens=torch.cat([batch["tokens"],
                                           tok[:, None].long()], dim=1))
    b, _ = model.prefill(params, longer, max_context)
    a, b = a.float().cpu(), b.float().cpu()
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        fail("non-finite logits in the decode/no-cache check")
    return ((a - b).abs().max() / a.abs().max()).item(), int(tok[0])


def _first_request(eng, cfg):
    """The first finished request's prefill inputs, as the engine made
    them: its prompt and the stub frontend's frames or patch rows."""
    r = min(eng.finished, key=lambda x: x.rid)
    return r.rid, {"tokens": _tokens(np.asarray(r.prompt)[None]),
                   **stub_frontend_inputs(cfg, r.rid, DEVICE)}


# ---------------------------------------------------------------- phase 10
# whisper's prefill check: requests, the decoder prompt (the reference's
# WHISPER_DECODER_LEN), the depth of the CPU f32 comparison (encoder and
# decoder layers) and the requests it takes; the engine's requests keep
# within the decoder's 448 positions: 416 prompt tokens and 32 new
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_CUT, WHISPER_CPU_ROWS = 8, 448, 4, 2
WHISPER_SERVE_PROMPT = 416


def _cut_depth(params, layers: int):
    """The first ``layers`` encoder and decoder layers' weights (views)."""
    cut = {"encoder": tree_map(lambda a: a[:layers], params["encoder"]),
           "blocks": tuple(tree_map(lambda a: a[:layers], b)
                           for b in params["blocks"])}
    return dict(params, **cut)


def check_whisper_prefill(cfg, model, params):
    """``Model.prefill`` of ``WHISPER_BATCH`` requests at the config's
    source length and a ``WHISPER_PROMPT``-token decoder prompt, at full
    depth; then the same weights cut to ``WHISPER_CUT`` + ``WHISPER_CUT``
    layers, on the device in the model's dtype against the CPU in f32, on
    the first ``WHISPER_CPU_ROWS`` requests: first-token logits within
    LOGIT_RTOL of the largest."""
    gen = torch.Generator(device=DEVICE).manual_seed(14)
    b, s_src = WHISPER_BATCH, cfg.max_source_len
    frames = torch.randn(b, s_src, cfg.d_model, generator=gen,
                         device=DEVICE) * 0.02
    tokens = torch.randint(0, cfg.vocab_size, (b, WHISPER_PROMPT),
                           generator=gen, device=DEVICE)
    max_context = WHISPER_PROMPT + 2
    _sync()
    t0 = time.perf_counter()
    logits, state = model.prefill(params, {"frames": frames,
                                           "tokens": tokens}, max_context)
    _sync()
    t1 = time.perf_counter()
    if logits.shape != (b, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        fail(f"whisper: prefill logits {tuple(logits.shape)} not finite")
    if state["src_len"].tolist() != [s_src] * b:
        fail(f"whisper: src_len {state['src_len'].tolist()}")
    del state
    rows = slice(0, WHISPER_CPU_ROWS)
    cut = dataclasses.replace(cfg, num_layers=WHISPER_CUT,
                              num_encoder_layers=WHISPER_CUT)
    cp = _cut_depth(params, WHISPER_CUT)
    a, _ = build_model(cut).prefill(
        cp, {"frames": frames[rows], "tokens": tokens[rows]}, max_context)
    t2 = time.perf_counter()
    cut32 = dataclasses.replace(cut, dtype="float32")
    ref, _ = build_model(cut32).prefill(
        tree_map(lambda x: x.cpu().float(), cp),
        {"frames": frames[rows].cpu(), "tokens": tokens[rows].cpu()},
        max_context)
    err = _rel_err(a, ref)
    log(f"[whisper] Model.prefill of {b} requests x {s_src} frames and "
        f"{WHISPER_PROMPT} prompt tokens at full depth: {t1 - t0:.3f} s; "
        f"first-token logits of {WHISPER_CUT} + {WHISPER_CUT} layers, "
        f"{WHISPER_CPU_ROWS} requests, device {cfg.dtype} against CPU f32 "
        f"({time.perf_counter() - t2:.1f} s): max|d|/max|logit| = {err:.3g} "
        f"(tolerance {LOGIT_RTOL}; max|logit| {ref.abs().max().item():.3g})")
    if not err <= LOGIT_RTOL:
        fail(f"whisper: cut prefill differs from the CPU by {err}")


def phase_whisper(cfg=ARCHS["whisper-medium"]):
    _reset_peak()
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(14),
                        DEVICE)
    _sync()
    leaves = tree_leaves(params)
    log(f"[whisper] {cfg.name}: {cfg.num_encoder_layers} encoder + "
        f"{cfg.num_layers} decoder layers, d_model {cfg.d_model}, heads "
        f"{cfg.num_heads} x {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}; "
        f"{sum(x.numel() for x in leaves) / 1e9:.3f} B params, "
        f"{sum(x.numel() * x.element_size() for x in leaves) / 1e9:.2f} GB, "
        f"initialised in {time.perf_counter() - t0:.1f} s")
    check_whisper_prefill(cfg, model, params)
    max_context = WHISPER_SERVE_PROMPT + NEW + 2
    eng, counts = _serve_dense(cfg, params, "whisper", 8,
                               WHISPER_SERVE_PROMPT, NEW, max_context)
    per_request = cfg.num_encoder_layers + 2 * cfg.num_layers
    log(f"[whisper] flash launches {counts['flash_attention']} "
        f"({per_request} a request: encoder, decoder self and cross)")
    if DEVICE == "cuda" and counts["flash_attention"] != 8 * per_request:
        fail(f"whisper: flash_attention launched "
             f"{counts['flash_attention']} times, expected {8 * per_request}")
    if DEVICE == "cuda":
        log_profile("whisper", 8, step_profile(_decode_step_fn(
            model, params, eng.tenants[cfg.name].state, max_context)),
            weight_read_ms(params, cfg, 8))
    rid, batch = _first_request(eng, cfg)
    del eng
    gap, tok = decode_vs_no_cache(model, params, batch, max_context)
    log(f"[whisper] {rid}: one decode step (token {tok}; "
        f"{batch['frames'].shape[1]} frames, cross cache of "
        f"{cfg.max_source_len} rows) against a "
        f"no-cache prefill of the prompt and that token: max|d|/max|logit| = "
        f"{gap:.3g} (tolerance {LOGIT_RTOL})")
    if not gap <= LOGIT_RTOL:
        fail(f"whisper: decode and no-cache prefill differ by {gap}")
    log(f"[whisper] peak memory {_peak() / 2**30:.2f} GiB")
    del params, model
    _free()
    return counts


# ---------------------------------------------------------------- phase 11
def phase_whisper_remap(cfg=ARCHS["whisper-medium"]):
    return phase_dense_remap(cfg, "whisper-remap", "flash_attention",
                             (15, 16))


# ---------------------------------------------------------------- phase 12
# llava's requests: 4 prompts of 512 tokens behind the 2880 patch rows, 16
# new tokens, and the dense cache's length (patches + prompt + new, and a
# little room: the engine's finish guard does not count the patches)
LLAVA_BATCH, LLAVA_PROMPT, LLAVA_NEW, LLAVA_CONTEXT = 4, 512, 16, 3456
# llava's depth: all 60 layers (34.39 B params, 68.8 GB in bf16) fit the card
LLAVA_LAYERS = 60


def phase_llava(cfg=dataclasses.replace(ARCHS["llava-next-34b"],
                                        num_layers=LLAVA_LAYERS)):
    _reset_peak()
    model, params = _init(cfg, 17, "vlm", f"{cfg.num_image_patches} patch "
                          f"rows, d_ff {cfg.d_ff}, ")
    full = ARCHS[cfg.name].num_layers
    if cfg.num_layers != full:
        log(f"[vlm] depth cut to {cfg.num_layers} of {full} layers")
    max_context = LLAVA_CONTEXT
    eng, counts = _serve_dense(cfg, params, "vlm", LLAVA_BATCH, LLAVA_PROMPT,
                               LLAVA_NEW, max_context)
    if DEVICE == "cuda" and \
            counts["flash_attention"] != LLAVA_BATCH * cfg.num_layers:
        fail(f"vlm: flash_attention launched {counts['flash_attention']} "
             f"times, expected {LLAVA_BATCH * cfg.num_layers}")
    if DEVICE == "cuda":
        log_profile("vlm", LLAVA_BATCH, step_profile(_decode_step_fn(
            model, params, eng.tenants[cfg.name].state, max_context)),
            weight_read_ms(params, cfg, LLAVA_BATCH))
    rid, batch = _first_request(eng, cfg)
    del eng
    _free()
    gap, tok = decode_vs_no_cache(model, params, batch, max_context)
    log(f"[vlm] {rid}: one decode step at position "
        f"{cfg.num_image_patches + LLAVA_PROMPT} (token {tok}, after "
        f"{cfg.num_image_patches} patch rows and {LLAVA_PROMPT} prompt "
        f"tokens) against a no-cache prefill of the patches, the prompt and "
        f"that token: max|d|/max|logit| = {gap:.3g} (tolerance {LOGIT_RTOL})")
    if not gap <= LOGIT_RTOL:
        fail(f"vlm: decode and no-cache prefill differ by {gap}")
    log(f"[vlm] peak memory {_peak() / 2**30:.2f} GiB")
    del params, model
    _free()
    return counts


# --------------------------------------------------------------- phase 13
# (a): 4 system prompts of 384 tokens, each shared by 4 requests that add
# 128 tokens of their own (512-token prompts, as in phase 3), prefilled in
# 128-token chunks on two replicas of one llama3-8b tenant
FLEET_SYSTEM, FLEET_OWN, FLEET_GROUPS, FLEET_SHARE = 384, 128, 4, 4
FLEET_CHUNK, FLEET_PAGES = 128, 512
# the spec whose costs decide import against recompute: a 384-token span
# of llama3-8b (50,331,648 bytes of K/V) crosses GH200's 450 GB/s link in
# 0.11 ms, and recomputing it costs 10.6 ms, so the group imports it
FLEET_HW = GH200
# (b): phase 4's two 2-layer tenants and tight pool; 8 requests at once
# (remaps under pressure), 4 more after the scale-in and scale-out
SCALE_PROMPT, SCALE_NEW, SCALE_PAGES, SCALE_LATE = 96, 16, 16, 100.0
SCALE_PREWARM_BLOCKS = 12


def fleet_trace(model: str, vocab: int, gap: float = 2.0):
    """The 4 groups' first requests, then the rest round-robin over the
    groups, one arrival every ``gap`` steps: a group's first request has
    prefilled its 4 chunks and published its prompt before the group's
    second request arrives 4 * ``gap`` steps later."""
    rng = np.random.default_rng(13)
    systems = [rng.integers(0, vocab, FLEET_SYSTEM)
               for _ in range(FLEET_GROUPS)]
    reqs = []
    for k in range(FLEET_SHARE):
        for g in range(FLEET_GROUPS):
            own = rng.integers(0, vocab, FLEET_OWN)
            reqs.append(Request(
                f"g{g}-{k}", model,
                np.concatenate([systems[g], own]).astype(np.int32),
                max_new_tokens=NEW, arrival=1.0 + gap * len(reqs)))
    return reqs


def _kv_bytes(kv) -> int:
    return sum(x.numel() * x.element_size() for x in kv)


def instrument_fleet(rt, log_: dict) -> None:
    """Wrap one replica's ``export_prefix``/``import_prefix``: time them
    (each ends synchronised), count the bytes that cross, record each
    import's tokens, and check after every import that the importer's
    pages for the span are the donor's exactly (``torch.equal``)."""
    export, import_ = rt.export_prefix, rt.import_prefix

    def timed_export(model, tokens, n_tokens):
        _sync()
        t0 = time.perf_counter()
        kv = export(model, tokens, n_tokens)      # returns after the copy
        log_["ms"] += (time.perf_counter() - t0) * 1e3
        if kv is not None:
            log_["exported"] += _kv_bytes(kv)
        return kv

    def checked_import(model, tokens, n_tokens, kv=None):
        _sync()
        t0 = time.perf_counter()
        got = import_(model, tokens, n_tokens, kv=kv)
        _sync()
        log_["ms"] += (time.perf_counter() - t0) * 1e3
        if got:
            blocks = got // PAGE
            log_["imported"] += _kv_bytes(kv) * blocks // kv[0].shape[1]
            log_["imports"].append(np.asarray(tokens).tobytes())
            mine = export(model, tokens, n_tokens)
            if mine is None or not all(
                    torch.equal(a, b) for a, b in zip(mine, kv)):
                fail(f"fleet: the importer's pages for a {n_tokens}-token "
                     f"span differ from the donor's export")
        return got

    rt.export_prefix, rt.import_prefix = timed_export, checked_import


def _fleet_log() -> dict:
    return {"ms": 0.0, "exported": 0, "imported": 0, "imports": []}


def _check_replica(rt) -> None:
    rt.allocator.check_invariants()
    for idx in rt.prefix.values():
        idx.check_invariants()


def phase_fleet_import(cfg=ARCHS["llama3-8b"]):
    """13(a): two replicas lowered from one RuntimeConfig, a fleet prefix
    cache and a least-loaded router; a request routed away from its
    group's prefix imports the 384-token span's pages from the other
    replica and prefills only its own 128 tokens (paged prefill kernel)."""
    _reset_peak()
    model, params = _init(cfg, 0, "fleet", "")
    name = cfg.name
    max_context = FLEET_SYSTEM + FLEET_OWN + NEW + 2 * PAGE
    conf = RuntimeConfig(
        tenants={name: TenantSpec(cfg, params=params, max_batch=8,
                                  max_context=max_context, paged=True)},
        mode="mirage", prefill_chunk_tokens=FLEET_CHUNK, prefix_sharing=True)
    fc = FleetPrefixCache(page_size=PAGE)
    group = ReplicaGroup.from_config(
        conf, 2, backend="engine", router=Router("least_loaded"),
        fleet_cache=fc, base_kv_pages=FLEET_PAGES, page_size=PAGE,
        keep_prefill_logits=True, hw=FLEET_HW, device=DEVICE)
    moved = _fleet_log()
    for rt in group.replicas:
        instrument_fleet(rt, moved)
    trace = fleet_trace(name, cfg.vocab_size)
    prompts = {np.asarray(r.prompt).tobytes(): r for r in trace}
    originals = {r.rid: r.prompt.copy() for r in trace}
    kernels.reset_launch_counts()
    group.submit(trace)
    _sync()
    t0 = time.perf_counter()
    t_first = first_tokens = None
    while group.busy() and group.ticks < 20_000:
        group.tick()
        if t_first is None and all(r.generated for r in trace):
            _sync()
            t_first = time.perf_counter()
            first_tokens = sum(len(r.generated) for r in trace)
    _sync()
    t_end = time.perf_counter()
    counts = kernels.launch_counts()
    done = [r for rt in group.replicas for r in rt.finished]
    if len(done) != len(trace) or any(len(r.generated) != NEW
                                      for r in trace):
        fail(f"fleet: {len(done)} of {len(trace)} requests finished, not "
             f"every one with {NEW} tokens")
    for rt in group.replicas:
        _check_replica(rt)
    imported = [prompts[k] for k in moved["imports"]]
    kinds = [k for rt in group.replicas for _, k, _ in rt.events]
    dec = sum(len(r.generated) for r in trace) - first_tokens
    log(f"[fleet] 2 replicas, {len(trace)} requests ({FLEET_GROUPS} system "
        f"prompts of {FLEET_SYSTEM} tokens x {FLEET_SHARE}, +{FLEET_OWN} "
        f"own): {group.ticks} rounds in {t_end - t0:.3f} s; decode after "
        f"the last first token: {dec} tokens in {t_end - t_first:.3f} s = "
        f"{dec / (t_end - t_first):.1f} tok/s; events {Counter(kinds)}; "
        f"fleet cache {dataclasses.asdict(fc.stats)}")
    log(f"[fleet] launches {counts}")
    log(f"[fleet] exported {moved['exported']} bytes, imported "
        f"{moved['imported']} bytes in {len(imported)} imports ("
        f"{[r.rid for r in imported]}); export+import {moved['ms']:.3f} ms; "
        f"imported pages torch.equal to the donor's export after each")
    if not moved["imported"] > 0 or not fc.stats.fetch_bytes > 0:
        fail("fleet: no prefix was imported")
    if "remap" in kinds:
        fail("fleet: a replica remapped (a donated layer grows the pool by "
             "26,626 pages; this phase must run inside its base pool)")
    if DEVICE == "cuda" and not (counts["paged_prefill_attention"] > 0
                                 and counts["paged_decode_attention"] > 0):
        fail(f"fleet: a kernel of the path never launched: {counts}")
    # each request that used an imported span, against a lone engine's
    # monolithic prefill of its whole prompt (flash kernel)
    lone = ServingEngine(
        {name: TenantConfig(cfg, params, max_batch=8,
                            max_context=max_context, paged=True)},
        mode="mirage", base_kv_pages=FLEET_PAGES, page_size=PAGE,
        device=DEVICE, keep_prefill_logits=True)
    lone.submit([Request(r.rid, name, originals[r.rid], max_new_tokens=1)
                 for r in imported])
    kernels.reset_launch_counts()
    lone.run()
    _sync()
    c_lone = kernels.launch_counts()
    if DEVICE == "cuda" and not c_lone["flash_attention"] > 0:
        fail(f"fleet: the lone engine's prefill never launched flash: "
             f"{c_lone}")
    worst = 0.0
    for r in imported:
        rt = group.replicas[group.router.assignments[r.rid]]
        a, b = lone.prefill_logits[r.rid], rt.prefill_logits[r.rid]
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            fail(f"fleet: non-finite prefill logits for {r.rid}")
        if r.prefix_matched_tokens < FLEET_SYSTEM:
            fail(f"fleet: {r.rid} matched {r.prefix_matched_tokens} cached "
                 f"tokens, not the imported {FLEET_SYSTEM}")
        worst = max(worst, ((a - b).abs().max() / a.abs().max()).item())
    log(f"[fleet] first-token logits of the {len(imported)} requests on "
        f"imported spans against a lone monolithic prefill: "
        f"max|d|/max|logit| = {worst:.3g} (tolerance {LOGIT_RTOL}); peak "
        f"memory {_peak() / 2**30:.2f} GiB")
    if not worst <= LOGIT_RTOL:
        fail(f"fleet: prefill logits after an import differ by {worst}")
    del lone, group, params, model
    _free()
    return Counter(counts) + Counter(c_lone)


def _pool_bytes(rt) -> int:
    return sum(t.state[k].numel() * t.state[k].element_size()
               for t in rt.tenants.values() if t.paged
               for k in ("pool_k", "pool_v"))


def phase_fleet_scale(cfg=dataclasses.replace(ARCHS["llama3-8b"],
                                              num_layers=2)):
    """13(b): phase 4's tenants on a 2-replica group with coordinated
    remaps; a replica is removed while it is remapped (respill, forced
    reversion, teardown) and a pre-warmed one joins."""
    _reset_peak()
    tp = {n: build_model(cfg).init(
        torch.Generator(device=DEVICE).manual_seed(seed), DEVICE)
        for n, seed in (("A", 1), ("B", 2))}
    conf = RuntimeConfig(
        tenants={n: TenantSpec(cfg, params=p, max_batch=4, max_context=128,
                               paged=True) for n, p in tp.items()},
        mode="mirage", quantum_steps=8, prefill_chunk_tokens=64,
        prefix_sharing=True)
    # no Dynamic Reversion: the removed replica's layers come back only
    # through its forced drain
    build_kw = dict(base_kv_pages=SCALE_PAGES, page_size=PAGE,
                    runtime=EngineKnobs(dynamic_reversion=False),
                    device=DEVICE)
    fc = FleetPrefixCache(page_size=PAGE)
    group = ReplicaGroup.from_config(conf, 2, backend="engine",
                                     coordinate=True, fleet_cache=fc,
                                     **build_kw)
    trace = tiny_trace(["A", "B"], n_per_model=6, prompt_len=SCALE_PROMPT,
                       max_new=SCALE_NEW, vocab=cfg.vocab_size, seed=1)
    # both tenants on each replica: the least-loaded router alternates, so
    # order the first 8 A, A, B, B, ...; the last 4 come after the scale-in
    order = sorted(trace, key=lambda r: (int(r.rid.split("-")[1]) // 2,
                                         r.model, r.rid))
    for i, r in enumerate(order):
        r.arrival = 0.01 * i if i < 8 else SCALE_LATE + 4.0 * (i - 8)
    moved = _fleet_log()
    for rt in group.replicas:
        instrument_fleet(rt, moved)
    kernels.reset_launch_counts()
    group.submit(trace)
    removed = joined = None
    while group.busy() and group.ticks < 20_000:
        group.tick()
        if removed is None:
            hot = [i for i, rt in enumerate(group.replicas)
                   if rt.store.total_remapped_bytes() > 0]
            if hot:
                removed = group.replicas[hot[0]]
                # what the group's own withdraw_pending call will respill
                respilled = removed.withdraw_pending()
                removed.submit(respilled)
                remap_alpha = {n: m.remapped_alpha
                               for n, m in removed.store.models.items()}
                group.remove_replica(hot[0])
        elif joined is None and removed not in group.replicas:
            joined = conf.build("engine", **build_kw)
            instrument_fleet(joined, moved)
            group.add_replica(joined, prewarm=True,
                              prewarm_blocks=SCALE_PREWARM_BLOCKS)
            donor = group.replicas[0]
            snap = donor.prefix_snapshot(SCALE_PREWARM_BLOCKS)
            probes = [(donor.prefix_probe(m, tok), joined.prefix_probe(m, tok))
                      for m, tok in snap]
    _sync()
    counts = kernels.launch_counts()
    if removed is None or joined is None:
        fail(f"fleet-scale: no replica remapped, or the scale-in never "
             f"completed (membership {group.events})")
    done = [r for rt in [*group.replicas, removed] for r in rt.finished]
    if len(done) != len(trace) or any(len(r.generated) != SCALE_NEW
                                      for r in trace):
        fail(f"fleet-scale: {len(done)} of {len(trace)} requests finished, "
             f"not every one with {SCALE_NEW} tokens")
    kinds = [k for _, k, _ in removed.events]
    cycle = [x.shape[0] for n in removed.xfer.split
             for x in tree_leaves(removed.xfer.split[n][1])]
    log(f"[fleet-scale] membership {group.events}; removed replica: remapped "
        f"alpha {remap_alpha} at removal, events {Counter(kinds)}, "
        f"respilled {len(respilled)}, host->device fetch bytes "
        f"{removed.xfer.host_fetch_bytes}, TransferStats "
        f"{dataclasses.asdict(removed.xfer.stats)}, cycle layers left "
        f"{sum(cycle)}")
    if not removed.xfer.stats.stream_bytes > 0 or (
            DEVICE == "cuda" and not removed.xfer.host_fetch_bytes > 0):
        fail("fleet-scale: the removed replica never decoded from streamed "
             "layers")
    if any(m.remapped_alpha for m in removed.store.models.values()) \
            or removed.xfer.pending or sum(cycle) \
            or "revert-teardown" not in kinds:
        fail("fleet-scale: the removed replica was not fully reverted")
    for rt in group.replicas:
        _check_replica(rt)
    log(f"[fleet-scale] pre-warm: {len(probes)} spans, donor/joiner probes "
        f"{probes}; exported {moved['exported']} bytes, imported "
        f"{moved['imported']} bytes in {moved['ms']:.3f} ms")
    if not probes or not moved["imported"] > 0 or any(
            a != b for a, b in probes):
        fail("fleet-scale: the pre-warmed replica does not hold the donor's "
             "spans")
    log(f"[fleet-scale] {sum(len(r.generated) for r in trace)} tokens; peak "
        f"memory {_peak() / 2**30:.2f} GiB")
    # the group keeps a retired unit (its finished requests stay in the
    # fleet's metrics); the pool goes once the group does
    pool = _pool_bytes(removed)
    gone = weakref.ref(removed)
    survivors = list(group.replicas)
    gc.collect()
    _sync()
    before = torch.cuda.memory_allocated() if DEVICE == "cuda" else 0
    del removed, group, joined, donor
    gc.collect()
    after = torch.cuda.memory_allocated() if DEVICE == "cuda" else 0
    log(f"[fleet-scale] dropping the removed replica: memory allocated "
        f"{before / 2**30:.2f} -> {after / 2**30:.2f} GiB; its pools held "
        f"{pool / 2**30:.2f} GiB")
    if gone() is not None or (DEVICE == "cuda" and before - after < pool):
        fail("fleet-scale: the removed replica's pools were not released")
    del survivors, tp
    _free()
    return counts


# ------------------------------------------------------------------- main
def main() -> None:
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    checked, shape_rows = phase_kernels()
    # launches summed over every serving phase's runs (each resets the
    # counts just before its engine runs and reads them just after)
    launches = Counter()
    for phase in (phase_serve, phase_remap, phase_xlstm, phase_xlstm_remap,
                  phase_moonshot, phase_jamba, phase_danube, phase_whisper,
                  phase_whisper_remap, phase_llava, phase_fleet_import,
                  phase_fleet_scale):
        launches.update(phase())
    log(f"[launches] every serving phase: {dict(launches)}")
    rows = []
    for name, (err, (ms, pms, bms, by, lib, _shape)) in checked.items():
        src, replaces = SOURCES[name]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "max_err": err, "ms": ms, "plain_ms": pms,
            "bound_ms": bms, "bound_by": by, "bound": by,
            "library_ms": lib,
            "shapes": [r for r in shape_rows if r["name"] == name]})
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
