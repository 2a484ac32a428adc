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
14. train: (a) llama3-8b at full width, cut to 8 of its 32 layers (2.80 B
   params; with AdamW's f32 moments and the f32 clipped gradients ~45 GB,
   so 16 layers, 72.6 GB before any activation, or all 32 do not fit one
   card), bf16,
   AdamW, ``remat_policy="dots_saveable"``, one sequence of 4096 tokens
   (train_4k's, its global batch of 256 cut to 1) through
   ``make_train_step``: 3 steps on fresh batches, then 10 on one fixed batch
   whose loss must fall; every loss and grad norm finite, every parameter
   leaf with a nonzero gradient at every step (a kernel output without
   ``grad_fn`` would leave its projections none), forward, backward and
   optimizer timed by CUDA events, tokens/s, peak memory, launches a step
   (flash runs each attention forward, again in the recompute) and, from
   the profiled last step, the device's idle share. (b) the same width cut
   to 2 layers at 512 tokens: the loss and each leaf's gradient on the card
   (bf16, kernels) against the same weights in f32 on the CPU (plain
   versions). (c) xlstm-1.3b at full width and depth (48 layers), bf16,
   AdamW, no remat, 3 steps on one 512-token batch: the same checks and
   times (no profile: its sLSTM loops launch ~10^5 kernels a step;
   ``tools/profile_torch_train.py`` profiles it), ``ssd_scan`` in every
   mLSTM forward. (d) the flash Function's dq, dk, dv
   and the kernel's lse at (a)'s shape and at danube's window shape, and
   the ssd Function's gradients at the xLSTM and Mamba widths, against
   autograd through the plain versions. (e) the kernel at (a)'s shape with
   its lse, the plain flash backward, and one causal SDPA forward (plus
   backward) beside them as yardsticks; the ssd Function's plain backward
   at xLSTM's shape.
15. distributed: (a) ``repro_torch.launch.serve`` with its default flags
   on the card (llama3-8b and h2o-danube-3-4b scaled to 4 layers, dense
   tenants: flash in every prefill), every request finished and the
   allocator's invariants held; (b) ``distributed_decode_attention`` on 2
   ranks sharing the card over gloo (spawned, meeting through a file
   store) at llama3-8b's attention width (Hq 32, Hkv 8, D 128, bf16): B=1
   at a 131,072-token context (the sequence over both ranks) and B=8 at
   8,192, each against one rank's ``decode_attention`` on the whole cache
   within ``ROW_RTOL``, each rank's partial and combine timed apart; (c)
   one full-width llama3-8b ``Attention.fwd_dec`` under a 2-rank mesh
   against the same step on one rank: the output and the ranks' cache
   slices put together. Each part's seconds beside the card's name and
   power limit.
16. mesh training: llama3-8b at full width cut to 4 layers, bf16, AdamW,
   3 steps of 2 x 2048 tokens on one rank, then on a (2, 2) mesh of 4
   gloo ranks sharing the card, held to it step by step and leaf by leaf
   (values and updates); the state moved to (4, 1) and back, a mesh
   checkpoint restored onto (4, 1); the launcher with ``--mesh host``.
17. mesh training of the MoE and SSM stacks on the same mesh, each held
   to one rank: moonshot-v1-16b-a3b (2 of 48 layers: experts over
   "model", one MoE group per data rank), jamba-v0.1-52b's layer 0
   (Mamba heads-parallel) and xlstm-1.3b (8 of 48 layers: mLSTM and
   sLSTM heads-parallel). (a) one layer of each kind on the mesh against
   one rank (row by row), the MoE's slot/disp bitwise against one rank's
   route on each group's tokens, at the training batch and at a
   decode-scale one (one group over both data ranks: the count
   exchange); (b) 3 steps against one rank (loss, grad norm, leaves and
   their updates); (c) step times (forward, backward, optimizer),
   collectives by kind, peak memory and flash/ssd_scan launches a rank.
   Phase 2 holds flash and ssd_scan at the ranks' shapes.
18. mesh training of the enc-dec and VLM configs on the same mesh, each
   held to one rank as in phase 17: whisper-medium (4 + 4 of its 24 + 24
   layers; 2 rows of 4096 frames, split over "model" as the input spec's
   "seq_cp" places them, and 448 tokens; its odd vocabulary stays whole)
   and llava-next-34b (1 of 60 layers; 2 x 4096 positions, 2880 of them
   patch rows). (a) whisper's encoder layer, its decoder layer over that
   encoder (the encoder's leaves reached only through cross-attention)
   and llava's layer on the mesh against one rank, every leaf's gradient
   row by row; (b) and (c) as in phase 17. Phase 2 holds flash at the
   ranks' shapes.
19. the kernels line (JSON; launches summed over phases 3-18; each kernel's
   ``shapes`` lists phase 2's timed shape rows and phases 14 and 16's
   flash rows) and, last, the result line (JSON).
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
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
from repro_torch.configs.base import ShapeConfig  # noqa: E402
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
from repro_torch.training import (  # noqa: E402
    OptimizerConfig, batch_for_step, checkpoint, make_optimizer,
    make_train_step,
)
from repro_torch.training.optimizer import Optimizer  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    MeshLayout, mesh_context, mesh_group,
)
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch.mesh import make_mesh, spawn_ranks  # noqa: E402
from repro_torch.models.attention_ops import (  # noqa: E402
    decode_attention_partial, distributed_decode_attention, lse_combine,
)
from repro_torch.models.blocks import (  # noqa: E402
    Attention, decode_cache_slices, decode_layout,
)
from repro_torch.models.lm import MIXERS  # noqa: E402

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


def update_err(out, ref, init) -> float:
    """|d - d_ref| / max(|d|, |d_ref|), Frobenius norms, of the updates
    d = out - init and d_ref = ref - init: 0 where they agree, 1 where
    either is zero (no update) and the other is not, or both are."""
    d_ref = ref.float() - init.float()
    d = out.float() - init.float()
    top = max(d.norm().item(), d_ref.norm().item())
    return (d - d_ref).norm().item() / top if top else 1.0


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
    check_ssd_rank_shapes(gen, rows)
    for shape in SHAPES:
        check_shape(gen, rows, shape)
    for shape in FLASH_SHAPES:
        check_flash_shape(gen, rows, shape)
    timing = time_kernels(gen)
    timing["ssd_scan"] = time_ssd(gen)
    shape_rows = [row for shape in SHAPES for row in time_shape(gen, shape)]
    shape_rows += [time_flash_shape(gen, shape) for shape in FLASH_SHAPES]
    shape_rows += time_ssd_rank_shapes(gen)
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
    # phase 17's moonshot attention on a rank of the (2, 2) mesh: 8 of its
    # 16 heads (G = 1), one 2048-token row
    "moonshot_mesh_rank": (1, 2048, 2048, 8, 8, 128, True),
    # phase 18's on a rank of the same mesh: whisper's encoder over one
    # row of 4096 frames, its decoder's 448 tokens and their cross-attention
    # against the frames, 8 of its 16 heads; llava's 4096 positions, 28 of
    # its 56 query heads and 4 of its 8 KV heads
    "whisper_mesh_encoder": (1, 4096, 4096, 8, 8, 64, False),
    "whisper_mesh_decoder": (1, 448, 448, 8, 8, 64, True),
    "whisper_mesh_cross": (1, 448, 4096, 8, 8, 64, False),
    "llava_mesh_rank": (1, 4096, 4096, 28, 4, 128, True),
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


# phase 17's ssd_scan shapes on a rank of the (2, 2) mesh: (b, T, H, dk,
# dv, mLSTM): jamba's Mamba (64 of its 128 heads, one 2048-token row) and
# xlstm's mLSTM (2 of its 4 heads, one 512-token row)
SSD_RANK_SHAPES = {"jamba_mesh_rank": (1, 2048, 64, 16, 64, False),
                   "xlstm_mesh_rank": (1, 512, 2, 512, 513, True)}


def check_ssd_rank_shapes(gen, rows):
    """ssd_scan at ``SSD_RANK_SHAPES`` against its plain version: y and the
    final state within SSD_RTOL * max(1, max|plain|), and y row by row (dv)
    within ROW_RTOL of its bf16 inputs."""
    tol = ROW_RTOL[torch.bfloat16]
    for name, (b, t, h, dk, dv, mlstm) in SSD_RANK_SHAPES.items():
        q, k, v, la = ssd_inputs(gen, b, t, h, dk, dv, mlstm)
        y, f = ssd_ops.ssd_scan(q, k, v, la)
        ry, rf = ssd_scan_ref(q, k, v, la)
        torch.cuda.synchronize()
        ey, ef, r = _rel(y, ry), _rel(f, rf), row_err(y, ry)
        rows["ssd_scan"] += [_err(y, ry), _err(f, rf)]
        log(f"[kernels] ssd_scan {name} B={b} T={t} H={h} dk={dk} dv={dv}: "
            f"y rel err {ey:.3g}, final state rel err {ef:.3g} (limit "
            f"{SSD_RTOL}), y row_err {r:.3g} (limit {tol})")
        if not (ey <= SSD_RTOL and ef <= SSD_RTOL and r <= tol):
            fail(f"ssd_scan {name}: {ey}, {ef} > {SSD_RTOL} or row_err "
                 f"{r} > {tol}")


def time_ssd_rank_shapes(gen):
    """ssd_scan at ``SSD_RANK_SHAPES`` in turns with its plain version,
    beside its bound; no library call computes it. Returns the kernels
    line's shape rows."""
    out = []
    for name, (b, t, h, dk, dv, mlstm) in SSD_RANK_SHAPES.items():
        q, k, v, la = ssd_inputs(gen, b, t, h, dk, dv, mlstm)
        ms, turns = time_turns({
            "kernel": lambda: ssd_ops.ssd_scan(q, k, v, la),
            "plain": lambda: ssd_scan_ref(q, k, v, la)}, {"kernel": 50,
                                                          "plain": 10})
        bms, by = bound(*ssd_work(b, t, h, dk, dv))
        log(f"[kernels] time ssd_scan at {name} (B={b} T={t} H={h} dk={dk} "
            f"dv={dv}): {ms['kernel']:.4f} ms (turns "
            f"{_fmt(turns['kernel'])}), plain {ms['plain']:.4f} ms, bound "
            f"{bms:.4f} ms ({by}), {bms / ms['kernel']:.3f} of it, library "
            f"none")
        out.append(_shape_row("ssd_scan", f"{name} B={b} T={t} H={h} "
                              f"dk={dk} dv={dv}", ms["kernel"], ms["plain"],
                              bms, by, None))
    return out


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
    # an enc-dec's pattern is ["encdec"]
    pattern = [ld if isinstance(ld, str) else f"{ld.mixer}/{ld.ffn}"
               for ld in model.impl.pattern]
    log(f"[{tag}] {cfg.name}: {cfg.num_layers} layers ({model.repeats} x "
        f"{pattern}), d_model "
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


# ---------------------------------------------------------------- phase 14
# (a) llama3-8b at full width, cut to TRAIN_LAYERS of its 32 layers: 2.80 B
# params, about 16 bytes each with AdamW (bf16 params and grads, the f32
# clipped grads, f32 mu and nu: ~45 GB) plus the activations; 16 layers
# (72.6 GB before any activation) or all 32 do not fit one card. One
# sequence of train_4k's 4096 tokens (its global batch of 256 cut to 1).
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH = 8, 4096, 1
TRAIN_STEPS, FIXED_STEPS = 3, 10     # varying batches, then one fixed batch
TRAIN_REMAT = "dots_saveable"
TRAIN_OPT = dict(learning_rate=3e-4, warmup_steps=10)
# (b) the same width cut to CHECK_LAYERS layers at CHECK_SEQ tokens: loss and
# every leaf's gradient on the card (bf16, kernels) against the same
# weights in f32 on the CPU (plain versions). bf16 keeps 8 significant bits:
# every product's output, activation and gradient on the card is rounded to
# it (2^-9 relative each), and the errors add up through the two layers, the
# 128256-way softmax and the backward, to ~1e-2 of a gradient leaf's norm
# (and far less of the loss, an average over 512 tokens). A gradient left
# out (a kernel output without grad_fn) is an error of 1.0.
CHECK_LAYERS, CHECK_SEQ = 2, 512
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 2e-2, 5e-2
# (c) xlstm-1.3b at full width and depth, one 512-token sequence, without
# remat (the launcher's default): under dots_saveable the nested
# checkpoints (per repeat, per layer, per sLSTM chunk) run each sLSTM time
# loop four times a step (303,701 launches a step on an H100 host, ~18.5 s
# of host-bound time; PERF.md); tools/profile_torch_train.py profiles
# either
XLSTM_TRAIN_SEQ, XLSTM_TRAIN_STEPS, XLSTM_TRAIN_REMAT = 512, 3, "none"
# (d) the kernels' gradients: FlashAttention's dq, dk, dv (kernel forward,
# plain backward) against autograd through the plain forward in f32 on the
# same bf16 inputs, relative Frobenius error: the bf16 rounding of the
# kernel's output and of the returned gradients (2^-9 each) over f32 math
FLASH_GRAD_RTOL = 2e-2
# the kernel's lse against the plain m + log l in f32 on the same inputs:
# both exponentiate f32 scores (the kernel in base 2 with ex2.approx, ~2^-22
# relative) in another order, ~1e-5 at an lse of ~8; one key tile left out
# moves it by log(1 - 64 / Sk) or more
LSE_TOL = 1e-3
# (Sq = Sk, Hq, Hkv, D, window): (a)'s attention; danube's window shape
TRAIN_FLASH = {"llama3-8b": (4096, 32, 8, 128, 0),
               "danube": (4608, 32, 8, 120, 4096)}


def _mark():
    """A point on the device's timeline (a CUDA event; the host clock for
    a CPU rehearsal)."""
    if DEVICE != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _between(a, b) -> float:
    return a.elapsed_time(b) if DEVICE == "cuda" else (b - a) * 1e3


def instrument_step(model, opt):
    """Marks around the train step's parts on the model and the optimizer
    it is given: forward (``Model.train_loss``), backward (the gradients
    and their clip: from the loss to the optimizer) and optimizer
    (``update``); and each step's largest |gradient| per parameter leaf,
    from the clipped gradients the optimizer receives. Returns (optimizer,
    marks: per step [forward start, forward end, update start, update end],
    grad_max: per step a tensor over the leaves)."""
    marks, grad_max = [], []
    loss_fn = model.train_loss

    def train_loss(*args, **kwargs):
        marks.append([_mark()])
        out = loss_fn(*args, **kwargs)
        marks[-1].append(_mark())
        return out

    def update(grads, state, params, *shardings):
        marks[-1].append(_mark())
        grad_max.append(torch.stack([g.abs().amax()
                                     for g in tree_leaves(grads)]))
        out = opt.update(grads, state, params, *shardings)
        marks[-1].append(_mark())
        return out
    model.train_loss = train_loss
    return Optimizer(opt.init, update), marks, grad_max


def train_run(tag, model, params, batches, remat=TRAIN_REMAT,
              profile_last=False):
    """AdamW steps through ``make_train_step`` on ``batches`` (one a step),
    each timed: forward, backward and optimizer by marks on the device's
    timeline, the step's wall time on the host. Launch counts are reset
    just before the steps and read just after. With ``profile_last``, the
    last step runs under the profiler (launches, device time, idle share
    against the mean wall time of the others). Returns (records, launch
    counts, profile or None)."""
    opt, marks, grad_max = instrument_step(
        model, make_optimizer(OptimizerConfig(**TRAIN_OPT)))
    opt_state = opt.init(params)
    step = make_train_step(model, opt, remat_policy=remat)
    _sync()
    kernels.reset_launch_counts()
    recs, prof = [], None
    for i, batch in enumerate(batches):
        def one():
            nonlocal params, opt_state
            params, opt_state, m = step(params, opt_state, batch)
            return m
        if profile_last and i == len(batches) - 1:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as p:
                t0 = time.perf_counter()
                m = one()
                _sync()
                prof_wall = time.perf_counter() - t0
            avg = p.key_averages()
            prof = {"launches": sum(e.count for e in avg
                                    if e.key in _LAUNCH_KEYS),
                    "dev_ms": sum(e.self_device_time_total for e in avg
                                  if str(getattr(e, "device_type", ""))
                                  .endswith("CUDA")) / 1e3,
                    "prof_ms": prof_wall * 1e3}
            wall = prof_wall
        else:
            t0 = time.perf_counter()
            m = one()
            _sync()
            wall = time.perf_counter() - t0
        recs.append({"loss": m["loss"].item(),
                     "grad_norm": m["grad_norm"].item(),
                     "wall_ms": wall * 1e3})
    counts = kernels.launch_counts()
    _sync()
    for rec, mk, gm in zip(recs, marks, grad_max):
        rec["fwd_ms"] = _between(mk[0], mk[1])
        rec["bwd_ms"] = _between(mk[1], mk[2])
        rec["opt_ms"] = _between(mk[2], mk[3])
        rec["zero_grad_leaves"] = int((gm == 0).sum())
    for i, r in enumerate(recs):
        log(f"[{tag}] step {i}: loss {r['loss']:.4f}, grad norm "
            f"{r['grad_norm']:.4f}; forward {r['fwd_ms']:.1f} ms, backward "
            f"{r['bwd_ms']:.1f} ms, optimizer {r['opt_ms']:.1f} ms, wall "
            f"{r['wall_ms']:.1f} ms"
            + (" (profiled)" if prof is not None and i == len(recs) - 1
               else ""))
    bad = [i for i, r in enumerate(recs)
           if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]))]
    if bad:
        fail(f"{tag}: non-finite loss or grad norm at steps {bad}")
    zero = [(i, r["zero_grad_leaves"]) for i, r in enumerate(recs)
            if r["zero_grad_leaves"]]
    if zero:
        fail(f"{tag}: parameter leaves with an all-zero gradient (step, "
             f"count): {zero}")
    return recs, counts, prof


def _summary(tag, recs, counts, prof, tokens, steps_from=1):
    """Mean forward, backward and optimizer ms and tokens/s over the steps
    from ``steps_from`` (the first one warms up) that were not profiled."""
    plain_recs = recs[steps_from:len(recs) - (prof is not None)]
    mean = {k: sum(r[k] for r in plain_recs) / len(plain_recs)
            for k in ("fwd_ms", "bwd_ms", "opt_ms", "wall_ms")}
    n = len(recs)
    per_step = {k: v / n for k, v in counts.items() if v}
    last = steps_from + len(plain_recs) - 1
    log(f"[{tag}] mean of steps {steps_from}-{last}: forward "
        f"{mean['fwd_ms']:.1f} ms, backward {mean['bwd_ms']:.1f} ms, "
        f"optimizer {mean['opt_ms']:.1f} ms, wall {mean['wall_ms']:.1f} "
        f"ms; {tokens / mean['wall_ms'] * 1e3:.0f} tokens/s; kernel launches "
        f"a step {per_step}; peak memory {_peak() / 2**30:.2f} GiB")
    if prof is not None:
        log(f"[{tag}] profiled step: {prof['launches']:.0f} kernel launches, "
            f"device {prof['dev_ms']:.1f} ms, wall under the profiler "
            f"{prof['prof_ms']:.1f} ms; device idle share "
            f"{max(0.0, 1 - prof['dev_ms'] / mean['wall_ms']):.3f} of an "
            f"unprofiled step")
    return mean


def train_batches(model, seq, seeds):
    shape = ShapeConfig("train", seq, TRAIN_BATCH, "train")
    return [batch_for_step(model, shape, 0, s, device=DEVICE) for s in seeds]


def phase_train_llama(cfg=dataclasses.replace(ARCHS["llama3-8b"],
                                              num_layers=TRAIN_LAYERS)):
    """(a) llama3-8b, full width, TRAIN_LAYERS layers, bf16, AdamW,
    dots_saveable: TRAIN_STEPS steps on fresh batches, then FIXED_STEPS on
    one fixed batch whose loss must fall."""
    _reset_peak()
    model, params = _init(cfg, 18, "train", f"d_ff {cfg.d_ff}, ")
    batches = train_batches(model, TRAIN_SEQ, range(TRAIN_STEPS))
    batches += train_batches(model, TRAIN_SEQ, [TRAIN_STEPS]) * FIXED_STEPS
    recs, counts, prof = train_run("train", model, params, batches,
                                   profile_last=True)
    n_attn = sum(ld.mixer == "attn" for ld in model.impl.pattern) \
        * model.repeats
    per_step = counts["flash_attention"] / len(recs)
    log(f"[train] flash_attention launches a step {per_step:.0f} for "
        f"{n_attn} attention layers (forward, and again in the recompute)")
    if DEVICE == "cuda" and per_step < n_attn:
        fail(f"train: flash launched {per_step} times a step for {n_attn} "
             "attention layers")
    fixed = [r["loss"] for r in recs[TRAIN_STEPS:]]
    log(f"[train] fixed batch: loss {fixed[0]:.4f} -> {fixed[-1]:.4f}")
    if not fixed[-1] < fixed[0]:
        fail(f"train: the fixed batch's loss did not fall: {fixed}")
    _summary("train", recs, counts, prof, TRAIN_BATCH * TRAIN_SEQ)
    del params, model, batches
    _free()
    return counts


def loss_and_grads(model, params, batch, remat=TRAIN_REMAT):
    """(loss, gradients in the params' leaf order) of ``Model.train_loss``."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    loss = model.train_loss(tree_map(lambda _: next(it), params), batch,
                            remat_policy=remat)
    return loss.detach(), torch.autograd.grad(
        loss, leaves, allow_unused=True, materialize_grads=True)


def _rel_fro(a, ref) -> float:
    a, ref = a.float().cpu(), ref.float().cpu()
    return ((a - ref).norm() / ref.norm().clamp_min(1e-30)).item()


def check_train_against_cpu(cfg=dataclasses.replace(ARCHS["llama3-8b"],
                                                    num_layers=CHECK_LAYERS)):
    """(b) loss and per-leaf gradients of the card's bf16 step against the
    CPU in f32 on the same weights and batch."""
    model, params = _init(cfg, 19, "train-check", f"d_ff {cfg.d_ff}, ")
    batch = train_batches(model, CHECK_SEQ, [0])[0]
    loss, grads = loss_and_grads(model, params, batch)
    cpu_cfg = dataclasses.replace(cfg, dtype="float32")
    t0 = time.perf_counter()
    ref_loss, ref_grads = loss_and_grads(
        build_model(cpu_cfg), tree_map(lambda p: p.float().cpu(), params),
        {k: v.cpu() for k, v in batch.items()})
    paths = [p for p, _ in _leaf_paths(params)]
    errs = {p: _rel_fro(g, r) for p, g, r in zip(paths, grads, ref_grads)}
    le = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    worst = max(errs, key=errs.get)
    log(f"[train-check] {CHECK_LAYERS} layers, S={CHECK_SEQ}: loss "
        f"{loss.item():.5f} (card, bf16) vs {ref_loss.item():.5f} (CPU, f32, "
        f"{time.perf_counter() - t0:.1f} s), rel err {le:.3g} (limit "
        f"{TRAIN_LOSS_RTOL}); gradient rel Frobenius error per leaf: max "
        f"{errs[worst]:.3g} at {worst} (limit {TRAIN_GRAD_RTOL}), median "
        f"{sorted(errs.values())[len(errs) // 2]:.3g}")
    log("[train-check] per leaf: " + ", ".join(
        f"{p} {e:.3g}" for p, e in errs.items()))
    if not le <= TRAIN_LOSS_RTOL:
        fail(f"train-check: loss rel err {le} > {TRAIN_LOSS_RTOL}")
    if not errs[worst] <= TRAIN_GRAD_RTOL:
        fail(f"train-check: gradient of {worst}: rel err {errs[worst]} > "
             f"{TRAIN_GRAD_RTOL}")
    del params, model, grads
    _free()


def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaf_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in _leaf_paths(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def phase_train_xlstm(cfg=ARCHS["xlstm-1.3b"]):
    """(c) xlstm-1.3b at full width and depth, bf16, AdamW, no remat:
    XLSTM_TRAIN_STEPS steps on one fixed 512-token batch (the loss must
    fall), ssd_scan in every mLSTM forward."""
    _reset_peak()
    model, params = _init(cfg, 20, "train-xlstm", "")
    batches = train_batches(model, XLSTM_TRAIN_SEQ, [0]) * XLSTM_TRAIN_STEPS
    recs, counts, prof = train_run("train-xlstm", model, params, batches,
                                   remat=XLSTM_TRAIN_REMAT)
    if not recs[-1]["loss"] < recs[0]["loss"]:
        fail(f"train-xlstm: the loss did not fall: "
             f"{[r['loss'] for r in recs]}")
    n_mlstm = sum(ld.mixer == "mlstm" for ld in model.impl.pattern) \
        * model.repeats
    per_step = counts["ssd_scan"] / len(recs)
    log(f"[train-xlstm] ssd_scan launches a step {per_step:.0f} for "
        f"{n_mlstm} mLSTM layers")
    if DEVICE == "cuda" and per_step < n_mlstm:
        fail(f"train-xlstm: ssd_scan launched {per_step} times a step for "
             f"{n_mlstm} mLSTM layers")
    _summary("train-xlstm", recs, counts, prof,
             TRAIN_BATCH * XLSTM_TRAIN_SEQ)
    del params, model, batches
    _free()
    return counts


def _flash_train_inputs(gen, s, hq, hkv, d, dt=torch.bfloat16):
    return [torch.randn(1, s, h, d, generator=gen, device=DEVICE).to(dt)
            for h in (hq, hkv, hkv)]


def _positions(s):
    pos = torch.arange(s, dtype=torch.int32, device=DEVICE)[None]
    return pos, pos, torch.ones(1, s, dtype=torch.bool, device=DEVICE)


def check_train_kernels(gen):
    """(d) the flash Function's gradients and the kernel's lse at (a)'s and
    danube's shapes, and the ssd Function's gradients at the xLSTM and
    Mamba widths, each against autograd through the plain version."""
    for name, (s, hq, hkv, d, window) in TRAIN_FLASH.items():
        q, k, v = _flash_train_inputs(gen, s, hq, hkv, d)
        w = torch.randn(1, s, hq, d, generator=gen, device=DEVICE)
        _, lse = flash_kernel.flash_attention(q, k, v, window=window,
                                              lse=True)
        ins = [x.detach().requires_grad_() for x in (q, k, v)]
        out = flash_ops.flash_attention(*ins, window=window)
        got = torch.autograd.grad((out.float() * w).sum(), ins)
        ref_ins = [x.detach().float().requires_grad_() for x in (q, k, v)]
        ref_out, ref_lse = plain.flash_fwd(*ref_ins, *_positions(s), True,
                                           window, 512)
        ref = torch.autograd.grad((ref_out * w).sum(), ref_ins)
        _sync()
        le = _err(lse, ref_lse)
        errs = [_rel_fro(g, r) for g, r in zip(got, ref)]
        log(f"[train-kernels] flash {name} (S={s}, {hq}/{hkv}, D={d}, window "
            f"{window}): lse max_err {le:.3g} (limit {LSE_TOL}); dq, dk, dv "
            f"rel Frobenius err {', '.join(f'{e:.3g}' for e in errs)} (limit "
            f"{FLASH_GRAD_RTOL})")
        if not le < LSE_TOL:
            fail(f"flash lse at {name}: {le} >= {LSE_TOL}")
        if not max(errs) < FLASH_GRAD_RTOL:
            fail(f"flash gradients at {name}: {errs} >= {FLASH_GRAD_RTOL}")
        del q, k, v, ins, out, got, ref_ins, ref_out, ref
        _free()
    from repro_torch.models.blocks import ssd_chunked
    for b, t, h, dk, dv, what in SSD_CASES[::2]:
        q, k, v, la = ssd_inputs(gen, b, t, h, dk, dv, what != "mamba")
        wy = torch.randn(b, t, h, dv, generator=gen, device=DEVICE)
        wf = torch.randn(b, h, dk, dv, generator=gen, device=DEVICE)

        def grads(fn):
            ins = [x.detach().requires_grad_() for x in (q, k, v, la)]
            y, f = fn(*ins, chunk=128)
            return torch.autograd.grad((y * wy).sum() + (f * wf).sum(), ins)
        got, ref = grads(ssd_ops.ssd_scan), grads(ssd_chunked)
        errs = [_rel(g.float(), r.float()) for g, r in zip(got, ref)]
        log(f"[train-kernels] ssd_scan {what} (B={b} T={t} H={h} dk={dk} "
            f"dv={dv}): dq, dk, dv, dlog_a err / max(1, max|ref|) "
            f"{', '.join(f'{e:.3g}' for e in errs)} (limit {SSD_RTOL})")
        if not max(errs) <= SSD_RTOL:
            fail(f"ssd_scan gradients at {what}: {errs} > {SSD_RTOL}")


def time_train_flash(gen, rows, tag: str, shape, label: str):
    """Flash at a training shape (B=1, S, Hq, Hkv, D, causal, bf16) with
    and without its lse output (graph replay), beside one causal SDPA
    forward, in turns; the plain forward; the bound. Appends the kernels
    line's shape row (the lse call) to ``rows``; returns q, k, v."""
    s, hq, hkv, d = shape
    q, k, v = _flash_train_inputs(gen, s, hq, hkv, d)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    calls = 5
    ms, turns = time_turns({
        "lse": graphed(lambda: flash_kernel.flash_attention(q, k, v,
                                                            lse=True), calls),
        "no_lse": graphed(lambda: flash_kernel.flash_attention(q, k, v),
                          calls),
        "sdpa": graphed(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), calls)}, 5)
    ms = {n: t / calls for n, t in ms.items()}
    plain_ms = time_ms(lambda: plain.flash_attention(q, k, v), 2, warmup=1)
    nbytes, flops = attention_work(s, s, hq, hkv, d)
    bms, by = bound(nbytes + s * hq * 4, flops)   # + the lse written
    log(f"[{tag}] time flash_attention (B=1 S={s} Hq {hq} Hkv {hkv} D {d} "
        f"causal bf16, lse): {ms['lse']:.4f} ms (graph replay); without lse "
        f"{ms['no_lse']:.4f} ms; SDPA forward {ms['sdpa']:.4f} ms, "
        f"kernel/SDPA {ms['lse'] / ms['sdpa']:.3f}; plain {plain_ms:.4f} ms; "
        f"bound {bms:.4f} ms ({by}), {bms / ms['lse']:.3f} of it")
    rows.append(_shape_row("flash_attention", label, ms["lse"], plain_ms,
                           bms, by, ms["sdpa"]))
    return q, k, v


def time_train_kernels(gen, rows):
    """(e) at (a)'s attention shape: the kernel with and without its lse
    output (graph replay) beside one causal SDPA forward; the plain
    forward; the plain backward (``flash_bwd``) beside one causal SDPA
    forward plus backward (eager calls, CUDA events); then the ssd
    Function's plain backward at xLSTM's shape. Appends flash's row at
    (a)'s shape to ``rows``."""
    s, hq, hkv, d, _ = TRAIN_FLASH["llama3-8b"]
    q, k, v = time_train_flash(gen, rows, "train-kernels", (s, hq, hkv, d),
                               f"train llama3-8b B=1 S={s} causal, lse")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out, lse = flash_kernel.flash_attention(q, k, v, lse=True)
    do = torch.randn_like(out)
    pos = _positions(s)
    bwd_ms = time_ms(lambda: plain.flash_bwd(q, k, v, *pos, out, lse, do,
                                             True, 0, 512), 3, warmup=1)
    qs, ks, vs = (x.detach().requires_grad_() for x in (qt, kt, vt))
    dot = do.transpose(1, 2)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                           enable_gqa=True)
        torch.autograd.grad(o, (qs, ks, vs), dot)
    sdpa_ms = time_ms(sdpa_fwd_bwd, 10)
    log(f"[train-kernels] time plain flash backward (B=1 S={s} causal, bf16 "
        f"in, f32 math): {bwd_ms:.3f} ms; SDPA forward + backward "
        f"{sdpa_ms:.3f} ms; plain backward / SDPA forward + backward "
        f"{bwd_ms / sdpa_ms:.2f}")
    # the ssd Function's backward at xLSTM's shape: autograd through the
    # plain recompute (what SsdScan.backward runs), beside the kernel's
    # forward
    from repro_torch.models.blocks import ssd_chunked
    b, t, h, dk, dv, _ = SSD_CASES[0]
    q, k, v, la = ssd_inputs(gen, b, t, h, dk, dv, True)
    dy = torch.randn(b, t, h, dv, generator=gen, device=DEVICE)
    df = torch.randn(b, h, dk, dv, generator=gen, device=DEVICE)

    def ssd_bwd():
        ins = [x.detach().requires_grad_() for x in (q, k, v, la)]
        torch.autograd.grad(ssd_chunked(*ins, 128), ins, (dy, df))
    fwd_ms = time_ms(lambda: ssd_ops.ssd_scan(q, k, v, la), 20)
    log(f"[train-kernels] time ssd_scan backward (plain recompute, B={b} "
        f"T={t} H={h} dk={dk} dv={dv}): {time_ms(ssd_bwd, 5):.3f} ms; the "
        f"kernel's forward {fwd_ms:.4f} ms (eager calls)")


def phase_train(shape_rows):
    """Phase 14: (a)-(e), each part's seconds logged. Returns the launch
    counts of (a) and (c)'s training runs; appends flash's training-shape
    row to ``shape_rows``."""
    gen = torch.Generator(device=DEVICE).manual_seed(14)
    counts = Counter()
    for part, run in (
            ("a", lambda: counts.update(phase_train_llama())),
            ("b", check_train_against_cpu),
            ("c", lambda: counts.update(phase_train_xlstm())),
            ("d", lambda: check_train_kernels(gen)),
            ("e", lambda: time_train_kernels(gen, shape_rows))):
        t0 = time.perf_counter()
        run()
        _free()
        log(f"[train] part ({part}) took {time.perf_counter() - t0:.1f} s")
    return counts


# --------------------------------------------------------------- phase 15
# (b) the distributed flash-decode at llama3-8b's attention width (Hq 32,
# Hkv 8, D 128, bf16) on DIST_WORLD ranks sharing the card over gloo:
# name -> (B, context); B=1 at 131,072 tokens splits the sequence over
# both ranks (kv_seq_full: 512 MiB of K+V, half a rank), B=8 at 8,192 over
# the model axis (kv_seq)
DIST_WORLD = 2
DIST_HEADS = (32, 8, 128)
DIST_CASES = {"b1_131k": (1, 131072), "b8_8k": (8, 8192)}
DIST_DTYPE = torch.bfloat16
DIST_REPS = 5
# (c) one llama3-8b attention layer's fwd_dec at full width: the batch, the
# dense cache's length, each row's position (its slot; both ranks' halves)
DIST_FWD = (4, 8192, (8191, 5000, 4096, 100))
DIST_FWD_CFG = ARCHS["llama3-8b"]


def _wall_ms(fn, reps: int, device: str) -> float:
    """Host milliseconds a call of ``fn`` takes to finish on the device
    (each call synchronised): the wall time one rank sees."""
    fn()
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        if device == "cuda":
            torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def dist_rank(rank: int, device: str, heads, cases, dtype, reps: int,
              fwd_cfg, fwd, out: str) -> None:
    """One rank of phase 15 (b) and (c) (under ``spawn_ranks``): the
    cases' seeded q/K/V made whole on every rank, each rank's contiguous
    slice of the sequence through ``distributed_decode_attention`` on a
    (1, world) mesh; its partial and its combine timed apart; rank 0 holds
    the result against single-rank ``decode_attention`` on the whole
    cache. Then one ``Attention.fwd_dec`` under the mesh against the same
    step on rank 0 alone, the ranks' cache slices gathered there. Writes
    this rank's numbers (JSON) to ``out`` % rank."""
    import torch.distributed as dist
    if device == "cuda":
        torch.cuda.set_device(0)
    world = dist.get_world_size()
    mesh = make_mesh(MeshLayout(("data", "model"), (1, world)), device)
    hq, hkv, d = heads
    res = {}
    for name, (b, ctx) in cases.items():
        gen = torch.Generator(device=device).manual_seed(15)
        q = torch.randn(b, hq, d, generator=gen, device=device).to(dtype)
        k, v = (torch.randn(b, ctx, hkv, d, generator=gen,
                            device=device).to(dtype) for _ in range(2))
        q_pos = torch.full((b,), ctx - 1, dtype=torch.int32, device=device)
        kv_pos = torch.arange(ctx, dtype=torch.int32,
                              device=device)[None].expand(b, ctx)
        kv_valid = torch.ones(b, ctx, dtype=torch.bool, device=device)
        kv_axes, _ = decode_layout(mesh, b, ctx)
        rows, seq = decode_cache_slices(mesh, b, ctx)
        local = (q[rows], k[rows, seq].contiguous(),
                 v[rows, seq].contiguous(), q_pos[rows], kv_pos[rows, seq],
                 kv_valid[rows, seq])
        if rank:
            del k, v
        group = mesh_group(mesh, kv_axes)
        part = decode_attention_partial(*local)
        rec = {"kv_axes": kv_axes, "slice": [seq.start, seq.stop],
               "partial_ms": _wall_ms(lambda: decode_attention_partial(
                   *local), reps, device),
               "combine_ms": _wall_ms(lambda: lse_combine(*part, group),
                                      reps, device),
               "total_ms": _wall_ms(lambda: distributed_decode_attention(
                   mesh, kv_axes, *local), reps, device)}
        got = distributed_decode_attention(mesh, kv_axes, *local)
        if rank == 0:
            ref = plain.decode_attention(q, k, v, q_pos, kv_pos, kv_valid)
            rec["row_err"] = row_err(got[rows], ref[rows])
            rec["finite"] = bool(torch.isfinite(got).all())
            rec["single_ms"] = _wall_ms(lambda: plain.decode_attention(
                q, k, v, q_pos, kv_pos, kv_valid), reps, device)
        dist.barrier()
        res[name] = rec
        del q, local, part, got
    # (c) fwd_dec of one full-width attention layer
    b, cache, positions = fwd
    gen = torch.Generator(device=device).manual_seed(16)
    attn = Attention()
    p = {w: (0.02 * torch.randn(spec.shape, generator=gen,
                                device=device)).to(dtype)
         for w, spec in attn.specs(fwd_cfg).items()}
    hkv, hd = fwd_cfg.num_kv_heads, fwd_cfg.resolved_head_dim
    x = torch.randn(b, fwd_cfg.d_model, generator=gen, device=device).to(dtype)
    k0, v0 = (torch.randn(b, cache, hkv, hd, generator=gen,
                          device=device).to(dtype) for _ in range(2))
    pos = torch.tensor(positions, dtype=torch.int32, device=device)
    kv_pos = torch.arange(cache, dtype=torch.int32,
                          device=device)[None].expand(b, cache)
    kv_valid = kv_pos <= pos[:, None]
    rows, seq = decode_cache_slices(mesh, b, cache)
    state = {"k": k0[rows, seq].clone(), "v": v0[rows, seq].clone()}
    shared = {"pos": pos, "slot": pos, "cache_len": cache,
              "kv_pos": kv_pos[rows, seq], "kv_valid": kv_valid[rows, seq]}
    t0 = time.perf_counter()
    with mesh_context(mesh):
        y, _ = attn.fwd_dec(p, x, state, shared, fwd_cfg)
    if device == "cuda":
        torch.cuda.synchronize()
    rec = {"step_ms": (time.perf_counter() - t0) * 1e3}
    # the slices in rank order make up the cache (one sequence block each)
    parts = {n: [torch.empty_like(state[n].cpu()) for _ in range(world)]
             for n in ("k", "v")}
    for n in ("k", "v"):
        dist.all_gather(parts[n], state[n].cpu())
    if rank == 0:
        one = {"k": k0.clone(), "v": v0.clone()}
        y1, _ = attn.fwd_dec(p, x, one, {"pos": pos, "slot": pos,
                                         "kv_pos": kv_pos,
                                         "kv_valid": kv_valid}, fwd_cfg)
        ar, slot = torch.arange(b), pos.long().cpu()
        rec["row_err"] = row_err(y, y1)
        rec["finite"] = bool(torch.isfinite(y).all())
        rec["cache_err"] = max(row_err(torch.cat(parts[n], dim=1),
                                       one[n].cpu()) for n in ("k", "v"))
        # every row's new K/V landed, on whichever rank holds its slot
        rec["rows_written"] = all(
            bool((torch.cat(parts[n], dim=1)[ar, slot]
                  != orig[ar, slot].cpu()).flatten(1).any(1).all())
            for n, orig in (("k", k0), ("v", v0)))
    res["fwd_dec"] = rec
    with open(out % rank, "w") as f:
        json.dump(res, f)


def phase_serve_cli():
    """15 (a): ``repro_torch.launch.serve`` with its default tenants
    (llama3-8b and h2o-danube-3-4b, scaled to 4 layers, f32) on the card;
    the CLI checks the allocator's invariants itself. Returns the launch
    counts of its run."""
    kernels.reset_launch_counts()
    eng = serve_cli.main(["--device", DEVICE])
    _sync()
    counts = kernels.launch_counts()
    gen = [len(r.generated) for r in eng.finished]
    log(f"[dist] (a) serve CLI: finished {len(eng.finished)} requests, "
        f"tokens {gen}, {eng.step_idx} steps; launches {counts}")
    if len(eng.finished) != 8 or not all(gen):
        fail(f"serve CLI: {len(eng.finished)} of 8 requests finished")
    if DEVICE == "cuda" and counts["flash_attention"] == 0:
        fail(f"serve CLI: the flash kernel never launched: {counts}")
    return counts


def phase_dist(tmp_dir: str):
    """15 (b) and (c) on ``DIST_WORLD`` ranks (``dist_rank``); reads each
    rank's numbers back, logs them and checks rank 0's errors."""
    out = os.path.join(tmp_dir, "dist_rank%d.json")
    spawn_ranks(dist_rank, DIST_WORLD, DEVICE, DIST_HEADS, DIST_CASES,
                DIST_DTYPE, DIST_REPS, DIST_FWD_CFG, DIST_FWD, out)
    recs = []
    for r in range(DIST_WORLD):
        with open(out % r) as f:
            recs.append(json.load(f))
    tol = ROW_RTOL[DIST_DTYPE]
    hq, hkv, d = DIST_HEADS
    for name, (b, ctx) in DIST_CASES.items():
        r0 = recs[0][name]
        per_rank = "; ".join(
            f"rank {i} keys {rec[name]['slice']}: partial "
            f"{rec[name]['partial_ms']:.3f} ms, combine "
            f"{rec[name]['combine_ms']:.3f} ms, distributed call "
            f"{rec[name]['total_ms']:.3f} ms" for i, rec in enumerate(recs))
        log(f"[dist] (b) {name} (B={b}, context {ctx}, Hq {hq}, Hkv {hkv}, "
            f"D {d}, {DIST_DTYPE}) over {r0['kv_axes']} on {DIST_WORLD} "
            f"ranks: row_err {r0['row_err']:.3g} (limit {tol}) against one "
            f"rank's decode_attention ({r0['single_ms']:.3f} ms); "
            f"{per_rank}")
        if not (r0["finite"] and r0["row_err"] <= tol):
            fail(f"distributed decode {name}: row_err {r0['row_err']} > "
                 f"{tol} or not finite")
    f0 = recs[0]["fwd_dec"]
    b, cache, positions = DIST_FWD
    steps = ", ".join(f"{rec['fwd_dec']['step_ms']:.3f}" for rec in recs)
    log(f"[dist] (c) fwd_dec {DIST_FWD_CFG.name} (B={b}, cache {cache}, "
        f"slots {list(positions)}) on {DIST_WORLD} ranks against one: y "
        f"row_err {f0['row_err']:.3g}, caches row_err {f0['cache_err']:.3g} "
        f"(limit {tol}), new rows written {f0['rows_written']}; step "
        f"{steps} ms per rank")
    if not (f0["finite"] and f0["row_err"] <= tol and f0["cache_err"] <= tol
            and f0["rows_written"]):
        fail(f"fwd_dec on {DIST_WORLD} ranks differs from one rank: {f0}")


def phase_distributed():
    """Phase 15: (a) the serve CLI, (b) and (c) on ranks sharing the card;
    each part's seconds logged beside the card's name and power limit.
    Returns (a)'s launch counts."""
    import tempfile
    card = _card()
    counts = Counter()
    with tempfile.TemporaryDirectory() as tmp:
        for part, run in (("a", lambda: counts.update(phase_serve_cli())),
                          ("b, c", lambda: phase_dist(tmp))):
            t0 = time.perf_counter()
            run()
            _free()
            log(f"[dist] part ({part}) took {time.perf_counter() - t0:.1f} s"
                f" on {card}")
    return counts


# --------------------------------------------------------------- phase 16
# training over a (data, model) mesh of MESH_WORLD ranks sharing the card
# over gloo: llama3-8b at full width, MESH_LAYERS of its 32 layers (1.92 B
# params), bf16, AdamW (TRAIN_OPT) with dots_saveable, a global batch of
# MESH_BATCH x MESH_SEQ tokens for MESH_STEPS steps on fresh batches; the
# same run on one rank is the reference (a)
MESH_LAYERS, MESH_SEQ, MESH_BATCH, MESH_STEPS = 4, 2048, 2, 3
MESH_WORLD, MESH_LAYOUT, MESH_MOVE = 4, (2, 2), (4, 1)
MESH_CFG = dataclasses.replace(ARCHS["llama3-8b"], num_layers=MESH_LAYERS)
# the mesh run sums the same products in other orders (TP's partial sums,
# the gradients reduced in f32 across ranks) and rounds bf16 elsewhere:
# each step's loss within 1e-2 and grad norm within 2e-2 relative of one
# rank's, every leaf after the last step within ROW_RTOL[bf16] of its row
MESH_LOSS_RTOL, MESH_GNORM_RTOL = 1e-2, 2e-2
# AdamW at lr <= 9e-5 moves a bf16 weight by less than an ulp of its row's
# largest entry, so the row check above cannot see the update: each leaf's
# update over the steps (the leaf minus its init) is also held to one
# rank's, |d - d_ref| / max(|d|, |d_ref|) in the Frobenius norm. A run
# whose update does nothing reads 1; an update step near zero gradient
# entries takes the other sign on a last-bit difference (AdamW's step is
# ~lr * sign(g)), which the limit leaves room for
MESH_UPDATE_RTOL = 0.25
# phase 17: a leaf drawn at zero or at a tenth of the normal scale (the
# biases and gates, the sLSTM recurrence, the Mamba conv) is mostly its
# update after 3 steps, so its row check reads the sign of AdamW's ~lr *
# sign(g) steps at gradient entries near zero, noise (the control run
# prints its size). Such leaves are held row by row at their gradients in
# (a), where the mesh and one rank see the same input; after the steps,
# by the update check alone
SMALL_INITS = ("zeros", "small_normal")
MESH_SEED = 16
# (d) the launcher on the world's host mesh
MESH_CLI = ["--mesh", "host", "--scaled", "--layers", "2", "--steps", "5",
            "--fixed-batch"]


def _mesh_spec() -> dict:
    """What a phase-16 rank needs (spawned ranks re-import this script,
    so the parent's settings travel as arguments)."""
    return {"device": DEVICE, "cfg": MESH_CFG, "seq": MESH_SEQ,
            "batch": MESH_BATCH, "steps": MESH_STEPS, "layout": MESH_LAYOUT,
            "move": MESH_MOVE, "seed": MESH_SEED, "cli": MESH_CLI}


def _mesh_batches(model, sp: dict, shardings=None):
    shape = ShapeConfig("mesh", sp["seq"], sp["batch"], "train")
    return [batch_for_step(model, shape, 0, s, device=sp["device"],
                           shardings=shardings) for s in range(sp["steps"])]


def mesh_reference(ref_dir: str) -> tuple:
    """(a) One rank: the steps of the mesh run on the whole batch; the
    losses, grad norms and step times returned, the final leaves written
    to ``ref_dir`` (a checkpoint: on the host, the card freed). Returns
    (records, launch counts)."""
    sp = _mesh_spec()
    _reset_peak()
    model, params = _init(sp["cfg"], sp["seed"], "mesh-ref",
                          f"d_ff {sp['cfg'].d_ff}, ")
    batches = _mesh_batches(model, sp)
    recs, counts, _ = train_run("mesh-ref", model, params, batches)
    log(f"[mesh-ref] peak memory {_peak() / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    checkpoint.save(ref_dir, sp["steps"], params)
    log(f"[mesh-ref] final leaves written in {time.perf_counter() - t0:.1f} "
        f"s")
    del params, model, batches
    _free()
    return recs, counts


def _ref_leaves(ref_dir: str, step: int):
    """(key, the reference leaf) of each leaf of the checkpoint."""
    from repro_torch.training.checkpoint import _read_leaf
    path = os.path.join(ref_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    for meta in leaves:
        yield meta["key"], _read_leaf(os.path.join(path, meta["file"]),
                                      meta["dtype"])


def mesh_rank(rank: int, sp: dict, ref_dir: str, tmp: str, out: str) -> None:
    """One rank of phase 16 (under ``spawn_ranks``): (b) the steps on the
    ``sp["layout"]`` host mesh, each timed by CUDA events around a
    synchronised step; then every leaf gathered and held (on rank 0) to
    the reference's row by row; (c) the train state moved to the
    ``sp["move"]`` mesh and back with ``elastic_reshard``, the params saved
    from the mesh and restored onto the moved mesh, each against the
    blocks it must equal; (d) the launcher on the world's host mesh. Writes
    this rank's numbers (JSON) to ``out`` % rank."""
    import contextlib
    import io
    import torch.distributed as dist
    from repro_torch.distributed import collectives, elastic_reshard
    from repro_torch.distributed.sharding import gather_full
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.shardings import batch_shardings, opt_shardings
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.checkpoint import _paths
    dev = sp["device"]
    if dev == "cuda":
        # four ranks share the card: segments that grow keep each rank's
        # freed blocks reusable at other sizes
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank} finds no CUDA device")
        torch.cuda.set_device(0)
        torch.cuda.reset_peak_memory_stats()
    global DEVICE
    DEVICE = dev
    mesh = make_mesh(MeshLayout(("data", "model"), sp["layout"]), dev)
    model = build_model(sp["cfg"])
    res = {"rank": rank, "coords": list(mesh.get_coordinate())}
    with mesh_context(mesh):
        ps = model.param_shardings(mesh)
        bs = batch_shardings(model, ShapeConfig(
            "mesh", sp["seq"], sp["batch"], "train"), mesh)
        params = model.init(torch.Generator(device=dev).manual_seed(
            sp["seed"]), dev, mesh)
        batches = _mesh_batches(model, sp, bs)
        # the init on the host, to hold each leaf's update to one rank's
        init = tree_map(lambda t: t.to("cpu", copy=True), params)
        opt, marks, grad_max = instrument_step(
            model, make_optimizer(OptimizerConfig(**TRAIN_OPT)))
        state = opt.init(params, ps)
        step = make_train_step(model, opt, remat_policy=TRAIN_REMAT)
        kernels.reset_launch_counts()
        recs = []
        for batch in batches:
            _sync()
            dist.barrier()
            collectives.reset_counts()
            t0, start = time.perf_counter(), _mark()
            params, state, m = step(params, state, batch)
            end = _mark()
            _sync()
            recs.append({"loss": m["loss"].item(),
                         "grad_norm": m["grad_norm"].item(),
                         "step_ms": _between(start, end),
                         "wall_ms": (time.perf_counter() - t0) * 1e3,
                         "collectives": collectives.counts()})
        res["launches"] = kernels.launch_counts()
    for rec, mk, gm in zip(recs, marks, grad_max):
        rec["fwd_ms"] = _between(mk[0], mk[1])
        rec["bwd_ms"] = _between(mk[1], mk[2])
        rec["opt_ms"] = _between(mk[2], mk[3])
        rec["zero_grad_leaves"] = int((gm == 0).sum())
    res["steps"] = recs
    res["peak_gib"] = _peak() / 2**30
    del batches
    # every leaf whole against the reference's, row by row, and its update
    # against the reference's update
    t0 = time.perf_counter()
    ref = dict(_ref_leaves(ref_dir, sp["steps"])) if rank == 0 else {}
    worst, worst_upd = (0.0, ""), (0.0, "")
    for (key, leaf), (_, sh), (_, leaf0) in zip(_paths(params), _paths(ps),
                                                _paths(init)):
        full = gather_full(leaf, sh.spec, mesh)
        full0 = gather_full(leaf0.to(dev), sh.spec, mesh)
        if rank == 0:
            want = ref.pop(key).to(full.device)
            worst = max(worst, (row_err(full, want), key))
            worst_upd = max(worst_upd, (update_err(full, want, full0), key))
            del want
        del full, full0
    res["leaf_row_err"] = list(worst)
    res["leaf_update_err"] = list(worst_upd)
    res["compare_s"] = time.perf_counter() - t0
    del ref, init
    # (c) the params saved from the mesh; the train state moved to the
    # other mesh part by part, each part's original kept on the host and
    # freed on the card (4 ranks share it); the checkpoint restored onto
    # the moved mesh must equal the moved params (that holds the move's
    # layout to the checkpoint's whole leaves), the state moved back must
    # equal the original
    _free()
    t0 = time.perf_counter()
    ckpt.save(tmp, 1, params, shardings=ps)
    res["save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    moved_mesh = make_mesh(MeshLayout(("data", "model"), sp["move"]), dev)
    ps2 = model.param_shardings(moved_mesh)
    tree = {"params": params, "mu": state["mu"], "nu": state["nu"]}
    sh_from = {"params": ps, "mu": ps, "nu": ps}
    sh_to = {"params": ps2, "mu": ps2, "nu": ps2}
    del params, state, m
    host, moved = {}, {}
    for part in list(tree):
        host[part] = tree_map(lambda t: t.cpu(), tree[part])
        moved[part] = elastic_reshard(tree.pop(part), sh_from[part],
                                      sh_to[part])
        _free()
    res["moved_blocks"] = [list(x.shape)
                           for x in tree_leaves(moved["params"])][:4]
    res["reshard_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored, _ = ckpt.restore(tmp, 1, moved["params"], shardings=ps2)
    res["restore_s"] = time.perf_counter() - t0
    res["restore_diff"] = max(
        (a - b).abs().max().item()
        for a, b in zip(tree_leaves(restored), tree_leaves(moved["params"])))
    del restored
    diff = 0.0
    for part in list(moved):
        back = elastic_reshard(moved.pop(part), sh_to[part], sh_from[part])
        diff = max([diff] + [(a.cpu() - b).abs().max().item() for a, b in
                             zip(tree_leaves(back), tree_leaves(host[part]))])
        del back
        _free()
    res["reshard_back_diff"] = diff
    del host
    # (d) the launcher on the world's host mesh
    kernels.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        train_cli.main(sp["cli"] + ["--device", dev])
    res["cli_s"] = time.perf_counter() - t0
    res["cli_out"] = buf.getvalue()
    res["cli_launches"] = kernels.launch_counts()
    with open(out % rank, "w") as f:
        json.dump(res, f)


def phase_mesh_train(shape_rows):
    """Phase 16: (a) one rank, (b)-(d) on ``MESH_WORLD`` ranks sharing the
    card (``mesh_rank``); the checks, and flash at a rank's shape (shape
    row 3i). Returns the launch counts of (a) and of every rank's (b) and
    (d)."""
    import tempfile
    card = _card()
    sp = _mesh_spec()
    cfg = sp["cfg"]
    counts = Counter()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ref_recs, c = mesh_reference(os.path.join(tmp, "ref"))
        counts.update(c)
        log(f"[mesh] part (a) took {time.perf_counter() - t0:.1f} s on "
            f"{card}")
        t0 = time.perf_counter()
        out = os.path.join(tmp, "mesh_rank%d.json")
        spawn_ranks(mesh_rank, MESH_WORLD, sp, os.path.join(tmp, "ref"),
                    os.path.join(tmp, "ckpt"), out)
        recs = []
        for r in range(MESH_WORLD):
            with open(out % r) as f:
                recs.append(json.load(f))
        log(f"[mesh] parts (b)-(d) on {MESH_WORLD} ranks took "
            f"{time.perf_counter() - t0:.1f} s on {card}")
    r0 = recs[0]
    for i, (ref, got) in enumerate(zip(ref_recs, r0["steps"])):
        le = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
        ge = abs(got["grad_norm"] - ref["grad_norm"]) / abs(ref["grad_norm"])
        log(f"[mesh] (b) step {i}: loss {got['loss']:.5f} vs one rank's "
            f"{ref['loss']:.5f} (rel err {le:.3g}, limit {MESH_LOSS_RTOL}); "
            f"grad norm {got['grad_norm']:.5f} vs {ref['grad_norm']:.5f} "
            f"(rel err {ge:.3g}, limit {MESH_GNORM_RTOL}); rank 0 step "
            f"{got['step_ms']:.1f} ms (CUDA events; forward "
            f"{got['fwd_ms']:.1f}, backward {got['bwd_ms']:.1f}, optimizer "
            f"{got['opt_ms']:.1f}), wall {got['wall_ms']:.1f} ms; one rank "
            f"{ref['wall_ms']:.1f} ms")
        if not (le <= MESH_LOSS_RTOL and ge <= MESH_GNORM_RTOL):
            fail(f"mesh train step {i}: loss or grad norm off one rank's: "
                 f"{got['loss']} vs {ref['loss']}, {got['grad_norm']} vs "
                 f"{ref['grad_norm']}")
    bad = [(rec["rank"], i) for rec in recs
           for i, s in enumerate(rec["steps"])
           if not (np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]))
           or s["zero_grad_leaves"]]
    if bad:
        fail(f"mesh train: a non-finite loss or norm, or a leaf whose "
             f"local gradient is all zero (rank, step): {bad}")
    last = r0["steps"][-1]["collectives"]
    log(f"[mesh] (b) {cfg.name} {cfg.num_layers} layers on a "
        f"{MESH_LAYOUT} (data, model) mesh of {MESH_WORLD} ranks, global "
        f"batch {MESH_BATCH} x {MESH_SEQ}: collectives of rank 0's last "
        f"step (calls, MB): " + ", ".join(
            f"{k} {v['calls']} {v['bytes'] / 1e6:.1f}"
            for k, v in sorted(last.items()))
        + f"; {sum(v['bytes'] for v in last.values()) / 1e9:.3f} GB in all")
    log(f"[mesh] (b) peak memory per rank (GiB): " + ", ".join(
        f"{rec['peak_gib']:.2f}" for rec in recs)
        + "; step ms per rank (last step, CUDA events): " + ", ".join(
            f"{rec['steps'][-1]['step_ms']:.1f}" for rec in recs))
    err, key = r0["leaf_row_err"]
    tol = ROW_RTOL[torch.bfloat16]
    uerr, ukey = r0["leaf_update_err"]
    log(f"[mesh] (b) leaves after step {MESH_STEPS} against one rank's: "
        f"worst row_err {err:.3g} at {key} (limit {tol}); worst update "
        f"error {uerr:.3g} at {ukey} (limit {MESH_UPDATE_RTOL}; no update "
        f"reads 1); compared in {r0['compare_s']:.1f} s")
    if not err <= tol:
        fail(f"mesh train: leaf {key} row_err {err} > {tol}")
    if not uerr <= MESH_UPDATE_RTOL:
        fail(f"mesh train: leaf {ukey}'s update off one rank's: {uerr} > "
             f"{MESH_UPDATE_RTOL}")
    for rec in recs:
        if not (rec["reshard_back_diff"] == 0.0
                and rec["restore_diff"] == 0.0):
            fail(f"mesh state move on rank {rec['rank']}: back "
                 f"{rec['reshard_back_diff']}, restore "
                 f"{rec['restore_diff']}")
    log(f"[mesh] (c) elastic_reshard {MESH_LAYOUT} -> {MESH_MOVE} of the "
        f"params and AdamW moments (rank 0's first blocks "
        f"{r0['moved_blocks']}; {r0['reshard_s']:.1f} s) and back: diff 0 "
        f"on every rank; params saved from the mesh in {r0['save_s']:.1f} "
        f"s, restored onto {MESH_MOVE} in {r0['restore_s']:.1f} s: diff 0 "
        f"from the moved params")
    losses = [float(line.split()[3]) for line in r0["cli_out"].splitlines()
              if line.startswith("step")]
    log(f"[mesh] (d) launch.train {' '.join(MESH_CLI)} on {MESH_WORLD} "
        f"ranks: losses {losses} ({r0['cli_s']:.1f} s)")
    if len(losses) < 2 or not losses[-1] < losses[0] or any(
            rec["cli_out"] for rec in recs[1:]):
        fail(f"mesh launcher: losses {losses}, or a rank but 0 printed")
    for rec in recs:
        counts.update(rec["launches"])
        counts.update(rec["cli_launches"])
        if DEVICE == "cuda" and not (rec["launches"].get("flash_attention")
                                     and rec["cli_launches"].get(
                                         "flash_attention")):
            fail(f"mesh train: flash never launched on rank {rec['rank']}: "
                 f"{rec['launches']} {rec['cli_launches']}")
    log(f"[mesh] flash launches per rank, (b) and (d): " + ", ".join(
        f"{rec['launches'].get('flash_attention', 0)} + "
        f"{rec['cli_launches'].get('flash_attention', 0)}" for rec in recs))
    if DEVICE == "cuda":
        hq = cfg.num_heads // MESH_LAYOUT[1]
        hkv = cfg.num_kv_heads // MESH_LAYOUT[1]
        time_train_flash(torch.Generator(device=DEVICE).manual_seed(17),
                         shape_rows, "mesh", (MESH_SEQ, hq, hkv,
                                              cfg.resolved_head_dim),
                         f"mesh rank llama3-8b B=1 S={MESH_SEQ} Hq {hq} "
                         f"Hkv {hkv} causal, lse")
        _free()
    return counts


# --------------------------------------------------------------- phase 17
# training of the MoE and SSM stacks over phase 16's (2, 2) mesh of
# MESH_WORLD ranks sharing the card (gloo), at full width, bf16, AdamW
# (TRAIN_OPT), MESH_STEPS steps on fresh batches against the same run on
# one rank. name -> (config cut in depth, global batch, tokens a row,
# remat): moonshot-v1-16b-a3b at 2 of 48 layers (1.81 B params; each data
# rank's 2048 tokens route as a group of their own, the JAX block's g = 2);
# jamba-v0.1-52b's layer 0 (Mamba and a dense FFN; 0.81 B: a cut with an
# MoE layer adds 2.82 B params a layer and does not fit 4 ranks and a
# one-rank reference on one card); xlstm-1.3b at 8 of 48 layers (7 mLSTM
# and its sLSTM; 0.35 B), no remat (phase 14's (c): nested checkpoints run
# the sLSTM loop up to four times a step)
MOE_SSM_RUNS = {
    "moonshot": (dataclasses.replace(ARCHS["moonshot-v1-16b-a3b"],
                                     num_layers=2), 2, 2048, TRAIN_REMAT),
    "jamba": (dataclasses.replace(ARCHS["jamba-v0.1-52b"], num_layers=1),
              2, 2048, TRAIN_REMAT),
    "xlstm": (dataclasses.replace(ARCHS["xlstm-1.3b"], num_layers=8), 2,
              512, "none"),
}
# (a)'s MoE drop pattern also at a decode-scale batch: 2 x 32 tokens
# (64 x 6 <= 8 x 64 experts: one group over both data ranks, through the
# count exchange)
MOE_DECODE_BATCH = (2, 32)
MOE_SSM_SEED = 18


def _moe_ssm_spec() -> dict:
    """What a phase-17 rank needs (the parent's settings travel as
    arguments)."""
    return {"device": DEVICE, "runs": MOE_SSM_RUNS, "steps": MESH_STEPS,
            "layout": MESH_LAYOUT, "seed": MOE_SSM_SEED,
            "decode_batch": MOE_DECODE_BATCH, "tag": "moe-ssm"}


# phase 18: enc-dec and VLM training on phase 16's (2, 2) mesh of
# MESH_WORLD ranks against one rank, at full width, bf16, AdamW (TRAIN_OPT)
# with dots_saveable, MESH_STEPS steps: whisper-medium cut to 4 + 4 of its
# 24 + 24 layers (0.26 B params), a global batch of 2 of train_4k's rows
# (4096 frames, split over "model" as the input spec's "seq_cp" places
# them, and 448 decoder tokens; its odd vocabulary of 51865 stays whole);
# llava-next-34b cut to 1 of its 60 layers (1.48 B), 2 x 4096 positions
# (2880 patch rows and 1216 tokens)
ENCDEC_VLM_RUNS = {
    "whisper": (dataclasses.replace(ARCHS["whisper-medium"], num_layers=4,
                                    num_encoder_layers=4), 2, 4096,
                TRAIN_REMAT),
    "llava": (dataclasses.replace(ARCHS["llava-next-34b"], num_layers=1), 2,
              4096, TRAIN_REMAT),
}
ENCDEC_VLM_SEED = 19


def _encdec_vlm_spec() -> dict:
    """What a phase-18 rank needs."""
    return {"device": DEVICE, "runs": ENCDEC_VLM_RUNS, "steps": MESH_STEPS,
            "layout": MESH_LAYOUT, "seed": ENCDEC_VLM_SEED,
            "tag": "encdec-vlm"}


def _moe_groups(cfg, tokens: int, shards: int) -> int:
    """The JAX MoE block's group count of ``tokens`` on ``shards`` data
    shards: 1 where t * k <= 8 E, else gcd(t, shards)."""
    m = cfg.moe
    if tokens * m.top_k <= 8 * m.num_experts:
        return 1
    return math.gcd(tokens, shards)


def _layer_checks(name: str, model, sp: dict):
    """(a)'s layer checks of run ``name``: (tag, pattern position, batch,
    tokens a row). The MoE at the training batch and at the decode-scale
    one; the Mamba layer; an mLSTM and the sLSTM layer; an enc-dec's
    encoder layer and its decoder layer over it; a VLM's layer."""
    _, b, s, _ = sp["runs"][name]
    if model.cfg.is_encoder_decoder:
        return [("encoder", 0, b, s), ("decoder", 0, b, s)]
    if model.cfg.num_image_patches:
        return [("layer", 0, b, s)]
    out = []
    for pos, ld in enumerate(model.impl.pattern):
        if ld.ffn == "moe" and pos == 0:
            out += [("moe_train", pos, b, s),
                    ("moe_decode", pos) + tuple(sp["decode_batch"])]
        if ld.mixer in ("mamba", "slstm") or (ld.mixer == "mlstm"
                                              and pos == 0):
            out.append((ld.mixer, pos, b, s))
    return out


# phase 18's layer checks: the parameters each one differentiates
STACK_CHECKS = {"encoder": ("encoder", "enc_norm"),
                "decoder": ("encoder", "enc_norm", "blocks"),
                "layer": ("blocks",)}


def _stack_check(cfg, params, check, sp: dict, mesh=None, shardings=None):
    """A phase-18 layer check, on one rank or, with ``mesh``, on the rank's
    blocks of the weights and of the inputs (one body): the model's own
    code cut to depth 1 (whisper's encoder layer 0 alone, or feeding its
    decoder layer 0, whose encoder leaves the output reaches only through
    cross-attention; llava's layer) forward and backward under an output
    gradient ``dy`` seeded as the inputs, in f32 (the weights widened;
    the kernels run their f32 paths): in bf16 one rank's own rounding
    moves these gradients, two layers deep, by 0.03-0.04 of their rows
    from f32's, above the 2e-2 limit, so a bf16 check could not tell a
    fault from rounding. Returns the output, the gradient of every leaf of
    ``STACK_CHECKS[tag]`` (keyed by path), both whole (on the mesh the
    gradients summed over the data axes that do not split the leaf, then
    gathered) on the device, and the check's collectives."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed.collectives import gather_over, sum_over
    from repro_torch.distributed.sharding import (
        batch_axis_names, gather_full, local_shard,
    )
    from repro_torch.launch.shardings import batch_shardings
    from repro_torch.models.registry import WHISPER_DECODER_LEN
    from repro_torch.training.checkpoint import _paths
    tag, _, b, s = check
    dev, seed = sp["device"], sp["seed"]
    cfg = dataclasses.replace(
        cfg, num_layers=1, num_encoder_layers=min(cfg.num_encoder_layers, 1),
        dtype="float32")
    cut = build_model(cfg)
    names = STACK_CHECKS[tag]
    tree = {k: tree_map(lambda t: (t[:1] if k in ("encoder", "blocks")
                                   else t).detach().float()
                        .requires_grad_(),
                        params[k]) for k in names}
    keys, leaves = zip(*_paths(tree))
    data = () if mesh is None else batch_axis_names(mesh)
    bs = None if mesh is None else batch_shardings(
        cut, ShapeConfig("check", s, b, "train"), mesh)

    def rows(x):
        """This data rank's rows of the whole input ``x``."""
        return x if mesh is None else local_shard(x, bs["mask"].spec, mesh)
    collectives.reset_counts()
    with torch.enable_grad():
        if cfg.is_encoder_decoder:
            frames = _layer_input(cfg, seed, f"{tag} frames", b, s, dev)
            axes = ()
            if mesh is not None:
                frames = local_shard(frames, bs["frames"].spec, mesh)
                axes = bs["frames"].axes(1)
            y = cut.impl.encode(tree, frames, mesh, axes)
            if tag == "decoder":
                x = rows(_layer_input(cfg, seed, f"{tag} x", b,
                                      min(WHISPER_DECODER_LEN, s), dev))
                y, _ = cut.impl.dec_seq(tree, x, y, mesh=mesh)
        else:
            x = rows(_layer_input(cfg, seed, tag, b, s, dev))
            positions = torch.arange(s, device=dev)[None].expand(
                x.shape[0], s)
            y, _, _ = cut.impl.fwd_seq(tree, x, {"positions": positions,
                                                 "mesh": mesh})
        dy = rows(_layer_input(cfg, seed, f"{tag} dy", b, y.shape[1], dev))
        grads = torch.autograd.grad((y.float() * dy.float()).sum(), leaves)
    out = {"collectives": {k: v for k, v in collectives.counts().items()
                           if k != "check"}}
    y = y.detach()
    if mesh is not None:
        sh = [x for _, x in _paths({k: shardings[k] for k in names})]
        grads = [gather_full(sum_over(
            g, mesh, [ax for ax in data if ax not in h.split_axes()],
            "check"), h.spec, mesh) for g, h in zip(grads, sh)]
        y = gather_over(y, mesh, data, "check").reshape(
            (b,) + y.shape[1:])
    out.update(y=y, grads=dict(zip(keys, grads)))
    return out


def _layer_input(cfg, seed: int, tag: str, b: int, s: int, dev):
    """The layer check's input [b, s, d] (bf16), the same on every rank
    and on one rank: a generator seeded by the run's seed and the tag."""
    gen = torch.Generator(device=dev).manual_seed(
        seed * 1000 + sum(map(ord, tag)))
    return torch.randn(b, s, cfg.d_model, generator=gen, device=dev,
                       dtype=torch.float32).to(dtype_of(cfg))


def _layer_ref(cfg, model, params, check, seed: int, shards: int) -> dict:
    """One rank's result of a layer check: a mixer's output and the
    gradients of its leaves under the output gradient ``dy`` (seeded as the
    input), or the MoE's
    output with each group's route (the JAX block's groups of the mesh's
    ``shards`` data shards, ``route`` on each group's tokens), its slot,
    disp (tokens in the global numbering) and drops, and the drops of one
    group over every token."""
    if check[0] in STACK_CHECKS:
        got = _stack_check(cfg, params, check, {"device": DEVICE,
                                                "seed": seed})
        return {"y": got["y"].cpu(),
                "grads": {k: g.cpu() for k, g in got["grads"].items()}}
    tag, pos, b, s = check
    x = _layer_input(cfg, seed, tag, b, s, DEVICE)
    ld = model.impl.pattern[pos]
    with torch.no_grad():
        if not tag.startswith("moe"):
            p = {k: v.detach().requires_grad_()
                 for k, v in _layer(params, pos, "mixer").items()}
            positions = torch.arange(s, device=DEVICE)[None].expand(b, s)
            with torch.enable_grad():
                y, _ = MIXERS[ld.mixer].fwd_seq(
                    p, x, {"positions": positions}, cfg)
                dy = _layer_input(cfg, seed, f"{tag} dy", b, s, DEVICE)
                grads = torch.autograd.grad((y.float() * dy.float()).sum(),
                                            list(p.values()))
            return {"y": y.detach().cpu(),
                    "grads": {k: g.cpu() for k, g in zip(p, grads)}}
        p = _layer(params, pos, "ffn")
        moe = MoE()
        xf = x.reshape(b * s, -1)
        t = b * s
        g = _moe_groups(cfg, t, shards)
        tg = t // g
        slots, disps, ys, drops = [], [], [], 0
        for i in range(g):
            xg = xf[i * tg:(i + 1) * tg]
            _, _, disp, _, slot, cap = moe.route(p, xg, cfg)
            slots.append(slot)
            disps.append(torch.where(disp < tg, disp + i * tg, t))
            drops += int((slot == cfg.moe.num_experts * cap).sum())
            ys.append(moe.forward(p, xg, cfg)[0])
        one = moe.route(p, xf, cfg)
        return {"y": torch.cat(ys).view(b, s, -1).cpu(), "groups": g,
                "slot": torch.cat(slots).cpu(),
                "disp": torch.stack(disps).cpu(), "drops": drops,
                "drops_one_group": int(
                    (one[4] == cfg.moe.num_experts * one[5]).sum())}


def _moe_step0_drops(cfg, model, params, batch, shards: int):
    """(assignments, dropped in the mesh's groups, dropped in one group of
    every token) of the first MoE layer at the first step's input: its
    parameters and input recorded from one no-grad ``train_loss`` of the
    model itself (the MoE's ``forward`` wrapped on the instance the LM
    calls)."""
    from repro_torch.models import lm
    first = []

    def record(p, x, cfg_, mesh=None):
        if not first:
            first.append((p, x.reshape(-1, x.shape[-1])))
        return MoE.forward(lm._MOE, p, x, cfg_, mesh)
    lm._MOE.forward = record
    try:
        with torch.no_grad():
            model.train_loss(params, batch)
    finally:
        del lm._MOE.forward
    (p, xf), moe = first[0], MoE()
    t = xf.shape[0]
    g = _moe_groups(cfg, t, shards)

    def drops(groups):
        n = 0
        with torch.no_grad():
            for i in range(groups):
                part = xf[i * t // groups:(i + 1) * t // groups]
                _, _, _, _, slot, cap = moe.route(p, part, cfg)
                n += int((slot == cfg.moe.num_experts * cap).sum())
        return n
    return t * cfg.moe.top_k, drops(g), drops(1)


def _control(name, cfg, sp, ref_dir, batches, remat) -> None:
    """The noise of (b)'s leaf row checks: the run's steps again on one
    rank with every weight scaled by 1 +- 2^-8 (random signs; a bf16 weight
    moves by about one unit in its last place, as the mesh's other
    rounding moves its activations), its leaves held to the reference's
    by ``row_err``; printed."""
    from repro_torch.training.checkpoint import _paths
    model, params = _init(cfg, sp["seed"], f"{sp['tag']}-ctl {name}", "")
    gen = torch.Generator(device=DEVICE).manual_seed(sp["seed"] + 1)
    for leaf in tree_leaves(params):
        sign = torch.randint(0, 2, leaf.shape, generator=gen,
                             device=DEVICE) * 2 - 1
        leaf.copy_(leaf.float() * (1 + sign * 2.0 ** -8))
    train_run(f"{sp['tag']}-ctl {name}", model, params, batches, remat=remat)
    ref = dict(_ref_leaves(os.path.join(ref_dir, name), sp["steps"]))
    worst = {False: (0.0, ""), True: (0.0, "")}
    for (key, leaf), (_, spec) in zip(_paths(params), _paths(model.specs())):
        small = spec.init in SMALL_INITS
        worst[small] = max(worst[small], (row_err(
            leaf, ref.pop(key).to(leaf.device)), key))
    log(f"[{sp['tag']}] (b) {name} control, one rank with its weights moved by "
        f"a bf16 last bit against one rank, after step {sp['steps']}: "
        f"worst row_err {worst[False][0]:.3g} at {worst[False][1]}; the "
        f"leaves drawn at zero or a tenth of the scale {worst[True][0]:.3g} "
        f"at {worst[True][1] or 'none'}")
    del params, model, ref
    _free()


def moe_ssm_reference(name: str, ref_dir: str, sp: dict) -> tuple:
    """(a) and (b) of run ``name`` on one rank: the layer checks' results
    (saved to ``ref_dir``/name_layers.pt), then the steps; the final leaves
    written to ``ref_dir``/name (a checkpoint: on the host, the card
    freed); then ``_control``. Returns (records, launch counts, layer
    results)."""
    cfg, b, s, remat = sp["runs"][name]
    _reset_peak()
    tag = f"{sp['tag']}-ref {name}"
    model, params = _init(cfg, sp["seed"], tag,
                          f"d_ff {cfg.d_ff}, ")
    layers = {check[0]: _layer_ref(cfg, model, params, check, sp["seed"],
                                   sp["layout"][0])
              for check in _layer_checks(name, model, sp)}
    torch.save(layers, os.path.join(ref_dir, f"{name}_layers.pt"))
    batches = _mesh_batches(model, {"device": DEVICE, "seq": s, "batch": b,
                                    "steps": sp["steps"]})
    if cfg.moe is not None and any(ld.ffn == "moe"
                                   for ld in model.impl.pattern):
        n, mesh_drops, one_drops = _moe_step0_drops(
            cfg, model, params, batches[0], sp["layout"][0])
        log(f"[{tag}] step 0's first MoE layer: of {n} "
            f"assignments the mesh's groups drop {mesh_drops}, one group of "
            f"all {b * s} tokens (one rank's) {one_drops}")
    recs, counts, _ = train_run(tag, model, params,
                                batches, remat=remat)
    log(f"[{tag}] peak memory {_peak() / 2**30:.2f} GiB")
    checkpoint.save(os.path.join(ref_dir, name), sp["steps"], params)
    del params, model
    _free()
    _control(name, cfg, sp, ref_dir, batches, remat)
    del batches
    return recs, counts, layers


def _mesh_layer(cfg, model, params, ps, check, sp, mesh, ref):
    """A layer check on the mesh, on this data rank's rows: the output
    (gathered over the data axis); for a mixer the gradients of its leaves
    (``ps``: the params' shardings) under the same ``dy`` as one rank's,
    summed over the data axes that do not split the leaf and gathered
    whole; for the MoE, slot and disp (tokens in the global numbering, T
    where another rank's token sits), each gathered over the data axis.
    Rank 0 holds them to ``ref``. Returns this check's numbers and its
    collectives."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed.collectives import gather_over, sum_over
    from repro_torch.distributed.sharding import (
        batch_axis_names, gather_full, mesh_index,
    )
    from repro_torch.models.blocks import _gathered
    if check[0] in STACK_CHECKS:
        got = _stack_check(cfg, params, check, sp, mesh, ps)
        res = {"collectives": got["collectives"]}
        if ref is not None:
            res["row_err"] = row_err(got["y"], ref["y"].to(got["y"].device))
            res["grad_row_err"] = {
                k: row_err(g, ref["grads"][k].to(g.device))
                for k, g in got["grads"].items()}
        return res
    tag, pos, b, s = check
    dev = sp["device"]
    data = mesh_index(mesh, ("data",))
    rows = b // sp["layout"][0]
    x = _layer_input(cfg, sp["seed"], tag, b, s, dev)[
        data * rows:(data + 1) * rows]
    ld = model.impl.pattern[pos]
    res = {}
    collectives.reset_counts()
    with torch.no_grad():
        if tag.startswith("moe"):
            p = _layer(params, pos, "ffn")
            moe = MoE()
            xf = x.reshape(rows * s, -1)
            w, _ = _gathered(moe, p, cfg, mesh)
            _, _, disp, _, slot, cap = moe.route(w, xf, cfg, mesh)
            t_l = rows * s
            gdisp = torch.where(disp < t_l, disp + data * t_l, b * s)
            y = moe.forward(p, x, cfg, mesh)[0]
            slot = gather_over(slot, mesh, ("data",), "check")
            gdisp = gather_over(gdisp, mesh, ("data",), "check")
        else:
            p = {k: v.detach().requires_grad_()
                 for k, v in _layer(params, pos, "mixer").items()}
            positions = torch.arange(s, device=dev)[None].expand(rows, s)
            with torch.enable_grad():
                y, _ = MIXERS[ld.mixer].fwd_seq(
                    p, x, {"positions": positions, "mesh": mesh}, cfg)
                dy = _layer_input(cfg, sp["seed"], f"{tag} dy", b, s, dev)[
                    data * rows:(data + 1) * rows]
                grads = torch.autograd.grad((y.float() * dy.float()).sum(),
                                            list(p.values()))
            y = y.detach()
        res["collectives"] = {k: v for k, v in collectives.counts().items()
                              if k != "check"}
        if not tag.startswith("moe"):
            full = {}
            for (k, g), sh in zip(zip(p, grads),
                                  ps["blocks"][pos]["mixer"].values()):
                # the stacked leaf's spec without its repeat dim
                g = sum_over(g, mesh, [ax for ax in batch_axis_names(mesh)
                                       if ax not in sh.split_axes()],
                             "check")
                full[k] = gather_full(g, sh.spec[1:], mesh)
        y = gather_over(y, mesh, ("data",), "check").reshape(b, s, -1)
    if ref is not None:
        res["row_err"] = row_err(y, ref["y"].to(y.device))
        if not tag.startswith("moe"):
            res["grad_row_err"] = {k: row_err(full[k], g.to(dev))
                                   for k, g in ref["grads"].items()}
        else:
            g = ref["groups"]
            want_disp = ref["disp"].to(gdisp.device)
            # each group's disp merged over the ranks that share it (groups
            # of another capacity differ in length)
            same = gdisp.shape[0] % g == 0 and \
                gdisp.shape[-1] == want_disp.shape[-1]
            res["slot_equal"] = bool(torch.equal(
                slot.reshape(-1, cfg.moe.top_k), ref["slot"].to(dev)))
            res["disp_equal"] = same and bool(torch.equal(
                gdisp.reshape(g, -1, gdisp.shape[-1]).amin(1), want_disp))
            res["groups"], res["cap"] = g, cap
            res["drops"] = ref["drops"]
            res["drops_one_group"] = ref["drops_one_group"]
    return res


def moe_ssm_rank(rank: int, sp: dict, ref_dir: str, out: str) -> None:
    """One rank of phase 17 (under ``spawn_ranks``), for each run: (a) the
    layer checks on the mesh against one rank's (``_mesh_layer``); (b)
    the steps on the ``sp["layout"]`` host mesh, each timed by CUDA events
    around a synchronised step (forward, backward, optimizer), its
    collectives by kind, then every leaf gathered and held (on rank 0) to
    the reference's row by row and by its update; (c) peak memory and the
    kernels' launches of (b). Writes this rank's numbers (JSON) to
    ``out`` % rank."""
    import torch.distributed as dist
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import gather_full
    from repro_torch.launch.shardings import batch_shardings
    from repro_torch.training.checkpoint import _paths
    dev = sp["device"]
    if dev == "cuda":
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank} finds no CUDA device")
        torch.cuda.set_device(0)
    global DEVICE
    DEVICE = dev
    mesh = make_mesh(MeshLayout(("data", "model"), sp["layout"]), dev)
    res = {"rank": rank, "coords": list(mesh.get_coordinate()), "runs": {}}
    for name, (cfg, b, s, remat) in sp["runs"].items():
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = {}
        model = build_model(cfg)
        refs = torch.load(os.path.join(ref_dir, f"{name}_layers.pt")) \
            if rank == 0 else {}
        with mesh_context(mesh):
            ps = model.param_shardings(mesh)
            params = model.init(torch.Generator(device=dev).manual_seed(
                sp["seed"]), dev, mesh)
            run["layers"] = {
                check[0]: _mesh_layer(cfg, model, params, ps, check, sp,
                                      mesh, refs.get(check[0]))
                for check in _layer_checks(name, model, sp)}
            del refs
            bs = batch_shardings(model, ShapeConfig("mesh", s, b, "train"),
                                 mesh)
            batches = _mesh_batches(model, {"device": dev, "seq": s,
                                            "batch": b,
                                            "steps": sp["steps"]}, bs)
            init = tree_map(lambda t: t.to("cpu", copy=True), params)
            opt, marks, grad_max = instrument_step(
                model, make_optimizer(OptimizerConfig(**TRAIN_OPT)))
            state = opt.init(params, ps)
            step = make_train_step(model, opt, remat_policy=remat,
                                   batch_shardings=bs)
            kernels.reset_launch_counts()
            recs = []
            for batch in batches:
                _sync()
                dist.barrier()
                collectives.reset_counts()
                t1, start = time.perf_counter(), _mark()
                params, state, m = step(params, state, batch)
                end = _mark()
                _sync()
                recs.append({"loss": m["loss"].item(),
                             "grad_norm": m["grad_norm"].item(),
                             "step_ms": _between(start, end),
                             "wall_ms": (time.perf_counter() - t1) * 1e3,
                             "collectives": collectives.counts()})
            run["launches"] = kernels.launch_counts()
        for rec, mk, gm in zip(recs, marks, grad_max):
            rec["fwd_ms"] = _between(mk[0], mk[1])
            rec["bwd_ms"] = _between(mk[1], mk[2])
            rec["opt_ms"] = _between(mk[2], mk[3])
            rec["zero_grad_leaves"] = int((gm == 0).sum())
        run["steps"] = recs
        run["peak_gib"] = _peak() / 2**30
        del batches, state, m, opt, step
        ref = dict(_ref_leaves(os.path.join(ref_dir, name), sp["steps"])) \
            if rank == 0 else {}
        worst, worst_small, worst_upd = (0.0, ""), (0.0, ""), (0.0, "")
        for (key, leaf), (_, sh), (_, leaf0), (_, spec) in zip(
                _paths(params), _paths(ps), _paths(init),
                _paths(model.specs())):
            full = gather_full(leaf, sh.spec, mesh)
            full0 = gather_full(leaf0.to(dev), sh.spec, mesh)
            if rank == 0:
                want = ref.pop(key).to(full.device)
                err = (row_err(full, want), key)
                if spec.init in SMALL_INITS:
                    worst_small = max(worst_small, err)
                else:
                    worst = max(worst, err)
                worst_upd = max(worst_upd,
                                (update_err(full, want, full0), key))
                del want
            del full, full0
        run["leaf_row_err"] = list(worst)
        run["small_leaf_row_err"] = list(worst_small)
        run["leaf_update_err"] = list(worst_upd)
        run["seconds"] = time.perf_counter() - t0
        res["runs"][name] = run
        del ref, init, params, model
        _free()
    with open(out % rank, "w") as f:
        json.dump(res, f)


def _check_moe_ssm_run(name: str, sp: dict, ref_recs, recs) -> None:
    """The checks and lines of one run of phase 17 or 18 (rank 0 holds the
    comparisons)."""
    cfg, b, s, _ = sp["runs"][name]
    r0 = recs[0]["runs"][name]
    tol = ROW_RTOL[torch.bfloat16]
    for tag, lay in r0["layers"].items():
        line = (f"[{sp['tag']}] (a) {name} {tag} layer on the mesh against one "
                f"rank: row_err {lay['row_err']:.3g} (limit {tol})")
        if tag.startswith("moe"):
            line += (f"; {lay['groups']} group(s) of capacity {lay['cap']}, "
                     f"slot equal {lay['slot_equal']}, disp equal "
                     f"{lay['disp_equal']}; assignments dropped: "
                     f"{lay['drops']} in the mesh's groups, "
                     f"{lay['drops_one_group']} in one group of all "
                     f"tokens")
        line += "; collectives (calls, MB): " + ", ".join(
            f"{k} {v['calls']} {v['bytes'] / 1e6:.3f}"
            for k, v in sorted(lay["collectives"].items()))
        grads = lay.get("grad_row_err", {})
        if grads:
            line += ("; its leaves' gradients, row_err (limit "
                     f"{tol}): " + ", ".join(f"{k} {v:.3g}" for k, v in
                                            sorted(grads.items())))
        log(line)
        if not lay["row_err"] <= tol:
            fail(f"{sp['tag']} {name} {tag}: row_err {lay['row_err']} > {tol}")
        for k, v in sorted(grads.items()):
            if not v <= tol:
                fail(f"{sp['tag']} {name} {tag}: the gradient of leaf {k} off "
                     f"one rank's: row_err {v} > {tol}")
        if tag.startswith("moe") and not (lay["slot_equal"]
                                          and lay["disp_equal"]):
            fail(f"{sp['tag']} {name} {tag}: the drop pattern differs from "
                 f"one rank's per-group route")
    if "moe_decode" in r0["layers"] and \
            "moe_counts" not in r0["layers"]["moe_decode"]["collectives"]:
        fail(f"{sp['tag']} {name}: the decode-scale batch made no count "
             f"exchange")
    for i, (ref, got) in enumerate(zip(ref_recs, r0["steps"])):
        le = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
        ge = abs(got["grad_norm"] - ref["grad_norm"]) / abs(ref["grad_norm"])
        log(f"[{sp['tag']}] (b) {name} step {i}: loss {got['loss']:.5f} vs one "
            f"rank's {ref['loss']:.5f} (rel err {le:.3g}, limit "
            f"{MESH_LOSS_RTOL}); grad norm {got['grad_norm']:.5f} vs "
            f"{ref['grad_norm']:.5f} (rel err {ge:.3g}, limit "
            f"{MESH_GNORM_RTOL}); rank 0 step {got['step_ms']:.1f} ms (CUDA "
            f"events; forward {got['fwd_ms']:.1f}, backward "
            f"{got['bwd_ms']:.1f}, optimizer {got['opt_ms']:.1f}), wall "
            f"{got['wall_ms']:.1f} ms; one rank {ref['wall_ms']:.1f} ms "
            f"(forward {ref['fwd_ms']:.1f}, backward {ref['bwd_ms']:.1f}, "
            f"optimizer {ref['opt_ms']:.1f})")
        if not (le <= MESH_LOSS_RTOL and ge <= MESH_GNORM_RTOL):
            fail(f"{sp['tag']} {name} step {i}: loss or grad norm off one "
                 f"rank's: {got['loss']} vs {ref['loss']}, "
                 f"{got['grad_norm']} vs {ref['grad_norm']}")
    bad = [(rec["rank"], i) for rec in recs
           for i, st in enumerate(rec["runs"][name]["steps"])
           if not (np.isfinite(st["loss"]) and np.isfinite(st["grad_norm"]))
           or st["zero_grad_leaves"]]
    if bad:
        fail(f"{sp['tag']} {name}: a non-finite loss or norm, or a leaf whose "
             f"local gradient is all zero (rank, step): {bad}")
    last = r0["steps"][-1]["collectives"]
    log(f"[{sp['tag']}] (c) {name} {cfg.num_layers} layers on a "
        f"{tuple(sp['layout'])} (data, model) mesh of {MESH_WORLD} ranks, "
        f"global batch {b} x {s}: collectives of rank 0's last step "
        f"(calls, MB): " + ", ".join(
            f"{k} {v['calls']} {v['bytes'] / 1e6:.1f}"
            for k, v in sorted(last.items()))
        + f"; {sum(v['bytes'] for v in last.values()) / 1e9:.3f} GB in all")
    log(f"[{sp['tag']}] (c) {name} peak memory per rank (GiB): " + ", ".join(
        f"{rec['runs'][name]['peak_gib']:.2f}" for rec in recs)
        + "; step ms per rank (last step, CUDA events): " + ", ".join(
            f"{rec['runs'][name]['steps'][-1]['step_ms']:.1f}"
            for rec in recs)
        + "; flash and ssd_scan launches per rank: " + ", ".join(
            f"{rec['runs'][name]['launches'].get('flash_attention', 0)}/"
            f"{rec['runs'][name]['launches'].get('ssd_scan', 0)}"
            for rec in recs)
        + f"; the run took {r0['seconds']:.1f} s on rank 0")
    err, key = r0["leaf_row_err"]
    serr, skey = r0["small_leaf_row_err"]
    uerr, ukey = r0["leaf_update_err"]
    log(f"[{sp['tag']}] (b) {name} leaves after step {sp['steps']} against one "
        f"rank's: worst row_err {err:.3g} at {key} (limit {tol}; the leaves "
        f"drawn at zero or a tenth of the scale, held by (a)'s gradients "
        f"and their update: {serr:.3g} at {skey or 'none'}); worst update "
        f"error {uerr:.3g} at {ukey} (limit {MESH_UPDATE_RTOL}; no update "
        f"reads 1)")
    if not err <= tol:
        fail(f"{sp['tag']} {name}: leaf {key} row_err {err} > {tol}")
    if not uerr <= MESH_UPDATE_RTOL:
        fail(f"{sp['tag']} {name}: leaf {ukey}'s update off one rank's: {uerr} "
             f"> {MESH_UPDATE_RTOL}")
    if DEVICE == "cuda":
        kernel = "flash_attention" if cfg.is_encoder_decoder or any(
            ld.mixer == "attn" for ld in build_model(cfg).impl.pattern) \
            else "ssd_scan"
        if not all(rec["runs"][name]["launches"].get(kernel)
                   for rec in recs):
            fail(f"{sp['tag']} {name}: {kernel} never launched on some rank")


def _phase_mesh_runs(sp: dict):
    """Phases 17 and 18: each run's one-rank reference (a, b), then every
    run of ``sp["runs"]`` on ``MESH_WORLD`` ranks sharing the card
    (``moe_ssm_rank``); the checks. Returns the launch counts of the
    one-rank runs and of every rank's steps."""
    import tempfile
    card = _card()
    counts = Counter()
    with tempfile.TemporaryDirectory() as tmp:
        refs = {}
        for name in sp["runs"]:
            t0 = time.perf_counter()
            recs, c, _ = moe_ssm_reference(name, tmp, sp)
            refs[name] = recs
            counts.update(c)
            log(f"[{sp['tag']}] {name} one rank took "
                f"{time.perf_counter() - t0:.1f} s on {card}")
        t0 = time.perf_counter()
        out = os.path.join(tmp, "mesh_rank%d.json")
        spawn_ranks(moe_ssm_rank, MESH_WORLD, sp, tmp, out)
        recs = []
        for r in range(MESH_WORLD):
            with open(out % r) as f:
                recs.append(json.load(f))
        log(f"[{sp['tag']}] the runs on {MESH_WORLD} ranks took "
            f"{time.perf_counter() - t0:.1f} s on {card}")
    for name in sp["runs"]:
        _check_moe_ssm_run(name, sp, refs[name], recs)
        for rec in recs:
            counts.update(rec["runs"][name]["launches"])
    return counts


def phase_mesh_moe_ssm():
    """Phase 17 (``_phase_mesh_runs`` of ``MOE_SSM_RUNS``)."""
    return _phase_mesh_runs(_moe_ssm_spec())


def phase_mesh_encdec_vlm():
    """Phase 18 (``_phase_mesh_runs`` of ``ENCDEC_VLM_RUNS``)."""
    return _phase_mesh_runs(_encdec_vlm_spec())


def _card() -> str:
    if DEVICE != "cuda":
        return "the CPU"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ------------------------------------------------------------------- main
def main() -> None:
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    checked, shape_rows = phase_kernels()
    # launches summed over every serving phase's runs, phase 14's two
    # training runs, phase 15's serve CLI and phases 16-18's runs on one
    # rank and on each rank of the mesh (each resets the counts just
    # before it runs and reads them just after)
    launches = Counter()
    for phase in (phase_serve, phase_remap, phase_xlstm, phase_xlstm_remap,
                  phase_moonshot, phase_jamba, phase_danube, phase_whisper,
                  phase_whisper_remap, phase_llava, phase_fleet_import,
                  phase_fleet_scale):
        launches.update(phase())
    launches.update(phase_train(shape_rows))
    launches.update(phase_distributed())
    launches.update(phase_mesh_train(shape_rows))
    launches.update(phase_mesh_moe_ssm())
    launches.update(phase_mesh_encdec_vlm())
    log(f"[launches] every serving, training and CLI phase: "
        f"{dict(launches)}")
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
