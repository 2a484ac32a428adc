"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device and the CUDA
toolkit. It imports the port (``src/repro_torch``) and nothing of JAX or of
the JAX package, and exits non-zero, printing no result line, when there is
no CUDA device or any phase fails. Phases:

0. device: the card's name and power limit (nvidia-smi); TF32 off.
1. build: the hand-written CUDA kernels, from ``src/repro_torch/kernels/csrc``.
2. kernels: each kernel against its plain PyTorch version at llama3-8b head
   shapes (Hq 32, Hkv 8, D 128, page 16), f32 within 1e-4 and bf16 within
   2e-2; its time (CUDA events), the plain version's time, the least time
   the card could take (bound) and, for flash, the time of one PyTorch SDPA
   call as a yardstick.
3. serve: llama3-8b at full width and depth (32 layers, bf16, seeded random
   weights) through ``ServingEngine`` in mirage mode with a paged tenant:
   8 prompts of 512 tokens, 32 new tokens each, once with monolithic
   prefill (flash kernel) and once with 256-token chunks (paged prefill
   kernel); both decode through the paged decode kernel.
4. remap: two llama3-8b-width tenants cut to 2 layers, one trace with a
   small KV pool (the controller remaps parameter memory into the pool and
   the donor's layers stream from pinned host memory) and with an ample
   pool; the generated tokens must be identical.
5. the kernels line (JSON) and, last, the result line (JSON).
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.paged_attention import ops as paged_ops  # noqa: E402
from repro_torch.models import attention_ops as plain  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.serving import ServingEngine, TenantConfig  # noqa: E402
from repro_torch.serving.traces import tiny_trace  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
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
}


# the serve phase's requests: prompt tokens and new tokens each
PROMPT, NEW = 512, 32
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


def bound(nbytes: float, flops: float):
    """(ms, "bytes" | "operations"): the larger of bytes over the memory
    rate and operations over the bf16 peak."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def visible(qpos: int, kv_limit: int, window: int, causal: bool = True) -> int:
    """Keys a query at ``qpos`` sees below ``kv_limit``."""
    hi = min(kv_limit, qpos + 1) if causal else kv_limit
    lo = max(0, qpos - window + 1) if window > 0 else 0
    return max(hi - lo, 0)


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
    b, n = 8, 192
    for dt in (torch.float32, torch.bfloat16):
        kp, vp = (x[0] for x in _pool(b * n + 1, dt, gen))
        pt = _page_table(b, n, b * n + 1, gen)
        q = torch.randn(b, HQ, D, generator=gen, device="cuda").to(dt)
        ctx = torch.tensor([1, 17, 100, 513, 2048, 2500, 3000, 16],
                           dtype=torch.int32, device="cuda")
        for window in (0, 1000):
            out = paged_ops.paged_decode_attention(q, kp, vp, pt, ctx,
                                                   window=window)
            ref = plain.paged_decode_attention(q, kp, vp, pt, ctx,
                                               window=window)
            torch.cuda.synchronize()
            e = _err(out, ref)
            rows["paged_decode_attention"].append(e)
            log(f"[kernels] paged_decode {str(dt)[6:]} B={b} ctx="
                f"{ctx.tolist()} window={window} max_err={e:.3g}")
            if not e < TOL[dt]:
                fail(f"paged_decode {dt} window={window}: {e} >= {TOL[dt]}")


def check_prefill(gen, rows):
    n = 192
    for dt in (torch.float32, torch.bfloat16):
        kp, vp = (x[0] for x in _pool(2 * n + 1, dt, gen))
        pt = _page_table(2, n, 2 * n + 1, gen)
        q = torch.randn(2, 256, HQ, D, generator=gen, device="cuda").to(dt)
        q_start = torch.tensor([768, 2048], dtype=torch.int32, device="cuda")
        ctx = q_start + 256
        for window in (0, 300):
            out = paged_ops.paged_prefill_attention(q, kp, vp, pt, q_start,
                                                    ctx, window=window)
            ref = plain.paged_prefill_attention(q, kp, vp, pt, q_start, ctx,
                                                window=window)
            torch.cuda.synchronize()
            e = _err(out, ref)
            rows["paged_prefill_attention"].append(e)
            log(f"[kernels] paged_prefill {str(dt)[6:]} Sq=256 q_start="
                f"{q_start.tolist()} window={window} max_err={e:.3g}")
            if not e < TOL[dt]:
                fail(f"paged_prefill {dt} window={window}: {e} >= {TOL[dt]}")


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
    prompt. Paged inputs rotate over 32 layers' pools, as the decode step
    does, so the L2 cache does not hold them between launches."""
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
            i = next(it) % layers
            return fn(q, kp[i], vp[i], pt, ctx)
        return call
    ms = time_ms(dec(paged_ops.paged_decode_attention), 200)
    plain_ms = time_ms(dec(plain.paged_decode_attention), 10)
    keys = 528 * b
    nbytes = (2 * q.numel() + 2 * keys * HKV * D) * 2 + pt.numel() * 4 + b * 4
    out["paged_decode_attention"] = (
        ms, plain_ms, *bound(nbytes, 4 * HQ * D * keys), None,
        "B=8 ctx=528 bf16")
    # paged prefill: chunk 256 at q_start 256 of a 512-token prompt
    n = 40
    kp, vp = _pool(n + 1, dt, gen, layers)
    pt = _page_table(1, n, n + 1, gen)
    q = torch.randn(1, 256, HQ, D, generator=gen, device="cuda").to(dt)
    q_start = torch.tensor([256], dtype=torch.int32, device="cuda")
    ctx = q_start + 256

    def pre(fn):
        def call():
            i = next(it) % layers
            return fn(q, kp[i], vp[i], pt, q_start, ctx)
        return call
    ms = time_ms(pre(paged_ops.paged_prefill_attention), 100)
    plain_ms = time_ms(pre(plain.paged_prefill_attention), 10)
    seen = sum(visible(256 + i, 512, 0) for i in range(256))
    nbytes = (2 * q.numel() + 2 * 512 * HKV * D) * 2 + pt.numel() * 4 + 8
    out["paged_prefill_attention"] = (
        ms, plain_ms, *bound(nbytes, 4 * HQ * D * seen), None,
        "Sq=256 q_start=256 ctx=512 bf16")
    # flash: monolithic prefill of one 512-token prompt
    s = 512
    q = torch.randn(1, s, HQ, D, generator=gen, device="cuda").to(dt)
    k = torch.randn(1, s, HKV, D, generator=gen, device="cuda").to(dt)
    v = torch.randn(1, s, HKV, D, generator=gen, device="cuda").to(dt)
    ms = time_ms(lambda: flash_ops.flash_attention(q, k, v), 100)
    plain_ms = time_ms(lambda: plain.flash_attention(q, k, v), 10)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 100)
    seen = sum(visible(i, s, 0) for i in range(s))
    nbytes = (2 * q.numel() + 2 * s * HKV * D) * 2
    out["flash_attention"] = (
        ms, plain_ms, *bound(nbytes, 4 * HQ * D * seen), lib_ms,
        "B=1 S=512 causal bf16")
    for name, (ms, pms, bms, by, lib, shape) in out.items():
        log(f"[kernels] time {name} ({shape}): {ms:.4f} ms, plain "
            f"{pms:.4f} ms, bound {bms:.4f} ms ({by}), library "
            f"{'none' if lib is None else f'{lib:.4f} ms'}")
    # the long-context shapes of the checks, for the record
    b, n, layers = 8, 192, 4
    kp, vp = _pool(b * n + 1, dt, gen, layers)
    pt = _page_table(b, n, b * n + 1, gen)
    q = torch.randn(b, HQ, D, generator=gen, device="cuda").to(dt)
    ctx = torch.full((b,), 2048, dtype=torch.int32, device="cuda")
    ms = time_ms(dec(paged_ops.paged_decode_attention), 50)
    bms, by = bound((2 * q.numel() + 2 * 2048 * b * HKV * D) * 2,
                    4 * HQ * D * 2048 * b)
    log(f"[kernels] time paged_decode_attention (B=8 ctx=2048 bf16): "
        f"{ms:.4f} ms, bound {bms:.4f} ms ({by})")
    s = 2048
    q = torch.randn(1, s, HQ, D, generator=gen, device="cuda").to(dt)
    k = torch.randn(1, s, HKV, D, generator=gen, device="cuda").to(dt)
    v = torch.randn(1, s, HKV, D, generator=gen, device="cuda").to(dt)
    ms = time_ms(lambda: flash_ops.flash_attention(q, k, v), 20)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 20)
    bms, by = bound((2 * q.numel() + 2 * s * HKV * D) * 2,
                    4 * HQ * D * s * (s + 1) / 2)
    log(f"[kernels] time flash_attention (B=1 S=2048 causal bf16): "
        f"{ms:.4f} ms, bound {bms:.4f} ms ({by}), library {lib_ms:.4f} ms")
    return out


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {name: [] for name in SOURCES}
    check_decode(gen, rows)
    check_prefill(gen, rows)
    check_flash(gen, rows)
    timing = time_kernels(gen)
    return {name: (max(errs), timing[name]) for name, errs in rows.items()}


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


# ------------------------------------------------------------------- main
def main() -> None:
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    checked = phase_kernels()
    launches = phase_serve()
    phase_remap()
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
