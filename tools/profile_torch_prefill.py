"""Where a prefill of the PyTorch/CUDA port spends its time, on one GPU,
through the compiled prefill (CUDA graphs) and eagerly.

    python3 tools/profile_torch_prefill.py [--arch xlstm-1.3b] [--layers 0]
        [--prompts 8] [--prompt 512] [--chunk 256] [--profile-prompts 8]
        [--graphs on|off|both]

Serves ``--arch`` at full width (bf16, seeded random weights; ``--layers``
cuts the depth, 0 keeps the config's) through the ``ServingEngine``: a
recurrent or hybrid stack as a dense tenant (its prefill is
``Model.prefill``, whose sLSTM layers replay their time chunk's graph), an
attention stack as a paged one prefilled in chunks of ``--chunk`` tokens
(each chunk length's layer loop one graph; 0: monolithic, eager either
way). ``--graphs`` switches the engine's ``prefill_graphs`` (``both``: on,
then off, on the same weights); decode graphs stay on in both. Each mode
runs three traces through one engine: a warm one of ``--prompts``
requests (its graphs are captured there: the line after it gives the
prefill graph counters: captures, capture ms, pool MiB), a timed one of
``--prompts`` (the wall of its admit+prefill steps: the engine's steps
until every request has its first token, which hold one decode step of
the batch too) and a profiled one of ``--profile-prompts`` (the host's
launches, a replay counting one ``cudaGraphLaunch``, and the device's
kernel time, by kernel). Every figure is also given a prompt, with the
idle share 1 - device / wall. Needs a CUDA device; imports neither JAX nor
the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time
import warnings

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import chip_smoke  # noqa: E402  (puts src/ on the path)
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import ServingEngine, TenantConfig  # noqa: E402
from repro_torch.serving.traces import tiny_trace  # noqa: E402


def admit_and_prefill(eng, cfg, n: int, prompt: int, seed: int) -> float:
    """Submit ``n`` requests and step the engine until each has its first
    token; returns those steps' wall seconds. The rest decodes untimed."""
    trace = tiny_trace([cfg.name], n_per_model=n, prompt_len=prompt,
                       max_new=2, vocab=cfg.vocab_size, seed=seed)
    for r in trace:
        r.rid = f"{r.rid}-{seed}"
    eng.submit(trace)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings():      # run() warns at its step budget
        warnings.simplefilter("ignore", RuntimeWarning)
        while not all(r.generated for r in trace):
            eng.run(max_steps=eng.step_idx + 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng.run()
    return wall


def profile_mode(cfg, params, paged: bool, args, graphs: bool) -> None:
    eng = ServingEngine(
        {cfg.name: TenantConfig(cfg, params, max_batch=args.prompts,
                                max_context=args.prompt + 16, paged=paged)},
        mode="mirage", base_kv_pages=64 * args.prompts, page_size=16,
        prefill_chunk_tokens=args.chunk if paged else 0, device="cuda",
        prefill_graphs=graphs)
    how = (f"paged, chunks of {args.chunk}" if paged and args.chunk
           else "paged, monolithic" if paged else "dense")
    tag = f"[profile] {cfg.name} {cfg.num_layers} layers {cfg.dtype}, " \
        f"{how}, prefill graphs {'on' if graphs else 'off'}"
    torch.cuda.reset_peak_memory_stats()
    warm = admit_and_prefill(eng, cfg, args.prompts, args.prompt, 1)
    stats = chip_smoke.graph_summary(eng, "prefill")
    chip_smoke.log(
        f"{tag}: warm trace {warm:.3f} s; prefill graphs "
        f"{stats.get('captures', 0)} captures "
        f"({stats.get('capture_ms', 0.0):.1f} ms), "
        f"{stats.get('replays', 0)} replays, pool "
        f"{stats.get('pool_bytes', 0) / 2**20:.1f} MiB")
    wall = admit_and_prefill(eng, cfg, args.prompts, args.prompt, 2) \
        / args.prompts * 1e3
    n = args.profile_prompts
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall = admit_and_prefill(eng, cfg, n, args.prompt, 3) / n * 1e3
    avg = prof.key_averages()
    on_device = [e for e in avg
                 if str(getattr(e, "device_type", "")).endswith("CUDA")]
    dev = sum(e.self_device_time_total for e in on_device) / 1e3 / n
    launches = sum(e.count for e in avg
                   if e.key in chip_smoke._LAUNCH_KEYS) / n
    chip_smoke.log(
        f"{tag}: a prompt of {args.prompt} tokens (admit+prefill steps of "
        f"{args.prompts} prompts): wall {wall:.3f} ms; of {n} profiled: "
        f"{prof_wall:.3f} ms under the profiler, {launches:.0f} host "
        f"launches, device {dev:.3f} ms; idle share {1 - dev / wall:.3f}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:10]
    chip_smoke.log(f"{tag}: device ms a prompt by kernel: " + ", ".join(
        f"{chip_smoke._kernel_key(e.key)} "
        f"{e.self_device_time_total / 1e3 / n:.3f} ({e.count / n:.0f} calls)"
        for e in top))
    del eng
    chip_smoke._free()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-1.3b", choices=sorted(ARCHS))
    ap.add_argument("--layers", type=int, default=0,
                    help="depth cut (0: the config's depth)")
    ap.add_argument("--prompts", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--chunk", type=int, default=256,
                    help="chunk tokens of a paged tenant (0: monolithic)")
    ap.add_argument("--profile-prompts", type=int, default=8)
    ap.add_argument("--graphs", choices=("on", "off", "both"), default="on",
                    help="both: on, then off, on the same weights")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_prefill: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = ARCHS[args.arch]
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    model = build_model(cfg)
    paged = getattr(model.impl, "attention_only", False) \
        and not cfg.num_image_patches
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    for mode in (("on", "off") if args.graphs == "both" else (args.graphs,)):
        profile_mode(cfg, params, paged, args, mode == "on")


if __name__ == "__main__":
    main()
