"""Where a decode step of the PyTorch/CUDA port spends its time, on one GPU.

    python3 tools/profile_torch_decode.py [--arch llama3-8b] [--layers 0]
        [--steps 8] [--batch 8] [--prompt 512] [--graphs on|off|both]

Serves ``--arch`` at full width (bf16, seeded random weights; ``--layers``
cuts the depth, 0 keeps the config's) through the ``ServingEngine`` with
monolithic prefill: as a paged tenant when the stack is a decoder-only
attention stack with no VLM prefix (llama3-8b, moonshot-v1-16b-a3b), else
as a dense (``paged=False``) one (jamba-v0.1-52b, which needs ``--layers
16`` to fit one card; whisper-medium; llava-next-34b, whose cache also
holds its 2880 patch rows; give it ``--batch 4``). Then it
profiles decode-only engine steps with ``chip_smoke.step_profile``, the
profiler of chip_smoke.py's serving phases, and prints what that prints:
the wall time per step (``--steps`` unprofiled steps), then for as many
profiled ones the launches, the device time (for an MoE stack also that of
the expert products), the device's idle share, the weight-read bound and
the device time by kernel (top 12). ``--graphs on`` (the default) decodes
through the engine's captured CUDA graphs, ``off`` eagerly, ``both`` the
one and then the other on the same weights; a replayed step counts one
host launch for its graph (``cudaGraphLaunch``), and the line after the
profile gives the graph cache's captures, replays, capture ms and pool
bytes, and the run's peak memory. Needs a CUDA device; imports neither JAX
nor the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import warnings

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import chip_smoke  # noqa: E402  (puts src/ on the path)
import torch  # noqa: E402

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import ServingEngine, TenantConfig  # noqa: E402
from repro_torch.serving.traces import tiny_trace  # noqa: E402


def profile_mode(cfg, params, paged: bool, args, graphs: bool) -> None:
    """Serve the trace through a fresh engine, then profile decode-only
    steps and print them (``chip_smoke.log_profile``)."""
    max_context = cfg.num_image_patches + args.prompt + 64
    eng = ServingEngine(
        {cfg.name: TenantConfig(cfg, params, max_batch=args.batch,
                                max_context=max_context, paged=paged)},
        mode="mirage", base_kv_pages=64 * args.batch, page_size=16,
        device="cuda", decode_graphs=graphs)
    trace = tiny_trace([cfg.name], n_per_model=args.batch,
                       prompt_len=args.prompt, max_new=2 * args.steps + 8,
                       vocab=cfg.vocab_size, seed=0)
    eng.submit(trace)
    expert_shape = None if cfg.moe is None else (
        cfg.moe.num_experts, cfg.d_model, cfg.moe.d_expert)
    torch.cuda.reset_peak_memory_stats()
    with warnings.catch_warnings():      # run() warns at its step budget
        warnings.simplefilter("ignore", RuntimeWarning)
        while not all(r.generated for r in trace):
            eng.run(max_steps=eng.step_idx + 1)
        eng.run(max_steps=eng.step_idx + 2)          # warm decode steps
        prof = chip_smoke.step_profile(
            lambda: eng.run(max_steps=eng.step_idx + 1), args.steps,
            expert_shape, top=12)
    chip_smoke.log(f"[profile] {cfg.name} {cfg.num_layers} layers "
                   f"{cfg.dtype}, {'paged' if paged else 'dense'} tenant, "
                   f"context ~{args.prompt}, {args.steps} steps each way, "
                   f"decode graphs {'on' if graphs else 'off'}")
    chip_smoke.log_profile("profile", args.batch, prof,
                           chip_smoke.weight_read_ms(params, cfg, args.batch))
    chip_smoke.log(f"[profile] decode graphs: {eng.graph_stats()}; peak "
                   f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
                   f"GiB")
    del eng
    chip_smoke._free()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=sorted(ARCHS))
    ap.add_argument("--layers", type=int, default=0,
                    help="depth cut (0: the config's depth)")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--graphs", choices=("on", "off", "both"), default="on",
                    help="both: on, then off, on the same weights")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_decode: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = ARCHS[args.arch]
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    model = build_model(cfg)
    paged = model.impl.attention_only and not cfg.num_image_patches
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    for mode in (("on", "off") if args.graphs == "both" else (args.graphs,)):
        profile_mode(cfg, params, paged, args, mode == "on")


if __name__ == "__main__":
    main()
