"""The attention kernels of two checkouts on one card, timed the same way.

    python3 tools/kernel_ab.py A_DIR B_DIR

First phase 2 of each checkout's own chip_smoke.py (build, every kernel
against its plain version, its times), each a process of its own started
from that checkout's root, so each builds its own kernels into its own
build/ directory; the lines each prints are echoed with its label. Then,
in this process, each checkout's own wrappers (its
``kernels/paged_attention/kernel.py`` and ``kernels/flash_attention/
kernel.py``, bound to its own ``build.py`` and library) at the serve
phases' shapes and the long-context ones: calls replayed from CUDA graphs
(``chip_smoke.graphed``), A and B in turns (``chip_smoke.time_turns``),
and eager calls of each beside. A checkout is any tree with these files:
the parent commit unpacked with ``git archive``, or a copy of this tree
with one change. Two versions of a kernel are only comparable inside one
such run: another run may land on another card, at another power limit.
Exits non-zero when a phase-2 run fails.
"""
from __future__ import annotations

import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

PHASE_2 = ("import chip_smoke as c; c.phase_device(); c.phase_build(); "
           "c.phase_kernels()")


def run_phase_2(label: str, root: str) -> int:
    p = subprocess.run([sys.executable, "-c", PHASE_2], cwd=root,
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    for line in p.stdout.splitlines():
        print(f"[{label}] {line}", flush=True)
    print(f"[{label}] exit {p.returncode}", flush=True)
    return p.returncode


def wrappers(label: str, root: str) -> dict:
    """The attention wrappers of the checkout at ``root``, each launching
    that checkout's kernels through its own build module."""
    kdir = os.path.join(root, "src", "repro_torch", "kernels")

    def load(name, *rel):
        spec = importlib.util.spec_from_file_location(
            f"kernel_ab_{label}_{name}", os.path.join(kdir, *rel))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    lib = load("build", "build.py")
    paged = load("paged", "paged_attention", "kernel.py")
    flash = load("flash", "flash_attention", "kernel.py")
    paged.build = flash.build = lib
    return {"paged_decode_attention": paged.paged_decode_attention,
            "paged_prefill_attention": paged.paged_prefill_attention,
            "flash_attention": flash.flash_attention}


def cases(gen):
    """(kernel, shape, calls a graph, args of layer i): paged inputs rotate
    over ``calls`` layers' pools, as a decode step does, so the L2 cache
    does not hold them between launches."""
    dt, HQ, HKV, D = torch.bfloat16, cs.HQ, cs.HKV, cs.D

    def paged(b, n, layers, make):
        kp, vp = cs._pool(b * n + 1, dt, gen, layers)
        pt = cs._page_table(b, n, b * n + 1, gen)
        return lambda i: make(kp[i], vp[i], pt)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device="cuda")
    for b, n, c, layers in ((8, 40, 528, 32), (8, 192, 2048, 4)):
        q = torch.randn(b, HQ, D, generator=gen, device="cuda").to(dt)
        ctx = i32([c] * b)
        yield ("paged_decode_attention", f"B={b} N={n} ctx={c}", layers,
               paged(b, n, layers, lambda k, v, pt, q=q, ctx=ctx:
                     (q, k, v, pt, ctx)))
    for n, starts, layers in ((40, [256], 32), (192, [768, 2048], 4)):
        b = len(starts)
        q = torch.randn(b, 256, HQ, D, generator=gen, device="cuda").to(dt)
        q0 = i32(starts)
        yield ("paged_prefill_attention", f"B={b} N={n} Sq=256 q_start="
               f"{starts}", layers,
               paged(b, n, layers, lambda k, v, pt, q=q, q0=q0:
                     (q, k, v, pt, q0, q0 + 256)))
    for s, calls in ((512, 20), (2048, 10)):
        args = tuple(torch.randn(1, s, h, D, generator=gen, device="cuda")
                     .to(dt) for h in (HQ, HKV, HKV))
        yield "flash_attention", f"B=1 S={s} causal", calls, lambda i: args


def time_both(libs: dict) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, shape, calls, args in cases(gen):
        replays, eager, outs = {}, {}, {}
        for label, fns in libs.items():
            it = iter(range(1 << 30))

            def call(fn=fns[name], it=it):
                return fn(*args(next(it) % calls))
            outs[label] = fns[name](*args(0)).float()
            replays[label] = cs.graphed(call, calls)
            eager[label] = cs.time_ms(call, 100 if calls > 10 else 30)
        ms, turns = cs.time_turns(replays, 10, rounds=6)
        a, b = (ms[k] / calls for k in ("A", "B"))
        diff = (outs["A"] - outs["B"]).abs().max().item()
        print(f"[ab] {name} ({shape} bf16): "
              + "; ".join(f"{k} {ms[k] / calls:.4f} ms (graph replay, turns "
                          f"{cs._fmt(t / calls for t in turns[k])}; eager "
                          f"calls {eager[k]:.4f} ms)" for k in ms)
              + f"; A/B {a / b:.3f}x; outputs max |A - B| {diff:.3g}",
              flush=True)


def main() -> None:
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    roots = {"A": os.path.abspath(sys.argv[1]),
             "B": os.path.abspath(sys.argv[2])}
    if any([run_phase_2(label, root) for label, root in roots.items()]):
        raise SystemExit(1)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    time_both({label: wrappers(label, root)
               for label, root in roots.items()})


if __name__ == "__main__":
    main()
