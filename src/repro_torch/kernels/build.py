"""Build and load the hand-written CUDA kernels (``kernels/csrc``).

Each ``.cu`` source compiles for ``sm_90a`` in its own ``nvcc`` process, all
started together, and one more ``nvcc`` call links the objects into a shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use, into ``build/repro_torch_kernels/`` at the repository root (a
directory ``.gitignore`` lists); the library's name carries a hash of the
sources, so an edited source rebuilds and an unchanged one loads at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# -Xptxas -v: each kernel's registers, shared memory and spills, kept in
# ``compile_log`` by source
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: every pointer and the stream are c_void_p, sizes c_int
SIGNATURES = {
    "rt_paged_decode_attention": [_P] * 7 + [_I] * 10 + [_P],
    "rt_paged_prefill_attention": [_P] * 7 + [_I] * 10 + [_P],
    "rt_flash_attention": [_P] * 5 + [_I] * 9 + [_P],
    "rt_ssd_scan": [_P] * 9 + [_I] * 6 + [_P],
    "rt_flash_encode_ns": [_P] * 3 + [_I] * 7,
}
RESTYPES = {"rt_flash_encode_ns": ctypes.c_double}   # the rest: c_int

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None     # wall time of this process's build
compile_log: dict = {}    # source name -> nvcc output, of this process's build


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"librepro_torch_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands at once and return their outputs; raise with the
    output of any that fail."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed, outs = [], []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        outs.append(out)
        if p.returncode != 0:
            failed.append(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}"
                          f"\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = out.with_suffix(f".{os.getpid()}.objs")
    objs.mkdir(exist_ok=True)
    nvcc = _nvcc()
    srcs = sorted(CSRC.glob("*.cu"))
    obj_of = {p: objs / f"{p.stem}.o" for p in srcs}
    t0 = time.perf_counter()
    try:
        outs = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj_of[p]),
                          str(p)] for p in srcs])
        compile_log.update({p.name: o for p, o in zip(srcs, outs)})
        _run_all([[nvcc, *ARCH, "-shared", "-o", str(tmp),
                   *(str(obj_of[p]) for p in srcs)]])
    finally:
        shutil.rmtree(objs, ignore_errors=True)
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = RESTYPES.get(name, ctypes.c_int)
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
