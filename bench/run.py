"""Run one cell of the benchmark of the PyTorch/CUDA port once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line (the result) as the last line of its standard output
and the numbers its check compared, each beside its limit, as the last
lines of its standard error. See bench/README.md.
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BUILD = os.path.join(ROOT, "build")

# bytecode and kernel caches at fixed paths inside the checkout, so that a
# checkout's first run compiles and writes them and every later run reads
# them (the machine may forbid bytecode and ship none for its packages)
sys.pycache_prefix = os.path.join(BUILD, "pycache")
sys.dont_write_bytecode = False
os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix
os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BUILD, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD, "triton")
os.environ["USE_FLAX"] = "0"
# one process, few threads: the host launches the program's kernels from one
# thread, and idle worker pools would only compete with it for the cores
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[:0] = [HERE, os.path.join(ROOT, "src")]

from harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
