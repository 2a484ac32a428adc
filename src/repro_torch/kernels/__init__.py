"""Hand-written CUDA kernels for Hopper (``csrc/``), one per Pallas TPU
kernel on the ported path, each with its plain PyTorch version and a launch
counter (``<wrapper>.launches``)."""
from repro_torch.kernels.flash_attention import kernel as _flash_kernel
from repro_torch.kernels.paged_attention import kernel as _paged_kernel
from repro_torch.kernels.ssd_scan import kernel as _ssd_kernel

# every kernel wrapper, by name; each carries its own ``launches`` count
WRAPPERS = {
    "paged_decode_attention": _paged_kernel.paged_decode_attention,
    "paged_prefill_attention": _paged_kernel.paged_prefill_attention,
    "flash_attention": _flash_kernel.flash_attention,
    "ssd_scan": _ssd_kernel.ssd_scan,
}


def launch_counts() -> dict:
    return {n: w.launches for n, w in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for w in WRAPPERS.values():
        w.launches = 0
