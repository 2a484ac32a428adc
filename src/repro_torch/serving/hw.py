"""Hardware abstraction: chip + host-link constants.

Roofline constants for the dry-run target (TPU v5e) are fixed per the
assignment: 197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI.

The MIRAGE evaluation additionally needs a host link: the paper's point is
that GH200-class CPU<->GPU bandwidth (450 GB/s) makes parameter streaming
profitable while PCIe-class (64 GB/s) may not — we expose both as named
specs so every benchmark reports the sensitivity.
"""
from __future__ import annotations

import dataclasses


# Host-link classes (unidirectional bytes/s) — the axis the remap-vs-swap
# crossover is swept across. Real numbers: PCIe Gen4/Gen5 x16 payload
# bandwidth, NVLink-C2C per direction (900 GB/s total on GH200).
PCIE_GEN4_X16_BW = 32e9
PCIE_GEN5_X16_BW = 64e9
NVLINK_C2C_BW = 450e9

HOST_LINKS = {
    "pcie4": PCIE_GEN4_X16_BW,
    "pcie5": PCIE_GEN5_X16_BW,
    "nvlink_c2c": NVLINK_C2C_BW,
}


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    flops_bf16: float          # per chip
    hbm_bw: float              # bytes/s
    hbm_bytes: int
    ici_bw: float              # bytes/s per link
    host_link_bw: float        # host DRAM <-> HBM, bytes/s (unidirectional)
    host_dram_bytes: int
    # paper §3.2: 1:1 read/write mix degrades host-link bandwidth ~15%
    bidir_degradation: float = 0.15
    mfu_ceiling: float = 0.6   # realistic fraction of peak for dense matmul
    # per-collective launch/synchronization floor on the ICI/NVLink fabric;
    # dominates ring all-reduce time for decode-sized payloads
    ici_latency_s: float = 1e-6

    @property
    def host_link_bw_bidir(self) -> float:
        return self.host_link_bw * (1.0 - self.bidir_degradation)

    def with_host_link(self, link: str) -> "HardwareSpec":
        """Same chip behind a different host-link class (``HOST_LINKS``
        key) — the named constructor benchmarks sweep instead of ad-hoc
        ``dataclasses.replace`` literals."""
        return dataclasses.replace(
            self, name=f"{self.name}_{link}", host_link_bw=HOST_LINKS[link])


# Dry-run/roofline target (assignment constants).
TPU_V5E = HardwareSpec(
    name="tpu_v5e",
    flops_bf16=197e12,
    hbm_bw=819e9,
    hbm_bytes=16 * 2**30,
    ici_bw=50e9,
    host_link_bw=450e9,        # GH200-class host link (paper's premise)
    host_dram_bytes=224 * 2**30,
)

# Same chip, PCIe-class host link (the paper's H100 contrast point).
TPU_V5E_PCIE = dataclasses.replace(
    TPU_V5E, name="tpu_v5e_pcie", host_link_bw=64e9)

# GH200 numbers as used in the paper's own evaluation (for the simulator's
# paper-faithful reproduction mode): H200 GPU-ish compute + the Grace
# Hopper NVLink-C2C host link (450 GB/s per direction).
GH200 = HardwareSpec(
    name="gh200",
    flops_bf16=990e12,
    hbm_bw=4.8e12,
    hbm_bytes=96 * 2**30,
    ici_bw=450e9,
    host_link_bw=NVLINK_C2C_BW,
    host_dram_bytes=224 * 2**30,
)

# PCIe-class contrast points (the paper §3 premise: parameter streaming
# pays on C2C-class links, maybe not on PCIe).
# H100 PCIe: 756 TFLOP/s dense bf16, 80 GB HBM2e @ 2 TB/s, PCIe Gen5 x16
# host link, NVLink bridge 600 GB/s.
H100_PCIE = HardwareSpec(
    name="h100_pcie",
    flops_bf16=756e12,
    hbm_bw=2.0e12,
    hbm_bytes=80 * 2**30,
    ici_bw=600e9,
    host_link_bw=PCIE_GEN5_X16_BW,
    host_dram_bytes=512 * 2**30,
)

# A100 80GB PCIe: 312 TFLOP/s bf16, HBM2e @ 1.94 TB/s, PCIe Gen4 x16.
A100_PCIE = HardwareSpec(
    name="a100_pcie",
    flops_bf16=312e12,
    hbm_bw=1.94e12,
    hbm_bytes=80 * 2**30,
    ici_bw=600e9,
    host_link_bw=PCIE_GEN4_X16_BW,
    host_dram_bytes=256 * 2**30,
)

SPECS = {s.name: s for s in (TPU_V5E, TPU_V5E_PCIE, GH200, H100_PCIE,
                             A100_PCIE)}
