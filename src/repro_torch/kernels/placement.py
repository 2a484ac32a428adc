"""Where a kernel call runs: decided by the tensors it is given."""
from __future__ import annotations

import torch


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on a CUDA device, False when every one is
    on the CPU; raises on a mix (a kernel never copies its inputs)."""
    cuda = [t.is_cuda for t in tensors]
    if all(cuda):
        return True
    if not any(cuda) and all(t.device.type == "cpu" for t in tensors):
        return False
    raise ValueError("kernel inputs on mixed devices: "
                     + ", ".join(str(t.device) for t in tensors))
