"""Plain PyTorch version of the SSD-scan kernel: the model's chunkwise
parallel recurrence (``models.blocks.ssd_chunked``), as the JAX package's
oracle is its model's ``ssd_chunked``."""


def ssd_scan_ref(q, k, v, log_a, chunk: int = 128, init_state=None):
    # imported at call time: models.blocks imports this package's dispatcher
    from repro_torch.models.blocks import ssd_chunked
    return ssd_chunked(q, k, v, log_a, chunk=chunk, init_state=init_state)


__all__ = ["ssd_scan_ref"]
