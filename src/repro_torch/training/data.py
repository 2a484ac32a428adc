"""Deterministic synthetic data pipeline (``repro.training.data``).

Every batch is a pure function of (seed, step): after a restart the loop
resumes at the checkpointed step and replays identical data, which is the
fault-tolerance contract (no data-loader state to persist). Two flavors:
token LM batches and stub-modality batches (frames for an enc-dec model,
patch embeddings for a VLM). The draws come from a ``torch.Generator``
seeded from both numbers; the JAX package's draws cannot be reproduced
here, so the keys, shapes, dtypes and masks match its batches, not the
values. Over a mesh each rank keeps its block of the global batch (its
rows over the data axes, ``launch.shardings.batch_shardings``), so the
data stays keyed by (seed, step) whatever the mesh.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import local_shard
from repro_torch.models.common import dtype_of
from repro_torch.models.registry import WHISPER_DECODER_LEN, Model


def _generator(seed: int, step: int) -> torch.Generator:
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]))


def batch_for_step(model: Model, shape: ShapeConfig, seed: int, step: int,
                   batch_override: int = 0, device="cuda",
                   shardings=None) -> Dict[str, torch.Tensor]:
    """Synthetic training batch for (arch x shape) at a given step, drawn
    on the CPU and moved to ``device``; with ``shardings`` (a
    ``NamedSharding`` per key) only the rank's block of each."""
    cfg = model.cfg
    b = batch_override or shape.global_batch
    gen = _generator(seed, step)
    dt = dtype_of(cfg)

    def normal(*size):
        return (torch.randn(size, generator=gen) * 0.02).to(dt)

    def tokens(n):
        return torch.randint(0, cfg.vocab_size, (b, n), generator=gen,
                             dtype=torch.int32)

    if cfg.is_encoder_decoder:
        s_dec = min(WHISPER_DECODER_LEN, shape.seq_len)
        frames = normal(b, shape.seq_len, cfg.d_model)
        toks = tokens(s_dec + 1)
        out = {"frames": frames, "tokens": toks[:, :-1],
               "targets": toks[:, 1:],
               "mask": torch.ones((b, s_dec), dtype=torch.float32)}
    else:
        s = shape.seq_len
        out = {}
        s_text = s
        if cfg.num_image_patches:
            p = min(cfg.num_image_patches, s - 1)
            s_text = s - p
            out["patch_embeds"] = normal(b, p, cfg.d_model)
        toks = tokens(s + 1)
        out["tokens"] = toks[:, :s_text]
        out["targets"] = toks[:, 1:]
        mask = torch.ones((b, s), dtype=torch.float32)
        mask[:, :s - s_text] = 0.0     # no loss on the image-prefix positions
        out["mask"] = mask
    if shardings is not None:
        out = {k: local_shard(v, shardings[k].spec, shardings[k].mesh)
               for k, v in out.items()}
    return {k: v.contiguous().to(device) for k, v in out.items()}
