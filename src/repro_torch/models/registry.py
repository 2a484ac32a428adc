"""Model facade over the port's LM and EncDec, and the weight bridge from
the JAX package's parameter tree."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import (
    get_mesh, local_shard, num_data_shards,
)
from repro_torch.models.common import (
    Spec, dtype_of, tree_map, tree_shardings,
)
from repro_torch.models.encdec import EncDec
from repro_torch.models.lm import LM

WHISPER_DECODER_LEN = 448   # decoder-side target length for train/prefill


class Model:
    """Dispatches to LM or EncDec, as the JAX facade does."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.impl = EncDec(cfg) if cfg.is_encoder_decoder else LM(cfg)

    def specs(self):
        return self.impl.specs()

    def init(self, generator: torch.Generator, device="cuda", mesh=None):
        """The parameters drawn from ``generator`` on ``device``. With a
        ``mesh``, each leaf is drawn whole in the same order (so the values
        equal one rank's ``init`` at the same seed) and only the rank's
        block under ``param_shardings(mesh)`` is kept: the peak is one full
        leaf."""
        if mesh is None:
            return self.impl.init(generator, device)
        return tree_map(
            lambda spec, sh: local_shard(
                spec.materialize(generator, device), sh.spec, mesh),
            self.specs(), self.param_shardings(mesh))

    def param_shardings(self, mesh, rules=None):
        """The ``NamedSharding`` of every parameter on ``mesh`` under
        ``rules`` (default: the ambient context's), the train profile's
        FSDP x TP placement with the divisibility fallback."""
        return tree_shardings(self.specs(), mesh, rules)

    @property
    def repeats(self) -> int:
        return self.impl.repeats

    # ------------------------------------------------------------------ train
    def train_loss(self, params, batch, remat_policy: str = "dots_saveable",
                   batch_shardings=None):
        """The training objective of one batch (``training.batch_for_step``'s
        keys): the mean masked next-token cross-entropy plus 0.01 x the MoE
        load-balance loss, a scalar, as the JAX facade's ``train_loss``.
        Under a mesh (``mesh_context``) ``params`` and ``batch`` are the
        rank's blocks and the loss is the global batch's: ``batch`` is
        placed by ``launch.shardings.batch_shardings``, which refuses an MoE
        config's batch that the data shards do not divide. An enc-dec
        config needs that placement here as ``batch_shardings``: its
        encoder gathers the frames over the axes that split their
        sequence."""
        mesh = get_mesh()
        if self.cfg.is_encoder_decoder:
            frames_axes = ()
            if mesh is not None:
                if batch_shardings is None:
                    raise ValueError(
                        f"{self.cfg.name}: an enc-dec batch over a mesh needs "
                        "its shardings (launch.shardings.batch_shardings): "
                        "the encoder gathers the frames over the axes that "
                        "split their sequence")
                frames_axes = batch_shardings["frames"].axes(1)
            return self.impl.loss(params, batch["frames"], batch["tokens"],
                                  batch["targets"], batch["mask"],
                                  remat_policy=remat_policy, mesh=mesh,
                                  frames_axes=frames_axes)
        x = self.impl.embed(params, batch["tokens"],
                            batch.get("patch_embeds"), mesh=mesh)
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
        x, aux, _ = self.impl.fwd_seq(
            params, x, {"positions": positions, "mesh": mesh},
            remat_policy=remat_policy)
        loss = self.impl.token_loss(params, x, batch["targets"],
                                    batch["mask"], mesh=mesh)
        return loss + 0.01 * aux

    # ---------------------------------------------------------------- serving
    def prefill(self, params, batch, max_context: int):
        """``batch``: "tokens" [B, S]; an enc-dec config's "frames" [B,
        S_enc, D]; a VLM's optional "patch_embeds" [B, P, D] and
        "lengths" [B]."""
        if self.cfg.is_encoder_decoder:
            return self.impl.prefill(params, batch["frames"], batch["tokens"],
                                     max_context)
        return self.impl.prefill(params, batch["tokens"], max_context,
                                 prefix_embeds=batch.get("patch_embeds"),
                                 lengths=batch.get("lengths"))

    def decode_step(self, params, state, tokens, max_context: int,
                    fetch=None):
        return self.impl.decode_step(params, state, tokens, max_context,
                                     fetch=fetch)

    def decode_state_specs(self, batch: int, max_context: int):
        return self.impl.decode_state_specs(batch, max_context)

    def init_decode_state(self, batch: int, max_context: int, device="cuda"):
        return self.impl.init_decode_state(batch, max_context, device)

    # ------------------------------------------------------------ input specs
    def batch_shardings(self, shape: ShapeConfig, mesh, rules=None):
        """Each train input's ``NamedSharding`` on ``mesh`` under ``rules``:
        its batch dim over the data axes where they divide it, else kept
        whole (``spec_for``'s fallback). An MoE config raises ``ValueError``
        for a batch that is not split over every data axis: its token
        groups (``blocks.MoE.route``) read a rank's rows as its block of
        the global batch."""
        out = tree_shardings(self.input_spec_tree(shape), mesh, rules)
        b = shape.global_batch
        shards = num_data_shards(mesh)
        if self.cfg.moe is not None and \
                out["tokens"].local_shape((b,))[0] * shards != b:
            raise ValueError(
                f"{self.cfg.name}: an MoE config over a mesh needs a global "
                f"batch split over its {shards} data shards (got {b} rows)")
        return out

    def input_spec_tree(self, shape: ShapeConfig):
        """Spec tree of a train batch, the reference's: the batch dim is
        logical "batch" (``launch.shardings.batch_shardings`` splits it
        over the data axes); an enc-dec config's frames [B, S, D] split
        their sequence as "seq_cp", beside decoder tokens, targets and mask
        of ``WHISPER_DECODER_LEN``; a VLM's patch embeddings [B, P, D] (P =
        min(patches, S - 1)) come ahead of S - P tokens, with targets and
        mask over all S positions."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        dt = dtype_of(cfg)

        def tok(n):
            return Spec((b, n), ("batch", None), torch.int32, "zeros")

        def ones(n):
            return Spec((b, n), ("batch", None), torch.float32, "ones")
        if cfg.is_encoder_decoder:
            n = WHISPER_DECODER_LEN
            return {"frames": Spec((b, s, cfg.d_model),
                                   ("batch", "seq_cp", None), dt, "normal"),
                    "tokens": tok(n), "targets": tok(n), "mask": ones(n)}
        out = {}
        s_text = s
        if cfg.num_image_patches:
            p = min(cfg.num_image_patches, s - 1)
            s_text = s - p
            out["patch_embeds"] = Spec((b, p, cfg.d_model),
                                       ("batch", None, None), dt, "normal")
        out.update(tokens=tok(s_text), targets=tok(s), mask=ones(s))
        return out

    @staticmethod
    def insert_slot(state, slot: int, new_state):
        """Insert a batch=1 prefill state into batch slot ``slot``, in place
        (the JAX facade returns a new state); returns ``state``.

        Layout-aware: ``blocks`` leaves are stacked [R, B, ...] (batch is
        dim 1); every other state leaf is batch-major [B, ...].
        """
        for key, val in state.items():
            if key == "blocks":
                tree_map(lambda d, s: d[:, slot].copy_(s[:, 0]), val,
                         new_state[key])
            else:
                tree_map(lambda d, s: d[slot].copy_(s[0]), val,
                         new_state[key])
        return state


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes bf16: same bits, as int16
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device)


def params_from_jax(tree: Any, device="cuda") -> Any:
    """The JAX params tree (nested dicts/tuples whose leaves are arrays,
    e.g. after ``jax.tree.map(np.asarray, params)``) as the port's params:
    leaf by leaf, same structure, same layout, same dtype, on ``device``."""
    return tree_map(lambda a: _to_torch(a, device), tree)


def opt_state_from_jax(state: Any, device="cuda") -> Any:
    """A JAX optimizer state (AdamW's {"mu", "nu", "step"}, Adafactor's
    {"v", "step"}, as numpy leaves) as the port's optimizer state: the
    moment trees leaf by leaf as ``params_from_jax`` converts params, the
    step an int32 scalar tensor."""
    if "step" not in state:
        raise ValueError(f"not an optimizer state: keys {sorted(state)}")
    return params_from_jax(state, device)
