"""Checkpointing with the on-disk layout of ``repro.training.checkpoint``.

Layout: <dir>/step_<N>/manifest.json + one .npy per leaf, named
``leaf_<i>.npy`` in the JAX package's flattening order (dict keys sorted)
and keyed in the manifest by the same path strings ("blocks/[0]/ffn/w_in"),
written into ``step_<N>.tmp`` and renamed into place; the three newest
steps are kept. So either package restores what the other wrote.

A bf16 leaf is written as the JAX package writes it: its 2-byte payload
under a '<V2' header, with dtype "bfloat16" in the manifest. It is read
back by the manifest's dtype, the raw payload viewed as ``torch.bfloat16``
(no ``ml_dtypes`` needed). The reference's own ``restore`` cannot read such
a leaf (``jax.numpy.asarray`` refuses '|V2'; ROADMAP queue 3). ``restore``
places each leaf on ``device`` (default: the target leaf's device).

Over a mesh (``shardings``: a ``NamedSharding`` per leaf, the tree the
rank's blocks) ``save`` gathers each leaf whole, one at a time, and rank 0
alone writes: the files are those a one-rank save of the same values
writes. ``restore`` with shardings (of this mesh or of another: the elastic
path) reads each leaf whole and keeps the rank's block.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import gather_full, local_shard

_BF16_DESCR = "<V2"


def _paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key path, leaf) in the JAX flattening order: dict keys sorted,
    sequence items in order, "[i]" for a sequence index."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree)
                for kv in _paths(v, f"{prefix}[{i}]/")]
    return [(prefix[:-1], tree)]


def _map_paths(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """fn(key path, leaf) over the tree, keeping its structure."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [_map_paths(fn, v, f"{prefix}[{i}]/")
               for i, v in enumerate(tree)]
        return tuple(out) if isinstance(tree, tuple) else out
    return fn(prefix[:-1], tree)


def _write_leaf(path: str, t: torch.Tensor) -> Tuple[list, str]:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        raw = t.contiguous().view(torch.int16).numpy()
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(f, {
                "descr": _BF16_DESCR, "fortran_order": False,
                "shape": tuple(raw.shape)})
            f.write(raw.tobytes())
        return list(raw.shape), "bfloat16"
    arr = t.numpy()
    np.save(path, arr)
    return list(arr.shape), str(arr.dtype)


def _read_leaf(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(ckpt_dir: str, step: int, tree, extra: Optional[Dict] = None,
         shardings=None) -> str:
    """Write ``tree`` as step ``step``. With ``shardings`` every rank of
    the mesh calls this (the gathers are collectives); rank 0 writes, and
    no rank returns before the step is in place."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = path + ".tmp"
    writer = shardings is None or dist.get_rank() == 0
    if writer:
        os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    sh = [None] * len(_paths(tree)) if shardings is None else \
        [s for _, s in _paths(shardings)]
    for i, ((key, leaf), s) in enumerate(zip(_paths(tree), sh)):
        if s is not None:
            leaf = gather_full(leaf, s.spec, s.mesh)
        if not writer:
            continue
        fname = f"leaf_{i:05d}.npy"
        shape, dtype = _write_leaf(os.path.join(tmp, fname), leaf)
        manifest["leaves"].append(
            {"key": key, "file": fname, "shape": shape, "dtype": dtype})
    if writer:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(path):      # atomic-ish replace
            shutil.rmtree(path)
        os.rename(tmp, path)
        _gc(ckpt_dir, keep=3)
    if shardings is not None:
        dist.barrier()
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, target_tree, device=None,
            shardings=None) -> Tuple[Any, Dict]:
    """Rebuild ``target_tree``'s structure (a tree of tensors) from disk,
    each leaf with the stored dtype and the target leaf's shape, on
    ``device`` (default: the target leaf's). With ``shardings`` (same
    structure) the target holds the rank's blocks under them: each leaf is
    read whole and cut to the block. Returns (tree, extra)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {leaf["key"]: leaf for leaf in manifest["leaves"]}
    sh = {} if shardings is None else dict(_paths(shardings))

    def load(key, like):
        meta = by_key[key]
        t = _read_leaf(os.path.join(path, meta["file"]), meta["dtype"])
        if key in sh:
            t = local_shard(t, sh[key].spec, sh[key].mesh)
        assert list(t.shape) == list(like.shape), (key, t.shape, like.shape)
        return t.to(like.device if device is None else device)
    return _map_paths(load, target_tree), manifest["extra"]


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(int(m.group(1)) for d in os.listdir(ckpt_dir)
                   if (m := re.fullmatch(r"step_(\d+)", d)))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
