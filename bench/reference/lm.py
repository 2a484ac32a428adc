"""Plain PyTorch reference of the served decoder, written from the published
equations and not from the port: f32 throughout with TF32 off, no kernels,
no cache, no batching across sequences except where the MoE's capacity
couples the rows of one call.

The model: token embedding times sqrt(d); per layer, x += Attn(RMSNorm(x))
with RoPE (the rotate-half form) on q and k, grouped-query heads and causal
softmax attention scaled by 1/sqrt(head_dim); x += FFN(RMSNorm(x)), the FFN
a SwiGLU (silu(x Wg) * (x Wi)) Wo or a mixture of such experts: softmax
router, top-k, weights renormalised over the k, and GShard capacity: in
each group of rows that one call routes together, an expert takes its
assignments in row order (a row's k in descending probability) up to its
capacity and drops the rest; finally RMSNorm and the output matrix.

The weights are the benchmark's tree (leaf names and layouts as
``bench/harness/weights.py`` makes them). Every K/V, routing and logit is
worked out here again from the tokens.

``quant="fp8"`` is the control: every matrix product of the layers and the
logits takes its operands rounded to float8 e4m3 (a scale per row of the
activations and per output column of the weights) and multiplies them in
f32; the router and attention's own products stay f32.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

F8_MAX = 448.0


def _q8(t: torch.Tensor, dim: int) -> torch.Tensor:
    s = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / F8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def _mm(a: torch.Tensor, w: torch.Tensor, quant: Optional[str]):
    """a [N, K] f32 times w [K, M] f32."""
    if quant == "fp8":
        return _q8(a, -1) @ _q8(w, 0)
    if quant is not None:
        raise ValueError(f"quant {quant!r}: None or 'fp8'")
    return a @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, H, D], pos [S]: rotate-half RoPE."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = pos.float()[:, None, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v):
    """Causal attention of one sequence: q [S, Hq, D], k/v [S, Hkv, D]."""
    s, hq, d = q.shape
    g = hq // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    sc = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(d)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    sc = sc.masked_fill(~mask, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(sc, dim=-1), v)


def capacity(t: int, top_k: int, experts: int, factor: float,
             floor: int) -> int:
    """Slots an expert has in a call routing ``t`` rows: the GShard
    capacity ceil(factor * t k / E), raised to a floor and to the Poisson
    mean plus three standard deviations, and at most t."""
    lam = t * top_k / experts
    c = math.ceil(lam * factor)
    c3 = math.ceil(lam + 3.0 * math.sqrt(max(lam, 1e-9)))
    return min(t, max(c, c3, floor))


def kept(top_e: torch.Tensor, group: torch.Tensor, row: torch.Tensor,
         size: torch.Tensor, moe: Dict) -> torch.Tensor:
    """Which assignments survive capacity. top_e [N, k] (each row's experts
    in descending probability); group [N]: the call that routed the row
    (-1: a call of its own, which drops nothing); row [N]: its row in
    that call; size [G]: the rows each call routed. Returns a bool [N, k]."""
    n, k = top_e.shape
    e = moe["num_experts"]
    keep = torch.ones(n, k, dtype=torch.bool, device=top_e.device)
    sel = group >= 0
    if not bool(sel.any()):
        return keep
    caps = torch.tensor([capacity(int(s), k, e, moe["capacity_factor"],
                                  moe["min_capacity"]) for s in size.tolist()],
                        dtype=torch.long, device=top_e.device)
    g = group[sel].long()[:, None].expand(-1, k).reshape(-1)
    flat = (row[sel].long()[:, None] * k + torch.arange(
        k, device=top_e.device)).reshape(-1)
    ex = top_e[sel].long().reshape(-1)
    span = int(flat.max()) + 1
    key = (g * e + ex) * span + flat
    order = torch.argsort(key)
    primary = (g * e + ex)[order]
    idx = torch.arange(primary.numel(), device=top_e.device)
    start = torch.zeros_like(idx)
    new = torch.ones_like(primary, dtype=torch.bool)
    new[1:] = primary[1:] != primary[:-1]
    start[new] = idx[new]
    start = torch.cummax(start, dim=0).values
    pos = torch.empty_like(idx)
    pos[order] = idx - start
    keep[sel] = (pos < caps[g]).view(-1, k)
    return keep


def moe_ffn(h, p: Dict, moe: Dict, group, row, size, quant):
    """h [N, d] -> [N, d]: the routed experts of every row."""
    probs = torch.softmax(h @ p["router"], dim=-1)
    top_p, top_e = torch.topk(probs, moe["top_k"], dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    keep = kept(top_e, group, row, size, moe)
    out = torch.zeros_like(h)
    for e in range(moe["num_experts"]):
        tok, j = torch.nonzero((top_e == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        x = h[tok]
        w_in = p["w_in"][e].float()
        w_gate = p["w_gate"][e].float()
        w_out = p["w_out"][e].float()
        y = _mm(torch.nn.functional.silu(_mm(x, w_gate, quant))
                * _mm(x, w_in, quant), w_out, quant)
        out.index_add_(0, tok, y * top_p[tok, j][:, None])
    return out


def final_rows(weights: Dict, port: Dict, seqs: Sequence[torch.Tensor],
               want: Sequence[torch.Tensor], groups: Optional[Dict] = None,
               quant: Optional[str] = None) -> List[torch.Tensor]:
    """The final normalised hidden rows [len(want[i]), d] (f32) at positions
    ``want[i]`` of each token sequence ``seqs[i]`` (int64), each sequence
    read causally from its start; ``logits`` turns them into logits.

    ``groups``: for an MoE, {"group": [per sequence, int64 [len]], "row":
    [likewise], "size": int64 [G]}, the call that routed each position,
    its row there and each call's row count; positions of group -1 route
    alone. None: every position alone (no drops)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _forward(weights, port, seqs, want, groups, quant)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def logits(rows: torch.Tensor, out_w: torch.Tensor,
           quant: Optional[str] = None) -> torch.Tensor:
    """rows [n, d] (``final_rows``) times the output matrix (f32) [d, V]."""
    return _mm(rows, out_w, quant)


def logits_at(weights: Dict, port: Dict, seqs, want, groups=None,
              quant: Optional[str] = None) -> List[torch.Tensor]:
    """``final_rows`` and their logits [len(want[i]), V]."""
    out_w = weights["out"].float()
    return [logits(r, out_w, quant)
            for r in final_rows(weights, port, seqs, want, groups, quant)]


@torch.no_grad()
def _forward(weights, port, seqs, want, groups, quant):
    d, hq, hkv, hd = (port["d_model"], port["num_heads"],
                      port["num_kv_heads"], port["head_dim"])
    eps, theta, moe = port["norm_eps"], port["rope_theta"], port.get("moe")
    dev = weights["embed"].device
    lens = [int(s.numel()) for s in seqs]
    offs = [0]
    for n in lens:
        offs.append(offs[-1] + n)
    tokens = torch.cat([s.to(dev) for s in seqs])
    pos = torch.cat([torch.arange(n, device=dev) for n in lens])
    x = weights["embed"][tokens].float() * math.sqrt(d)
    if moe is not None:
        if groups is None:
            group = torch.full((x.shape[0],), -1, dtype=torch.long, device=dev)
            row = torch.zeros_like(group)
            size = torch.zeros(0, dtype=torch.long, device=dev)
        else:
            group = torch.cat([g.to(dev) for g in groups["group"]])
            row = torch.cat([r.to(dev) for r in groups["row"]])
            size = groups["size"].to(dev)
    blk = weights["blocks"][0]
    for li in range(port["num_layers"]):
        m = {k: v[li].float() for k, v in blk["mixer"].items()}
        h = rms_norm(x, blk["norm1"][li].float(), eps)
        q = _mm(h, m["wq"].reshape(d, -1), quant).view(-1, hq, hd)
        k = _mm(h, m["wk"].reshape(d, -1), quant).view(-1, hkv, hd)
        v = _mm(h, m["wv"].reshape(d, -1), quant).view(-1, hkv, hd)
        q, k = rope(q, pos, theta), rope(k, pos, theta)
        o = torch.cat([attention(q[a:b], k[a:b], v[a:b])
                       for a, b in zip(offs, offs[1:])])
        x = x + _mm(o.reshape(-1, hq * hd), m["wo"].reshape(hq * hd, d),
                    quant)
        del q, k, v, o, m
        h = rms_norm(x, blk["norm2"][li].float(), eps)
        f = blk["ffn"]
        if moe is not None:
            p = {"router": f["router"][li].float(), "w_in": f["w_in"][li],
                 "w_gate": f["w_gate"][li], "w_out": f["w_out"][li]}
            x = x + moe_ffn(h, p, moe, group, row, size, quant)
        else:
            w_in, w_gate, w_out = (f[n][li].float()
                                   for n in ("w_in", "w_gate", "w_out"))
            x = x + _mm(torch.nn.functional.silu(_mm(h, w_gate, quant))
                        * _mm(h, w_in, quant), w_out, quant)
            del w_in, w_gate, w_out
    fin = weights["final_norm"].float()
    return [rms_norm(x[offs[i] + w.to(dev)], fin, eps)
            for i, w in enumerate(want)]
