"""The plain reference against hand-built cases at a tiny width on the
CPU: the capacity rule, which assignments a call drops, and a one-layer
model's logits against a loop written out position by position."""
import math

import torch

import benchkit  # noqa: F401
from harness import weights
from reference import lm


def test_capacity_by_hand():
    assert lm.capacity(32, 6, 64, 1.25, 8) == 9      # Poisson 3-sigma
    assert lm.capacity(128, 6, 64, 1.25, 8) == 23
    assert lm.capacity(8, 6, 64, 1.25, 8) == 8       # at most the rows
    assert lm.capacity(1000, 1, 4, 1.25, 8) == 313   # the factor


def test_kept_by_hand():
    moe = {"num_experts": 8, "capacity_factor": 1.25, "min_capacity": 2}
    # call 0: 64 rows all on expert 0 (capacity 17: rows 0-16 kept);
    # call 1: 5 rows on expert 0, listed in reverse row order (capacity 3:
    # rows 0-2 kept, whatever the order they are listed in); 3 rows of no
    # call (never dropped)
    top_e = torch.zeros(72, 1, dtype=torch.long)
    group = torch.tensor([0] * 64 + [1] * 5 + [-1] * 3)
    row = torch.tensor(list(range(64)) + [4, 3, 2, 1, 0] + [0] * 3)
    size = torch.tensor([64, 5])
    keep = lm.kept(top_e, group, row, size, moe)[:, 0]
    assert keep[:17].all() and not keep[17:64].any()
    assert keep[64:69].tolist() == [False, False, True, True, True]
    assert keep[69:].all()
    # two experts a row: a row's second choice queues behind earlier rows'
    top_e = torch.tensor([[0, 1], [1, 0], [0, 1]])
    keep = lm.kept(top_e, torch.zeros(3, dtype=torch.long),
                   torch.tensor([2, 0, 1]), torch.tensor([3]),
                   dict(moe, num_experts=2))
    assert keep.all()                                 # capacity 3 = rows


def _loop_forward(w, port, toks):
    """The same model, one position at a time, keys and values kept in
    lists, everything f32: the textbook form."""
    d, hq, hkv, hd = (port["d_model"], port["num_heads"],
                      port["num_kv_heads"], port["head_dim"])
    eps, theta = port["norm_eps"], port["rope_theta"]
    blk = w["blocks"][0]

    def norm(x, s):
        return x / math.sqrt(float((x * x).mean()) + eps) * s

    def rot(v, p):
        half = hd // 2
        out = v.clone()
        for i in range(half):
            a = p * theta ** (-i / half)
            c, s = math.cos(a), math.sin(a)
            out[..., i] = v[..., i] * c - v[..., i + half] * s
            out[..., i + half] = v[..., i + half] * c + v[..., i] * s
        return out

    ks = [[] for _ in range(port["num_layers"])]
    vs = [[] for _ in range(port["num_layers"])]
    logits = []
    for p, t in enumerate(toks):
        x = w["embed"][t].float() * math.sqrt(d)
        for li in range(port["num_layers"]):
            m = {k: v[li].float() for k, v in blk["mixer"].items()}
            h = norm(x, blk["norm1"][li])
            q = rot(torch.einsum("d,dhk->hk", h, m["wq"]), p)
            ks[li].append(rot(torch.einsum("d,dhk->hk", h, m["wk"]), p))
            vs[li].append(torch.einsum("d,dhk->hk", h, m["wv"]))
            o = torch.zeros(hq, hd)
            for head in range(hq):
                kv = head // (hq // hkv)
                sc = torch.tensor([float(q[head] @ k[kv]) / math.sqrt(hd)
                                   for k in ks[li]])
                pr = torch.softmax(sc, 0)
                o[head] = sum(pr[j] * vs[li][j][kv] for j in range(p + 1))
            x = x + torch.einsum("hk,hkd->d", o, m["wo"])
            f = {k: v[li].float() for k, v in blk["ffn"].items()}
            h = norm(x, blk["norm2"][li])
            x = x + (torch.nn.functional.silu(h @ f["w_gate"])
                     * (h @ f["w_in"])) @ f["w_out"]
        logits.append(norm(x, w["final_norm"]) @ w["out"].float())
    return torch.stack(logits)


def test_logits_against_a_loop():
    port = dict(benchkit.DENSE, num_layers=1, d_model=16, num_heads=4,
                num_kv_heads=2, head_dim=4, d_ff=24, vocab_size=32)
    w = weights.make(port, 3, 0, "cpu")
    toks = torch.tensor([5, 1, 30, 7, 7, 2])
    want = torch.arange(6)
    ref = lm.logits_at(w, port, [toks], [want])[0]
    loop = _loop_forward(w, port, toks.tolist())
    assert torch.allclose(ref, loop, atol=1e-4, rtol=1e-4)
    # the control rounds its products to float8: visibly different
    q = lm.logits_at(w, port, [toks], [want], quant="fp8")[0]
    assert (q - ref).abs().max() > 1e-3


def test_weights_same_seed_same_tree():
    port = dict(benchkit.MOE, dtype="bfloat16")
    a = weights.make(port, 2**40 + 3, 1, "cpu")
    b = weights.make(port, 2**40 + 3, 1, "cpu")
    c = weights.make(port, 2**40 + 3, 0, "cpu")
    wa, wb, wc = (weights.leaf(t, ("blocks", 0, "ffn", "w_in"))
                  for t in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert wa.dtype == torch.bfloat16
    assert abs(float(wa.float().std()) - 1 / 8) < 0.01   # 1/sqrt(64)
    assert weights.leaf(a, ("blocks", 0, "ffn", "router")).dtype \
        == torch.float32
