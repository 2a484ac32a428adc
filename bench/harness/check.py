"""Whether what the timed path served is correct: the served tokens of a
sample of finished requests against the plain reference
(``bench/reference/lm.py``) run over each prompt and its served tokens.

The number compared is the widest gap, over every compared position, by
which the served token's logit lies below the reference's best logit
there (0 where the served token is the reference's argmax). The control
reads the same gap for the token that the reference computed in float8
puts first, at the same positions.

A sample: per tenant, the finished request with the most served tokens,
then others drawn from the seed until ``sample_tokens`` served tokens are
in. For an MoE the expert capacity couples the rows of one call, so the
reference is given every request that decoded beside a sampled one, each
position with the call that routed it (a prompt: its own prefill call; a
decode step: the step's batch, its row the request's slot), and the sample
is drawn from the requests that finished inside the window, while every
decode step held a full batch.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from harness.observed import Run
from harness.serve import Served
from reference.lm import final_rows, logits


def draw(run: Run, seed: int) -> List[Served]:
    spec = run.cell["check"]
    moe = run.port.get("moe") is not None
    done = [s for s in run.record.served if s.req.finished and s.tokens
            and (not moe or run.stamp(s.token_steps[-1]) <= run.end)]
    rng = np.random.default_rng([seed, 7])
    out: List[Served] = []
    for tenant in sorted({s.tenant for s in done}):
        mine = sorted((s for s in done if s.tenant == tenant),
                      key=lambda s: (-len(s.tokens), s.plan.rid))
        pick, rest = mine[:1], mine[1:]
        order = rng.permutation(len(rest))
        n = sum(len(s.tokens) for s in pick)
        for i in order:
            if n >= spec["sample_tokens"]:
                break
            pick.append(rest[i])
            n += len(rest[i].tokens)
        out.extend(pick)
    return out


def _groups(run: Run, tenant: str, last_step: int
            ) -> Tuple[List[Served], List[np.ndarray], List[np.ndarray],
                       List[int], int]:
    """Every request of ``tenant`` that a step up to ``last_step`` touched,
    with the call (group) and row of each of its positions up to there;
    and how many rows of those decode calls held no request."""
    slots = run.cell["slots"]
    reqs, grp, row, size = [], [], [], []
    step_gid: Dict[int, int] = {}
    used: Dict[int, set] = {}
    for s in run.record.served:
        if s.tenant != tenant or not s.token_steps \
                or s.token_steps[0] > last_step:
            continue
        p = s.plan.prompt.size
        dec = [st for st in s.token_steps[1:] if st <= last_step]
        g = np.empty(p + len(dec), np.int64)
        r = np.empty(p + len(dec), np.int64)
        g[:p] = len(size)
        r[:p] = np.arange(p)
        size.append(p)
        for j, st in enumerate(dec):
            if st not in step_gid:
                step_gid[st] = len(size)
                size.append(slots)
            g[p + j] = step_gid[st]
            r[p + j] = s.slot
            used.setdefault(st, set()).add(s.slot)
        reqs.append(s)
        grp.append(g)
        row.append(r)
    empty = sum(slots - len(u) for u in used.values())
    return reqs, grp, row, size, empty


def reference_rows(run: Run, weights: List[Dict], sample: List[Served],
                   quant: Optional[str] = None, log=print
                   ) -> Dict[str, torch.Tensor]:
    """rid -> the reference's final rows [n, d] at the positions that
    produced each sampled request's served tokens."""
    out: Dict[str, torch.Tensor] = {}
    for name in sorted({s.tenant for s in sample}):
        w = weights[int(name.rsplit(".", 1)[1])]
        picked = [s for s in sample if s.tenant == name]
        if run.port.get("moe") is None:
            seqs = [torch.from_numpy(np.concatenate(
                [s.plan.prompt, np.asarray(s.tokens[:-1], np.int32)])
                .astype(np.int64)) for s in picked]
            want = [torch.arange(s.plan.prompt.size - 1,
                                 s.plan.prompt.size - 1 + len(s.tokens))
                    for s in picked]
            res = final_rows(w, run.port, seqs, want, quant=quant)
            out.update({s.plan.rid: r for s, r in zip(picked, res)})
            continue
        last = max(s.token_steps[-1] for s in picked)
        reqs, grp, row, size, empty = _groups(run, name, last)
        log(f"[check] {name}: {len(reqs)} requests and {len(size)} MoE calls "
            f"up to step {last}; decode rows without a request: {empty}")
        seqs, want = [], []
        pick = {s.plan.rid for s in picked}
        for s, g in zip(reqs, grp):
            toks = np.concatenate([s.plan.prompt, np.asarray(
                s.tokens[:g.size - s.plan.prompt.size], np.int32)])
            seqs.append(torch.from_numpy(toks.astype(np.int64)))
            p = s.plan.prompt.size
            want.append(torch.arange(p - 1, p - 1 + len(s.tokens))
                        if s.plan.rid in pick else
                        torch.zeros(0, dtype=torch.long))
        res = final_rows(w, run.port, seqs, want, quant=quant, groups={
            "group": [torch.from_numpy(g) for g in grp],
            "row": [torch.from_numpy(r) for r in row],
            "size": torch.tensor(size, dtype=torch.long)})
        out.update({s.plan.rid: r for s, r in zip(reqs, res)
                    if s.plan.rid in pick})
    return out


def gaps(ref_rows: torch.Tensor, out_w: torch.Tensor, chosen=None,
         ctrl_rows: Optional[torch.Tensor] = None,
         chunk: int = 512) -> torch.Tensor:
    """Per position: the reference's best logit less its logit of the
    chosen token: the served one (``chosen``), or the one the control's
    logits (from ``ctrl_rows``, in float8) put first."""
    out = []
    for a in range(0, ref_rows.shape[0], chunk):
        ref = logits(ref_rows[a:a + chunk], out_w)
        if ctrl_rows is not None:
            c = logits(ctrl_rows[a:a + chunk], out_w, "fp8").argmax(-1)
        else:
            c = chosen[a:a + chunk].to(ref.device)
        out.append(ref.max(-1).values - ref.gather(-1, c[:, None])[:, 0])
    return torch.cat(out) if out else torch.zeros(0)


def summary(g: torch.Tensor) -> Dict[str, float]:
    """The gaps of every compared position: ``logit_gap`` the widest,
    ``logit_gap_mean`` their mean, ``logit_gap_p99`` the 99th percentile
    and ``flips`` the share of positions whose token is not the
    reference's first."""
    g = g.double()
    if g.numel() == 0:
        return {k: float("nan") for k in
                ("logit_gap", "logit_gap_mean", "logit_gap_p99", "flips")}
    return {"logit_gap": float(g.max()), "logit_gap_mean": float(g.mean()),
            "logit_gap_p99": float(torch.quantile(g, 0.99)),
            "flips": float((g > 0).double().mean())}


AT_LEAST = ("tokens_compared",)


def numbers(res: Dict, spec: Dict, events: int, prefix: str = "") -> Dict:
    """The numbers a run is judged by, each with its limit: every number of
    the cell's ``check.limits`` (read under ``prefix``: "control_" for the
    control's), the compared token count against ``check.min_tokens`` and
    the remaps, reverts and preemptions against 0."""
    out = {k: {"value": res[prefix + k], "limit": lim}
           for k, lim in spec["limits"].items()}
    out["tokens_compared"] = {"value": res["tokens"],
                              "limit": spec["min_tokens"]}
    out["remaps_reverts_preempts"] = {"value": events, "limit": 0}
    return out


def passes(nums: Dict) -> bool:
    """Every number within its limit: at most it, or at least it for the
    counts in ``AT_LEAST`` (a NaN passes neither)."""
    return all(v["value"] >= v["limit"] if k in AT_LEAST
               else v["value"] <= v["limit"] for k, v in nums.items())


def judge(run: Run, weights: List[Dict], seed: int, control: bool = False,
          log=print) -> Dict:
    """The check's numbers over the sample (``summary``), the compared
    token count and, with ``control``, the control's numbers under the
    names ``control_<name>``."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sample = draw(run, seed)
    ref = reference_rows(run, weights, sample, log=log)
    out_w = {s.tenant: weights[int(s.tenant.rsplit(".", 1)[1])]["out"]
             for s in sample}
    out_w = {k: v.float() for k, v in out_w.items()}
    g = torch.cat([gaps(ref[s.plan.rid], out_w[s.tenant],
                        torch.tensor(s.tokens)) for s in sample]) \
        if sample else torch.zeros(0)
    out = dict(summary(g), tokens=int(g.numel()), requests=len(sample),
               longest=max((len(s.tokens) for s in sample), default=0))
    log(f"[check] {len(sample)} requests, {out['tokens']} served tokens "
        f"compared (longest {out['longest']}); program "
        + ", ".join(f"{k} {out[k]!r}" for k in summary(g))
        + f"; reference {time.perf_counter() - t0:.1f} s")
    if control:
        t1 = time.perf_counter()
        q = reference_rows(run, weights, sample, quant="fp8", log=log)
        cg = torch.cat([gaps(ref[s.plan.rid], out_w[s.tenant],
                             ctrl_rows=q[s.plan.rid]) for s in sample])
        cs = summary(cg)
        out.update({f"control_{k}": v for k, v in cs.items()})
        log("[check] control (float8): " + ", ".join(
            f"{k} {v!r}" for k, v in cs.items())
            + f"; {time.perf_counter() - t1:.1f} s")
    return out
