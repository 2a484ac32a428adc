"""One generator for every traffic mix: a mix is a JSON file of parameters
(``bench/traffic/<name>.json``), and this module turns it and a seed into
requests.

Every seed gets the same work in another order. The lengths are the
quantiles of the mix's distribution at n evenly spaced probabilities (so the
multiset of prompt and output lengths is fixed by the mix and the request
count), an open loop's gaps between arrivals are the quantiles of the
exponential distribution of its rate, and the tenant shares are exact. The
seed draws a free order of each (a uniform permutation, independent of the
others) and the token ids. A free order of exponential gaps is a Poisson
process held to its count in the window: arrivals bunch and thin out as
they do in one, and no seed carries more or less work than another.

A mix key the generator does not implement is an error (``check_mix``), so
a mix that asks for what it cannot give fails before any run.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Dict, List, Sequence

import numpy as np

LENGTH_KEYS = {"dist", "mean", "sigma", "min", "max"}
COMMON_KEYS = {"name", "loop", "tenant_shares", "prompt_tokens",
               "output_tokens", "source", "why"}
LOOP_KEYS = {"open": {"arrivals"},
             "closed": {"clients", "requests_per_client", "think_s"}}


@dataclasses.dataclass
class Planned:
    """One request as the generator plans it. ``due``: seconds after the
    window opens (open loop); ``client``: the closed-loop caller that sends
    it, -1 in an open loop."""
    rid: str
    tenant: int
    prompt: np.ndarray
    max_new: int
    due: float = 0.0
    client: int = -1


def check_mix(mix: Dict) -> None:
    """A ValueError unless ``mix`` asks only for what this module
    implements: an open loop's ``arrivals`` "poisson", a closed loop's
    ``think_s`` 0, lognormal lengths, and no other key."""
    loop = mix.get("loop")
    if loop not in LOOP_KEYS:
        raise ValueError(f"mix {mix.get('name')!r}: loop {loop!r}, "
                         f"not one of {sorted(LOOP_KEYS)}")
    extra = set(mix) - COMMON_KEYS - LOOP_KEYS[loop]
    if extra:
        raise ValueError(f"mix {mix['name']!r}: keys the generator does not "
                         f"implement: {sorted(extra)}")
    if loop == "open" and mix.get("arrivals") != "poisson":
        raise ValueError(f"mix {mix['name']!r}: arrivals "
                         f"{mix.get('arrivals')!r}; only 'poisson' is "
                         f"implemented")
    if loop == "closed" and float(mix.get("think_s", 0.0)) != 0.0:
        raise ValueError(f"mix {mix['name']!r}: think_s {mix['think_s']!r}; "
                         f"only 0 (send on the reply) is implemented")
    for key in ("prompt_tokens", "output_tokens"):
        spec = mix[key]
        if set(spec) != LENGTH_KEYS or spec["dist"] != "lognormal":
            raise ValueError(f"mix {mix['name']!r}: {key} {spec!r}; a "
                             f"lognormal with keys {sorted(LENGTH_KEYS)}")


def lengths(spec: Dict, n: int) -> np.ndarray:
    """The n quantiles of ``spec``'s length distribution at the
    probabilities (i + 0.5) / n, clipped to [min, max], in ascending
    order. ``lognormal``: ``mean`` is the mean of the unclipped
    distribution, ``sigma`` the standard deviation of its log."""
    if spec["dist"] != "lognormal":
        raise ValueError(f"length distribution {spec['dist']!r}: lognormal")
    sigma = float(spec["sigma"])
    mu = math.log(float(spec["mean"])) - sigma ** 2 / 2
    nd = NormalDist()
    vals = [math.exp(mu + sigma * nd.inv_cdf((i + 0.5) / n))
            for i in range(n)]
    return np.clip(np.asarray(vals).astype(np.int64), int(spec["min"]),
                   int(spec["max"]))


def exp_gaps(rate: float, n: int) -> np.ndarray:
    """The n quantiles of the exponential distribution of ``rate``."""
    p = (np.arange(n) + 0.5) / n
    return -np.log1p(-p) / rate


def shares(weights: Sequence[float], n: int) -> np.ndarray:
    """Tenant indices of n requests in the proportions ``weights``
    (largest remainders), tenant 0 first."""
    w = np.asarray(weights, np.float64)
    raw = w / w.sum() * n
    counts = np.floor(raw).astype(np.int64)
    for i in np.argsort(-(raw - counts), kind="stable")[:n - counts.sum()]:
        counts[i] += 1
    return np.repeat(np.arange(len(w)), counts)


def _requests(rng, mix: Dict, n: int, vocab: int) -> List[Planned]:
    p_len = rng.permutation(lengths(mix["prompt_tokens"], n))
    o_len = rng.permutation(lengths(mix["output_tokens"], n))
    tenant = rng.permutation(shares(mix.get("tenant_shares", [1]), n))
    return [Planned(f"r{i}", int(tenant[i]),
                    rng.integers(0, vocab, int(p_len[i]), dtype=np.int64)
                    .astype(np.int32), int(o_len[i])) for i in range(n)]


def open_loop(mix: Dict, rate: float, seconds: float, seed: int,
              vocab: int) -> List[Planned]:
    """The requests due in a window of ``seconds`` at ``rate`` per second:
    n = round(rate * seconds) of them, their gaps the exponential quantiles
    in the seed's free order, scaled so that the n gaps and one mean gap
    more fill the window exactly."""
    check_mix(mix)
    n = max(int(round(rate * seconds)), 1)
    rng = np.random.default_rng(seed)
    gaps = rng.permutation(exp_gaps(rate, n))
    due = np.cumsum(gaps) * (seconds / (gaps.sum() + gaps.mean()))
    reqs = _requests(rng, mix, n, vocab)
    for r, t in zip(reqs, due):
        r.due = float(t)
    return reqs


def closed_loop(mix: Dict, seed: int, vocab: int) -> List[List[Planned]]:
    """Each client's queue of requests: ``clients`` x ``requests_per_client``
    requests, dealt to the clients in turn in the seed's order."""
    check_mix(mix)
    c, k = int(mix["clients"]), int(mix["requests_per_client"])
    reqs = _requests(np.random.default_rng(seed), mix, c * k, vocab)
    out: List[List[Planned]] = [[] for _ in range(c)]
    for i, r in enumerate(reqs):
        r.client = i % c
        out[i % c].append(r)
    return out
