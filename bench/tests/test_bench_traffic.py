"""The seeded traffic generator: one seed, one set of requests; every seed
the same work in another order."""
import numpy as np
import pytest

import benchkit  # noqa: F401  (the harness's import path)
from harness import registry, traffic


def _key(reqs):
    return [(r.rid, r.tenant, r.prompt.tolist(), r.max_new, r.due, r.client)
            for r in reqs]


def test_open_loop_same_seed_same_requests():
    mix = registry.mix("two-tenant.sharegpt")
    a = traffic.open_loop(mix, 2.5, 40.0, 2**31 + 11, 49155)
    b = traffic.open_loop(mix, 2.5, 40.0, 2**31 + 11, 49155)
    assert _key(a) == _key(b)


@pytest.mark.parametrize("mix_name", ["two-tenant.sharegpt"])
def test_open_loop_seeds_share_the_work(mix_name):
    mix = registry.mix(mix_name)
    a = traffic.open_loop(mix, 2.5, 40.0, 1, 49155)
    b = traffic.open_loop(mix, 2.5, 40.0, 987654321987, 49155)
    assert len(a) == len(b) == 100
    assert sorted(r.prompt.size for r in a) == sorted(r.prompt.size for r in b)
    assert sorted(r.max_new for r in a) == sorted(r.max_new for r in b)
    gaps = lambda rs: sorted(np.round(np.diff([0.0] + [r.due for r in rs]), 9))
    assert gaps(a) == gaps(b)
    assert [r.prompt.size for r in a] != [r.prompt.size for r in b]
    assert all(0 < r.due < 40.0 for r in a)
    assert sum(r.tenant == 0 for r in a) == 75
    lo, hi = mix["prompt_tokens"]["min"], mix["prompt_tokens"]["max"]
    assert all(lo <= r.prompt.size <= hi for r in a)
    assert all(0 <= int(r.prompt.max()) < 49155 for r in a)


def test_closed_loop_clients():
    mix = registry.mix("decode-heavy")
    a = traffic.closed_loop(mix, 77, 163840)
    b = traffic.closed_loop(mix, 77, 163840)
    c = traffic.closed_loop(mix, 78, 163840)
    assert len(a) == mix["clients"]
    assert all(len(q) == mix["requests_per_client"] for q in a)
    assert [_key(q) for q in a] == [_key(q) for q in b]
    flat = lambda qs: sorted(r.max_new for q in qs for r in q)
    assert flat(a) == flat(c)
    assert all(r.client == i for i, q in enumerate(a) for r in q)


def test_lengths_are_the_distributions_quantiles():
    spec = {"dist": "lognormal", "mean": 100, "sigma": 0.5, "min": 1,
            "max": 10**6}
    v = traffic.lengths(spec, 20001)
    # the median of a lognormal is exp(mu); its mean is the spec's
    assert abs(np.median(v) - 100 * np.exp(-0.125)) <= 1
    assert abs(v.mean() - 100) < 1.0
    assert list(traffic.shares([3, 1], 10)) == [0] * 8 + [1] * 2
    g = traffic.exp_gaps(2.0, 10001)
    assert abs(g.mean() - 0.5) < 0.01


def test_open_loop_arrivals_bunch_as_poisson():
    """Arrivals per second of the window are as dispersed as a Poisson
    process's (variance over mean about 1; a smoothed order reads far
    less), and each seed holds its longest prompts in another place."""
    mix = registry.mix("two-tenant.sharegpt")
    counts, first_long = [], set()
    for seed in range(40):
        reqs = traffic.open_loop(mix, 3.2, 51.0, 2**31 + seed, 49155)
        counts.extend(np.histogram([r.due for r in reqs], bins=51,
                                   range=(0.0, 51.0))[0])
        first_long.add(max(range(len(reqs)),
                           key=lambda i: reqs[i].prompt.size))
    counts = np.asarray(counts, np.float64)
    assert 0.8 < counts.var() / counts.mean() < 1.2
    assert len(first_long) > 20


def test_committed_mixes_ask_for_what_is_implemented():
    for w in registry.benchmark()["workloads"]:
        traffic.check_mix(registry.mix(w["traffic"]))


@pytest.mark.parametrize("change", [
    {"arrivals": "gamma"}, {"arrivals": None}, {"order_block": 8},
    {"think_s": 0.0}, {"loop": "ramp"},
    {"prompt_tokens": {"dist": "uniform", "mean": 415, "sigma": 0.9,
                       "min": 16, "max": 1536}}])
def test_open_mix_with_what_is_not_implemented_fails(change):
    mix = dict(registry.mix("two-tenant.sharegpt"), **change)
    with pytest.raises(ValueError):
        traffic.open_loop(mix, 3.2, 51.0, 1, 49155)


@pytest.mark.parametrize("change", [{"think_s": 0.5}, {"arrivals": "poisson"},
                                    {"burst": 2}])
def test_closed_mix_with_what_is_not_implemented_fails(change):
    mix = dict(registry.mix("decode-heavy"), **change)
    with pytest.raises(ValueError):
        traffic.closed_loop(mix, 1, 163840)
