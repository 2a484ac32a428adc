"""Drive the port's serving engine by the wall clock.

The engine keeps a step clock (each request's ``token_times`` are step
indices); this module stamps the host time at the start and the end of
every ``ServingEngine.step()`` (after a device synchronise) and maps the
step indices onto those stamps. Requests enter through ``submit()`` when
they are due (open loop) or when their client's previous reply finished
(closed loop); the engine is advanced by ``step()`` and nothing else.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from contextlib import nullcontext
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from harness.traffic import Planned

SPANS = ("_admit", "_prefill", "_decode", "_memory_control")


@dataclasses.dataclass
class Step:
    idx: int            # the engine's step index
    t0: float           # seconds from the window's start
    t1: float
    prefills: int = 0
    profiled: bool = False
    pages_used: int = 0   # the allocator's pages in use after the step


@dataclasses.dataclass
class Served:
    """One request as the harness saw it."""
    plan: Planned
    tenant: str
    sent: float                       # seconds from the window's start
    in_window: bool
    req: object = None                # the engine's Request
    slot: int = -1
    prefill_step: int = -1

    @property
    def token_steps(self) -> List[int]:
        return [int(s) for s in self.req.token_times]

    @property
    def tokens(self) -> List[int]:
        return list(self.req.generated)


@dataclasses.dataclass
class Record:
    steps: List[Step]
    served: List[Served]
    window_s: float
    closed_at: float                  # seconds from the window's start
    drain_s: float
    events: List[tuple]
    lateness: List[float]
    captures_in_window: int
    queue_samples: List[tuple]        # (t, requests submitted not yet admitted)
    step_at: Dict[int, Step] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.step_at = {s.idx: s for s in self.steps}

    def stamp(self, step_idx: int) -> float:
        return self.step_at[step_idx].t1


class WallClock:
    """The host's clock: ``now()`` in seconds, ``sleep(s)`` waits. The
    tests drive a run with a clock that counts instead (``drive``'s
    ``clock``)."""
    now = staticmethod(time.perf_counter)
    sleep = staticmethod(time.sleep)


def tenant_names(cell: Dict) -> List[str]:
    return [f"{cell['config']}.{i}" for i in range(cell["tenants"])]


def pool_bytes(engine) -> int:
    """Bytes of every paged tenant's K/V pool on the device."""
    return sum(t.state[k].numel() * t.state[k].element_size()
               for t in engine.tenants.values() if t.paged
               for k in ("pool_k", "pool_v"))


def model_config(port: Dict):
    from repro_torch.configs.base import ModelConfig, MoEConfig
    kw = dict(port)
    moe = kw.pop("moe")
    return ModelConfig(moe=MoEConfig(**moe) if moe else None, **kw)


def check_layout(cfg, tree) -> None:
    """The benchmark's weight tree against the port's specs: same paths,
    shapes and dtypes, or a ValueError."""
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    specs = build_model(cfg).specs()
    bad = []

    def cmp(s, t):
        if tuple(t.shape) != tuple(s.shape) or t.dtype != s.dtype:
            bad.append((tuple(s.shape), s.dtype, tuple(t.shape), t.dtype))
    try:
        tree_map(cmp, specs, tree)
    except (KeyError, IndexError, TypeError) as e:
        raise ValueError(f"weight tree differs from the port's specs: {e!r}")
    if bad:
        raise ValueError(f"weight leaves differ from the port's specs: {bad}")


def build_engine(cell: Dict, port: Dict, params: List[Dict], device):
    from repro_torch.serving import ServingEngine, TenantConfig
    cfg = model_config(port)
    names = tenant_names(cell)
    for tree in params:
        check_layout(cfg, tree)
    eng = cell["engine"]
    return ServingEngine(
        {n: TenantConfig(cfg, p, max_batch=cell["slots"],
                         max_context=cell["max_context"], paged=True)
         for n, p in zip(names, params)},
        mode=eng["mode"], scheduler=eng["scheduler"],
        base_kv_pages=cell["pool_pages"], page_size=cell["page_size"],
        prefill_chunk_tokens=eng["prefill_chunk_tokens"], device=device,
        decode_graphs=eng["decode_graphs"])


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def warm_up(engine, cell: Dict, vocab: int, device) -> None:
    """The cell's own shapes: one prefill and a few decode steps a tenant,
    which capture each tenant's decode graph (its key is fixed for the
    cell: batch, page-table width and pools never change), then idle."""
    from repro_torch.serving.request import Request
    w = cell["warm_up"]
    rng = np.random.default_rng(0)
    reqs = [Request(rid=f"warm-{n}", model=n,
                    prompt=rng.integers(0, vocab, w["prompt"]).astype(
                        np.int32), max_new_tokens=w["new"], arrival=0.0)
            for n in tenant_names(cell)]
    engine.submit(reqs)
    while engine.busy():
        engine.step()
    sync(device)


def captures(engine) -> int:
    return sum(s["captures"] for s in engine.graph_stats("decode").values())


class _Spans:
    """Profiler spans around the engine's layer calls (admission, prefill,
    decode, memory control), put on the instance for a traced run only."""

    def __init__(self, engine, on: bool):
        self.engine, self.on = engine, on

    def __enter__(self):
        if self.on:
            for name in SPANS:
                fn = getattr(self.engine, name)
                setattr(self.engine, name, self._wrap(name, fn))
        return self

    @staticmethod
    def _wrap(name, fn):
        def wrapped(*a, **k):
            with torch.profiler.record_function(f"engine.{name.strip('_')}"):
                return fn(*a, **k)
        return wrapped

    def __exit__(self, *exc):
        if self.on:
            for name in SPANS:
                self.engine.__dict__.pop(name, None)


def span(on: bool, name: str):
    return torch.profiler.record_function(f"bench.{name}") if on \
        else nullcontext()


def drive(engine, cell: Dict, mix: Dict, plans, seconds: float, device,
          profiler: Optional[Callable] = None, clock=WallClock) -> Record:
    """Serve ``plans`` (open loop: a list of ``Planned`` with ``due``;
    closed loop: one list a client) for a window of ``seconds``, then drain:
    step on until every request sent inside the window has its first
    token, for at most ``cell["drain_s"]`` seconds. ``profiler``: a
    callable ``(t, steps) -> bool`` asked after each step whether the
    traced slice is open (see ``trace.Slice``); ``clock``: ``now()`` and
    ``sleep(s)``, ``WallClock`` by default."""
    from repro_torch.serving.request import Request
    names = tenant_names(cell)
    closed = mix["loop"] == "closed"
    traced = profiler is not None
    served: List[Served] = []
    by_rid: Dict[str, Served] = {}
    steps: List[Step] = []
    lateness: List[float] = []
    queue: List[tuple] = []
    ev0 = len(engine.events)
    cap0 = captures(engine)

    def send(p: Planned, t: float, in_window: bool) -> None:
        r = Request(rid=p.rid, model=names[p.tenant], prompt=p.prompt,
                    max_new_tokens=p.max_new, arrival=0.0)
        s = Served(p, names[p.tenant], t, in_window, r)
        served.append(s)
        by_rid[p.rid] = s
        with span(traced, "submit"):
            engine.submit([r])

    def one_step(t_base: float) -> Step:
        n_ev = len(engine.events)
        with span(traced, "step"):
            t0 = clock.now()
            engine.step()
            sync(device)
            t1 = clock.now()
        st = Step(engine.step_idx, t0 - t_base, t1 - t_base,
                  pages_used=engine.allocator.used_pages)
        for step_idx, kind, detail in engine.events[n_ev:]:
            if kind == "prefill" and detail in by_rid:
                s = by_rid[detail]
                s.prefill_step, s.slot = step_idx, s.req.slot
                st.prefills += 1
        steps.append(st)
        return st

    with _Spans(engine, traced):
        if closed:
            clients = [deque(q) for q in plans]
            # the window opens once every slot is busy: the first request
            # of each client goes in one step before it
            t_fill = clock.now()
            for q in clients:
                send(q.popleft(), 0.0, False)
            fill = one_step(t_fill)
            t_base = clock.now()
            fill.t0 -= t_base - t_fill
            fill.t1 -= t_base - t_fill
            for s in served:
                s.sent = fill.t0
            live = {s.plan.client: s for s in served}
        else:
            pending = deque(sorted(plans, key=lambda p: p.due))
            t_base = clock.now()
        closed_at = None
        while True:
            now = clock.now() - t_base
            if closed_at is None and now >= seconds:
                closed_at = now
            if closed_at is not None:
                due_ok = all(s.req.t_first_token is not None
                             for s in served if s.in_window)
                if due_ok or now - closed_at > cell["drain_s"]:
                    break
            if not closed:
                batch = []
                while pending and pending[0].due <= now:
                    batch.append(pending.popleft())
                for p in batch:
                    lateness.append(now - p.due)
                    send(p, p.due, True)
            if engine.busy():
                st = one_step(t_base)
                if traced:
                    st.profiled = profiler(st.t1, steps)
                if closed:
                    for c, s in list(live.items()):
                        if s.req.finished and closed_at is None and clients[c]:
                            nxt = clients[c].popleft()
                            send(nxt, st.t1, True)
                            live[c] = served[-1]
                queue.append((st.t1, sum(len(t.queue) for t in
                                         engine.tenants.values())
                              + len(engine._incoming)))
            elif not closed and pending:
                with span(traced, "wait"):
                    clock.sleep(max(0.0, min(pending[0].due - now, 0.05)))
            elif closed_at is None and not closed:
                with span(traced, "wait"):
                    clock.sleep(max(0.0, min(seconds - now, 0.05)))
            elif closed_at is None:
                # a closed loop that ran out of queued requests
                closed_at = clock.now() - t_base
            else:
                break
    end = clock.now() - t_base
    return Record(steps=steps, served=served, window_s=float(seconds),
                  closed_at=float(closed_at if closed_at is not None
                                  else end),
                  drain_s=end - (closed_at if closed_at is not None else end),
                  events=list(engine.events[ev0:]), lateness=lateness,
                  captures_in_window=captures(engine) - cap0,
                  queue_samples=queue)
