"""Multi-tenant serving engine: continuous batching + MIRAGE integration
(PyTorch/CUDA port of ``repro.serving.engine``).

This is the *functional* runtime (it really executes the models — on the
CPU with reduced configs in tests, on an NVIDIA GPU at full width, where
attention runs the hand-written CUDA kernels): slot-based continuous
batching per tenant, a shared paged-KV control plane (`PagedKVAllocator`),
and per-iteration Remapping Controller hooks (Algorithm 1). Three memory
modes, matching the paper's comparison:

  * ``mirage`` — KV exhaustion grows the pool from remapped parameter
    memory; decode fetches cycling layers through the Transfer Engine.
  * ``vllm``   — fixed pool; exhaustion preempts the youngest running
    request and recomputes it later (PagedAttention recompute baseline).
  * ``swap``   — Pie-style: pool extends into host memory (functionally a
    growth; the bidirectional-transfer cost is charged by the simulator).

Timing is *not* measured here (CPU wall-time is meaningless for GH200/TPU
claims): the engine records per-token *step indices* and event counts; the
event-driven simulator (serving/simulator.py) owns latency/throughput.
Output-equivalence of mirage vs vllm modes is what the integration tests
assert — remapping must never change results.

On a CUDA device the decode step runs compiled, as the reference's
jitted ``_decode_fn`` does: each tenant's step is captured once per key
as a CUDA graph and replayed (``serving/decode_graph.py``; the key is the
reference's (resident, cycle, paged) plus the storage a graph bakes in),
with the streaming fetch of cycling layers inside the graph and the argmax
too, so a step reads back only its token ids. ``decode_graphs=False``
decodes eagerly instead, as on the CPU (the plain version every
differential test runs). The chunked paged prefill runs compiled too, as
the reference's ``prefill_chunk_paged`` does: each chunk length's layer
loop is captured once per tenant and replayed (``serving/prefill_graph.py``;
the key holds the chunk length, the page-table width and the pools' and
parameters' storage); a dense prefill replays its sLSTM time chunks
(``models/slstm_graph.py``); ``prefill_graphs=False`` runs prefill eagerly.
The monolithic paged prefill stays eager, as in the reference. The
engine keeps host mirrors of each paged tenant's page table and write
cursors, so no step reads the table back from the device.

It serves paged attention-stack tenants (dense or MoE FFN) and dense
(``paged=False``) tenants of any stack: attention (a K/V cache per slot,
a ring for a sliding window), hybrid Mamba + attention (jamba),
recurrent (xLSTM), VLM (llava: a prefix of patch embeddings) and enc-dec
(whisper: encoder, cross-attention); a remapped dense tenant streams its
cycling repeats (one repeat = one pattern period of layers, a decoder
layer for enc-dec) from pinned host memory exactly as a paged one does.
A paged VLM or enc-dec tenant is refused (``ValueError``): the reference
has no correct answer for either (ROADMAP queue 3). The fleet hooks of
the cluster layer move real K/V pages between replicas:
``export_prefix`` gathers a cached prefix's pages from the pools into
CPU tensors, ``import_prefix`` writes them into fresh pages of another
engine's pools in place; ``prefix_snapshot``, ``withdraw_pending`` and
``drain_for_removal`` (scale-out pre-warm and scale-in) are the
reference's, unchanged.
"""
from __future__ import annotations

import dataclasses
import warnings
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RuntimeConfig
from repro_torch.core import (
    ControllerConfig, MetadataStore, MemoryInfo, ModelInfo,
    PagedKVAllocator, PrefixIndex, RemapDecision, RemappingController,
    TransferEngine, identity_plan, make_fetch,
)
from repro_torch.models import build_model
from repro_torch.models.common import dtype_of, tree_bytes, tree_leaves
from repro_torch.serving.decode_graph import DecodeGraphs, decode_fn
from repro_torch.serving.prefill_graph import PrefillGraphs
from repro_torch.serving.hw import HardwareSpec, TPU_V5E
from repro_torch.serving.perf_model import PerfModel
from repro_torch.serving.request import (
    DECODE_WATERMARK_TOKENS, Request, ServingMetrics,
)
from repro_torch.serving.runtime import merge_arrivals
from repro_torch.serving.scheduler import admission_watermark, make_scheduler
from repro_torch.serving.slo import (
    SLOSpec, preemption_victim, runtime_tenant_slack, tier_rank,
)


def execute_remap_decision(allocator, store, elastic_pages, d, *,
                           drop_cached=None) -> Optional[str]:
    """Execute one ``RemapDecision`` against the paged pool; shared by the
    engine and the controller-fuzz harness so the pool-side invariant is
    testable without tenants. Returns ``"remap"`` / ``"revert"`` when the
    decision took effect, ``"undone"`` when a doomed reversion was rolled
    back in the store, and ``None`` when the decision was a no-op at page
    granularity (e.g. a revert whose pages were already over-released by
    an earlier whole-segment shrink).

    Invariant maintained (asserted by tests after every decision):
    ``elastic_pages[m] == sum of segment pages sourced by m``. The undo
    path must NOT shrink-then-regrow: regrowing mints fresh page ids while
    ``total_pages`` stays put, drifting the segment map away from the
    accounting and leaking ids past any pool sized from it.
    """
    info = store.models[d.model]
    target_pages = d.new_alpha * (info.layer_bytes // store.memory.page_bytes)
    cur = elastic_pages[d.model]
    if target_pages > cur:
        allocator.grow(target_pages - cur, d.model)
        elastic_pages[d.model] = target_pages
        return "remap"
    if target_pages < cur:
        # cached prefix blocks parked in the donated segments would block
        # reversion forever; drop the unreferenced ones first
        if drop_cached is not None:
            drop_cached(d.model)
        if allocator.releasable_pages(d.model) < cur - target_pages:
            # pages still in use: undo the reversion (retry later)
            store.apply_remap(d.model, d.new_alpha + 1)
            return "undone"
        released = allocator.shrink(d.model)
        elastic_pages[d.model] = cur - released
        return "revert"
    return None


@dataclasses.dataclass
class TenantConfig:
    cfg: ModelConfig
    params: Any
    max_batch: int = 8
    max_context: int = 64
    priority: int = 0
    # per-tenant SLO: targets are in ENGINE STEPS (the functional engine's
    # clock); the tier drives victim selection and preemption order
    slo: SLOSpec = dataclasses.field(default_factory=SLOSpec)
    # paged=True: decode reads the elastic paged KV pool through
    # kernels/paged_attention (attention-stack archs only). Pool pages map
    # 1:1 to allocator page ids; a remap tier switch that grows the
    # allocator grows the pool (the donated-memory segments become pages).
    # paged=False: a dense per-slot decode state (attention K/V caches,
    # recurrent and Mamba states), for any stack.
    paged: bool = False


def stub_frontend_inputs(cfg: ModelConfig, rid: str, device) -> Dict:
    """The stub frontends' prefill inputs for request ``rid``, drawn as the
    reference engine draws them (engine.py:763-771): an enc-dec config's
    "frames" [1, min(max_source_len, 32), D], a VLM's "patch_embeds" [1,
    num_image_patches, D], each 0.02 * a standard normal from a generator
    seeded by ``hash(rid)`` (salted per process for a str), made in f32 on
    the host and moved to ``device``. Empty for a text-only config."""
    shapes = {}
    if cfg.is_encoder_decoder:
        shapes["frames"] = (1, min(cfg.max_source_len, 32), cfg.d_model)
    if cfg.num_image_patches:
        shapes["patch_embeds"] = (1, cfg.num_image_patches, cfg.d_model)
    seed = abs(hash(rid)) % (2**31)
    return {k: torch.from_numpy((np.random.default_rng(seed).standard_normal(
        shape) * 0.02).astype(np.float32)).to(device)
        for k, shape in shapes.items()}


class Tenant:
    """Runtime state for one hosted model."""

    def __init__(self, name: str, tc: TenantConfig, hw: HardwareSpec,
                 device, decode_graphs: bool = False,
                 prefill_graphs: bool = False):
        self.name = name
        self.cfg = tc.cfg
        self.model = build_model(tc.cfg)
        if tc.paged and tc.cfg.is_encoder_decoder:
            # the reference's paged prefill calls an LM method EncDec lacks
            # (ROADMAP queue 3)
            raise ValueError(f"paged mode does not serve an encoder-decoder: "
                             f"{name}; use paged=False")
        if tc.paged and not self.model.impl.attention_only:
            raise ValueError(f"paged mode needs an attention stack: {name}")
        if tc.paged and tc.cfg.num_image_patches:
            # the reference admits prompt + 1 tokens of pages but writes
            # patches + prompt K/V rows through them (ROADMAP queue 3)
            raise ValueError(f"paged mode does not serve a VLM prefix: {name} "
                             f"({tc.cfg.num_image_patches} patch rows); use "
                             "paged=False")
        self.params = tc.params
        self.device = torch.device(device)
        for leaf in tree_leaves(tc.params):
            if leaf.device != self.device and not (
                    leaf.device.type == self.device.type == "cuda"
                    and self.device.index is None):
                raise ValueError(f"{name}: params on {leaf.device}, "
                                 f"engine on {self.device}")
        self.max_batch = tc.max_batch
        self.max_context = tc.max_context
        self.perf = PerfModel(tc.cfg, hw)
        self.queue: deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * tc.max_batch
        self.paged = tc.paged
        self.state = None if tc.paged else \
            self.model.init_decode_state(tc.max_batch, tc.max_context,
                                         self.device)
        # host mirrors of a paged tenant's page table and write cursors
        self.pt_host: Optional[np.ndarray] = None
        self.ctx_host: Optional[np.ndarray] = None
        cuda = self.device.type == "cuda"
        # the compiled decode step's cache (CUDA only)
        self.graphs = DecodeGraphs(self.device) \
            if decode_graphs and cuda else None
        # the compiled prefill (CUDA only): a paged tenant's chunk graphs;
        # a dense prefill replays the sLSTM chunks of the tenant's model
        self.compiled_prefill = prefill_graphs and cuda
        self.prefill_graphs = PrefillGraphs(self.device) \
            if self.compiled_prefill and tc.paged else None

    def init_paged_state(self, total_pages: int, page_size: int):
        """Pool covers every allocator page id + one scratch page (used by
        empty batch slots so their writes never touch live pages)."""
        cfg = self.cfg
        hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        r = self.model.repeats
        n = -(-self.max_context // page_size)
        dt, dev = dtype_of(cfg), self.device
        scratch = total_pages
        shape = (r, total_pages + 1, page_size, hkv, hd)
        self.pt_host = np.full((self.max_batch, n), scratch, np.int32)
        self.ctx_host = np.zeros((self.max_batch,), np.int32)
        self.state = {
            "pool_k": torch.zeros(shape, dtype=dt, device=dev),
            "pool_v": torch.zeros(shape, dtype=dt, device=dev),
            "page_table": torch.from_numpy(self.pt_host.copy()).to(dev),
            "ctx": torch.from_numpy(self.ctx_host.copy()).to(dev),
        }

    def grow_pool(self, new_total_pages: int):
        cur = self.state["pool_k"].shape[1] - 1
        add = new_total_pages - cur
        if add <= 0:
            return
        # scratch page stays last: insert new pages before it
        def grow(pool):
            body, scratch = pool[:, :-1], pool[:, -1:]
            pad = torch.zeros((pool.shape[0], add) + tuple(pool.shape[2:]),
                              dtype=pool.dtype, device=pool.device)
            return torch.cat([body, pad, scratch], dim=1)
        # scratch index moves: rewrite empty-slot table entries
        old_scratch, new_scratch = cur, new_total_pages
        pt = self.state["page_table"]
        pt = torch.where(pt == old_scratch, new_scratch, pt)
        self.pt_host[self.pt_host == old_scratch] = new_scratch
        self.state = dict(
            self.state, pool_k=grow(self.state["pool_k"]),
            pool_v=grow(self.state["pool_v"]), page_table=pt)

    def page_row(self, pages) -> np.ndarray:
        """Scratch-padded page-table row: ``pages`` first, every other
        entry the scratch page. THE one encoding of the slot-lifecycle
        invariant (unused entries must absorb writes harmlessly) — all
        row installs and resets go through here."""
        scratch = self.state["pool_k"].shape[1] - 1
        n = self.state["page_table"].shape[1]
        row = np.full((n,), scratch, np.int32)
        row[:len(pages)] = pages
        return row

    # ------------------------------------------------------------- batching
    def free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return None

    def running(self) -> List[Request]:
        return [r for r in self.slots if r is not None]

    def write_slot_state(self, slot: int, new_state) -> None:
        """Insert a prefill result (batch=1 state) into batch slot (in
        place)."""
        self.state = self.model.insert_slot(self.state, slot, new_state)

    def clear_slot(self, slot: int) -> None:
        """Release a batch slot. For paged tenants the slot's page-table
        row and write cursor MUST be reset: the freed pages may be handed
        to another request immediately, and a stale row would make every
        subsequent ``decode_step_paged`` write the dead slot's garbage KV
        into pages the survivor now owns (the slot-lifecycle invariant:
        an empty slot always points at the scratch page with ctx == 0)."""
        self.slots[slot] = None
        if self.paged and self.state is not None:
            self.set_row(slot, self.page_row([]), 0)

    def set_row(self, slot: int, row: np.ndarray, ctx: int) -> None:
        """Install a page-table row and write cursor for ``slot``, in the
        host mirrors and in place on the device."""
        self.pt_host[slot] = row
        self.ctx_host[slot] = ctx
        self.state["page_table"][slot] = torch.from_numpy(self.pt_host[slot])
        self.state["ctx"][slot] = ctx


class ServingEngine:
    def __init__(
        self,
        tenants: Dict[str, TenantConfig],
        *,
        mode: str = "mirage",                      # mirage | vllm | swap
        scheduler: str = "temporal",
        hw: HardwareSpec = TPU_V5E,
        base_kv_pages: int = 64,
        page_size: int = 16,
        runtime: RuntimeConfig = RuntimeConfig(),
        quantum_steps: int = 8,
        prefix_sharing: bool = False,
        prefill_chunk_tokens: int = 0,
        step_tokens: int = 0,
        watermark_tokens: int = DECODE_WATERMARK_TOKENS,
        slack_margin: float = 0.0,
        device="cuda",
        keep_prefill_logits: bool = False,
        decode_graphs: bool = True,
        prefill_graphs: bool = True,
    ):
        """``prefill_chunk_tokens``: > 0 enables token-budget chunked
        prefill for paged tenants — an admitted prompt is computed in
        chunks of at most this many tokens per engine step, interleaved
        with decode of the other slots (0 = monolithic prefill, the
        original behaviour). ``step_tokens``: scheduler-visible per-step
        token budget; decode tokens are charged first, prefill chunks
        consume the remainder (0 = unlimited). ``watermark_tokens``:
        decode headroom reserved per running request at admission, shared
        with the simulator via ``DECODE_WATERMARK_TOKENS``.
        ``scheduler="slo"`` enables slack-driven scheduling over each
        tenant's ``TenantConfig.slo`` (targets in engine steps);
        ``slack_margin`` is the urgency threshold in steps. ``device``:
        where the tenants' params, pools and compute live ("cuda" by
        default; the tests pass "cpu"). ``keep_prefill_logits``: keep each
        request's first-token logits (f32, on the CPU) in
        ``prefill_logits[rid]``, so runs can be compared beyond argmax.
        ``decode_graphs``: on a CUDA device, decode through captured CUDA
        graphs (the default); False decodes eagerly, to hold the graphs
        against the eager step. ``prefill_graphs``: on a CUDA device, run
        each chunk of the chunked paged prefill through a captured CUDA
        graph per chunk length, and a dense prefill's sLSTM time chunks
        through their captured graph (the default); False prefills
        eagerly. Neither has an effect on the CPU, which runs eagerly."""
        assert mode in ("mirage", "vllm", "swap")
        self.mode = mode
        self.hw = hw
        self.runtime = runtime
        self.prefill_chunk_tokens = int(prefill_chunk_tokens)
        self.watermark_tokens = int(watermark_tokens)
        self.slo_specs: Dict[str, SLOSpec] = {
            n: tc.slo for n, tc in tenants.items()}
        # slack is only worth computing when some tenant has a real SLO:
        # with every spec at the all-inf default, every slack is inf and
        # both consumers (scheduler urgency, victim ordering) ignore it
        self._slo_enabled = any(
            s != SLOSpec() for s in self.slo_specs.values())
        self.device = torch.device(device)
        self.prefill_logits: Optional[Dict[str, torch.Tensor]] = \
            {} if keep_prefill_logits else None
        self.tenants = {n: Tenant(n, tc, hw, self.device, decode_graphs,
                                  prefill_graphs)
                        for n, tc in tenants.items()}
        self.allocator = PagedKVAllocator(base_kv_pages, page_size)
        self.store = MetadataStore(MemoryInfo(
            hbm_bytes=hw.hbm_bytes, page_bytes=page_size * 1024,
            base_kv_pages=base_kv_pages))
        self.xfer = TransferEngine()
        for n, t in self.tenants.items():
            unit_bytes = max(tree_bytes(
                t.model.specs()["blocks"]) // t.model.repeats, 1)
            self.store.register(ModelInfo(
                name=n, num_layers=t.model.repeats, layer_bytes=unit_bytes,
                priority=tenants[n].priority,
                max_remap_fraction=runtime.max_remap_fraction,
                slo_tier=tenants[n].slo.tier))
            self.xfer.register(n, t.params["blocks"], unit_bytes)
        self.controller = RemappingController(
            self.store,
            ControllerConfig(
                victim_policy=runtime.victim_policy,
                double_buffer=runtime.double_buffer,
                dynamic_reversion=runtime.dynamic_reversion,
                reversion_hysteresis=runtime.reversion_hysteresis,
            ),
            {n: t.perf.t_transfer_unit for n, t in self.tenants.items()},
        )
        self.scheduler = make_scheduler(
            scheduler, list(self.tenants), quantum_steps=quantum_steps,
            step_tokens=step_tokens, specs=self.slo_specs,
            slack_margin=slack_margin)
        self._reversion_base = self.controller.cfg.dynamic_reversion
        self.step_idx = 0
        self._incoming: deque[Request] = deque()
        self.finished: List[Request] = []
        self.events: List[Tuple[int, str, str]] = []   # (step, kind, detail)
        self._elastic_pages: Dict[str, int] = {n: 0 for n in self.tenants}
        # prefix sharing rides the paged pool only: dense tenants keep
        # per-slot KV state, which has nothing shareable.
        self.prefix: Dict[str, PrefixIndex] = {
            n: PrefixIndex(page_size) for n, tc in tenants.items()
            if prefix_sharing and tc.paged}
        self._prefix_path: Dict[str, list] = {}   # rid -> acquired trie path
        # fleet prefix cache hooks (cluster layer): publish listener and
        # a sequence for synthetic import-allocation request ids
        self._prefix_listener = None
        self._import_seq = 0
        for t in self.tenants.values():
            if t.paged:
                t.init_paged_state(self.allocator.total_pages, page_size)

    # --------------------------------------------- API (ServingRuntime)
    def submit(self, reqs: List[Request]) -> None:
        """Enqueue arrivals (append-safe incremental ``merge_arrivals``:
        the cluster router feeds requests as their steps come due)."""
        self._incoming = merge_arrivals(self._incoming, reqs)

    def busy(self) -> bool:
        return bool(self._incoming or any(
            t.queue or t.running() for t in self.tenants.values()))

    def tick(self) -> float:
        """Advance one scheduling iteration; returns the elapsed steps —
        1.0 normally, more when the idle fast-forward jumped the clock
        across an arrival gap."""
        before = self.step_idx
        self.step()
        return float(self.step_idx - before)

    def _idle_jump(self) -> int:
        """Steps the idle fast-forward would skip before the next step:
        with no queued/running work and no pending transfer drain (each
        step drains one unit — skipping steps would freeze it), empty
        steps are unobservable and the clock may jump so the next step
        admits the head arrival at its usual ceil(arrival) step index."""
        if self._incoming and not self.xfer.pending and not any(
                t.queue or t.running() for t in self.tenants.values()):
            nxt = int(np.ceil(self._incoming[0].arrival)) - 1
            if nxt > self.step_idx:
                return nxt - self.step_idx
        return 0

    def horizon(self) -> float:
        """Arrival horizon of the next tick: ``step()`` advances the
        clock (through the idle fast-forward, if it applies) *before*
        admitting, so requests with arrival <= that post-advance clock
        are admitted in the upcoming iteration."""
        return float(self.step_idx + self._idle_jump()) + 1.0

    def pressure(self) -> float:
        """KV pool pressure in [0, 1] (used page fraction)."""
        return self.allocator.used_pages / max(self.allocator.total_pages, 1)

    def inflight(self) -> int:
        """Requests submitted but not finished (cluster-router load)."""
        return len(self._incoming) + sum(
            len(t.queue) + len(t.running()) for t in self.tenants.values())

    def draining(self) -> bool:
        """A remap/revert tier switch is mid-drain in the TransferEngine."""
        return bool(self.xfer.pending)

    def tenant_slacks(self) -> Dict[str, float]:
        """Live per-tenant SLO slack in ENGINE STEPS."""
        return self._slo_slack(float(self.step_idx))

    def set_reversion_enabled(self, enabled: bool) -> None:
        """Gate *new* Dynamic Reversion decisions (coordinated remap:
        a cluster policy staggers revert drains across replicas). The
        gate can only RESTRICT: a runtime built with reversion disabled
        stays disabled no matter what a cluster policy grants."""
        self.controller.cfg.dynamic_reversion = \
            enabled and self._reversion_base

    # ------------------------------------------- fleet prefix cache hooks
    def set_prefix_listener(self, cb) -> None:
        """Install ``cb(model, tokens, now)``, invoked on every prefix
        publish (the cluster layer points this at
        ``FleetPrefixCache.publish``; ``now`` is in engine steps)."""
        self._prefix_listener = cb

    def prefix_probe(self, model: str, tokens) -> int:
        """Non-mutating longest-cached-prefix length in tokens — what a
        fleet fetch verifies against before trusting a possibly-stale
        fleet index entry."""
        idx = self.prefix.get(model)
        return idx.peek(tokens) if idx is not None else 0

    def prefix_costs(self, model: str, span_tokens: int,
                     prompt_tokens: int):
        """(bytes, t_fetch_s, t_recompute_s) for importing a cached
        ``span_tokens`` prefix of a ``prompt_tokens`` prompt
        (``PerfModel.prefix_transfer_costs``)."""
        return self.tenants[model].perf.prefix_transfer_costs(
            span_tokens, prompt_tokens)

    def export_prefix(self, model: str, tokens, n_tokens: int):
        """Gather the real KV of the leading cached blocks of ``tokens``
        (up to ``n_tokens``) for a peer replica: returns ``(k, v)`` CPU
        tensors of shape ``(repeats, blocks, page_size, kv_heads,
        head_dim)`` in the pool's dtype, or None when nothing is cached.
        The device-to-host copy is complete when this returns. Uses
        ``match`` (LRU-refreshing, stats-free): an export IS a use of those
        blocks."""
        idx = self.prefix.get(model)
        t = self.tenants.get(model)
        if idx is None or t is None or not t.paged or t.state is None:
            return None
        ps = self.allocator.page_size
        nblk = max(int(n_tokens), 0) // ps
        if nblk <= 0:
            return None
        m = idx.match(tokens, max_tokens=nblk * ps, record=False)
        if not m.pages:
            return None
        pages = torch.tensor(m.pages[:nblk], dtype=torch.long,
                             device=t.device)
        # index_select copies out of the pool; .cpu() waits for the copy
        return (t.state["pool_k"].index_select(1, pages).cpu(),
                t.state["pool_v"].index_select(1, pages).cpu())

    def import_prefix(self, model: str, tokens, n_tokens: int,
                      kv=None) -> int:
        """Install a peer's exported prefix KV into the local paged pool
        as refcounted CoW cache pages — exactly like a local prefix fork:
        fresh pages are allocated, the KV bytes land in ``pool_k/pool_v``,
        the blocks enter the prefix index, and the cache takes the one
        reference that keeps them alive (``cache_hold``). Blocks already
        cached locally are skipped (only the delta is imported). Returns
        the tokens imported."""
        idx = self.prefix.get(model)
        t = self.tenants.get(model)
        if idx is None or t is None or not t.paged or t.state is None \
                or kv is None:
            return 0
        k, v = kv
        ps = self.allocator.page_size
        nblk = min(max(int(n_tokens), 0), len(tokens),
                   k.shape[1] * ps) // ps
        have = idx.peek(tokens, max_tokens=nblk * ps) // ps
        if nblk <= have:
            return 0
        new_blocks = nblk - have
        self._import_seq += 1
        rid = f"__prefix_import_{self._import_seq}"
        pages = self.allocator.allocate(rid, new_blocks * ps)
        if pages is None:
            self._reclaim(new_blocks - self.allocator.free_pages)
            pages = self.allocator.allocate(rid, new_blocks * ps)
            if pages is None:
                return 0
        # written in place: the pools are only ever replaced whole (by
        # grow_pool), and nothing holds one across steps but ``t.state``
        pool_k, pool_v = t.state["pool_k"], t.state["pool_v"]
        at = torch.tensor(pages, dtype=torch.long, device=pool_k.device)
        for pool, src in ((pool_k, k), (pool_v, v)):
            pool.index_copy_(1, at, torch.as_tensor(
                src[:, have:nblk], dtype=pool.dtype, device=pool.device))
        # the trie path beyond block ``have`` cannot exist locally (trie
        # property: a missing block severs every deeper node on the path),
        # so insert consumes exactly our fresh pages
        page_seq = [-1] * have + list(pages)
        new_pages, _path = idx.insert(tokens, page_seq,
                                      max_tokens=nblk * ps)
        assert new_pages == list(pages), (new_pages, pages)
        self.allocator.cache_hold(new_pages)
        self.allocator.free(rid)
        self.events.append((self.step_idx, "prefix-import",
                            f"{model} blocks={len(new_pages)}"))
        return len(new_pages) * ps

    def prefix_snapshot(self, max_blocks: int = 0):
        """Every maximal cached prefix as ``(model, tokens)`` pairs — the
        donor side of scale-out pre-warm (non-mutating; ``max_blocks``
        bounds the total blocks, 0 = unbounded). The joining replica
        imports each span through ``export_prefix``/``import_prefix``, so
        the real KV pages cross with it."""
        out = []
        budget = max_blocks if max_blocks > 0 else None
        for n, idx in self.prefix.items():
            paths = idx.paths(budget)
            if budget is not None:
                budget -= sum(len(p) // idx.page_size for p in paths)
            out.extend((n, p) for p in paths)
        return out

    # ------------------------------------------- replica lifecycle hooks
    def withdraw_pending(self) -> List[Request]:
        """Pull back every submitted-but-not-yet-admitted arrival so the
        cluster layer can respill it to another replica at scale-in.
        Requests already admitted (queued/running) finish here."""
        out = list(self._incoming)
        self._incoming.clear()
        return out

    def drain_for_removal(self) -> None:
        """Force reversion of every donated parameter segment before
        teardown (the drain-before-teardown invariant): pages are
        released back level by level — exactly the controller's one-step
        revert semantics, including the cached-prefix drop and the
        pages-in-use undo — and the restored layers' host->device traffic
        drains through the TransferEngine one unit per step; once it has,
        the tenant's split is resident again and its pinned cycle stack is
        released. Idempotent; call once the replica's inflight work is
        gone."""
        if self.mode != "mirage":
            return
        for name, info in self.store.models.items():
            progressed = False
            while info.remapped_alpha > 0:
                target = info.remapped_alpha - 1
                self.store.apply_remap(name, target)
                d = RemapDecision(name, target,
                                  identity_plan(info.num_layers),
                                  reverted=True)
                out = execute_remap_decision(
                    self.allocator, self.store, self._elastic_pages, d,
                    drop_cached=self._drop_cached_in_segments
                    if self.prefix else None)
                if out == "undone":
                    break       # pages still in use: retry next tick
                progressed = True
            if progressed:
                self.xfer.submit_plan(name, identity_plan(info.num_layers))
                self.events.append(
                    (self.step_idx, "revert-teardown", name))

    def run(self, max_steps: int = 10_000) -> List[Request]:
        while self.step_idx < max_steps and self.busy():
            self.step()
        if self.busy():
            warnings.warn(
                f"ServingEngine.run: step budget ({max_steps}) exhausted "
                f"with {self.inflight()} requests still unfinished — they "
                "are not in the returned list; see metrics().unfinished",
                RuntimeWarning, stacklevel=2)
        return self.finished

    # ----------------------------------------------------------------- step
    def step(self) -> None:
        # idle fast-forward (mirrors the simulator's): empty steps are
        # unobservable, so jump the clock across an arrival gap —
        # admission lands on the same ceil(arrival) step index the
        # one-by-one walk would reach, and a lagging cluster replica
        # heals in one tick instead of gating fleet dispatch. Gated on
        # xfer.pending: a pending tier switch drains one unit per step,
        # so the gap is walked normally until the drain completes.
        self.step_idx += self._idle_jump()
        self.step_idx += 1
        now = float(self.step_idx)
        # 1. admit arrivals (functional time: step index)
        while self._incoming and self._incoming[0].arrival <= now:
            r = self._incoming.popleft()
            self.tenants[r.model].queue.append(r)
        # 2. schedule — live SLO slack feeds both the scheduler (EDF
        # urgency) and the MetadataStore (victim/reversion ordering)
        if self._slo_enabled:
            slacks = self._slo_slack(now)
            self.store.note_slack(slacks)
            self.scheduler.observe_slack(slacks)
        pending = {n: len(t.queue) for n, t in self.tenants.items()}
        running = {n: len(t.running()) for n, t in self.tenants.items()}
        active = self.scheduler.schedule(pending, running, now)
        self.store.mark_active(active)
        self.store.note_kv_usage(self.allocator.used_pages)
        # 3. per active tenant: admit prefills, run prefill chunks under
        # the scheduler's token budget, then decode one token
        pressure = False
        for name in active:
            pressure |= self._admit(self.tenants[name])
        # decode tokens are charged against the step budget first so a
        # chunking tenant can never starve decode-heavy tenants
        decode_tokens = sum(
            1 for name in active for r in self.tenants[name].running()
            if not r.prefilling)
        budget = self.scheduler.prefill_budget(decode_tokens)
        for name in active:
            budget -= self._prefill_step(self.tenants[name], budget)
        for name in active:
            pressure |= self._decode(self.tenants[name])
        # 4. MIRAGE / baseline memory management
        self._memory_control(pressure)
        # 5. async apply queue: pending tier switches drain one remap unit
        # per step (the link carries about one layer per iteration), so a
        # decision's first decode step never serializes on the whole plan
        for n, info in self.store.models.items():
            self.xfer.advance(n, info.layer_bytes)

    # ------------------------------------------------------------- internals
    def _slo_slack(self, now: float) -> Dict[str, float]:
        """Per-tenant slack in ENGINE STEPS: one decode == one step, and a
        chunked prefill takes ceil(remaining prompt / chunk) steps to first
        token — lowered into the shared ``runtime_tenant_slack`` helper
        (the simulator lowers PerfModel seconds into the same helper;
        slack ordering is unit-invariant)."""
        chunk = self.prefill_chunk_tokens
        out = {}
        for n, t in self.tenants.items():
            def steps_left(remaining_tokens, chunked=t.paged and chunk > 0):
                if chunked:
                    return float(-(-max(remaining_tokens, 1) // chunk))
                return 1.0

            head = t.queue[0] if t.queue else None
            running = t.running()
            out[n] = runtime_tenant_slack(
                self.slo_specs[n], now, t.queue,
                [r for r in running if not r.prefilling],
                [r for r in running if r.prefilling],
                t_first_head=steps_left(head.prompt_len)
                if head is not None else 1.0,
                t_next=1.0,
                t_first_remaining=lambda r, sl=steps_left: sl(
                    r.prompt_len - r.prefill_pos))
        return out

    def _t_compute(self) -> Dict[str, float]:
        """Per-model T_c fed to the controller's pipeline-feasibility cap
        (§5.3). Uses the LIVE mean context of the running batch — a fixed
        ``max_context / 2`` guess would freeze the α cap while contexts
        grow and decode actually slows down."""
        out = {}
        for n, t in self.tenants.items():
            running = t.running()
            batch = max(len(running), 1)
            info = self.store.models[n]
            if info.active:
                ctx = (sum(r.total_len for r in running) / len(running)) \
                    if running else t.max_context / 2
                out[n] = t.perf.decode_step_time(batch, ctx) \
                    / t.model.repeats
            else:
                out[n] = t.perf.prefill_time(512) / t.model.repeats
        return out

    def _memory_control(self, pressure: bool) -> None:
        if self.mode == "vllm":
            return  # recompute handled at allocation sites
        if self.mode == "swap":
            if pressure:
                seg = self.allocator.grow(16, "host-swap")
                for t in self.tenants.values():
                    if t.paged:
                        t.grow_pool(self.allocator.page_id_bound)
                self.events.append((self.step_idx, "swap-grow", f"{seg.num_pages}"))
            return
        decisions = self.controller.step(
            kv_pressure=pressure, t_compute=self._t_compute())
        for d in decisions:
            self._apply_decision(d)

    def _drop_cached_in_segments(self, model: str) -> None:
        cand = [p for seg in self.allocator.segments
                if seg.source == model
                for p in self.allocator.segment_cached(seg)]
        for idx in self.prefix.values():
            dropped = idx.evict_pages(cand, evictable=self._cache_only)
            if dropped:
                self.allocator.cache_drop(dropped)

    def _apply_decision(self, d: RemapDecision) -> None:
        outcome = execute_remap_decision(
            self.allocator, self.store, self._elastic_pages, d,
            drop_cached=self._drop_cached_in_segments if self.prefix else None)
        if outcome not in ("remap", "revert"):
            return
        self.xfer.submit_plan(d.model, d.plan)
        if outcome == "remap":
            for t in self.tenants.values():     # donated memory becomes pages
                if t.paged:
                    t.grow_pool(self.allocator.page_id_bound)
        self.events.append(
            (self.step_idx, outcome, f"{d.model} a={d.new_alpha}"))

    # -------------------------------------------------------------- prefill
    def _admit(self, t: Tenant) -> bool:
        pressure = False
        idx = self.prefix.get(t.name)
        while t.queue:
            r = t.queue[0]
            slot = t.free_slot()
            if slot is None:
                break
            # longest cached prefix (full pages; at least the final token is
            # always recomputed so prefill produces the first logits).
            # Acquiring the path pins it against our own cache eviction
            # below; released again if admission fails on capacity.
            # a preempt-inflated prompt can outgrow a fixed pool entirely;
            # mirage/swap pools can still grow, but in vllm mode the
            # request is unserveable — drop it (simulator's starvation
            # guard, mirrored) instead of livelocking the tenant
            if self.mode == "vllm" and \
                    self.allocator.pages_needed(r.prompt_len + 1) \
                    > self.allocator.total_pages:
                t.queue.popleft()
                r.finished = True
                self.finished.append(r)
                self.events.append((self.step_idx, "drop-unserveable", r.rid))
                continue
            match = None
            if idx is not None:
                match = idx.match(r.prompt, max_tokens=r.prompt_len - 1,
                                  record=False)
                idx.acquire(match.nodes)
            matched_pages = len(match.pages) if match else 0
            # shared admission watermark (scheduler.admission_watermark):
            # decode headroom per running request, lowered to allocator
            # pages here and to KV bytes in the simulator
            reserve = admission_watermark(
                sum(len(x.running()) for x in self.tenants.values()),
                self.watermark_tokens, self.allocator.pages_needed)
            need = self.allocator.pages_needed(r.prompt_len + 1) \
                - matched_pages + reserve
            if need > self.allocator.free_pages:
                # unreferenced cached blocks are the low-pressure free-page
                # source, reclaimed before the controller escalates
                self._reclaim(need - self.allocator.free_pages)
            if need > self.allocator.free_pages and match and match.tokens:
                # the pinned match may hold the only reclaimable pages:
                # give up the match (prefix recomputes) and reclaim again
                idx.release(match.nodes)
                match = None
                need = self.allocator.pages_needed(r.prompt_len + 1) + reserve
                self._reclaim(need - self.allocator.free_pages)
            if need > self.allocator.free_pages:
                if match:
                    idx.release(match.nodes)
                pressure = True
                break
            if match:
                idx.record_lookup(match.tokens, r.prompt_len)
            if match and match.tokens:
                self.allocator.fork(r.rid, match.pages, match.tokens)
                self._prefix_path[r.rid] = list(match.nodes)
                r.prefix_matched_tokens += match.tokens
            elif match:
                idx.release(match.nodes)
            assert self.allocator.allocate(
                r.rid, r.prompt_len + 1 - (match.tokens if match else 0)
            ) is not None
            t.queue.popleft()
            # chunked prefill needs the paged pool to hold partial-prompt
            # KV between steps (VLM and enc-dec tenants are never paged)
            if t.paged and self.prefill_chunk_tokens > 0:
                self._begin_chunked_prefill(t, r, slot)
            else:
                self._prefill(t, r, slot)
        return pressure

    def _cache_only(self, p: int) -> bool:
        """Page is held by the prefix cache alone (no live request maps it)."""
        return self.allocator.refs.get(p) == 1 and p in self.allocator.cached

    def _reclaim(self, need_pages: int) -> int:
        """Evict unreferenced cached prefix blocks (leaf-first LRU) to free
        pages — tried before remapping (mirage) or preemption (vllm).
        Best-effort tenants' caches are drained before latency-critical
        ones: a cold cache miss is the cheapest place to take pressure,
        and the best-effort tier is who should take it."""
        freed = 0
        by_tier = sorted(self.prefix.items(), key=lambda kv: (
            tier_rank(self.slo_specs[kv[0]].tier), kv[0]))
        for name, idx in by_tier:
            if freed >= need_pages:
                break
            pages = idx.evict(need_pages - freed, evictable=self._cache_only)
            if pages:
                freed += self.allocator.cache_drop(pages)
                self.events.append(
                    (self.step_idx, "cache-evict", f"{name} n={len(pages)}"))
        return freed

    def _prefill(self, t: Tenant, r: Request, slot: int) -> None:
        prompt = torch.from_numpy(
            np.asarray(r.prompt[None, :], np.int64)).to(t.device)
        batch = {"tokens": prompt, **stub_frontend_inputs(t.cfg, r.rid,
                                                           t.device)}
        if t.paged:
            logits = self._prefill_paged(t, r, slot, batch)
        else:
            logits, state1 = t.model.prefill(t.params, batch, t.max_context,
                                             graphs=t.compiled_prefill)
        self._keep_logits(r, logits[0])
        tok = int(torch.argmax(logits[0]))
        t.slots[slot] = r
        r.slot = slot
        if not t.paged:
            t.write_slot_state(slot, state1)
        r.generated.append(tok)
        r.t_first_token = float(self.step_idx)
        r.token_times.append(float(self.step_idx))
        self.events.append((self.step_idx, "prefill", r.rid))

    def _prefill_paged(self, t: Tenant, r: Request, slot: int, batch):
        """Prefill and scatter the KV into this request's allocator pages.

        With prefix sharing, the leading ``seq_shared`` pages were forked
        from the cache and already hold this prefix's KV (same tokens, same
        params, same absolute positions => identical values); only the
        unmatched suffix is scattered, and shared pages are never written
        (the CoW invariant). The forward itself still runs full-length —
        the functional engine owns correctness, the simulator owns the
        prefill-FLOP savings."""
        lm = t.model.impl
        prompt = batch["tokens"]
        x = lm.embed(t.params, prompt)
        b, s = prompt.shape[0], x.shape[1]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=t.device)[None].expand(b, s)
        xo, _, caches = lm.fwd_seq(t.params, x, {"positions": positions},
                                   collect_cache=True)
        logits = lm.logits_last(t.params, xo[:, -1])
        pages = self.allocator.seq_pages[r.rid]
        page_size = self.allocator.page_size
        pt_row = t.page_row(pages)
        shared = self.allocator.seq_shared.get(r.rid, 0)
        if shared:
            m = shared * page_size
            caches = ({"k": caches[0]["k"][:, :, m:],
                       "v": caches[0]["v"][:, :, m:]},)
            scat_row = t.page_row(pages[shared:])
        else:
            scat_row = pt_row
        # scatters in place into the tenant's pools
        lm.paged_state_from_prefill(
            caches, torch.full((1,), s, dtype=torch.int32, device=t.device),
            torch.from_numpy(scat_row[None]).to(t.device),
            t.state["pool_k"].shape[1], page_size,
            pool_k=t.state["pool_k"], pool_v=t.state["pool_v"])
        t.set_row(slot, pt_row, s)
        self._publish(t, r, np.asarray(r.prompt))
        return logits

    # ----------------------------------------------------- chunked prefill
    def _begin_chunked_prefill(self, t: Tenant, r: Request, slot: int) -> None:
        """Admit ``r`` into ``slot`` without running any compute yet: pages
        are already allocated for the full prompt (+1 decode token), the
        slot's page-table row is installed, and the write cursor starts at
        the CoW-shared prefix (those pages already hold this prefix's KV).
        ``_prefill_step`` then advances the prompt in bounded chunks."""
        t.slots[slot] = r
        r.slot = slot
        r.prefilling = True
        r.prefill_pos = self.allocator.seq_shared.get(r.rid, 0) \
            * self.allocator.page_size
        row = t.page_row(self.allocator.seq_pages[r.rid])
        t.set_row(slot, row, r.prefill_pos)

    def _prefill_step(self, t: Tenant, budget: int) -> int:
        """Advance every prefilling request of ``t`` by one chunk of at
        most ``prefill_chunk_tokens`` (and at most the remaining scheduler
        token budget). Returns the prompt tokens consumed. A request whose
        last chunk completes emits its first token here and — since
        ``_decode`` runs after this in the same ``step()`` with
        ``prefilling`` now cleared — decodes its second token in the same
        step, exactly like the monolithic path (prefill + first decode in
        one step); that same-step decode is required for bit-identity."""
        spent = 0
        for r in [x for x in t.slots if x is not None and x.prefilling]:
            chunk = min(self.prefill_chunk_tokens, budget - spent,
                        r.prompt_len - r.prefill_pos)
            if chunk <= 0:
                continue
            tokens = np.asarray(
                r.prompt[r.prefill_pos:r.prefill_pos + chunk], np.int64)
            choice = None
            if t.prefill_graphs is not None:
                logits, choice = t.prefill_graphs.chunk(
                    t, r.slot, tokens, r.prefill_pos)
            else:
                logits, t.state = t.model.impl.prefill_chunk_paged(
                    t.params, t.state, r.slot,
                    torch.from_numpy(tokens).to(t.device), r.prefill_pos)
            r.prefill_pos += chunk
            t.ctx_host[r.slot] = r.prefill_pos
            spent += chunk
            if r.prefill_pos >= r.prompt_len:
                r.prefilling = False
                self._keep_logits(r, logits)
                tok = int(torch.argmax(logits) if choice is None else choice)
                r.generated.append(tok)
                r.t_first_token = float(self.step_idx)
                r.token_times.append(float(self.step_idx))
                self._publish(t, r, np.asarray(r.prompt))
                self.events.append((self.step_idx, "prefill", r.rid))
        return spent

    def _keep_logits(self, r: Request, logits: torch.Tensor) -> None:
        if self.prefill_logits is not None:
            self.prefill_logits[r.rid] = logits.float().cpu()

    def _publish(self, t: Tenant, r: Request, tokens: np.ndarray) -> None:
        """Register this request's fully written KV pages in the prefix
        index so later requests can fork them (cache takes one reference
        per newly published page)."""
        idx = self.prefix.get(t.name)
        if idx is None:
            return
        pages = self.allocator.seq_pages.get(r.rid, [])
        new_pages, path = idx.insert(tokens, pages)
        if new_pages:
            self.allocator.cache_hold(new_pages)
        # the request now depends on its full path (matched + own blocks)
        old = self._prefix_path.pop(r.rid, None)
        if old:
            idx.release(old)
        if path:
            idx.acquire(path)
            self._prefix_path[r.rid] = path
            if self._prefix_listener is not None:
                self._prefix_listener(t.name, tokens, float(self.step_idx))

    # --------------------------------------------------------------- decode
    def _decode(self, t: Tenant) -> bool:
        # mid-prefill slots hold no decodable token yet: they are skipped
        # here and advanced by _prefill_step instead
        reqs = [r for r in t.running() if not r.prefilling]
        if not reqs:
            return False
        pressure = False
        # page for the next token of every running request
        for r in reqs:
            if r.slot < 0 or t.slots[r.slot] is not r:
                # evicted by a _preempt_one earlier in this same loop
                # (vllm victim): it is queued again — allocating for it
                # here would leave a stale 1-token mapping behind
                continue
            if self.allocator.allocate(r.rid, 1) is None:
                # cached prefix blocks are the cheapest pages to reclaim —
                # drop cold ones before remapping/preempting
                if self._reclaim(1) and \
                        self.allocator.allocate(r.rid, 1) is not None:
                    continue
                pressure = True
                if self.mode == "vllm":
                    if self._preempt_one(exclude=r.rid) and \
                            self.allocator.allocate(r.rid, 1) is not None:
                        pressure = False
                        continue
                    self._preempt(r)  # could not make room: preempt r itself
                else:
                    # mirage/swap: grow synchronously then retry once
                    self._memory_control(True)
                    if self.allocator.allocate(r.rid, 1) is not None:
                        continue
                    self._preempt(r)
        reqs = [r for r in t.running() if not r.prefilling]
        if not reqs:
            return pressure
        tokens = np.zeros((t.max_batch,), np.int32)
        for r in reqs:
            tokens[r.slot] = r.generated[-1]
        if t.paged:
            # per-token page allocations land in the allocator; sync the
            # running slots' page-table rows (host mirror) before the step
            for r in reqs:
                t.pt_host[r.slot] = t.page_row(
                    self.allocator.seq_pages[r.rid])
        # the interim plan mid-drain keeps pending layers in the cycle set,
        # so the remapped fetch path stays consistent through a tier switch
        plan = self.xfer.plans[t.name]
        remapped = plan.m > 0
        batch = len(reqs)
        avg_ctx = sum(r.total_len for r in reqs) / batch
        _logits, choices = self._decode_tokens(t, tokens, plan)
        if t.paged:
            t.ctx_host += 1         # every row's cursor, as the step's
        if remapped:
            # shared-pipeline bubble accounting (same event model and
            # inputs the simulator charges for this plan)
            t_c_layer, t_f_layer = t.perf.pipeline_inputs(
                batch, avg_ctx, plan)
            self.xfer.note_decode_step(t.name, t_c_layer, t_f_layer)
        else:
            # non-remapped steps still count in the modeled decode time,
            # so bubble_fraction = stall / TOTAL decode time matches the
            # simulator's denominator
            self.xfer.stats.decode_time_s += \
                t.perf.decode_step_time(batch, avg_ctx)
        for r in list(reqs):
            r.generated.append(int(choices[r.slot]))
            r.token_times.append(float(self.step_idx))
            if len(r.generated) >= r.max_new_tokens or \
                    r.total_len >= t.max_context - 1:
                self._finish(t, r)
        return pressure

    def _decode_tokens(self, t: Tenant, tokens: np.ndarray, plan):
        """One decode step of ``t`` for the batch's last tokens ``tokens``
        [max_batch] under ``plan``: through the tenant's graph cache (the
        reference's jitted ``_decode_fn``) where it has one, else eagerly.
        Returns (logits [max_batch, V], valid until the tenant's next step;
        the argmax of each row on the host)."""
        split = self.xfer.split[t.name]
        if t.graphs is not None:
            logits, choices, h2d = t.graphs.step(
                t, plan, split, tokens, t.pt_host if t.paged else None,
                t.ctx_host if t.paged else None)
            self.xfer.host_fetch_bytes += h2d
            return logits, choices
        if t.paged:
            t.state = dict(t.state, page_table=torch.from_numpy(
                t.pt_host.copy()).to(t.device))
        fetch = None
        if plan.m > 0:
            resident, cycle, maps = split
            fetch = make_fetch(resident, cycle, maps, slots=max(plan.beta, 1))
        logits, t.state = self._decode_fn(
            t, torch.from_numpy(tokens).to(t.device), fetch)
        self.xfer.host_fetch_bytes += getattr(fetch, "h2d_bytes", 0)
        return logits, torch.argmax(logits, dim=-1).cpu().numpy()

    @staticmethod
    def _decode_fn(t: Tenant, tokens, fetch=None):
        """One eager decode step of tenant ``t``: against its paged pool, or
        against its dense decode state (both updated in place)."""
        return decode_fn(t, t.state, tokens, fetch)

    # ------------------------------------------------------------ preemption
    def _preempt_one(self, exclude: str = "") -> bool:
        """vLLM recompute baseline: the shared ``preemption_victim``
        choice (youngest running, best-effort tenants first)."""
        r = preemption_victim(
            (r for t in self.tenants.values() for r in t.running()
             if r.rid != exclude), self.slo_specs)
        if r is None:
            return False
        self._preempt(r)
        return True

    def _release_prefix(self, r: Request) -> None:
        idx = self.prefix.get(r.model)
        path = self._prefix_path.pop(r.rid, None)
        if idx is not None and path:
            idx.release(path)

    def _preempt(self, r: Request) -> None:
        t = self.tenants[r.model]
        self._release_prefix(r)
        self.allocator.free(r.rid)
        t.clear_slot(r.slot)
        r.preemptions += 1
        # recompute: prompt + generated becomes the new prompt
        r.prompt = np.concatenate(
            [r.prompt, np.asarray(r.generated, np.int32)])
        r.generated = []
        r.slot = -1
        # a mid-prefill victim restarts its prompt from scratch (the
        # partially scattered KV died with its pages)
        r.prefilling = False
        r.prefill_pos = 0
        t.queue.appendleft(r)
        self.events.append((self.step_idx, "preempt", r.rid))

    def _finish(self, t: Tenant, r: Request) -> None:
        # publish the conversation so the next turn's prompt (this prompt +
        # this response) forks the whole history. KV exists for the prompt
        # plus all generated tokens except the last (emitted, never fed
        # back); only fully written pages are publishable.
        if self.prefix.get(t.name) is not None and len(r.generated) > 1:
            toks = np.concatenate([
                np.asarray(r.prompt, np.int64),
                np.asarray(r.generated[:-1], np.int64)])
            self._publish(t, r, toks)
        self._release_prefix(r)
        self.allocator.free(r.rid)
        t.clear_slot(r.slot)
        r.finished = True
        self.finished.append(r)
        self.events.append((self.step_idx, "finish", r.rid))

    # ---------------------------------------------------------------- report
    def metrics(self) -> ServingMetrics:
        m = ServingMetrics.from_requests(
            self.finished, makespan=float(self.step_idx))
        st = self.xfer.stats
        # modeled SECONDS (PerfModel clock) while the engine's latency
        # metrics count steps — cross-compare via bubble_fraction only
        m.bubble_time = st.bubble_time_s
        m.bubble_fraction = (st.bubble_time_s / st.decode_time_s
                             if st.decode_time_s else 0.0)
        m._decode_time = st.decode_time_s
        m.unfinished = self.inflight()
        return m

    def graph_stats(self, kind: str = "decode") -> Dict[str, Dict[str, Any]]:
        """Per-tenant graph counters of ``kind``: "decode" (the decode
        graphs) or "prefill" (the chunked prefill's graphs and the sLSTM
        time chunks' together): captures, replays, graphs dropped, capture
        ms and the bytes the live graphs' captures reserved (empty where
        the engine runs that kind eagerly)."""
        if kind == "decode":
            return {n: dataclasses.asdict(t.graphs.stats)
                    for n, t in self.tenants.items() if t.graphs is not None}
        if kind != "prefill":
            raise ValueError(f"graph kind {kind!r}: decode or prefill")
        out = {}
        for n, t in self.tenants.items():
            if t.compiled_prefill:
                parts = [t.model.slstm_graphs.stats] + (
                    [t.prefill_graphs.stats] if t.prefill_graphs else [])
                out[n] = {k: sum(getattr(p, k) for p in parts)
                          for k in dataclasses.asdict(parts[0])}
        return out

    def tier_metrics(self) -> Dict[str, ServingMetrics]:
        """Tail metrics per SLO tier (engine-step clock)."""
        return ServingMetrics.per_tier(
            self.finished, self.slo_specs, makespan=float(self.step_idx))

    def prefix_stats(self) -> Dict[str, Any]:
        """Per-tenant prefix-cache counters (empty when sharing is off)."""
        return {n: dataclasses.asdict(idx.stats)
                | {"cached_blocks": idx.num_blocks}
                for n, idx in self.prefix.items()}
