"""Production trace replay: published LLM-serving workloads -> ``Request``s.

The paper's headline tail numbers are measured on *real* serving traffic;
``traces.py`` only synthesizes it. This module closes that gap: it loads the
two published workload formats the serving literature replays —

  * **Azure LLM inference traces** (AzurePublicDataset): per-invocation CSV
    rows ``TIMESTAMP,ContextTokens,GeneratedTokens`` — no model column, the
    trace is one endpoint's traffic. ``TIMESTAMP`` is a wall-clock datetime
    (7-digit fractional seconds) or a plain float of seconds.
  * **BurstGPT** (ChatGPT/GPT-4 gateway logs): CSV rows ``Timestamp,Model,
    Request tokens,Response tokens,Total tokens,Log Type`` with integer
    second timestamps and a model label per row.

— and lowers them into the exact ``Request`` interface the synthetic
generators produce, behind ``TraceSpec``-compatible entry points:
``replay_trace`` is the one-call path, ``ReplaySpec`` binds a trace file to
a tenant inside a declare-once ``RuntimeConfig`` just like a ``TraceSpec``.

Determinism contract (what the property tests pin):

  * **Round-trip**: records -> Requests -> records preserves arrival order,
    token counts, and tenant mapping exactly (``records_from_requests``).
  * **Seed-stable down-sampling**: ``max_requests`` selects a subset keyed
    only by ``(seed, max_requests, len(records))`` — re-running the same
    slice yields the same requests, and a record keeps its identity (rid,
    prompt tokens) whether or not its neighbours were sampled away.
  * **Never silent**: malformed rows are skipped with ONE summary warning
    naming the count; an all-malformed file raises.

Prompt token content is carved out of a shared seed-keyed pool (one slice
view per request, offset by a stable per-record CRC) so replaying a 10^5-
request trace costs one RNG draw, not 10^5 — and 100 MB of prompt arrays
collapse into one shared buffer.
"""
from __future__ import annotations

import dataclasses
import datetime
import io
import os
import warnings
import zlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.serving.request import Request

AZURE = "azure"
BURSTGPT = "burstgpt"

# header signatures used by ``sniff_format`` (matching is case-insensitive
# and order-insensitive on the required columns)
_AZURE_REQUIRED = ("timestamp", "contexttokens", "generatedtokens")
_BURSTGPT_REQUIRED = ("timestamp", "model", "request tokens",
                      "response tokens")

_POOL_TOKENS = 1 << 20          # shared prompt-token pool length (per seed)


@dataclasses.dataclass(frozen=True)
class TraceRecord:
    """One trace row, format-agnostic: arrival in seconds from trace start
    (rebased so the earliest valid row is t=0), token counts, and the
    trace's own model label ('' for single-endpoint traces like Azure)."""
    arrival: float
    prompt_tokens: int
    output_tokens: int
    source_model: str = ""


# --------------------------------------------------------------- parsing
def _parse_timestamp(text: str) -> float:
    """Seconds since an arbitrary epoch: accepts plain floats and the
    Azure datetime form ``2023-11-16 18:15:46.6805900`` (fractional part
    of any width — Python's fromisoformat caps at 6 digits)."""
    text = text.strip()
    try:
        return float(text)
    except ValueError:
        pass
    base, dot, frac = text.partition(".")
    frac = (frac[:6] if dot else "").ljust(6, "0")
    dt = datetime.datetime.fromisoformat(base)
    return dt.timestamp() + int(frac) / 1e6


def _open_lines(source) -> Tuple[Sequence[str], str]:
    """(lines, display-name) from a path, file-like, or list of lines."""
    if isinstance(source, (list, tuple)):
        return list(source), "<records>"
    if isinstance(source, io.IOBase):
        return source.read().splitlines(), "<stream>"
    with open(os.fspath(source)) as f:
        return f.read().splitlines(), os.fspath(source)


def sniff_format(header: str) -> str:
    """AZURE or BURSTGPT from a CSV header line; raises on neither."""
    cols = [c.strip().lower() for c in header.split(",")]
    if all(c in cols for c in _BURSTGPT_REQUIRED):
        return BURSTGPT
    if all(c in cols for c in _AZURE_REQUIRED):
        return AZURE
    raise ValueError(f"unrecognized trace header: {header!r} (expected "
                     f"Azure LLM inference or BurstGPT CSV schema)")


def _finish(rows: List[TraceRecord], bad: int, name: str,
            fmt: str) -> List[TraceRecord]:
    """Shared loader epilogue: rebase arrivals to t=0, sort, and surface
    skipped rows — a warning when some rows parsed, an error when none
    did. Silent truncation is unrepresentable: every skipped row is
    counted and reported."""
    if not rows:
        raise ValueError(
            f"{name}: no valid {fmt} rows ({bad} malformed)")
    if bad:
        warnings.warn(
            f"{name}: skipped {bad} malformed {fmt} row(s), "
            f"kept {len(rows)}", RuntimeWarning, stacklevel=3)
    t0 = min(r.arrival for r in rows)
    rows = [dataclasses.replace(r, arrival=r.arrival - t0) for r in rows]
    rows.sort(key=lambda r: r.arrival)
    return rows


def parse_azure_csv(source) -> List[TraceRecord]:
    """Azure LLM inference trace: ``TIMESTAMP,ContextTokens,GeneratedTokens``
    (extra columns tolerated; rows with unparseable timestamps or
    non-positive token counts are skipped with a summary warning)."""
    lines, name = _open_lines(source)
    if not lines:
        raise ValueError(f"{name}: empty trace file")
    cols = [c.strip().lower() for c in lines[0].split(",")]
    try:
        i_ts = cols.index("timestamp")
        i_in = cols.index("contexttokens")
        i_out = cols.index("generatedtokens")
    except ValueError:
        raise ValueError(f"{name}: not an Azure LLM inference trace header: "
                         f"{lines[0]!r}") from None
    rows, bad = [], 0
    for line in lines[1:]:
        if not line.strip():
            continue
        parts = line.split(",")
        try:
            rec = TraceRecord(_parse_timestamp(parts[i_ts]),
                              int(parts[i_in]), int(parts[i_out]))
            if rec.prompt_tokens <= 0 or rec.output_tokens <= 0:
                raise ValueError("non-positive token count")
        except (ValueError, IndexError):
            bad += 1
            continue
        rows.append(rec)
    return _finish(rows, bad, name, AZURE)


def parse_burstgpt_csv(source) -> List[TraceRecord]:
    """BurstGPT gateway log: ``Timestamp,Model,Request tokens,Response
    tokens,Total tokens,Log Type``. The model label is preserved as
    ``source_model`` for tenant mapping; failure rows (0 response tokens
    — the dataset marks failed calls that way) are skipped and counted."""
    lines, name = _open_lines(source)
    if not lines:
        raise ValueError(f"{name}: empty trace file")
    cols = [c.strip().lower() for c in lines[0].split(",")]
    try:
        i_ts = cols.index("timestamp")
        i_model = cols.index("model")
        i_in = cols.index("request tokens")
        i_out = cols.index("response tokens")
    except ValueError:
        raise ValueError(f"{name}: not a BurstGPT trace header: "
                         f"{lines[0]!r}") from None
    rows, bad = [], 0
    for line in lines[1:]:
        if not line.strip():
            continue
        parts = line.split(",")
        try:
            rec = TraceRecord(_parse_timestamp(parts[i_ts]),
                              int(parts[i_in]), int(parts[i_out]),
                              source_model=parts[i_model].strip())
            if rec.prompt_tokens <= 0 or rec.output_tokens <= 0:
                raise ValueError("non-positive token count")
        except (ValueError, IndexError):
            bad += 1
            continue
        rows.append(rec)
    return _finish(rows, bad, name, BURSTGPT)


def load_trace(source) -> Tuple[List[TraceRecord], str]:
    """Sniff the format from the header and parse: ``(records, format)``."""
    lines, name = _open_lines(source)
    if not lines:
        raise ValueError(f"{name}: empty trace file")
    fmt = sniff_format(lines[0])
    parser = parse_azure_csv if fmt == AZURE else parse_burstgpt_csv
    return parser(lines), fmt


# --------------------------------------------------------------- lowering
def _record_hash(seed: int, index: int) -> int:
    """Stable per-record 32-bit hash (CRC32, platform-independent — same
    idiom as the router's seed-stable affinity)."""
    return zlib.crc32(f"{seed}:{index}".encode())


def _token_pool(seed: int, vocab: int, max_prompt: int) -> np.ndarray:
    """Shared prompt-token pool: every request's prompt is a slice view of
    this one array, so token content is (seed, record)-stable and the
    trace costs one allocation instead of one array per request."""
    rng = np.random.default_rng([seed, 9 << 16])
    return rng.integers(0, vocab, _POOL_TOKENS + max_prompt,
                        dtype=np.int32)


def downsample_indices(n: int, max_requests: int, seed: int) -> np.ndarray:
    """Seed-stable sorted subset of ``range(n)`` with ``max_requests``
    elements (identity when the trace already fits). Keyed by
    ``(seed, max_requests, n)`` only, so the same slice of the same trace
    always replays the same subset."""
    if max_requests <= 0 or n <= max_requests:
        return np.arange(n)
    rng = np.random.default_rng([seed, 7 << 16, max_requests, n])
    idx = rng.choice(n, size=max_requests, replace=False)
    idx.sort()
    return idx


def _assign_tenant(model_map, rec: TraceRecord, index: int,
                   seed: int) -> Optional[str]:
    """Tenant for one record: a single name serves everything; a mapping
    routes by the trace's model label ('*' = fallback; unmapped labels
    drop the record — counted, never silent); a sequence hash-assigns
    records deterministically (seed-stable, independent of sampling)."""
    if isinstance(model_map, str):
        return model_map
    if isinstance(model_map, dict):
        t = model_map.get(rec.source_model, model_map.get("*"))
        return t
    tenants = list(model_map)
    return tenants[_record_hash(seed, index) % len(tenants)]


def replay_trace(
    trace: Union[str, os.PathLike, Sequence[TraceRecord]],
    model_map: Union[str, Dict[str, str], Sequence[str]],
    *,
    time_scale: float = 1.0,
    max_requests: int = 0,
    seed: int = 0,
    vocab: int = 32000,
    max_prompt_tokens: int = 32768,
    max_output_tokens: int = 8192,
    rid_prefix: str = "replay",
) -> List[Request]:
    """Lower a production trace into ``Request``s (the ``make_trace``
    counterpart for real traffic).

    ``trace`` is a CSV path (format sniffed from the header) or an already
    parsed record list. ``model_map`` maps trace traffic onto tenants —
    see ``_assign_tenant``. ``time_scale`` multiplies arrivals (0.1 = a
    10x-compressed replay; arrival ORDER is invariant). ``max_requests``
    down-samples seed-stably. Token counts are clamped to the caps with a
    summary warning (a 100k-token outlier would otherwise exceed any
    tenant's KV reservation and starve the replay).

    rid = ``{prefix}-{fmt?}-{original row index}`` — a record keeps its
    rid and prompt content under any down-sampling of its neighbours.
    """
    if time_scale <= 0:
        raise ValueError(f"time_scale must be positive, got {time_scale}")
    if isinstance(trace, (str, os.PathLike)):
        records, fmt = load_trace(trace)
        rid_prefix = f"{rid_prefix}-{fmt}"
    else:
        records = list(trace)
    idx = downsample_indices(len(records), max_requests, seed)
    pool = _token_pool(seed, vocab, max_prompt_tokens)
    out: List[Request] = []
    clamped = dropped = 0
    for i in idx:
        i = int(i)
        rec = records[i]
        tenant = _assign_tenant(model_map, rec, i, seed)
        if tenant is None:
            dropped += 1
            continue
        p = int(rec.prompt_tokens)
        o = int(rec.output_tokens)
        if p > max_prompt_tokens or o > max_output_tokens:
            clamped += 1
            p = min(p, max_prompt_tokens)
            o = min(o, max_output_tokens)
        off = _record_hash(seed, i) % _POOL_TOKENS
        out.append(Request(
            rid=f"{rid_prefix}-{i}",
            model=tenant,
            prompt=pool[off:off + p],
            max_new_tokens=o,
            arrival=float(rec.arrival * time_scale),
        ))
    if dropped:
        warnings.warn(
            f"replay_trace: dropped {dropped} record(s) whose model label "
            f"has no tenant mapping (add a '*' fallback to keep them)",
            RuntimeWarning, stacklevel=2)
    if clamped:
        warnings.warn(
            f"replay_trace: clamped token counts of {clamped} record(s) to "
            f"prompt<={max_prompt_tokens}, output<={max_output_tokens}",
            RuntimeWarning, stacklevel=2)
    if not out:
        raise ValueError("replay_trace: no records mapped to any tenant")
    out.sort(key=lambda r: r.arrival)
    return out


def records_from_requests(reqs: Sequence[Request]) -> List[TraceRecord]:
    """Inverse lowering for the round-trip property: the records a request
    list represents (arrival in request order, token counts from the
    built request, tenant name as the model label)."""
    return [TraceRecord(arrival=r.arrival, prompt_tokens=r.prompt_len,
                        output_tokens=r.max_new_tokens,
                        source_model=r.model) for r in reqs]


@dataclasses.dataclass
class ReplaySpec:
    """TraceSpec-compatible binding of a production trace to a tenant:
    drop one of these into ``TenantSpec.trace`` and
    ``RuntimeConfig.trace()`` replays the file into that tenant's name —
    the same declare-once ergonomics the synthetic specs have. ``path``
    or ``records`` supplies the trace (records win when both are set)."""
    model: str
    path: str = ""
    records: Optional[Sequence[TraceRecord]] = None
    time_scale: float = 1.0
    max_requests: int = 0
    vocab: int = 32000
    max_prompt_tokens: int = 32768
    max_output_tokens: int = 8192

    def requests(self, seed: int = 0) -> List[Request]:
        source = self.records if self.records is not None else self.path
        if source is None or (isinstance(source, str) and not source):
            raise ValueError(
                f"ReplaySpec for tenant {self.model!r} needs path or records")
        return replay_trace(
            source, self.model, time_scale=self.time_scale,
            max_requests=self.max_requests, seed=seed, vocab=self.vocab,
            max_prompt_tokens=self.max_prompt_tokens,
            max_output_tokens=self.max_output_tokens,
            rid_prefix=f"replay-{self.model}")


# ----------------------------------------------------- fixture synthesis
def synth_records(n: int, seed: int = 0, *, rate: float = 2.0,
                  burstiness: float = 2.5, mean_prompt: float = 1024.0,
                  mean_output: float = 256.0, sigma: float = 0.8,
                  models: Sequence[str] = ("",),
                  model_weights: Optional[Sequence[float]] = None,
                  ) -> List[TraceRecord]:
    """Schema-exact synthetic records: Gamma-burst modulated Poisson
    arrivals (the Azure-trace burst shape ``traces.bursty_arrivals``
    mimics) + lognormal token lengths. One RNG stream per seed; used both
    to generate the committed sample slices and to build arbitrarily
    large benchmark fixtures without shipping megabytes of CSV."""
    rng = np.random.default_rng([seed, 11 << 16])
    gaps = []
    remaining = n
    while remaining > 0:
        lam = max(rate * rng.gamma(1.0 / burstiness, burstiness), 1e-3)
        k = min(remaining, max(int(lam * rng.uniform(1.0, 5.0)), 1))
        gaps.extend(rng.exponential(1.0 / lam, k))
        remaining -= k
    arrivals = np.cumsum(np.asarray(gaps[:n]))
    def lengths(mean):
        mu = np.log(mean) - sigma ** 2 / 2
        return np.clip(rng.lognormal(mu, sigma, n).astype(np.int64),
                       4, 32768)
    p_lens, o_lens = lengths(mean_prompt), lengths(mean_output)
    labels = list(models)
    w = np.asarray(model_weights, float) if model_weights is not None \
        else np.ones(len(labels))
    picks = rng.choice(len(labels), size=n, p=w / w.sum())
    return [TraceRecord(float(arrivals[i]), int(p_lens[i]), int(o_lens[i]),
                        source_model=labels[picks[i]]) for i in range(n)]


_AZURE_EPOCH = datetime.datetime(2024, 5, 10, 0, 0, 0)


def format_azure_csv(records: Sequence[TraceRecord]) -> str:
    """Azure-schema CSV text (7-digit fractional datetime timestamps,
    exactly as the published traces format them)."""
    lines = ["TIMESTAMP,ContextTokens,GeneratedTokens"]
    for r in records:
        dt = _AZURE_EPOCH + datetime.timedelta(seconds=float(r.arrival))
        frac7 = int(round(dt.microsecond * 10))
        stamp = dt.strftime("%Y-%m-%d %H:%M:%S") + f".{frac7:07d}"
        lines.append(f"{stamp},{r.prompt_tokens},{r.output_tokens}")
    return "\n".join(lines) + "\n"


def format_burstgpt_csv(records: Sequence[TraceRecord]) -> str:
    """BurstGPT-schema CSV text (integer-second timestamps, model label,
    derived total, conversation log type)."""
    lines = ["Timestamp,Model,Request tokens,Response tokens,"
             "Total tokens,Log Type"]
    for r in records:
        lines.append(f"{r.arrival:.0f},{r.source_model or 'ChatGPT'},"
                     f"{r.prompt_tokens},{r.output_tokens},"
                     f"{r.prompt_tokens + r.output_tokens},Conversation log")
    return "\n".join(lines) + "\n"


def write_sample_traces(directory, n: int = 400, seed: int = 20240510
                        ) -> List[str]:
    """(Re)generate the two committed anonymized sample slices under
    ``benchmarks/traces/`` — synthetic but schema-exact, so tests and the
    fig25 benchmark replay real-format files without shipping real user
    data. Returns the written paths."""
    os.makedirs(directory, exist_ok=True)
    azure = synth_records(n, seed, rate=2.0, mean_prompt=1024,
                          mean_output=256)
    burst = synth_records(n, seed + 1, rate=1.5, mean_prompt=512,
                          mean_output=320, models=("ChatGPT", "GPT-4"),
                          model_weights=(0.8, 0.2))
    paths = []
    for name, text in (("azure_llm_sample.csv", format_azure_csv(azure)),
                       ("burstgpt_sample.csv", format_burstgpt_csv(burst))):
        path = os.path.join(os.fspath(directory), name)
        with open(path, "w") as f:
            f.write(text)
        paths.append(path)
    return paths
