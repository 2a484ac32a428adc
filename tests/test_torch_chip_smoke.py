"""chip_smoke.py's serve and remap phases (llama3-8b, xlstm-1.3b, moonshot,
jamba, danube, whisper, llava) and its fleet phase, rehearsed on the CPU at
a tiny size: the same engine calls, checks and printouts as on the card,
with the kernels' plain versions (the script itself refuses to run without
a CUDA device); and its pure helpers."""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from repro_torch.configs import ARCHS, scaled_config  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine, and
    PyTorch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def on_cpu(monkeypatch):
    for name, value in (("DEVICE", "cpu"), ("PROMPT", 24), ("NEW", 5),
                        ("PAGE", 4), ("REMAP_PROMPT", 18), ("REMAP_NEW", 6),
                        ("REMAP_PAGES", (8, 64))):
        monkeypatch.setattr(chip_smoke, name, value)
    return dataclasses.replace(scaled_config(ARCHS["llama3-8b"],
                                             num_layers=2), dtype="bfloat16")


def test_serve_and_remap_phases_run(on_cpu, capsys):
    launches = chip_smoke.phase_serve(on_cpu)
    assert set(launches) == {"paged_decode_attention",
                             "paged_prefill_attention", "flash_attention",
                             "ssd_scan"}
    chip_smoke.phase_remap(on_cpu)
    out = capsys.readouterr().out
    assert "finished 8 requests" in out
    assert "generated tokens identical to the ample-pool run" in out


def test_xlstm_serve_and_remap_phases_run(on_cpu, capsys):
    """16 layers: two repeats of the 8-layer pattern, bf16."""
    cfg = dataclasses.replace(scaled_config(ARCHS["xlstm-1.3b"],
                                            num_layers=16), dtype="bfloat16")
    counts = chip_smoke.phase_xlstm(cfg)
    assert counts["ssd_scan"] == 0          # the plain version on the CPU
    chip_smoke.phase_xlstm_remap(cfg)
    out = capsys.readouterr().out
    assert "[xlstm] dense tenant: finished 8 requests" in out
    assert "prefill of P-1 and one decode step" in out
    assert "1 remap and" in out
    assert "generated tokens identical to the ample-budget run" in out


def _bf16(arch, layers):
    return dataclasses.replace(scaled_config(ARCHS[arch], num_layers=layers),
                               dtype="bfloat16")


@pytest.fixture
def small_new_phases(on_cpu, monkeypatch):
    for name, value in (("MOE_TOKENS", 48), ("RING_BATCH", 2),
                        ("RING_PROMPT", 80), ("RING_NEW", 4)):
        monkeypatch.setattr(chip_smoke, name, value)


def test_moe_phase_runs(small_new_phases, capsys):
    """moonshot (MoE on every layer) as a paged tenant, bf16."""
    launches = chip_smoke.phase_moonshot(
        _bf16("moonshot-v1-16b-a3b", 2))
    assert set(launches) == set(chip_smoke.SOURCES)
    out = capsys.readouterr().out
    assert "[moe] MoE layer, 48 tokens" in out
    assert "tokens with another top-2 set 0" in out
    assert "[moe] no remap on the card" in out
    assert out.count("[moe] chunk=") == 2
    assert "finished 8 requests" in out


def test_hybrid_phase_runs(small_new_phases, capsys):
    """jamba (Mamba + attention, MoE) as a dense tenant: 8 layers, two
    repeats of the scaled 4-layer pattern, bf16."""
    counts = chip_smoke.phase_jamba(_bf16("jamba-v0.1-52b", 8))
    assert counts["ssd_scan"] == counts["flash_attention"] == 0   # CPU
    out = capsys.readouterr().out
    assert "[hybrid] Mamba layer, prefill of 24 tokens and 4 decode" in out
    assert "[hybrid] MoE layer, 48 tokens" in out
    assert "[hybrid] dense tenant: finished 8 requests" in out
    assert "(6 Mamba and 2 attention layers a prompt)" in out


def test_ring_phase_runs(small_new_phases, capsys):
    """danube's sliding window (64 slots scaled) with 80-token prompts, then
    the two-tenant remap; bf16."""
    chip_smoke.phase_danube(_bf16("h2o-danube-3-4b", 2))
    out = capsys.readouterr().out
    assert "[ring] dense ring tenant (64-slot ring, prompts of 80 tokens)" \
        in out
    assert "finished 2 requests" in out
    assert "one decode step at position 80 (past the 64-token window)" in out
    assert "[ring-remap] 1 remap and" in out
    assert "generated tokens identical to the ample-budget run" in out


@pytest.fixture
def small_encdec_vlm(on_cpu, monkeypatch):
    for name, value in (("WHISPER_BATCH", 2), ("WHISPER_PROMPT", 20),
                        ("WHISPER_CUT", 1), ("WHISPER_CPU_ROWS", 1),
                        ("WHISPER_SERVE_PROMPT", 20), ("LLAVA_BATCH", 2),
                        ("LLAVA_PROMPT", 20), ("LLAVA_NEW", 4),
                        ("LLAVA_CONTEXT", 64)):
        monkeypatch.setattr(chip_smoke, name, value)


def test_whisper_phases_run(small_encdec_vlm, capsys):
    """whisper (2 encoder + 2 decoder layers scaled, 64 source rows) as a
    dense tenant, its prefill checks, then the two-tenant remap; bf16."""
    cfg = _bf16("whisper-medium", 2)
    counts = chip_smoke.phase_whisper(cfg)
    assert counts["flash_attention"] == 0           # the plain version
    chip_smoke.phase_whisper_remap(cfg)
    out = capsys.readouterr().out
    assert "[whisper] Model.prefill of 2 requests x 64 frames and 20 " \
        "prompt tokens" in out
    assert "first-token logits of 1 + 1 layers, 1 requests" in out
    assert "[whisper] dense tenant: finished 8 requests, 40 tokens" in out
    assert "(6 a request: encoder, decoder self and cross)" in out
    assert "32 frames, cross cache of 64 rows" in out
    assert "[whisper-remap] 1 remap and" in out
    assert "generated tokens identical to the ample-budget run" in out


def test_vlm_phase_runs(small_encdec_vlm, capsys):
    """llava (2 layers scaled, 16 patch rows) as a dense tenant; bf16."""
    chip_smoke.phase_llava(_bf16("llava-next-34b", 2))
    out = capsys.readouterr().out
    assert "[vlm] dense tenant: finished 2 requests, 8 tokens" in out
    assert "one decode step at position 36 (token" in out
    assert "after 16 patch rows and 20 prompt tokens" in out


@pytest.fixture
def fleet_on_cpu(monkeypatch):
    """Phase 13 at its own trace, pool and page sizes (routing and page
    accounting are the card's, step for step) on a 2-layer, 128-wide llama
    in bf16. The spec that prices import against recompute gets a slow
    card, so that moving a 2-layer span also costs less than recomputing
    it, as a full-width span does on GH200."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "FLEET_HW", dataclasses.replace(
        chip_smoke.GH200, name="gh200-slow", flops_bf16=1e9))
    return dataclasses.replace(scaled_config(ARCHS["llama3-8b"],
                                             num_layers=2), dtype="bfloat16")


def test_fleet_phase_runs(fleet_on_cpu, capsys):
    counts = chip_smoke.phase_fleet_import(fleet_on_cpu)
    assert counts["paged_prefill_attention"] == 0   # the plain versions
    chip_smoke.phase_fleet_scale(fleet_on_cpu)
    out = capsys.readouterr().out
    # 4 spans of 384 tokens, 2 layers x 2 kv heads x 32 x (K, V) x 2 bytes
    span = 384 * 2 * 2 * 32 * 2 * 2
    assert f"imported {4 * span} bytes in 4 imports" in out
    assert "imported pages torch.equal to the donor's export" in out
    assert "first-token logits of the 4 requests on imported spans" in out
    assert "'revert-teardown': 1" in out
    assert "cycle layers left 0" in out
    assert "(96, 96), (96, 96)" in out


def test_fleet_phase_sees_a_wrong_import(fleet_on_cpu, monkeypatch):
    """An import that writes anything but the donor's pages fails the
    phase at the first import."""
    from repro_torch.serving import ServingEngine

    real = ServingEngine.import_prefix

    def shifted(self, model, tokens, n_tokens, kv=None):
        return real(self, model, tokens, n_tokens,
                    kv=None if kv is None else (kv[0] + 1, kv[1]))

    monkeypatch.setattr(ServingEngine, "import_prefix", shifted)
    with pytest.raises(SystemExit, match="differ from the donor's export"):
        chip_smoke.phase_fleet_import(fleet_on_cpu)

def test_decode_check_sees_a_lost_src_len():
    """Phase 10's decode/no-cache check on whisper (f32, scaled): passes
    with the state's src_len, fails by far with it dropped, as the
    reference engine's slot insertion drops it."""
    from repro_torch.models import build_model

    cfg = scaled_config(ARCHS["whisper-medium"], num_layers=2)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    batch = {"frames": torch.from_numpy(rng.standard_normal(
        (1, 32, cfg.d_model)).astype(np.float32) * 0.02),
        "tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 12)))}
    gap, _ = chip_smoke.decode_vs_no_cache(model, params, batch, 32)
    assert gap < 1e-5

    class Lost:                 # prefill's state without its src_len
        cfg = model.cfg

        def prefill(self, *a):
            logits, state = model.prefill(*a)
            del state["src_len"]
            return logits, state

        def decode_step(self, *a):
            return model.decode_step(*a)
    gap, _ = chip_smoke.decode_vs_no_cache(Lost(), params, batch, 32)
    assert gap > chip_smoke.LOGIT_RTOL


@pytest.mark.parametrize("shape", sorted(chip_smoke.FLASH_SHAPES))
def test_flash_shapes_are_the_served_models(shape):
    """Phase 2's whisper and llava flash shapes: the configs' heads, the
    phases' batches and lengths."""
    b, sq, sk, hq, hkv, d, causal = chip_smoke.FLASH_SHAPES[shape]
    cfg = ARCHS["llava-next-34b" if shape == "llava_prefix"
                else "whisper-medium"]
    assert (hq, hkv, d) == (cfg.num_heads, cfg.num_kv_heads,
                            cfg.resolved_head_dim)
    if shape == "llava_prefix":
        assert (b, sq, causal) == (1, cfg.num_image_patches
                                   + chip_smoke.LLAVA_PROMPT, True)
        assert sq + chip_smoke.LLAVA_NEW < chip_smoke.LLAVA_CONTEXT
    elif shape.startswith("whisper_engine"):       # one engine request
        src, dec = min(cfg.max_source_len, 32), chip_smoke.WHISPER_SERVE_PROMPT
        assert b == 1
        assert (sq, sk, causal) == {
            "whisper_engine_encoder": (src, src, False),
            "whisper_engine_decoder": (dec, dec, True),
            "whisper_engine_cross": (dec, src, False)}[shape]
    else:                                          # the prefill check
        src, dec = cfg.max_source_len, chip_smoke.WHISPER_PROMPT
        assert b == chip_smoke.WHISPER_BATCH
        assert (sq, sk, causal) == {"whisper_encoder": (src, src, False),
                                    "whisper_decoder": (dec, dec, True),
                                    "whisper_cross": (dec, src, False)}[shape]


def test_weight_read_bound_leaves_out_the_encoder():
    """A decode step never runs whisper's encoder: its weights do not count
    toward the bound."""
    from repro_torch.models import build_model

    cfg = scaled_config(ARCHS["whisper-medium"], num_layers=2)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    without = {k: v for k, v in params.items() if k != "encoder"}
    assert chip_smoke.weight_read_ms(params, cfg, 2) == \
        chip_smoke.weight_read_ms(without, cfg, 2)


@pytest.mark.parametrize("shape", sorted(chip_smoke.SHAPES))
def test_phase2_shapes_fit_their_tables_and_match_the_served_models(shape):
    """Phase 2's moonshot and danube shapes: every decode context and
    prefill chunk lies inside its page table, and they are the served
    configs' head shapes (danube's timed decode and chunk past its
    window where it has one)."""
    hq, hkv, d, window, b, lens, n, starts, s = chip_smoke.SHAPES[shape]
    cfg = ARCHS["moonshot-v1-16b-a3b" if shape == "moonshot"
                else "h2o-danube-3-4b"]
    assert (hq, hkv, d) == (cfg.num_heads, cfg.num_kv_heads,
                            cfg.resolved_head_dim)
    assert window in (0, cfg.sliding_window) and len(lens) == b
    assert max(lens) <= n * chip_smoke.PAGE
    assert max(starts) + 256 <= n * chip_smoke.PAGE
    if window:
        assert lens[0] > window and starts[-1] + 256 > window and s > window


@pytest.mark.parametrize("window", [0, 4096])
def test_row_err_sees_a_one_tile_fault(window):
    """Phase 2's row check at danube's flash shape (4608 tokens, head dim
    120; two heads here): the reference rounded to bf16 passes it, and the
    output with the window edge one 64-key tile off (the last row leaves
    out its first tile) fails it by far."""
    from repro_torch.models import attention_ops as plain

    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 4608, 2, 120))
                                .astype(np.float32)) for _ in range(3))
    ref = plain.flash_attention(q, k, v, window=window)
    fault = plain.flash_attention(q, k, v, window=(window or 4608) - 64)
    limit = chip_smoke.ROW_RTOL[torch.bfloat16]
    assert chip_smoke.row_err(ref.to(torch.bfloat16), ref) < limit / 2
    assert chip_smoke.row_err(fault, ref) > 5 * limit


def test_ssd_work_counts_the_ragged_chunk():
    bf16, f32 = chip_smoke.ssd_chunk_work(65, 2, 3, chunk=64)
    pairs = 64 * 65 // 2 + 1
    assert bf16 == pairs * 2 * 2
    assert f32 == pairs * 2 * 3 + 2 * 1 * 2 * 3 + 2 * 65 * 2 * 3
    nbytes, _, _ = chip_smoke.ssd_work(1, 65, 1, 2, 3)
    assert nbytes == 2 * 65 * 2 * 2 + 65 * 3 * 4 + 65 * 4 + 65 * 3 * 4 \
        + 2 * 3 * 4


@pytest.mark.parametrize("t,dk,dv,chunk", [
    (8, 16, 4, 8),              # T < 2 dk: one chunk, the quadratic form
    (64, 2, 3, 1),              # T >> dk: the token-by-token recurrence
    # the serve shape: a 496-token chunk and a ragged 16 trade bf16 scores
    # for f32 inter-chunk products, a little under the quadratic form
    (512, 512, 513, 496)])
def test_ssd_work_takes_the_cheapest_chunk(t, dk, dv, chunk):
    _, bf16, f32 = chip_smoke.ssd_work(2, t, 3, dk, dv)
    assert (bf16, f32) == tuple(6 * w for w in chip_smoke.ssd_chunk_work(
        t, dk, dv, chunk))
    quadratic = chip_smoke.ssd_chunk_work(t, dk, dv, t)
    assert quadratic == (t * (t + 1) * dk,
                         t * (t + 1) * dv + 2 * t * dk * dv)
    for w in (quadratic, chip_smoke.ssd_chunk_work(t, dk, dv, 64)):
        assert chip_smoke.bound(0, bf16, f32) <= chip_smoke.bound(
            0, 6 * w[0], 6 * w[1])


def test_refuses_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        chip_smoke.main()
    assert e.value.code != 0
    assert '"ok"' not in capsys.readouterr().out


def test_attention_work_counts_the_visible_keys():
    # causal S=4: 1 + 2 + 3 + 4 keys; a window of 2: 1 + 2 + 2 + 2
    assert chip_smoke.attention_work(4, 4, 2, 1, 8) == (
        (2 * 4 * 2 * 8 + 2 * 4 * 1 * 8) * 2, 4 * 2 * 8 * 10)
    assert chip_smoke.attention_work(4, 4, 2, 1, 8, window=2)[1] == \
        4 * 2 * 8 * 7
    assert chip_smoke.attention_work(3, 5, 1, 1, 8, causal=False)[1] == \
        4 * 8 * 15
    # the serve shape's bound: S (S + 1) / 2 pairs
    assert chip_smoke.attention_work(2048, 2048, 32, 8, 128)[1] == \
        4 * 32 * 128 * 2048 * 2049 // 2


PTXAS = """\
ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async \
instructions are serialized due to insufficient register resources for the \
function '_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_f0d7563511flash_\
wgmmaILi2EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16iiiiiiif'
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__e7510225_18_flash_\
attention_cu_f0d7563511flash_wgmmaILi2EEEv14CUtensorMap_stS1_S1_P13__nv_\
bfloat16iiiiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__e7510225_18_flash_\
attention_cu_f0d7563511flash_wgmmaILi2EEEv14CUtensorMap_stS1_S1_P13__nv_\
bfloat16iiiiiiif
    72 bytes stack frame, 72 bytes spill stores, 76 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 72 bytes cumulative \
stack size
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__70402df9_11_ssd_\
scan_cu_ac0ed4ba10ssd_statesI13__nv_bfloat16EEvPKT_S4_PKfS6_PfS7_S7_S7_NS_\
5ShapeE' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 17152 bytes smem
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__70402df9_11_ssd_\
scan_cu_ac0ed4ba11ssd_outputsEPKfS1_S1_S1_PfNS_5ShapeE' for 'sm_90a'
ptxas info    : Used 64 registers, used 1 barriers
"""


def test_ptxas_summary_reads_registers_spills_and_serialisation():
    got = chip_smoke.ptxas_summary(PTXAS)
    assert got == [
        {"kernel": "flash_wgmma<2>", "registers": 168, "smem": 0,
         "spill_stores": 72, "spill_loads": 76, "wgmma_serialized": True},
        {"kernel": "ssd_states<bf16>", "registers": 80, "smem": 17152,
         "spill_stores": 0, "spill_loads": 0, "wgmma_serialized": False},
        {"kernel": "ssd_outputs", "registers": 64, "smem": 0,
         "spill_stores": 0, "spill_loads": 0, "wgmma_serialized": False}]
    assert chip_smoke.ptxas_summary("") == []


@pytest.mark.parametrize("mangled,name", [
    ("_ZN48_GLOBAL__N__22431cb3_15_paged_decode_cu_9313802a12decode_splitI13"
     "__nv_bfloat16Li4ELi16ELi1EEEvPKT_S4_S4_PKiS6_PS2_Pfiiiiiiif",
     "decode_split<bf16, 4, 16, 1>"),
    ("_ZN49_GLOBAL__N__f17dc337_16_paged_prefill_cu_95b0c20311paged_wgmmaILi2"
     "ELb1EEEv14CUtensorMap_stS1_PK13__nv_bfloat16S4_S4_PKiS6_S6_PS2_iiiiii"
     "iiif", "paged_wgmma<2, true>"),
    ("_ZN48_GLOBAL__N__22431cb3_15_paged_decode_cu_9313802a14decode_combineI"
     "fEEvPKfPT_ii", "decode_combine<float>"),
    ("_ZN49_GLOBAL__N__f17dc337_16_paged_prefill_cu_95b0c2039paged_f32EPKfS1"
     "_S1_PKiS3_S3_Pfiiiiiiif", "paged_f32")])
def test_kernel_name_reads_every_template_argument(mangled, name):
    assert chip_smoke.kernel_name(mangled) == name


@pytest.mark.parametrize("key,name", [
    ("void (anonymous namespace)::decode_split<__nv_bfloat16, 4, 16, 1>("
     "__nv_bfloat16 const*, int)", "decode_split"),
    ("void (anonymous namespace)::ssd_outputs(float const*, "
     "(anonymous namespace)::Shape)", "ssd_outputs"),
    ("ssd_states", "ssd_states")])
def test_profiler_kernel_keys_lose_namespace_and_arguments(key, name):
    assert chip_smoke._kernel_key(key) == name
