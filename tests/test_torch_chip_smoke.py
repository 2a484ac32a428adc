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
    phases' batches and lengths; phase 17's moonshot row: a rank's heads
    of the (2, 2) mesh and a data rank's row."""
    b, sq, sk, hq, hkv, d, causal = chip_smoke.FLASH_SHAPES[shape]
    data, model = chip_smoke.MESH_LAYOUT
    if "_mesh_" in shape and shape != "moonshot_mesh_rank":
        # phase 18's: a rank's heads and a data rank's row
        run = shape.split("_")[0]
        cfg, rows, seq, _ = chip_smoke.ENCDEC_VLM_RUNS[run]
        assert (b, hq, hkv, d) == (rows // data, cfg.num_heads // model,
                                   cfg.num_kv_heads // model,
                                   cfg.resolved_head_dim)
        from repro_torch.models.registry import WHISPER_DECODER_LEN
        dec = min(WHISPER_DECODER_LEN, seq)
        want = {"whisper_mesh_encoder": (seq, seq, False),
                "whisper_mesh_decoder": (dec, dec, True),
                "whisper_mesh_cross": (dec, seq, False),
                "llava_mesh_rank": (seq, seq, True)}[shape]
        assert (sq, sk, causal) == want
        return
    if shape == "moonshot_mesh_rank":
        cfg, rows, seq, _ = chip_smoke.MOE_SSM_RUNS["moonshot"]
        data, model = chip_smoke.MESH_LAYOUT
        assert (hq, hkv, d) == (cfg.num_heads // model,
                                cfg.num_kv_heads // model,
                                cfg.resolved_head_dim)
        assert (b, sq, sk, causal) == (rows // data, seq, seq, True)
        return
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


# ------------------------------------------------------------ phase 14
@pytest.fixture
def train_on_cpu(monkeypatch):
    for name, value in (("DEVICE", "cpu"), ("TRAIN_SEQ", 48),
                        ("CHECK_SEQ", 32), ("XLSTM_TRAIN_SEQ", 32)):
        monkeypatch.setattr(chip_smoke, name, value)
    return dataclasses.replace(scaled_config(ARCHS["llama3-8b"],
                                             num_layers=2), dtype="bfloat16")


def test_train_phase_runs(train_on_cpu, capsys):
    counts = chip_smoke.phase_train_llama(train_on_cpu)
    chip_smoke.check_train_against_cpu(train_on_cpu)
    out = capsys.readouterr().out
    n = chip_smoke.TRAIN_STEPS + chip_smoke.FIXED_STEPS
    assert f"[train] step {n - 1}:" in out and "(profiled)" in out
    assert "[train] fixed batch: loss" in out and "tokens/s" in out
    assert "[train-check] 2 layers" in out
    assert set(counts) == set(chip_smoke.SOURCES)


def test_train_xlstm_phase_runs(train_on_cpu, capsys):
    cfg = dataclasses.replace(scaled_config(ARCHS["xlstm-1.3b"],
                                            num_layers=8), dtype="bfloat16")
    chip_smoke.phase_train_xlstm(cfg)
    out = capsys.readouterr().out
    assert "[train-xlstm] step 2:" in out
    assert "ssd_scan launches a step 0 for 7 mLSTM layers" in out


def _detached_bf16_attention(monkeypatch):
    """Attention whose bf16 output carries no grad_fn (what a kernel output
    outside the autograd Function would be); f32 keeps its gradient."""
    from repro_torch.models import blocks
    real = blocks.flash_attention

    def attention(q, k, v, **kw):
        out = real(q, k, v, **kw)
        return out.detach() if q.dtype == torch.bfloat16 else out
    monkeypatch.setattr(blocks, "flash_attention", attention)


def test_train_phase_sees_a_missing_gradient(train_on_cpu, monkeypatch):
    _detached_bf16_attention(monkeypatch)
    with pytest.raises(SystemExit, match="all-zero gradient"):
        chip_smoke.phase_train_llama(train_on_cpu)


def test_train_check_sees_a_missing_gradient(train_on_cpu, monkeypatch):
    _detached_bf16_attention(monkeypatch)
    with pytest.raises(SystemExit, match="train-check: gradient of blocks"):
        chip_smoke.check_train_against_cpu(train_on_cpu)


def test_train_cut_is_what_fits_one_card():
    """8 of llama3-8b's 32 layers: ~16 bytes a parameter with AdamW fit an
    80 GB card with room for activations; 16 layers leave under 8 GB for
    them and for the update's f32 temporaries."""
    from repro_torch.models.common import tree_leaves as leaves

    def n_params(layers):
        cfg = dataclasses.replace(ARCHS["llama3-8b"], num_layers=layers)
        return sum(int(np.prod(s.shape))
                   for s in leaves(chip_smoke.build_model(cfg).specs()))
    assert round(n_params(chip_smoke.TRAIN_LAYERS) / 1e9, 2) == 2.80
    assert n_params(chip_smoke.TRAIN_LAYERS) * 16 < 50e9
    assert n_params(16) * 16 > 72e9


@pytest.mark.parametrize("name,arch", [("llama3-8b", "llama3-8b"),
                                       ("danube", "h2o-danube-3-4b")])
def test_train_flash_shapes_are_the_models(name, arch):
    s, hq, hkv, d, window = chip_smoke.TRAIN_FLASH[name]
    cfg = ARCHS[arch]
    assert (hq, hkv, d, window) == (cfg.num_heads, cfg.num_kv_heads,
                                    cfg.resolved_head_dim,
                                    cfg.sliding_window)
    assert s > window


@pytest.fixture
def dist_on_cpu(monkeypatch):
    """Phase 15 at a small width on the CPU: (b)'s cases at 4/2 heads of 16
    (B=1 over 256 keys, B=4 over 64), (c)'s fwd_dec on one layer of the
    scaled llama in bf16 with a 64-slot cache, one timed rep."""
    cfg = dataclasses.replace(scaled_config(ARCHS["llama3-8b"],
                                            num_layers=1), dtype="bfloat16")
    for name, value in (("DEVICE", "cpu"), ("DIST_HEADS", (4, 2, 16)),
                        ("DIST_CASES", {"b1": (1, 256), "b4": (4, 64)}),
                        ("DIST_REPS", 1), ("DIST_FWD_CFG", cfg),
                        ("DIST_FWD", (4, 64, (63, 40, 32, 3)))):
        monkeypatch.setattr(chip_smoke, name, value)


def test_distributed_phase_runs(dist_on_cpu, capsys):
    """Phase 15 on 2 gloo ranks on the CPU: the serve CLI, both decode
    cases and the fwd_dec step pass their checks and print their times."""
    counts = chip_smoke.phase_distributed()
    assert counts["flash_attention"] == 0          # the plain versions
    out = capsys.readouterr().out
    assert "[dist] (a) serve CLI: finished 8 requests" in out
    for name in ("b1", "b4"):
        line = next(x for x in out.splitlines()
                    if x.startswith(f"[dist] (b) {name} "))
        assert "rank 0 keys" in line and "rank 1 keys" in line
        assert "partial" in line and "combine" in line
    assert "new rows written True" in out
    assert "part (b, c) took" in out and "on the CPU" in out


def test_distributed_phase_fails_with_a_rank(dist_on_cpu, monkeypatch,
                                             tmp_path):
    """A rank that fails (here: 3 query heads over 2 KV heads) fails the
    phase."""
    monkeypatch.setattr(chip_smoke, "DIST_HEADS", (3, 2, 16))
    with pytest.raises(Exception, match="ProcessRaisedException|3, 2|"
                                        "process 0 terminated"):
        chip_smoke.phase_dist(str(tmp_path))


def test_distributed_phase_shapes_are_llama3_8b():
    """Phase 15 runs at llama3-8b's attention width: its heads and head
    dim, B=1 over 131,072 keys (512 MiB of bf16 K+V, half a rank on 2),
    B=8 at 8,192; (c)'s slots lie in both ranks' halves of its cache."""
    cfg = ARCHS["llama3-8b"]
    assert chip_smoke.DIST_HEADS == (cfg.num_heads, cfg.num_kv_heads,
                                     cfg.resolved_head_dim)
    assert chip_smoke.DIST_FWD_CFG is cfg
    assert chip_smoke.DIST_CASES == {"b1_131k": (1, 131072),
                                     "b8_8k": (8, 8192)}
    assert 2 * 131072 * cfg.num_kv_heads * cfg.resolved_head_dim * 2 \
        == 512 * 2**20
    b, cache, slots = chip_smoke.DIST_FWD
    half = cache // chip_smoke.DIST_WORLD
    assert len(slots) == b and max(slots) < cache
    assert {s // half for s in slots} == set(range(chip_smoke.DIST_WORLD))


@pytest.fixture
def mesh_on_cpu(monkeypatch):
    """Phase 16 at a small width on the CPU: the scaled llama (2 layers,
    bf16), a global batch of 2 x 32."""
    cfg = dataclasses.replace(scaled_config(ARCHS["llama3-8b"],
                                            num_layers=2), dtype="bfloat16")
    for name, value in (("DEVICE", "cpu"), ("MESH_CFG", cfg),
                        ("MESH_SEQ", 32)):
        monkeypatch.setattr(chip_smoke, name, value)


def test_mesh_train_phase_runs(mesh_on_cpu, capsys):
    """Phase 16 on 4 gloo ranks on the CPU: (a)-(d) pass their checks and
    print the step times, collectives by kind, peak memory, the worst
    leaf, the moves' diffs and the launcher's falling loss."""
    counts = chip_smoke.phase_mesh_train([])
    assert counts["flash_attention"] == 0          # the plain versions
    out = capsys.readouterr().out
    steps = [x for x in out.splitlines() if x.startswith("[mesh] (b) step")]
    assert len(steps) == chip_smoke.MESH_STEPS
    for line in steps:
        le = float(line.split("rel err ")[1].split(",")[0])
        assert le <= chip_smoke.MESH_LOSS_RTOL
    coll = next(x for x in out.splitlines()
                if "collectives of rank 0's last step" in x)
    for kind in ("fsdp_all_gather", "fsdp_reduce_scatter", "tp_all_reduce",
                 "ce_all_reduce", "grad_all_reduce"):
        assert kind in coll
    assert "peak memory per rank" in out and "worst row_err" in out
    assert "worst update error" in out
    assert "and back: diff 0 on every rank" in out
    cli = next(x for x in out.splitlines() if x.startswith("[mesh] (d)"))
    losses = [float(v) for v in cli.split("losses [")[1].split("]")[0]
              .split(",")]
    assert len(losses) == 5 and losses[-1] < losses[0]
    assert "parts (b)-(d) on 4 ranks took" in out


def test_mesh_train_phase_sees_a_wrong_rank(mesh_on_cpu, monkeypatch):
    """A mesh run that departs from one rank's fails the phase: here the
    one-rank reference steps at another learning rate (the spawned ranks
    import the script afresh and keep TRAIN_OPT), so their second step's
    loss differs."""
    monkeypatch.setattr(chip_smoke, "TRAIN_OPT",
                        dict(learning_rate=0.3, warmup_steps=1))
    with pytest.raises(SystemExit, match="loss or grad norm off one rank"):
        chip_smoke.phase_mesh_train([])


def test_mesh_train_phase_sees_an_update_that_does_nothing(mesh_on_cpu,
                                                           monkeypatch,
                                                           capsys):
    """At AdamW's small first steps the losses, grad norms and leaves of a
    run that does not update stay within their limits of one that does;
    the update check does not: here the one-rank reference steps at
    learning rate 0 and its update reads 1."""
    monkeypatch.setattr(chip_smoke, "TRAIN_OPT",
                        dict(learning_rate=0.0, warmup_steps=1))
    with pytest.raises(SystemExit, match="update off one rank's: 1.0 >"):
        chip_smoke.phase_mesh_train([])
    out = capsys.readouterr().out
    steps = [x for x in out.splitlines() if x.startswith("[mesh] (b) step")]
    assert len(steps) == chip_smoke.MESH_STEPS
    worst = next(x for x in out.splitlines() if "worst row_err" in x)
    assert float(worst.split("worst row_err ")[1].split()[0]) <= \
        chip_smoke.ROW_RTOL[torch.bfloat16]


def test_mesh_train_phase_is_llama3_8b_cut_in_depth():
    """Phase 16 trains llama3-8b at full width, 4 of its 32 layers (1.92 B
    params), on a (2, 2) mesh: every rank takes 16 query heads and 4 KV
    heads, the flash shape row 3i."""
    cfg = chip_smoke.MESH_CFG
    full = ARCHS["llama3-8b"]
    assert dataclasses.replace(cfg, num_layers=full.num_layers) == full
    assert cfg.num_layers == 4
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    n = sum(int(np.prod(s.shape))
            for s in tree_leaves(build_model(cfg).specs()))
    assert round(n / 1e9, 2) == 1.92
    assert chip_smoke.MESH_LAYOUT == (2, 2) and chip_smoke.MESH_WORLD == 4
    assert (cfg.num_heads // 2, cfg.num_kv_heads // 2) == (16, 4)
    assert (chip_smoke.MESH_BATCH, chip_smoke.MESH_SEQ) == (2, 2048)


@pytest.fixture
def moe_ssm_on_cpu(monkeypatch):
    """Phase 17 at a small width on the CPU (bf16): scaled moonshot (2
    layers; a global batch of 2 x 32 tokens, one MoE group per data rank),
    scaled jamba's layer 0 (Mamba) and scaled xlstm at 8 layers (2 x 16);
    the decode-scale MoE batch 2 x 8 (one group over both data ranks)."""
    def cut(arch, layers):
        return dataclasses.replace(scaled_config(ARCHS[arch],
                                                 num_layers=layers),
                                   dtype="bfloat16")
    runs = {"moonshot": (cut("moonshot-v1-16b-a3b", 2), 2, 32,
                         "dots_saveable"),
            "jamba": (cut("jamba-v0.1-52b", 1), 2, 32, "dots_saveable"),
            "xlstm": (cut("xlstm-1.3b", 8), 2, 16, "none")}
    for name, value in (("DEVICE", "cpu"), ("MOE_SSM_RUNS", runs),
                        ("MOE_DECODE_BATCH", (2, 8))):
        monkeypatch.setattr(chip_smoke, name, value)


def test_moe_ssm_phase_runs(moe_ssm_on_cpu, capsys):
    """Phase 17 on 4 gloo ranks on the CPU: the layer checks (the MoE's
    drop pattern equal to one rank's per-group route, the decode-scale
    batch through the count exchange), the steps against one rank and the
    leaves pass; the step times, collectives by kind and peak memory are
    printed."""
    counts = chip_smoke.phase_mesh_moe_ssm()
    assert counts["flash_attention"] == 0 and counts["ssd_scan"] == 0
    out = capsys.readouterr().out
    layers = [x for x in out.splitlines() if x.startswith("[moe-ssm] (a)")]
    assert {x.split()[3] for x in layers} == {"moe_train", "moe_decode",
                                              "mamba", "mlstm", "slstm"}
    moe = [x for x in layers if " moe_" in x]
    assert all("slot equal True, disp equal True" in x for x in moe)
    assert "2 group(s)" in moe[0] and "1 group(s)" in moe[1]
    assert "moe_counts" in moe[1] and "moe_counts" not in moe[0]
    assert "step 0's first MoE layer: of 128 assignments" in out
    mamba = next(x for x in layers if " mamba " in x)
    assert "tp_all_gather" in mamba
    steps = [x for x in out.splitlines() if x.startswith("[moe-ssm] (b)")
             and ": loss " in x]
    assert len(steps) == 3 * chip_smoke.MESH_STEPS
    for name in ("moonshot", "jamba", "xlstm"):
        assert f"[moe-ssm] (c) {name} peak memory per rank" in out
        assert f"[moe-ssm] (b) {name} leaves after step" in out
    # the mixers' gradients at (a), and (b)'s control
    assert all("its leaves' gradients, row_err" in x
               for x in layers if " moe_" not in x)
    for name in ("moonshot", "jamba", "xlstm"):
        assert f"[moe-ssm] (b) {name} control, one rank with its weights " \
            f"moved by a bf16 last bit" in out


def test_moe_ssm_phase_sees_a_wrong_drop_pattern(moe_ssm_on_cpu,
                                                 monkeypatch):
    """A mesh whose MoE groups differ from the reference's fails the
    phase: here the one-rank reference groups the training batch as one
    group (the spawned ranks import the script afresh and keep the JAX
    block's grouping)."""
    monkeypatch.setattr(chip_smoke, "_moe_groups", lambda cfg, t, s: 1)
    with pytest.raises(SystemExit, match="drop pattern differs"):
        chip_smoke.phase_mesh_moe_ssm()


def test_moe_ssm_phase_sees_a_fault_in_one_heads_gradient(moe_ssm_on_cpu,
                                                         monkeypatch):
    """A fault confined to one head's rows of a leaf drawn at a tenth of
    the scale fails the phase at (a)'s gradients: the one-rank reference's
    sLSTM scales head 0's gradient of ``r`` by 1.1 (the spawned ranks
    import the blocks afresh)."""
    from repro_torch.models.blocks import SLSTM

    class ScaleHead0(torch.autograd.Function):
        @staticmethod
        def forward(ctx, r):
            return r.view_as(r)

        @staticmethod
        def backward(ctx, g):
            g = g.clone()
            g[0] *= 1.1
            return g

    fwd_seq = SLSTM.fwd_seq

    def faulty(self, p, *args, **kwargs):
        return fwd_seq(self, {**p, "r": ScaleHead0.apply(p["r"])}, *args,
                       **kwargs)
    monkeypatch.setattr(SLSTM, "fwd_seq", faulty)
    with pytest.raises(SystemExit, match="slstm: the gradient of leaf r "):
        chip_smoke.phase_mesh_moe_ssm()


def test_moe_ssm_phase_runs_are_cut_in_depth_only():
    """Phase 17 runs moonshot-v1-16b-a3b (2 of 48 layers, 1.81 B params),
    jamba-v0.1-52b's layer 0 (Mamba and a dense FFN, 0.81 B) and
    xlstm-1.3b (8 of 48 layers, 0.35 B) at full width on phase 16's (2, 2)
    mesh: 32 experts, 64 Mamba heads and 2 xLSTM heads a rank."""
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    want = {"moonshot": ("moonshot-v1-16b-a3b", 2, 1.81, 2048),
            "jamba": ("jamba-v0.1-52b", 1, 0.81, 2048),
            "xlstm": ("xlstm-1.3b", 8, 0.35, 512)}
    assert set(chip_smoke.MOE_SSM_RUNS) == set(want)
    for name, (cfg, b, s, _) in chip_smoke.MOE_SSM_RUNS.items():
        arch, layers, params, seq = want[name]
        full = ARCHS[arch]
        assert dataclasses.replace(cfg, num_layers=full.num_layers) == full
        assert cfg.num_layers == layers and (b, s) == (2, seq)
        model = build_model(cfg)
        n = sum(int(np.prod(x.shape)) for x in tree_leaves(model.specs()))
        assert round(n / 1e9, 2) == params, (name, n)
    pattern = build_model(chip_smoke.MOE_SSM_RUNS["jamba"][0]).impl.pattern
    assert [(ld.mixer, ld.ffn) for ld in pattern] == [("mamba", "dense")]
    assert chip_smoke.MESH_LAYOUT == (2, 2)
    b, s = chip_smoke.MOE_DECODE_BATCH
    moe = ARCHS["moonshot-v1-16b-a3b"].moe
    assert b * s * moe.top_k <= 8 * moe.num_experts


@pytest.mark.parametrize("name", sorted(chip_smoke.SSD_RANK_SHAPES))
def test_ssd_rank_shapes_are_phase_17s(name):
    """Phase 2's ssd_scan rows at the ranks' shapes: jamba's Mamba (d_in /
    64 heads split over "model", d_state, one data rank's 2048 tokens) and
    xlstm's mLSTM (its heads split, head_dim and head_dim + 1)."""
    from repro_torch.models.blocks import Mamba
    b, t, h, dk, dv, mlstm = chip_smoke.SSD_RANK_SHAPES[name]
    data, model = chip_smoke.MESH_LAYOUT
    run = "jamba" if name.startswith("jamba") else "xlstm"
    cfg, rows, seq, _ = chip_smoke.MOE_SSM_RUNS[run]
    assert (b, t) == (rows // data, seq)
    if run == "jamba":
        _, heads, n = Mamba().dims(cfg)
        assert (h, dk, dv, mlstm) == (heads // model, n, Mamba.HEAD_DIM,
                                      False)
    else:
        hd = cfg.resolved_head_dim
        assert (h, dk, dv, mlstm) == (cfg.num_heads // model, hd, hd + 1,
                                      True)


@pytest.fixture
def encdec_vlm_on_cpu(monkeypatch):
    """Phase 18 at a small width on the CPU (bf16): scaled whisper (2 + 2
    layers; 2 rows of 32 frames and 32 decoder tokens) and scaled llava at
    1 layer (2 x 32 positions, 16 of them patch rows)."""
    def cut(arch, layers):
        return dataclasses.replace(scaled_config(ARCHS[arch],
                                                 num_layers=layers),
                                   dtype="bfloat16")
    runs = {"whisper": (cut("whisper-medium", 2), 2, 32, "dots_saveable"),
            "llava": (cut("llava-next-34b", 1), 2, 32, "dots_saveable")}
    for name, value in (("DEVICE", "cpu"), ("ENCDEC_VLM_RUNS", runs)):
        monkeypatch.setattr(chip_smoke, name, value)


def test_encdec_vlm_phase_runs(encdec_vlm_on_cpu, capsys):
    """Phase 18 on 4 gloo ranks on the CPU: whisper's encoder and decoder
    layer checks and llava's layer check (every leaf's gradient, the
    encoder's through cross-attention), the steps against one rank and the
    leaves pass; the frames are gathered over the model axis; the step
    times, collectives, peak memory and the control run are printed."""
    counts = chip_smoke.phase_mesh_encdec_vlm()
    assert counts["flash_attention"] == 0
    out = capsys.readouterr().out
    layers = [x for x in out.splitlines()
              if x.startswith("[encdec-vlm] (a)")]
    assert [x.split()[2:4] for x in layers] == [
        ["whisper", "encoder"], ["whisper", "decoder"], ["llava", "layer"]]
    assert all("its leaves' gradients, row_err" in x for x in layers)
    decoder = layers[1]
    assert "encoder/attn/wq" in decoder and "blocks/[0]/cross/wk" in decoder
    assert "frames_all_gather" in layers[0]
    steps = [x for x in out.splitlines() if x.startswith("[encdec-vlm] (b)")
             and ": loss " in x]
    assert len(steps) == 2 * chip_smoke.MESH_STEPS
    for name in ("whisper", "llava"):
        assert f"[encdec-vlm] (c) {name} peak memory per rank" in out
        assert f"[encdec-vlm] (b) {name} leaves after step" in out
        assert f"[encdec-vlm] (b) {name} control, one rank with its " \
            f"weights moved by a bf16 last bit" in out
    assert "frames_all_gather" in next(
        x for x in out.splitlines()
        if x.startswith("[encdec-vlm] (c) whisper") and "collectives" in x)


def test_encdec_vlm_phase_sees_a_fault_on_the_cross_attention_path(
        encdec_vlm_on_cpu, monkeypatch):
    """A gradient that reaches the encoder through cross-attention scaled
    by 1.1 fails the phase at (a)'s decoder check, at the encoder's
    leaves, while the encoder check alone passes: the one-rank reference's
    decoder scales the gradient of the encoder output it reads (the
    spawned ranks import the model afresh)."""
    from repro_torch.models.encdec import EncDec

    class Scale(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            return g * 1.1

    dec_seq = EncDec.dec_seq

    def faulty(self, params, x, enc_out, *args, **kwargs):
        return dec_seq(self, params, x, Scale.apply(enc_out), *args,
                       **kwargs)
    monkeypatch.setattr(EncDec, "dec_seq", faulty)
    with pytest.raises(SystemExit,
                       match="whisper decoder: the gradient of leaf enc"):
        chip_smoke.phase_mesh_encdec_vlm()


def test_encdec_vlm_phase_runs_are_cut_in_depth_only():
    """Phase 18 runs whisper-medium (4 + 4 of 24 + 24 layers, 0.26 B
    params) and llava-next-34b (1 of 60 layers, 1.48 B) at full width on
    phase 16's (2, 2) mesh, 2 rows of train_4k's 4096 positions each: 8
    of whisper's heads a rank, 28 of llava's query heads and 4 of its KV
    heads; whisper's 51865-row vocabulary stays whole."""
    import warnings
    from repro_torch.distributed.sharding import MeshLayout
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    want = {"whisper": ("whisper-medium", 4, 4, 0.26),
            "llava": ("llava-next-34b", 1, 0, 1.48)}
    assert set(chip_smoke.ENCDEC_VLM_RUNS) == set(want)
    layout = MeshLayout(("data", "model"), chip_smoke.MESH_LAYOUT)
    for name, (cfg, b, s, _) in chip_smoke.ENCDEC_VLM_RUNS.items():
        arch, layers, enc, params = want[name]
        full = ARCHS[arch]
        assert dataclasses.replace(
            cfg, num_layers=full.num_layers,
            num_encoder_layers=full.num_encoder_layers) == full
        assert (cfg.num_layers, cfg.num_encoder_layers) == (layers, enc)
        assert (b, s) == (2, 4096)
        model = build_model(cfg)
        n = sum(int(np.prod(x.shape)) for x in tree_leaves(model.specs()))
        assert round(n / 1e9, 2) == params, (name, n)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            sh = model.param_shardings(layout)
        if name == "whisper":
            assert sh["embed"].spec == (None, "data")
    assert chip_smoke.MESH_LAYOUT == (2, 2)
