"""chip_smoke.py's serve and remap phases (llama3-8b and xlstm-1.3b),
rehearsed on the CPU at a tiny size: the same engine calls, checks and
printouts as on the card, with the kernels' plain versions (the script
itself refuses to run without a CUDA device)."""
import dataclasses
import sys
from pathlib import Path

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
    assert "[xlstm] finished 8 requests" in out
    assert "prefill of P-1 and one decode step" in out
    assert "1 remap and" in out
    assert "generated tokens identical to the ample-budget run" in out


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
