"""chip_smoke.py's serve and remap phases, rehearsed on the CPU at a tiny
size: the same engine calls, checks and printouts as on the card, with the
kernels' plain versions (the script itself refuses to run without a CUDA
device)."""
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
                        ("PAGE", 4)):
        monkeypatch.setattr(chip_smoke, name, value)
    return dataclasses.replace(scaled_config(ARCHS["llama3-8b"],
                                             num_layers=2), dtype="bfloat16")


def test_serve_and_remap_phases_run(on_cpu, capsys):
    launches = chip_smoke.phase_serve(on_cpu)
    assert set(launches) == {"paged_decode_attention",
                             "paged_prefill_attention", "flash_attention"}
    chip_smoke.phase_remap(on_cpu)
    out = capsys.readouterr().out
    assert "finished 8 requests" in out
    assert "generated tokens identical to the ample-pool run" in out


def test_refuses_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        chip_smoke.main()
    assert e.value.code != 0
    assert '"ok"' not in capsys.readouterr().out
