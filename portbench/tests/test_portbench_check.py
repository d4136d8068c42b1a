"""The comparison that decides ``correct``, at a size the CPU holds: the
plain reference against the port, the precision control, and a run with
the timed path broken underneath, which must come out not correct.

The limits are the cells' own (``configs/<config>.json``), set from the
chip's readings at the published sizes."""
import numpy as np
import pytest
import smoke

import harness
import run

CELLS = ["musicgen-large.montage-backlog", "arctic-480b-2l.montage-backlog"]


def limits(cell):
    """{the number compared: its limit}."""
    return smoke.spec(cell)["config"]["limits"]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_equals_the_port_in_fp32(cell):
    rec = smoke.run(cell, dtype="float32")
    assert rec["compared"]["scored_tokens"] > 20
    assert rec["compared"]["served_gap"] < 1e-4


@pytest.mark.parametrize("seed", [2**31 + 11, 2**31 + 12])
@pytest.mark.parametrize("cell", CELLS)
def test_bf16_passes_and_the_fp8_control_reads_far_above(cell, seed):
    """The control at the cells' own size fails their limits on the chip
    (``PERF.md``); at a size a test holds it still reads 3x bf16."""
    rec = smoke.run(cell, seed=seed, control="fp8", size="wide")
    c = rec["compared"]
    for key, value in limits(cell).items():
        ctrl = "control_gap" if key == "served_gap" else f"control_{key}"
        assert c[key] <= value
        assert c[ctrl] >= 3 * c[key]


def _run_cell(cell):
    with smoke.ticking_clock():
        return run.run_cell(smoke.spec(cell), 2**31 + 21, 0.2, False, "cpu",
                            0.0)


def test_a_sound_run_is_correct():
    out = _run_cell(CELLS[0])
    assert out["correct"] is True
    assert list(out)[-1] == "compared"
    assert {k: c["limit"] for k, c in out["compared"].items()} \
        == limits(CELLS[0])


def _alter_a_token(monkeypatch):
    """The greedy id of the first row of every prefill group and decode
    step changed where the engine produces it."""
    from repro_torch.serve import engine
    gather = engine.gather_rows
    vocab = smoke.SIZES["small"]["vocab_size"]

    def broken(ids, data):
        ids = gather(ids, data).clone()
        ids[0] = (ids[0] + 1) % vocab
        return ids
    monkeypatch.setattr(engine, "gather_rows", broken)


def _state_unchanged(monkeypatch):
    """A decode step that leaves the KV cache as it found it."""
    from repro_torch.models import blocks
    attend = blocks._decode_attention

    def broken(q, k, v, k_cache, v_cache, *a):
        return attend(q, k, v, k_cache.clone(), v_cache.clone(), *a)
    monkeypatch.setattr(blocks, "_decode_attention", broken)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_alter_a_token, _state_unchanged])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = _run_cell(cell)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["compared"].values())


def test_no_card_no_result():
    import subprocess
    import sys
    p = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"][0]
         ["name"], "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"},
        cwd=harness.ROOT)
    assert p.returncode != 0 and p.stdout == ""
