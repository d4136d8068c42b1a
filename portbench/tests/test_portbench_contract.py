"""``BENCHMARK.json`` against the rules for its names and limits, each cell's
files, and the modules a run loads."""
import json
import re
import subprocess
import sys

import pytest
import smoke  # noqa: F401

import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert all(LINE.match(w) for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/")
        f = harness.load_json(harness.ROOT / c["file"])
        assert sorted(f["reduced"]) == sorted(c["reduced"])
        assert f["source"] == c["source"]
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and LINE.match(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
        names.append(w["name"])
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            names.append(m["name"])
    assert len(names) == len(set(names))


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in harness.metrics_of(BENCH, "end_to_end",
                                                     w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = harness.metrics_of(BENCH, "per_layer", w["name"])
        assert layer and all(m["moves"] in e2e for m in layer)


def test_every_roofline_has_a_whole_step_share_beside_it():
    """A kernel's roofline is bounded by the whole step's share of the
    peak: an ``mfu`` metric of the same cells that moves the same
    end-to-end metric."""
    for r in BENCH["per_layer"]:
        if not r["name"].endswith("_roofline"):
            continue
        assert r["unit"] == "%"
        assert any("mfu" in m["name"] and m["moves"] == r["moves"]
                   and set(r["workloads"]) <= set(m["workloads"])
                   for m in BENCH["per_layer"]), r["name"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_resolve(cell):
    s = harness.cell_spec(cell)
    assert s["gen"].KIND == "serve"
    assert len(s["config"]["limits"]) >= 1
    assert None not in s["config"]["limits"].values()


def test_a_per_layer_metric_lists_its_cells():
    cell = BENCH["workloads"][0]["name"]
    bench = dict(BENCH, per_layer=[{"name": "x", "moves": "setup_s"}])
    with pytest.raises(ValueError, match="lists no workloads"):
        harness.metrics_of(bench, "per_layer", cell)
    assert harness.metrics_of(BENCH, "end_to_end", cell)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import smoke, harness;"
            "smoke.run('arctic-480b-2l.montage-backlog');"
            "print(harness.forbidden_modules());"
            "import sys; print(sorted({m.split('.')[0] for m in sys.modules"
            " if m.split('.')[0].startswith('repro')}))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=smoke.HERE)
    assert p.returncode == 0, p.stderr[-2000:]
    bad, loaded = p.stdout.strip().splitlines()[-2:]
    assert bad == "[]"
    assert loaded == "['repro_torch']"


def test_the_reference_imports_nothing_of_the_program():
    for f in (harness.HERE / "reference").glob("*.py"):
        src = f.read_text()
        assert "repro" not in src.replace("reproduc", "")
        assert "import jax" not in src
