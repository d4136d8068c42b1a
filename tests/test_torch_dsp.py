"""The port's DSP control plane (``repro_torch.core``, ``repro_torch.sim``,
``repro_torch.serve.{driver,fleet,columnar,tenant,paged}``,
``repro_torch.launch.emulate``) against ``repro``'s, in one process on
the same seeds, with emulated engines only (no model).

- drift: each copied module's source equals the reference's once
  ``repro.`` reads ``repro_torch.`` and ``JaxEngineAdapter`` reads
  ``TorchEngineAdapter``, apart from the adapter class itself and a few
  named lines the port words differently;
- emulator: the same 11 registered systems, the 8 emulated ones giving
  equal ``SystemResult``s field for field, the 3 serve systems equal
  ``FleetStats``, equal ``launch.emulate --json`` output, and
  ``examples/emulate_cloud_torch.py`` printing what
  ``examples/emulate_cloud.py`` prints;
- fleet and columnar runs equal field for field.

The reference's two failing tests (``test_provider.py::
test_admission_queue_drains_fifo_fair``, ``test_serve_fleet.py::
test_property_fleet_partitioning``) are not ported: the copies fail where
the reference fails, and the parity here carries those semantics.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"

# (reference path relative to src/repro) of every module the port copies
COPIED = ("core/types.py", "core/policy.py", "core/provision.py",
          "core/lifecycle.py", "core/scheduling.py", "core/tre.py",
          "core/provider.py", "core/registry.py", "core/__init__.py",
          "core/controller.py",
          "sim/traces.py", "sim/engine.py", "sim/systems.py",
          "sim/__init__.py", "serve/tenant.py", "serve/driver.py",
          "serve/paged.py", "serve/fleet.py", "serve/columnar.py",
          "launch/emulate.py")

# Lines the port words differently, as (pattern in the reference, port
# text) after the renames: docstrings that name the reference's pull
# request history or its framework, the controller's device pool, and
# one error text.
PR = r"PR \d+"
PORT_LINES = {
    "core/__init__.py": [(r"real elastic JAX jobs\n",
                          "real elastic PyTorch jobs\n")],
    "core/controller.py": [
        (re.escape("        self.devices = list(devices if devices is not "
                   "None else jax.devices())\n"),
         "        # indexed devices: \"cuda\" and \"cuda:0\" name one card\n"
         "        self.devices = [resolve_device(d) for d in (\n"
         "            devices if devices is not None else [None])]\n")],
    "sim/systems.py": [
        (rf"bit-for-bit with {PR}\);", "bit-for-bit with the paper's runs);")],
    "sim/traces.py": [(rf"small \(the {PR}\n", "small (the\n")],
    "serve/paged.py": [(rf"isolation story\. {PR}'s\n",
                        "isolation story. The\n")],
    "serve/fleet.py": [
        (rf"ServeDriver`` \({PR}\)\n", "ServeDriver``\n"),
        (rf"bit-identical to {PR}\.\n", "bit-identical to one without it.\n"),
        (r'"a paged jax engine\)"\)', '"a paged engine)")')],
    "serve/columnar.py": [(rf"``ServeDriver`` \({PR}\) holds",
                           "``ServeDriver`` holds")],
}
ADAPTER = re.compile(r"^class \w+EngineAdapter:\n(?:(?:    .*)?\n)*",
                     re.MULTILINE)
# the controller's own parts in either package: the module docstring and
# imports, and the two execution methods (placing a job, running a
# segment)
CONTROLLER_OWN = (re.compile(r"\A.*?(?=^@dataclass\nclass TrainTask)",
                             re.MULTILINE | re.DOTALL),
                  re.compile(r"^    def _mesh_for\(.*?(?=^    def tick\()",
                             re.MULTILINE | re.DOTALL))
EMULATED = ("dawningcloud", "dawningcloud-backfill",
            "dawningcloud-coordinated", "dawningcloud-easy",
            "dawningcloud-quota", "dcs", "drp", "ssp")
SERVE_SYSTEMS = ("dawningcloud-serve-fleet", "dawningcloud-serve-hetero",
                 "dawningcloud-train-serve")
PKGS = ("repro", "repro_torch")      # the reference, then the port


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _plain(x):
    """Dataclasses (of either package) as plain dicts, recursively."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


# ----------------------------------------------------------------- drift
@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_has_not_drifted(rel):
    want = re.sub(r"\brepro\.", "repro_torch.", (REF / rel).read_text())
    want = want.replace("JaxEngineAdapter", "TorchEngineAdapter")
    for pattern, port_text in PORT_LINES.get(rel, ()):
        want, n = re.subn(pattern, lambda _: port_text, want)
        assert n == 1, (rel, pattern)
    got = (PORT / rel).read_text()
    if rel == "serve/driver.py":
        # the adapter class is the port's own: the rest is the copy
        assert len(ADAPTER.findall(want)) == len(ADAPTER.findall(got)) == 1
        want, got = ADAPTER.sub("", want), ADAPTER.sub("", got)
    if rel == "core/controller.py":
        # the execution is the port's own: the rest is the copy
        for own in CONTROLLER_OWN:
            assert len(own.findall(want)) == len(own.findall(got)) == 1
            want, got = own.sub("", want), own.sub("", got)
    assert got == want


# -------------------------------------------------------------- emulator
def test_same_registered_systems():
    ref, port = (_mod(p, "core").available_systems() for p in PKGS)
    assert ref == port and len(port) == 11
    assert set(port) == set(EMULATED) | set(SERVE_SYSTEMS)


@pytest.mark.parametrize("system", EMULATED)
def test_emulated_system_results_equal(system):
    got = []
    for pkg in PKGS:
        wls = _mod(pkg, "sim.traces").standard_workloads(0)
        res = _mod(pkg, "sim").run_system(system, wls, mtc_fixed_nodes=166)
        got.append(_plain(res))
    assert got[0] == got[1]


def _tenant_streams(pkg, mix, workflows=1, seed=0, jobs_scale=0.05,
                    period=3600.0):
    """``benchmarks/serve_fleet.py::tenant_streams`` on one package."""
    traces, fleet = _mod(pkg, "sim.traces"), _mod(pkg, "serve.fleet")
    streams, widths = [], []
    for t, w in enumerate(mix):
        fam = traces.workload_family(0, workflows, seed=seed * 1009 + t,
                                     jobs_scale=jobs_scale)
        profile = traces.SERVE_PROFILES[w]
        streams.append(profile.stream(fam, period=period, seed=seed + t))
        widths.append(profile.width)
    return fleet.rekey_disjoint(streams), widths


@pytest.mark.parametrize("system", SERVE_SYSTEMS)
def test_serve_system_results_equal(system):
    """The three serve systems through their ``serve`` entry (as
    tests/test_serve_fleet.py and tests/test_tenant.py drive them)."""
    got = []
    for pkg in PKGS:
        impl = _mod(pkg, "core").get_system(system)
        mix = [1, 1] if system.endswith("serve-fleet") else [1, 2, 4]
        streams, _ = _tenant_streams(pkg, mix, seed=3)
        kw = {}
        if system.endswith("train-serve"):
            kw["train_jobs"] = _mod(pkg, "sim.traces").train_stream(
                3, seed=20, period=3600.0)
        fs = impl.serve(streams, names=[f"t{i}" for i in range(len(mix))],
                        **kw)
        got.append(fs.as_dict())
    assert got[0] == got[1]
    assert got[1]["workflows_completed"] == got[1]["workflows_expected"]


def test_emulate_cli_json_equal(monkeypatch, capsys):
    out = []
    for pkg in PKGS:
        monkeypatch.setattr(sys, "argv", ["emulate", "--json"])
        _mod(pkg, "launch.emulate").main()
        out.append(json.loads(capsys.readouterr().out))
    assert out[0] == out[1]
    assert set(out[1]) == {"dcs", "ssp", "drp", "dawningcloud"}


def _run_example(name, argv):
    """The printed lines of ``examples/<name>`` run under ``argv`` in a
    process of its own (``--all`` reads the registry, which this process'
    other tests may have added to)."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / name)] + argv,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


@pytest.mark.parametrize("argv", [[], ["--policy-set", "paper"]],
                         ids=["tuned", "paper"])
def test_emulate_cloud_example_prints_the_reference_numbers(argv):
    """``examples/emulate_cloud_torch.py`` prints what
    ``examples/emulate_cloud.py`` prints, line for line: the workloads,
    every system's node-hours, peak and adjustments, and the savings."""
    ref = _run_example("emulate_cloud.py", argv)
    got = _run_example("emulate_cloud_torch.py", argv)
    assert "DawningCloud saves" in got and got == ref


# ----------------------------------------------------------------- fleet
@pytest.mark.parametrize("coordination", ["first-come", "coordinated"])
@pytest.mark.parametrize("n_tenants", [1, 3])
@pytest.mark.parametrize("mix", ["1", "1/2/4"])
def test_emulated_fleet_stats_equal(mix, n_tenants, coordination):
    widths = [int(w) for w in mix.split("/")]
    got = []
    for pkg in PKGS:
        driver, fleet = _mod(pkg, "serve.driver"), _mod(pkg, "serve.fleet")
        policy = _mod(pkg, "core.policy").MgmtPolicy
        streams, ws = _tenant_streams(
            pkg, [widths[t % len(widths)] for t in range(n_tenants)],
            workflows=2, seed=1)
        base = policy(initial=1, ratio=2.0, scan_interval=3.0,
                      release_interval=60.0)
        pols = [policy(initial=base.initial * w, ratio=base.ratio,
                       scan_interval=base.scan_interval,
                       release_interval=base.release_interval) for w in ws]
        f = fleet.ServeFleet(streams, engine=driver.EmulatedEngine(
            16, max_len=48), coordination=coordination, policies=pols,
            widths=ws, name="fleet", page_size=8)
        fs = f.run()
        f.pool.pager.check_conservation()
        got.append((fs.as_dict(),
                    [(e.t, e.tre, e.delta) for e in f.provider.adjust_events]))
    assert got[0] == got[1]
    stats = got[1][0]
    assert stats["workflows_completed"] == stats["workflows_expected"]
    assert stats["over_admissions"] == stats["isolation_violations"] == 0


def test_columnar_stats_equal():
    """A small generated ``ColumnarStream`` through the columnar driver
    under DSP negotiation (tests/test_serve_columnar.py:221)."""
    got = []
    for pkg in PKGS:
        traces, col = _mod(pkg, "sim.traces"), _mod(pkg, "serve.columnar")
        cs = traces.montage_stream_columnar(40, n_project=2, seed=3,
                                            period=400.0)
        prov = _mod(pkg, "core.provider").ResourceProvider(
            64, coordination="first-come")
        drv = col.ColumnarServeDriver(
            cs, provider=prov, engine=col.ColumnarEngine(64),
            policy=_mod(pkg, "core.policy").MgmtPolicy(
                initial=4, ratio=2.0, scan_interval=3.0,
                release_interval=300.0))
        stats = drv.run()
        got.append((stats.as_dict(),
                    [(e.t, e.tre, e.delta) for e in prov.adjust_events],
                    drv.env.start_t.tolist(), drv.env.finish_t.tolist()))
    assert got[0] == got[1]
    assert got[1][0]["workflows_completed"] == 40


def test_serve_package_exports_the_references():
    """``repro_torch.serve`` exports what ``repro.serve`` does, with
    ``TorchEngineAdapter`` in the JAX adapter's place."""
    names = {"ColumnarEngine", "ColumnarEnv", "ColumnarServeDriver",
             "EmulatedEngine", "ServeDriver", "ServeInvariantError",
             "ServeStats", "FleetStats", "PartitionedEngine", "ServeFleet",
             "TenantSlice", "PagedKVAllocator", "pages_for", "Engine",
             "Request"}
    ref, port = (importlib.import_module(f"{p}.serve") for p in PKGS)
    assert all(hasattr(ref, n) for n in names | {"JaxEngineAdapter"})
    assert all(hasattr(port, n) for n in names | {"TorchEngineAdapter"})
    assert port.ServeInvariantError is _mod(
        "repro_torch", "serve.paged").ServeInvariantError
