"""The port stands alone: no JAX, nothing of `repro`, no silent CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.device import resolve_device
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_files_import_neither_jax_nor_repro(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = ("import sys, repro_torch, repro_torch.serve, "
            "repro_torch.dsl.exec, repro_torch.lowering.cuda_backend, "
            "repro_torch.obs, repro_torch.analysis, repro_torch.core, "
            "repro_torch.core.intersect, repro_torch.core.profile, "
            "repro_torch.kernels.stencil.ops, "
            "repro_torch.kernels.qmatmul.ops, repro_torch.kernels.qdq.ops, "
            "repro_torch.dse, repro_torch.core.cost_model, "
            "repro_torch.core.beta_search, repro_torch.pipelines.data, "
            "repro_torch.pipelines.metrics, repro_torch.smt, "
            "repro_torch.smt.solver, repro_torch.core.npops, "
            "repro_torch.obs.exporters, repro_torch.obs.runtime, "
            "repro_torch.obs.report, repro_torch.pipelines.workflows, "
            "repro_torch.benchmarks.paper_tables, "
            "repro_torch.benchmarks.alpha_delta, "
            "repro_torch.benchmarks.executor_overhead, "
            "repro_torch.examples.quickstart, "
            "repro_torch.examples.analyze_pipeline; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_the_obs_subpackage_is_checked():
    assert {p.name for p in PORT_FILES if p.parent.name == "obs"} == \
        {"__init__.py", "exporters.py", "report.py", "runtime.py",
         "tracer.py", "warnonce.py"}


def test_the_benchmarks_and_examples_subpackages_are_checked():
    port = ROOT / "src" / "repro_torch"
    assert {p.name for p in PORT_FILES if p.parent == port / "benchmarks"} \
        == {"__init__.py", "alpha_delta.py", "executor_overhead.py",
            "paper_tables.py"}
    assert {p.name for p in PORT_FILES if p.parent == port / "examples"} \
        == {"__init__.py", "analyze_pipeline.py", "quickstart.py"}
    assert port / "pipelines" / "workflows.py" in PORT_FILES
    assert port / "core" / "npops.py" in PORT_FILES


def test_the_quickstart_runs_on_the_cpu_when_asked(capsys):
    """The port's quickstart on the CPU prints the reference's
    `examples/quickstart.py` analysis, betas, quality and pixel error."""
    import importlib.util
    import warnings
    spec = importlib.util.spec_from_file_location(
        "reference_quickstart", ROOT / "examples" / "quickstart.py")
    reference = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reference)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        reference.main()
    want = capsys.readouterr().out
    from repro_torch.examples import quickstart
    assert quickstart.main(["--device", "cpu"]) == 0
    got = capsys.readouterr().out

    def lines(out):
        keep = ("stages:", "range=", "betas:", "quality:",
                "max abs pixel error:")
        return [ln for ln in out.splitlines()
                if any(k in ln for k in keep)]
    assert len(lines(want)) == 9 and lines(got) == lines(want), (got, want)


def test_the_smt_subpackage_is_checked():
    assert {p.name for p in PORT_FILES if p.parent.name == "smt"} == \
        {"__init__.py", "domain.py", "encoder.py", "optimize.py",
         "solver.py"}


def test_the_dse_subpackage_is_checked():
    assert {p.name for p in PORT_FILES if p.parent.name == "dse"} == \
        {"__init__.py", "betas.py", "driver.py", "evaluate.py",
         "frontier.py", "strategies.py"}


def test_default_device_is_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
