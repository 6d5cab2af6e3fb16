"""The port stands alone: no JAX, nothing of `repro`, no silent CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.device import resolve_device

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
            "repro_torch.smt.solver; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_the_obs_subpackage_is_checked():
    assert {p.name for p in PORT_FILES if p.parent.name == "obs"} == \
        {"__init__.py", "tracer.py", "warnonce.py"}


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
