"""The band kernel on the card against its plain version, bit for bit.

Needs a CUDA card: every test here skips without one.  Run on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

No JAX here: the plain version, which the CPU tests hold equal to the
JAX package, is the reference on the card.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.fixedpoint import alpha_for_range
from repro_torch.dsl.exec import run_fixed
from repro_torch.kernels.stencil import kernel as K
from repro_torch.pipelines import ALL, usm
from repro_torch.pipelines.types import load_types, types_from_data

pytestmark = pytest.mark.cuda

PARAMS = {"usm": dict(usm.DEFAULT_PARAMS)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _frames(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.float64)


def _check(pipe, img, types, params, dev):
    before = K.LAUNCHES["fused_band"]
    got = run_fixed(pipe, img, types, params, backend="cuda", device=dev)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fused_band"] > before
    want = run_fixed(pipe, img, types, params, backend="torch", device=dev)
    assert sorted(got) == sorted(pipe.outputs)
    for k in got:
        assert got[k].device.type == "cuda"
        assert torch.equal(got[k], want[k]), k


CASES = [("usm", (48, 48)), ("hcd", (48, 48)), ("dus", (47, 48)),
         ("dus_ext", (48, 48)), ("usm", (3, 47, 48)), ("hcd", (2, 40, 56)),
         ("dus_ext", (3, 47, 48)), ("usm", (2, 1080, 1920))]


@pytest.mark.parametrize("name,shape", CASES,
                         ids=[f"{n}-{'x'.join(map(str, s))}"
                              for n, s in CASES])
def test_kernel_equals_plain_version(cuda, name, shape):
    _check(ALL[name](), _frames(shape, 5), load_types(name),
           PARAMS.get(name, {}), cuda)


def test_saturating_phase_plan(cuda):
    """Residue bounds tighter than the true ranges, so per-residue
    saturation engages on random frames."""
    data = load_types("dus_ext").to_data()
    ranges = {"resS": ((2, 1), {"0,0": (-50, 50)}),
              "UyS": ((2, 1), {"0,0": (0, 150), "1,0": (0, 250)}),
              "band": ((2, 2), {"0,0": (-30, 30)})}
    data["phases"] = {
        s: {"lattice": list(lat),
            "ranges": {k: {"alpha": alpha_for_range(lo, hi),
                           "signed": lo < 0} for k, (lo, hi) in r.items()}}
        for s, (lat, r) in ranges.items()}
    _check(ALL["dus_ext"](), _frames((2, 96, 96), 3), types_from_data(data),
           {}, cuda)
