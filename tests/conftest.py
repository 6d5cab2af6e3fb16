"""Shared test config.

NOTE: do NOT set XLA_FLAGS / device-count env vars here — smoke tests and
benches must see the single real CPU device; only launch/dryrun.py forces
the 512-device placeholder topology (and only in its own process).

`hypothesis` is an optional dev dependency (see requirements-dev.txt): when
it is absent the tier-1 suite must still collect and run — only the
property-fuzz module is skipped (mixed modules import via _hyp_compat and
degrade their property tests to runtime skips).

Profiles: "repro" (default) disables deadlines for local runs; "ci"
additionally bounds example counts so fuzz suites are deterministic and
fast in CI — select it with HYPOTHESIS_PROFILE=ci and pin the run with
pytest's --hypothesis-seed (see .github/workflows/ci.yml).
"""
import os

try:
    from hypothesis import HealthCheck, settings
except ModuleNotFoundError:
    # skip only the hypothesis-only module; everything else runs without it
    collect_ignore = ["test_property_fuzz.py"]
else:
    # jax dispatch inside property bodies easily exceeds hypothesis' 200 ms
    # deadline on a 1-core container; disable deadlines globally.
    settings.register_profile(
        "repro",
        deadline=None,
        suppress_health_check=[HealthCheck.too_slow],
    )
    # CI twin: same deadline policy, bounded example budget (the seeded
    # deterministic batteries carry the coverage; hypothesis adds breadth).
    # Determinism comes from pytest's --hypothesis-seed flag — NOT from
    # derandomize=True, which would silently ignore that seed.
    settings.register_profile(
        "ci",
        deadline=None,
        max_examples=15,
        suppress_health_check=[HealthCheck.too_slow],
    )
    settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "repro"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one); run on the "
        "card with `python -m pytest -m cuda tests/test_torch_cuda.py`")
