"""Test configuration: force CPU backend with 8 virtual devices.

Multi-device sharding tests run on a virtual 8-device CPU mesh. Tests that
need an NVIDIA GPU carry the ``gpu`` marker and take the ``gpu`` fixture,
which skips them when no card is present; the program itself is checked
on the card with ``python chip_smoke.py [--four-cards]``.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
# Persistent compile cache at a fixed path, shared by test runs. Set
# before importing jax.
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 ".pytest_jax_cache"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.3")

import jax  # noqa: E402

# Tests run on a local 8-device virtual CPU mesh (fast, deterministic,
# multi-device shardings compile).
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavy conformance/e2e tests, skipped unless "
        "GATB_SLOW_TESTS=1 (keeps the default tier short)")
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; skipped (by the gpu fixture) when "
        "none is present")


def pytest_collection_modifyitems(config, items):
    if os.environ.get("GATB_SLOW_TESTS"):
        return
    skip = pytest.mark.skip(reason="slow tier (set GATB_SLOW_TESTS=1)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(scope="session")
def gpu():
    """Skip unless an NVIDIA GPU is present. Decided when a test asks
    for it, never at import: this process is pinned to the CPU, so the
    card is probed through nvidia-smi and the test drives it from a
    subprocess."""
    import shutil
    import subprocess

    smi = shutil.which("nvidia-smi")
    if smi is None:
        pytest.skip("no NVIDIA GPU (nvidia-smi not found)")
    out = subprocess.run([smi, "-L"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0 or "GPU" not in out.stdout:
        pytest.skip("no NVIDIA GPU")
    return out.stdout.splitlines()[0]


@pytest.fixture(scope="session")
def test_db():
    """Path to the reference-bundled small fixture files."""
    path = "/root/reference/gatb-core/test/db"
    if not os.path.isdir(path):
        pytest.skip("reference test/db not available")
    return path
