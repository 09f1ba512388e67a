"""Run every example script (the reference compiles its examples/ in CI
as living documentation; we execute ours)."""

import glob
import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow

EXAMPLES = sorted(glob.glob(os.path.join(
    os.path.dirname(__file__), "..", "examples", "*.py")))


@pytest.mark.parametrize("script", EXAMPLES,
                         ids=[os.path.basename(s) for s in EXAMPLES])
def test_example_runs(script):
    # examples run on the local CPU (fast, deterministic)
    repo_root = os.path.abspath(os.path.join(os.path.dirname(__file__),
                                             ".."))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=repo_root)
    proc = subprocess.run([sys.executable, script], capture_output=True,
                          text=True, timeout=420, env=env,
                          cwd=os.path.dirname(script))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip()
