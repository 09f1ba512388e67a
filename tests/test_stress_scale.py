"""Stress-scale conformance vs the reference binary (VERDICT r2 item 4).

30 Mbp synthetic genome at 30x (6M x 150 bp reads, k=31, abundance 3),
-max-memory 1500 / -max-disk 600 forcing nb_passes=3 and many
superbatches per pass; the full solid count tables (29,999,950 distinct
kmers), counts and histogram are compared key-by-key against
`.ref_build` dbgh5 (ConfigurationAlgorithm.cpp:350-430 territory).

Gated: needs a GPU (the CPU path would take hours), ~3 GB under /tmp and
the rebuilt reference binary. Driven by tools_dev/stress_r3.py (also
parametrizable: --k 63 / --k 127); the last full runs found the solid
tables key-by-key equal to the reference's (n=29,999,950 at k=31).
"""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_BIN = os.path.join(HERE, ".ref_build", "bin", "Release", "dbgh5")


@pytest.mark.gpu
@pytest.mark.skipif(not os.environ.get("GATB_STRESS_TESTS"),
                    reason="stress: ~30M distinct kmers on the GPU "
                           "(set GATB_STRESS_TESTS=1)")
@pytest.mark.skipif(not os.path.exists(REF_BIN),
                    reason="reference dbgh5 not built (.ref_build)")
def test_stress_scale_conformance(gpu):
    env = dict(os.environ)
    # conftest pins this process to the CPU, so the phases run in
    # subprocesses that reach the card
    env.pop("JAX_PLATFORMS", None)
    env.setdefault("JAX_COMPILATION_CACHE_DIR",
                   os.path.join(HERE, ".jax_cache"))
    script = os.path.join(HERE, "tools_dev", "stress_r3.py")
    for phase in ("gen", "ref", "ours", "compare"):
        out = subprocess.run([sys.executable, script, "--phase", phase],
                             env=env, capture_output=True, text=True,
                             timeout=7200)
        assert out.returncode == 0, (phase, out.stdout[-2000:],
                                     out.stderr[-2000:])
    res = json.loads(open(os.path.join(
        HERE, "tools_dev", "stress_r3_results.json")).read()
        .strip().splitlines()[-1])
    assert res["solid_equal"] is True
    assert res["n_ref"] == res["n_ours"] == 29_999_950
