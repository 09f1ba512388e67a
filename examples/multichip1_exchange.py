"""Sharded counting over a device mesh (no reference analogue).

Runs on any platform: forces an 8-device virtual CPU mesh if fewer
devices are present.
"""
import os
import jax

if os.environ.get("JAX_PLATFORMS", "") == "cpu":
    # local/demo run: build a virtual 8-device CPU mesh (must be set
    # before any backend initialization)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
import numpy as np
import jax.numpy as jnp
from gatb_core_tpu.parallel.mesh import make_mesh
from gatb_core_tpu.parallel.exchange import make_count_step, global_table

rng = np.random.default_rng(0)
B, L, k = 64, 120, 31
codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
mesh = make_mesh(8)
step = make_count_step(mesh, k)
shards = step(jnp.asarray(codes), jnp.asarray(np.ones((B, L), bool)),
              jnp.asarray(np.full(B, L, np.int32)))
kmers, counts = global_table(shards, 8)
print("distinct kmers across 8 devices:", len(kmers),
      "total:", int(counts.sum()))
