"""End-to-end multi-device k-mer counting over a mesh.

The full SortingCount pipeline in SPMD form: reads shard over the data
axis, kmers are exchanged by minimizer partition via all-to-all (the
reference's fillPartitions spill, SortingCountAlgorithm.cpp:1211-1345),
each device sorts/reduces its partitions, and the result equals the
single-device (and reference) table exactly. Runs on an 8-device virtual
CPU mesh here; the same code drives a mesh of GPUs.
"""

import os

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

from gatb_core_tpu.bank.fasta import BankStrings  # noqa: E402
from gatb_core_tpu.kmer.counting import count_kmers  # noqa: E402
from gatb_core_tpu.parallel.mesh import make_mesh  # noqa: E402
from gatb_core_tpu.parallel.exchange import \
    count_kmers_distributed  # noqa: E402

rng = np.random.default_rng(0)
genome = "".join(rng.choice(list("ACGT"), size=500))
reads = [genome[s:s + 80] for s in rng.integers(0, 420, size=64)]

mesh = make_mesh(8)
res = count_kmers_distributed(BankStrings(*reads), mesh, kmer_size=21,
                              abundance_min=1, nb_passes=2)
ref = count_kmers(BankStrings(*reads), kmer_size=21, abundance_min=1)
assert (res.solid_kmers == ref.solid_kmers).all()
assert (res.solid_counts == ref.solid_counts).all()
print(f"{res.info['nb_devices']} devices, "
      f"{res.info['nb_passes']} passes: "
      f"{res.info['kmers_nb_distinct']} distinct kmers — "
      "identical to the single-device table")
