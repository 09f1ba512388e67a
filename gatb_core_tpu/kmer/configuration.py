"""DSK execution-plan computation (ConfigurationAlgorithm port).

Bit-faithful port of the reference's resource planner
(kmer/impl/ConfigurationAlgorithm.cpp:300-466): from a bank estimate and
memory/disk budgets it derives the number of counting passes and
partitions. On the device the same plan bounds HBM-resident batch volume per
pass and sizes the minimizer-partition exchange; the formulas (including
the 0.5*1.2 kxmer/minimizer volume factor and the open-files fallback
loop) are preserved so plans match the reference's for identical inputs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

MBYTE = 1 << 20


@dataclass
class Configuration:
    """The DSK plan (kmer/impl/Configuration.hpp:38-115)."""

    kmer_size: int = 31
    minimizer_size: int = 10
    estimate_seq_nb: int = 0
    estimate_seq_total_size: int = 0
    estimate_seq_max_size: int = 0
    kmers_nb: int = 0
    volume_mb: int = 0
    max_disk_space_mb: int = 0
    max_memory_mb: int = 5000
    nb_passes: int = 1
    nb_partitions: int = 1
    nb_partitions_in_parallel: int = 1
    nb_cores: int = 1
    nb_cores_per_partition: int = 1
    nb_cached_items_per_core_per_part: int = 0
    abundance_min: int | str = 2
    abundance_max: int = 2**31 - 1
    solidity_kind: str = "sum"

    def get_properties(self) -> dict:
        return {
            "kmer_size": self.kmer_size,
            "minimizer_size": self.minimizer_size,
            "sequences_number": self.estimate_seq_nb,
            "kmers_number": self.kmers_nb,
            "volume_mb": self.volume_mb,
            "nb_passes": self.nb_passes,
            "nb_partitions": self.nb_partitions,
            "max_memory_mb": self.max_memory_mb,
            "max_disk_mb": self.max_disk_space_mb,
        }

    # persistence (Configuration::save/load, Configuration.cpp:145+)
    def save(self, storage) -> None:
        g = storage.group("configuration")
        for key, val in self.get_properties().items():
            g.set_property("plan_" + key, val)

    @classmethod
    def load(cls, storage) -> "Configuration":
        g = storage.group("configuration")
        cfg = cls()
        cfg.kmer_size = int(g.get_property("plan_kmer_size"))
        cfg.nb_passes = int(g.get_property("plan_nb_passes"))
        cfg.nb_partitions = int(g.get_property("plan_nb_partitions"))
        return cfg


def kmer_type_size(kmer_size: int) -> int:
    """sizeof(Type) = 8 bytes per 32-mer span (LargeInt<(span+31)/32>)."""
    return 8 * ((kmer_size + 31) // 32)


def compute_plan(estimate_seq_nb: int, estimate_seq_total_size: int,
                 estimate_seq_max_size: int, kmer_size: int,
                 max_memory_mb: int = 5000, max_disk_space_mb: int = 0,
                 nb_cores: int = 1, nb_partitions_in_parallel: int = 0,
                 available_space_mb: int = 1 << 20,
                 max_open_files: int = 512,
                 minimizer_size: int = 10) -> Configuration:
    """ConfigurationAlgorithm::execute planning section, formula-exact
    (ConfigurationAlgorithm.cpp:300-466)."""
    if estimate_seq_nb == 0:
        raise ValueError("Empty bank")

    cfg = Configuration(kmer_size=kmer_size, minimizer_size=minimizer_size,
                        estimate_seq_nb=estimate_seq_nb,
                        estimate_seq_total_size=estimate_seq_total_size,
                        estimate_seq_max_size=estimate_seq_max_size,
                        nb_cores=nb_cores)
    cfg.nb_partitions_in_parallel = nb_partitions_in_parallel or nb_cores

    mean_seq_len = estimate_seq_total_size // max(estimate_seq_nb, 1)
    used_seq_len = max(mean_seq_len, kmer_size)
    kmers_nb = (used_seq_len - kmer_size + 1) * estimate_seq_nb
    if kmers_nb <= 0:
        raise ValueError(
            f"Configuration failed: longest sequence {estimate_seq_max_size}"
            f" nt < kmer size {kmer_size}")
    cfg.kmers_nb = kmers_nb

    volume = kmers_nb * kmer_type_size(kmer_size) // MBYTE
    cfg.volume_mb = max(volume, 1)
    volume_minim = max(int(cfg.volume_mb * 0.5 * 1.2), 1)

    # max(75%, 100% - 2GB) of available space (ConfigurationAlgorithm.cpp:330)
    max_disk = max_disk_space_mb
    if max_disk == 0:
        max_disk = max(75 * available_space_mb // 100,
                       available_space_mb - 2000)
    if max_disk == 0:
        max_disk = 10000
    cfg.max_disk_space_mb = max_disk
    cfg.max_memory_mb = max_memory_mb or 5000

    cfg.nb_passes = (cfg.volume_mb // 4) // max_disk + 1

    # partition sizing loop with open-files fallback (lines 396-430)
    while True:
        volume_per_pass = volume_minim // cfg.nb_passes
        cfg.nb_partitions = (volume_per_pass
                             * cfg.nb_partitions_in_parallel) \
            // cfg.max_memory_mb + 1
        if cfg.nb_partitions >= max_open_files \
                and cfg.nb_partitions_in_parallel > 1:
            cfg.nb_partitions_in_parallel //= 2
        elif cfg.nb_partitions >= max_open_files \
                and cfg.nb_partitions_in_parallel == 1:
            cfg.nb_passes += 1
        else:
            break

    # round partitions to a multiple of the parallelism (lines 432-436)
    incpart = cfg.nb_partitions_in_parallel \
        - cfg.nb_partitions % cfg.nb_partitions_in_parallel
    incpart %= cfg.nb_partitions_in_parallel
    if max_open_files - cfg.nb_partitions > incpart:
        cfg.nb_partitions += incpart

    cfg.nb_cores_per_partition = max(
        1, nb_cores // cfg.nb_partitions_in_parallel)

    # cached items geometric sizing <= max_memory/10 (lines 452-466)
    cfg.nb_cached_items_per_core_per_part = 1 << 8
    while True:
        cfg.nb_cached_items_per_core_per_part *= 2
        usage = (cfg.nb_cached_items_per_core_per_part * cfg.nb_partitions
                 * nb_cores * kmer_type_size(kmer_size))
        if usage >= cfg.max_memory_mb * MBYTE // 10:
            break
    return cfg
