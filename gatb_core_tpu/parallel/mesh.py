"""Device mesh helpers.

The reference's only parallel substrate is a pthread pool pulling batches
from a shared iterator (Dispatcher, designpattern/impl/Command.hpp). The
device equivalent is SPMD over a 1-D data mesh: reads are sharded over
axis "d" and kmers are re-sharded by minimizer partition via all-to-all
(see exchange.py and SURVEY.md §2.11).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "d"
# 2-D topology (SURVEY §5.8): the counting exchange's all-to-all rides
# the intra-host axis; cross-host reduces (pass-table merge, histogram
# psum) ride the inter-host axis. Not yet run on more than one host.
HOST_AXIS = "host"
CHIP_AXIS = "chip"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            if len(devices) < n_devices:
                raise ValueError(
                    f"need {n_devices} devices, have {len(devices)}")
            devices = devices[:n_devices]
    return Mesh(np.array(devices), (DATA_AXIS,))


def make_mesh2d(nb_hosts: int, chips_per_host: int, devices=None) -> Mesh:
    """(host, chip) mesh: the chips of one host share the intra-host
    axis (JAX device order groups a host's local devices
    consecutively); hosts meet on the inter-host axis. On the CPU
    backend this simulates the topology for tests."""
    if devices is None:
        devices = jax.devices()
    need = nb_hosts * chips_per_host
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.array(devices[:need]).reshape(nb_hosts, chips_per_host)
    return Mesh(arr, (HOST_AXIS, CHIP_AXIS))


def data_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
