"""Mesh construction for multi-device execution.

The engine itself is mesh-aware: running `echelonize` inside
`use_mesh(make_mesh())` (parallel/context.py) shards every device stage
— row-sharded block elimination and combination forming (DP, the analog
of the reference's `omp parallel for` over Schur rows,
/root/reference/src/spasm_schur.c:86), column-sharded dense elimination
(TP), and the device finisher's accumulator width (the SP analog of
SURVEY.md §5.7) — with XLA's SPMD partitioner inserting the collectives
(pick a mesh, annotate shardings, let the compiler place collectives).

This module only builds meshes; the earlier standalone demo entry
points (one-panel round step, per-chunk block eliminate) duplicated the
engine's own code paths and were removed — tests/test_parallel.py
asserts mesh-vs-single-device equality through the real engine instead.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int = None, devices=None,
              process_of=None) -> Mesh:
    """A ('rows', 'cols') mesh over the available devices.

    One process (one host): the cards of an H100 host are linked all
    to all by NVLink, so no device pairing is faster than another and
    the mesh follows the algorithm alone: the rows-heavy factorization
    below (2 x 2 on four devices).

    Several processes (multi-host): 'rows' runs across processes and
    'cols' stays within one, so the width-sharded collectives of the
    dense stages (all-gathers of pivot-minor data, psums over column
    shards) stay on the host's own links, while the row-partitioned
    data parallelism — which only communicates at block boundaries —
    crosses the slower network between hosts.

    `process_of` (device -> process id) is injectable for tests; the
    default is `device.process_index`.
    """
    if devices is None:
        devices = jax.devices()[:n_devices] if n_devices else jax.devices()
    if process_of is None:
        process_of = lambda d: getattr(d, "process_index", 0)  # noqa: E731
    procs = {}
    for d in devices:
        procs.setdefault(process_of(d), []).append(d)
    nproc = len(procs)
    per = len(devices) // max(nproc, 1)
    if nproc > 1 and all(len(v) == per for v in procs.values()):
        grid = np.asarray([procs[k] for k in sorted(procs)], object)
        return Mesh(grid.reshape(nproc, per), ("rows", "cols"))
    n = len(devices)
    rows = n
    cols = 1
    while rows % 2 == 0 and cols < rows // 2:
        rows //= 2
        cols *= 2
    return Mesh(np.asarray(devices).reshape(rows, cols), ("rows", "cols"))


def shard_rows(mesh: Mesh, X):
    return jax.device_put(X, NamedSharding(mesh, P("rows", None)))


def shard_cols(mesh: Mesh, X):
    return jax.device_put(X, NamedSharding(mesh, P(None, "cols")))


def replicate(mesh: Mesh, X):
    return jax.device_put(X, NamedSharding(mesh, P()))
