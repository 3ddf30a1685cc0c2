"""Mesh context: opt-in multi-device execution for the whole engine.

    with use_mesh(make_mesh()):
        fact = echelonize(A)

Inside the context every device-resident stage of the engine places its
arrays with explicit NamedShardings and XLA's SPMD partitioner inserts
the collectives (mesh + shardings; XLA places the collectives):

  * chunked block elimination (UEliminator): the dense row block X is
    sharded P('rows', None); chunk bases V are replicated -> pure data
    parallelism, zero per-chunk communication (the device analog of the
    reference's `omp parallel for` over Schur rows, spasm_schur.c:86).
  * blocked dense RREF/PLUQ (dense/elim._eliminate): S is sharded
    P(None, 'cols') — classic right-looking column-block Gaussian
    elimination: the panel sweep runs where the panel lives and the
    composed trailing updates are local matmuls on each column
    shard after an all-gather of the (nb, nb) pivot minor data
    (inserted by SPMD).

Replicated-vs-sharded correctness is covered by tests/test_parallel.py,
which asserts bit-identical U/rank between a mesh run and a single-device
run on the virtual 8-device CPU mesh.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_ACTIVE: list = []


def current_mesh() -> Optional[Mesh]:
    """The innermost active mesh, or None (single-device execution)."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Run engine device stages sharded over `mesh` ('rows', 'cols')."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def shard_rows(X, mesh: Optional[Mesh] = None):
    """Place a (B, m) device array row-sharded (replicated columns)."""
    import jax
    mesh = mesh or current_mesh()
    if mesh is None:
        return X
    return jax.device_put(X, NamedSharding(mesh, P("rows", None)))


def shard_cols(X, mesh: Optional[Mesh] = None):
    """Place an (n, m) device array column-sharded (replicated rows)."""
    import jax
    mesh = mesh or current_mesh()
    if mesh is None:
        return X
    return jax.device_put(X, NamedSharding(mesh, P(None, "cols")))


def replicated(X, mesh: Optional[Mesh] = None):
    import jax
    mesh = mesh or current_mesh()
    if mesh is None:
        return X
    return jax.device_put(X, NamedSharding(mesh, P()))


def row_quantum(mesh: Optional[Mesh] = None) -> int:
    """Row-padding quantum so every device holds an equal slice."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return 1
    return int(np.prod([mesh.shape[a] for a in ("rows",)
                        if a in mesh.shape]))


def col_quantum(mesh: Optional[Mesh] = None) -> int:
    mesh = mesh or current_mesh()
    if mesh is None:
        return 1
    return int(mesh.shape.get("cols", 1))
