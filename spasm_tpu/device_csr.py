"""Device-resident CSR: upload a sparse matrix once, then build dense row
blocks, random row combinations, and batched SpMVs entirely on device.

Motivation: the host<->device link is orders of magnitude slower than
device memory, and every transfer is a synchronisation point, so a flow
that moves matrix-sized dense data across the link wastes the device.
This module makes the *entries of A* (a few MB for the reference's
headline instances) the only bulk upload of the whole echelonization:

  * `densify(rows)`   — scatter selected rows into a padded dense block
                        (upload: one int32 row-id vector);
  * `combine(sel, coeffs)` — N random sparse-weight row combinations
                        (upload: the (N, w) selection + coefficients);
  * `spmv(XT)`        — batched x*A products for device-resident
                        coefficient vectors (upload: nothing).

The reference's analogous primitives are spasm_scatter / spasm_xApy
(/root/reference/src/spasm_scatter.c:7-16, spasm_spmv.c:10-21) and the
random-combination loop of spasm_schur_dense_randomized
(/root/reference/src/spasm_schur.c:346-413).
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .csr import CSR
from .dense.modp import dnorm64, device_field
from .dense.elim import _size_bucket


def _bucket_pow2(x: int, lo: int = 256) -> int:
    b = lo
    while b < x:
        b <<= 1
    return b


@functools.partial(jax.jit,
                   static_argnames=("Bp", "mp", "maxlen", "dtype"))
def _densify(indptr, indices, data, rows, nrows, p, Bp: int, mp: int,
             maxlen: int, dtype=jnp.int32):
    """Scatter rows into a (Bp, mp) dense block.  Row entry slots beyond
    the row's length scatter into the dead column mp-1 with value 0.
    dtype=int16 for primes <= 65279 (balanced values fit; every gather,
    scatter and slab pass downstream moves half the bytes)."""
    starts = indptr[rows]                              # (Bp,)
    lens = indptr[rows + 1] - starts
    k = jnp.arange(maxlen)
    idx = starts[:, None] + k[None, :]                 # (Bp, maxlen)
    live = (k[None, :] < lens[:, None]) & \
        (jnp.arange(Bp) < nrows)[:, None]
    idx = jnp.where(live, idx, 0)
    cols = jnp.where(live, indices[idx], mp - 1)
    vals = jnp.where(live, data[idx], 0)
    X = jnp.zeros((Bp, mp), dtype)
    gi = jnp.broadcast_to(jnp.arange(Bp)[:, None], cols.shape)
    return X.at[gi, cols].add(vals.astype(dtype))


@functools.partial(jax.jit,
                   static_argnames=("Np", "mp", "maxlen", "w", "dtype"))
def _combine(indptr, indices, data, sel, coeffs, p, Np: int, mp: int,
             maxlen: int, w: int, dtype=jnp.int32):
    """X[i] = sum_t coeffs[i, t] * A[sel[i, t]]  into (Np, mp)."""
    starts = indptr[sel]                               # (Np, w)
    lens = indptr[sel + 1] - starts
    k = jnp.arange(maxlen)
    idx = starts[..., None] + k[None, None, :]         # (Np, w, maxlen)
    live = k[None, None, :] < lens[..., None]
    idx = jnp.where(live, idx, 0)
    cols = jnp.where(live, indices[idx], mp - 1)
    vals = jnp.where(live, data[idx].astype(jnp.int64)
                     * coeffs[..., None].astype(jnp.int64), 0)
    vals = dnorm64(vals, p).astype(jnp.int32)
    X = jnp.zeros((Np, mp), jnp.int32)
    gi = jnp.broadcast_to(jnp.arange(Np)[:, None, None], cols.shape)
    X = X.at[gi, cols].add(vals)
    # sparse-weight combinations only sum a handful of balanced values;
    # one reduction keeps everything balanced for downstream kernels
    return dnorm64(X, p).astype(dtype)


@functools.partial(jax.jit, static_argnames=("mp", "acc32"))
def _spmv_batch(rowids, indices, data, XT, p, mp: int,
                acc32: bool = False):
    """Y[s] = XT[s] * A  for a batch of dense coefficient vectors.

    XT: (S, n) device int32; returns (S, mp) with the dead column zero.
    acc32 (static; caller guarantees max_column_count * (p//2) < 2^31):
    per-term balanced reduction + int32 scatter — half the bytes of an
    int64 scatter.
    """
    t = XT[:, rowids].astype(jnp.int64) * data.astype(jnp.int64)[None, :]
    t = dnorm64(t, p)
    gi = jnp.broadcast_to(jnp.arange(XT.shape[0])[:, None], t.shape)
    if acc32:
        Y = jnp.zeros((XT.shape[0], mp), jnp.int32)
        Y = Y.at[gi, indices].add(t.astype(jnp.int32))
        Y = dnorm64(Y.astype(jnp.int64), p)
    else:
        Y = jnp.zeros((XT.shape[0], mp), jnp.int64)
        Y = Y.at[gi, indices].add(t)
        Y = dnorm64(Y, p)
    return Y.astype(jnp.int32).at[:, mp - 1].set(0)


class DeviceCSR:
    """A CSR matrix uploaded to device memory once.

    The dense blocks it produces are (Bp, mp) with mp = bucket(m + 1)
    and a dead last column, matching the eliminator's padding convention
    (dense/block.py).
    """

    def __init__(self, A: CSR, mp: Optional[int] = None):
        self.n, self.m = A.n, A.m
        self.prime = A.prime
        self.F = device_field(A.prime)
        self.mp = mp if mp is not None else _size_bucket(A.m + 1, 64)
        nnz = A.nnz
        # pad entry arrays so padded gather slots stay in range
        self.nnz = nnz
        cap = max(nnz + 1, 1)
        ind = np.full(cap, self.mp - 1, np.int32)
        ind[:nnz] = A.indices[:nnz]
        dat = np.zeros(cap, np.int32)
        dat[:nnz] = A.data[:nnz]
        self.indptr = jnp.asarray(A.indptr.astype(np.int64))
        self.indices = jnp.asarray(ind)
        self.data = jnp.asarray(dat)
        self._rowids = None
        # spmv scatter tier: int32 accumulation is exact when the
        # largest column's balanced partial sums stay under 2^31
        colmax = int(np.bincount(ind[:nnz], minlength=1).max(initial=0)) \
            if nnz else 0
        self._acc32 = colmax * (A.prime // 2) < (1 << 31)
        lens = np.diff(A.indptr)
        self.maxlen = int(lens.max()) if A.n else 0
        self.p64 = jnp.int64(A.prime)
        # balanced values |x| <= p//2 fit int16 for every p <= 65535
        # (independent of the digit tier: d only drives the arithmetic)
        self.block_dtype = jnp.int16 if A.prime <= 65535 else jnp.int32

    def densify(self, rows: np.ndarray, Bp: Optional[int] = None):
        """Dense (Bp, mp) block of the given rows (device array).

        Upload cost: len(rows) int64s.  Duplicate column entries sum
        (mod p semantics preserved by int32 accumulation: row sums of
        balanced values stay far below 2^31 for maxlen * p/2 < 2^31)."""
        rows = np.asarray(rows, np.int64)
        B = len(rows)
        if Bp is None:
            Bp = _size_bucket(max(B, 1), 8)
        rp = np.zeros(Bp, np.int64)
        rp[:B] = rows
        X = _densify(self.indptr, self.indices, self.data,
                     jnp.asarray(rp), B, self.p64, Bp, self.mp,
                     max(self.maxlen, 1), self.block_dtype)
        from .parallel.context import shard_rows
        return shard_rows(X)

    def combine(self, sel: np.ndarray, coeffs: np.ndarray,
                Np: Optional[int] = None):
        """(Np, mp) block of random combinations: row i is
        sum_t coeffs[i,t] * A[sel[i,t]].  Upload: the (N, w) arrays."""
        sel = np.asarray(sel, np.int64)
        coeffs = np.asarray(coeffs, np.int32)
        N, w = sel.shape
        if Np is None:
            Np = _size_bucket(max(N, 1), 8)
        sp = np.zeros((Np, w), np.int64)
        sp[:N] = sel
        cp = np.zeros((Np, w), np.int32)
        cp[:N] = coeffs
        X = _combine(self.indptr, self.indices, self.data,
                     jnp.asarray(sp), jnp.asarray(cp), self.p64,
                     Np, self.mp, max(self.maxlen, 1), w,
                     self.block_dtype)
        from .parallel.context import shard_rows
        return shard_rows(X)

    def spmv(self, XT):
        """Batched x*A for device-resident (S, n) coefficient rows."""
        if self._rowids is None:
            # entry -> row map, computed once on device
            ones = jnp.zeros(self.nnz + 1, jnp.int32).at[
                self.indptr[1:self.n + 1]].add(1)
            self._rowids = jnp.cumsum(ones)[:max(self.nnz, 1)]
        return _spmv_batch(self._rowids, self.indices[:max(self.nnz, 1)],
                           self.data[:max(self.nnz, 1)], XT, self.p64,
                           self.mp, self._acc32)
