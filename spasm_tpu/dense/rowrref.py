"""Row-sweep RREF: rank-revealing reduction with sequential cost
proportional to the number of ROWS, not columns.

The classic column sweep (dense/elim.py) runs one sequential step per
*column* — m steps.  The engine's finisher blocks are short and wide
(B rows over q >> B free columns), where m steps at the device's
per-iteration loop latency dominate everything.  This kernel instead
sweeps over rows (B steps): each step finds the leftmost nonzero of the
current row (one VPU reduction), then applies a division-free Jordan
cross-multiplication update to every other row of the panel.

Blocked structure (nb-row panels) maintains the invariant that all
processed rows form a *fully reduced* (RREF) unit-pivot basis:
  * panel start: eliminate the panel against every prior pivot row with
    ONE masked matmul — exact in one shot because priors are RREF;
  * within the panel: nb sequential division-free Jordan steps
        P <- v_k * P - P[:, j_k] (x) u_k
    (zero pattern preserved, so pivot choices match classical row
    elimination; eliminating above AND below keeps the panel mutually
    reduced with no composition step);
  * panel end: ONE batched Fermat inversion normalizes the panel's
    pivot rows, then one masked matmul back-reduces all prior rows
    against the new pivots.

Column choice is free (any echelon basis is valid for rank / kernel /
solve via qinv), exactly like the reference's column-pivoted FFPACK RREF
which reduces A*Q, not A (spasm_rref.c:10-20).

The last column of X must be dead (zero padding): row/column gathers
park out-of-range indices there.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .modp import matmul_digits, modinv, dnorm64
from .elim import _mulsub, _submod, _scale_rows


@functools.partial(jax.jit, static_argnames=("d", "nb", "sweep_small"),
                   donate_argnums=(0,))
def _rref_rows(X, p, weights, d: int, nb: int = 64,
               sweep_small: bool = False):
    """Row-sweep RREF of X (B, M) int32 balanced, B % nb == 0, last
    column dead (all zero).  Returns (X', pivcol):

      pivcol[i] >= 0: row i of X' is a normalized (unit-pivot) basis row
        with its pivot at column pivcol[i], fully reduced against every
        other pivot row (RREF);
      pivcol[i] == -1: row i reduced to zero.
    """
    B, M = X.shape
    npanel = B // nb
    small = d == 2
    rounds = 1 if sweep_small else 2
    iota_nb = jnp.arange(nb)
    iota_B = jnp.arange(B)

    def panel(t, carry):
        X, pivcol = carry
        q0 = t * nb
        # No elimination against prior pivots is needed here: the
        # end-of-panel back-reduction (delta2 below) updates EVERY row
        # outside the panel — including future panels — so by induction
        # this panel already has exact zeros on all prior pivot columns.
        P = jax.lax.dynamic_slice(X, (q0, 0), (nb, M))

        def step(k, c):
            P, pivl = c
            u = P[k]
            nz = u != 0
            has = jnp.any(nz)
            j = jnp.argmax(nz)
            v = jnp.where(has, u[j], 1)
            g = jnp.where((iota_nb != k) & has, P[:, j], 0)
            P = _mulsub(v, P, g[:, None], u[None, :], p, small,
                        rounds).astype(X.dtype)
            pivl = pivl.at[k].set(jnp.where(has, j, -1).astype(jnp.int32))
            return P, pivl

        P, pivl = jax.lax.fori_loop(
            0, nb, step, (P, jnp.full((nb,), -1, jnp.int32)))
        # normalize panel pivot rows (one batched Fermat inversion)
        pv = P[iota_nb, jnp.where(pivl >= 0, pivl, M - 1)]
        inv = dnorm64(modinv(jnp.where(pivl >= 0, pv, 1), p), p)
        P = _scale_rows(inv.astype(jnp.int32), P, p, small,
                        rounds).astype(X.dtype)
        X = jax.lax.dynamic_update_slice(X, P, (q0, 0))
        # back-reduce every prior row against the panel's new pivots so
        # the processed prefix stays fully RREF
        pcs2 = jnp.where(pivl >= 0, pivl, M - 1)
        C2 = X[:, pcs2]                                   # (B, nb)
        inpanel = (iota_B >= q0) & (iota_B < q0 + nb)
        C2 = jnp.where((~inpanel[:, None]) & (pivl >= 0)[None, :], C2, 0)
        delta2 = matmul_digits(C2.astype(jnp.int32), P.astype(jnp.int32),
                               p, weights, d)
        X = _submod(X, delta2, p, small).astype(X.dtype)
        pivcol = jax.lax.dynamic_update_slice(pivcol, pivl, (q0,))
        return X, pivcol

    return jax.lax.fori_loop(
        0, npanel, panel, (X, jnp.full((B,), -1, jnp.int32)))


def rref_rows_device(Xd, p: int, nb: int = 64, sync: bool = True):
    """Host-facing wrapper.  Xd: (B, M) device array, last column dead.
    Returns (Xd', pivcol (B,) np.ndarray).  nb is clamped so it divides
    B (all row buckets are powers of two or multiples of 512).
    sync=False returns pivcol as a DEVICE array so callers can overlap
    more work before paying the device->host round trip."""
    from .modp import device_field
    F = device_field(p)
    B = Xd.shape[0]
    nb = min(nb, B)
    while B % nb:
        nb //= 2
    Xd, pivcol = _rref_rows(Xd, jnp.int64(p), jnp.asarray(F.weights),
                            F.ndigits, nb, p <= (1 << 23))
    return Xd, (np.asarray(pivcol) if sync else pivcol)


@functools.partial(jax.jit, static_argnames=("d",), donate_argnums=(0,))
def _basis_apply(X, R, jpos, p, weights, d: int):
    """Eliminate the pivots of a reduced basis block R from X.

    R: (K, M) mutually reduced unit-pivot rows, pivot of row k at column
    jpos[k] (dead rows: jpos -> the dead last column, where X is zero).
    One matmul — exact because R is RREF.  X is donated.
    """
    C = X[:, jpos]                                    # (B, K)
    small = d == 2
    delta = matmul_digits(C.astype(jnp.int32), R, p, weights, d)
    return _submod(X, delta, p, small).astype(X.dtype)


_CHUNK = 4096        # fixed basis-chunk height: ONE compiled program per
                     # role regardless of round count or basis size
                     # (carried over untuned; see ROADMAP A3)


@functools.partial(jax.jit, static_argnames=("d",), donate_argnums=(0,))
def _basis_apply_at(X, Rbuf, jbuf, start, p, weights, d: int):
    """Eliminate one _CHUNK-row slice of the basis buffer from X.
    start is traced, so every chunk of every round shares one compile."""
    M = Rbuf.shape[1]
    Rd = jax.lax.dynamic_slice(Rbuf, (start, jnp.int32(0)), (_CHUNK, M))
    jd = jax.lax.dynamic_slice(jbuf, (start,), (_CHUNK,))
    C = X[:, jd]
    delta = matmul_digits(C.astype(jnp.int32), Rd, p, weights, d)
    return _submod(X, delta, p, d == 2).astype(X.dtype)


@functools.partial(jax.jit, static_argnames=("d",), donate_argnums=(0,))
def _backreduce_at(Rbuf, Rd, jd, start, p, weights, d: int):
    """Back-reduce one _CHUNK-row slice of the buffer against new rows
    Rd (Kp, M) with pivots jd; Kp is shape-bucketed by the caller."""
    M = Rbuf.shape[1]
    Xc = jax.lax.dynamic_slice(Rbuf, (start, jnp.int32(0)), (_CHUNK, M))
    C = Xc[:, jd]
    delta = matmul_digits(C.astype(jnp.int32), Rd, p, weights, d)
    Xc = _submod(Xc, delta, p, d == 2)
    return jax.lax.dynamic_update_slice(Rbuf, Xc.astype(Rbuf.dtype),
                                        (start, jnp.int32(0)))


@functools.partial(jax.jit, donate_argnums=(0,))
def _write_rows(Rbuf, Rd, start):
    return jax.lax.dynamic_update_slice(Rbuf, Rd.astype(Rbuf.dtype),
                                        (start, jnp.int32(0)))


@functools.partial(jax.jit, donate_argnums=(0,))
def _write_vec(jbuf, jd, start):
    return jax.lax.dynamic_update_slice(jbuf, jd, (start,))


@functools.partial(jax.jit, static_argnames=("cap", "M", "dt"))
def _alloc_basis(cap: int, M: int, dt):
    return (jnp.zeros((cap, M), dt),
            jnp.full((cap,), M - 1, jnp.int64))


class CompactBasis:
    """Growing device-resident RREF basis over a fixed compacted width M.

    ONE preallocated (cap, M) buffer (pad rows zero, pivots parked at
    the dead column M-1, algebraically inert): blocks eliminate against
    the basis chunk-by-chunk with a FIXED-SHAPE program (_CHUNK rows,
    traced offset), so the whole finisher compiles one apply and one
    back-reduce variant regardless of round count — the per-round
    shape-specialized programs of the growing-buffer design dominated
    cold start through compile time.  Storage is int16 or int32 as
    `modp.storage_dtype(p)` decides.
    """

    def __init__(self, M: int, p: int, cap: int):
        from .modp import device_field, storage_dtype
        self.M = M
        self.p = p
        self.F = device_field(p)
        self.cap = -(-max(cap, 1) // _CHUNK) * _CHUNK
        self.Rbuf, self.jbuf = _alloc_basis(self.cap, M, storage_dtype(p))
        self.jpos_host = []       # host jpos of each appended chunk
        self.count = 0
        self.nrows = 0

    def apply(self, X):
        """Eliminate every basis pivot from X (B, M).  Consumes X."""
        p64 = jnp.int64(self.p)
        w = jnp.asarray(self.F.weights)
        for c in range(-(-self.count // _CHUNK)):
            X = _basis_apply_at(X, self.Rbuf, self.jbuf,
                                jnp.int32(c * _CHUNK), p64, w,
                                self.F.ndigits)
        return X

    def add(self, Rd, jpos: np.ndarray):
        """Append reduced rows (pivots at compacted columns jpos), after
        back-reducing the existing basis against them."""
        jpos = np.asarray(jpos, np.int64)
        jd = jnp.asarray(jpos)
        Kp = int(Rd.shape[0])
        p64 = jnp.int64(self.p)
        w = jnp.asarray(self.F.weights)
        for c in range(-(-self.count // _CHUNK)):
            self.Rbuf = _backreduce_at(self.Rbuf, Rd, jd,
                                       jnp.int32(c * _CHUNK), p64, w,
                                       self.F.ndigits)
        need = self.count + Kp
        if need > self.cap:                     # rare: bucket-padding
            grow = -(-(need - self.cap) // _CHUNK) * _CHUNK
            self.Rbuf = jnp.concatenate(
                [self.Rbuf, jnp.zeros((grow, self.M), self.Rbuf.dtype)])
            self.jbuf = jnp.concatenate(
                [self.jbuf, jnp.full((grow,), self.M - 1, jnp.int64)])
            self.cap += grow
        st = jnp.int32(self.count)
        self.Rbuf = _write_rows(self.Rbuf, Rd, st)
        self.jbuf = _write_vec(self.jbuf, jd, st)
        self.count = need
        self.jpos_host.append(jpos)
        self.nrows += int(jpos.size)

    def export(self):
        """(rows, jpos) of the whole basis: rows (count, M) device view,
        jpos (count,) host (concatenated append order)."""
        if self.count == 0:
            return None, np.empty(0, np.int64)
        return (self.Rbuf[:self.count],
                np.concatenate(self.jpos_host))
