"""Blocked rank-revealing dense elimination over GF(p) on device.

Replaces the reference's FFPACK bridge (spasm_ffpack.cpp:22-75,
FFPACK::pReducedRowEchelonForm / FFPACK::pPLUQ) with a device design:

  * columns are processed left-to-right in panels of NB;
  * a *division-free discovery sweep* (lax.fori_loop over the (n, NB)
    panel only) finds the pivot (row, column) pairs.  Cross-multiplication
    updates  P <- v*P - col*P[r]  preserve zero patterns exactly, so the
    pivot choices match classical column-pivoted elimination while needing
    no modular inverses inside the sequential loop;
  * the panel's pivot minor  W = S[R, J]  (rows R, columns J of the
    pre-panel matrix) is inverted by a division-free Gauss-Jordan with
    diagonal pivoting — valid because W's leading minors are exactly the
    pivot minors, all nonsingular — followed by ONE batched Fermat
    inversion of the accumulated diagonal scales;
  * the whole panel update is then two exact int8-digit matmuls:
        U = W^-1 @ S[R, :]                (the reduced pivot rows)
        S <- S - G @ U,   G = S[:, J] - I_at_pivot_slots
    The -I trick makes pivot rows land exactly on their reduced rows
    (row r_t receives  S[r_t] - (W[t,:]-e_t) W^-1 S[R,:] = U[t]).

  Rank deficiency is handled by masking: a column with no available
  nonzero contributes an identity row/column to W and a zero slot in
  G/U, which is algebraically a no-op.  This keeps every shape static
  for XLA while the reference's FFPACK performs data-dependent row and
  column rotations.

  RREF mode eliminates every row; LU mode eliminates only not-yet-pivotal
  rows, computes the forward (unit-lower) factorization of W instead of
  the full inverse, and records multipliers L (A_block == L @ U).

The prime is a runtime scalar (one compiled kernel per shape bucket and
digit tier, not per prime).  For the d == 2 digit tier (p <= 65279)
every elementwise step runs in pure int32 + float32-Barrett; int64
lanes are used only for larger primes.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .modp import (dnorm, dnorm64, modinv, matmul_digits, device_field,
                   mulmod, _reduce31)

_NB = 64          # panel width (local sweep length)
_NBLK = 512       # column-block width of the composed trailing update
                  # (both carried over untuned; see ROADMAP A3)


def _mulsub(v, P, g, piv, p, small: bool, rounds: int):
    """Balanced v*P - g*piv (outer product form), elementwise exact.

    small (p <= 65279): |v*P - g*piv| <= 2*(p/2)^2 < 2^31, pure int32.
    otherwise: int64 products < 2^62, Barrett rounds as given.
    """
    if small:
        # explicit int32 casts: int16 operands (the small-prime block
        # dtype) would otherwise multiply in int16 and overflow
        x = (v.astype(jnp.int32) * P.astype(jnp.int32)
             - g.astype(jnp.int32) * piv.astype(jnp.int32))
        return _reduce31(x, p)
    x = (v.astype(jnp.int64) * P.astype(jnp.int64)
         - g.astype(jnp.int64) * piv.astype(jnp.int64))
    return dnorm(x, p, rounds)


def _submod(A, B, p, small: bool):
    """Balanced A - B; |A - B| <= p needs one conditional correction."""
    if small:
        x = A - B
        p32 = jnp.asarray(p, jnp.int32)
        half = (p32 - 1) >> 1
        x = jnp.where(x > half, x - p32, x)
        return jnp.where(x < -half, x + p32, x)
    x = A.astype(jnp.int64) - B.astype(jnp.int64)
    p64 = jnp.asarray(p, jnp.int64)
    half = p64 >> 1
    x = jnp.where(x > half, x - p64, x)
    return jnp.where(x < -half, x + p64, x).astype(jnp.int32)


def _scale_rows(c, M, p, small: bool, rounds: int):
    """Balanced diag(c) @ M."""
    if small:
        return _reduce31(c[:, None].astype(jnp.int32) * M, p)
    return dnorm(c[:, None].astype(jnp.int64) * M.astype(jnp.int64),
                 p, rounds)


class _Pivots(NamedTuple):
    lrows: jnp.ndarray    # (NB,)  pivot row per slot (-1 if none)
    lhas: jnp.ndarray     # (NB,)  slot validity
    is_piv: jnp.ndarray   # (n,)   updated pivot-row mask


def _discovery_sweep(P, is_piv, p, small: bool, rounds: int) -> _Pivots:
    """Division-free pivot discovery on a panel (positions only).

    Updates scale rows by the running pivot value, which preserves zero
    patterns exactly, so the (row, column) pivot choices equal those of
    the classical normalized sweep — at ~10 cheap ops per sequential
    step instead of a Fermat inversion.
    """
    n, nb = P.shape
    iota = jnp.arange(n)

    def step(t, carry):
        P, is_piv, lrows, lhas = carry
        col = P[:, t]
        avail = jnp.logical_and(~is_piv, col != 0)
        has = jnp.any(avail)
        r = jnp.argmax(avail)
        v = jnp.where(has, col[r], 1)
        g = jnp.where(jnp.logical_and(avail, iota != r), col, 0)
        P = _mulsub(v, P, g[:, None], P[r, :][None, :], p, small, rounds)
        lrows = lrows.at[t].set(jnp.where(has, r, -1).astype(jnp.int32))
        lhas = lhas.at[t].set(has)
        is_piv = is_piv.at[r].set(is_piv[r] | has)
        return P, is_piv, lrows, lhas

    init = (P, is_piv, jnp.full((nb,), -1, jnp.int32),
            jnp.zeros((nb,), bool))
    _, is_piv, lrows, lhas = jax.lax.fori_loop(0, nb, step, init)
    return _Pivots(lrows, lhas, is_piv)


def _jordan_inverse(W, p, small: bool, rounds: int):
    """W^-1 mod p by division-free Gauss-Jordan with diagonal pivots.

    Requires every leading principal minor of W nonsingular (true for
    pivot minors produced by the discovery sweep; empty slots carry
    embedded identity rows/columns).  One batched Fermat inversion of
    the accumulated diagonal scales at the end.
    """
    nb = W.shape[0]
    M = jnp.concatenate([W, jnp.eye(nb, dtype=jnp.int32)], axis=1)

    def step(t, M):
        v = M[t, t]
        g = M[:, t].at[t].set(_submod(v, jnp.int32(1), p, small))
        piv = M[t, :]
        return _mulsub(v, M, g[:, None], piv[None, :], p, small, rounds)

    M = jax.lax.fori_loop(0, nb, step, M)
    dvals = M[jnp.arange(nb), jnp.arange(nb)]
    dinv = dnorm64(modinv(dvals, p), p)          # batched Fermat
    return _scale_rows(dinv.astype(jnp.int32), M[:, nb:], p, small, rounds)


def _forward_factor(W, p, small: bool, rounds: int):
    """Division-free forward elimination of [W | I] (rows below the
    diagonal only).  Returns (Zlu, Vup) with
        Zlu = D^-1 Λ^-1    (so Zlu @ S[R,:] are the unit-pivot LU rows)
        Vup = D^-1 Ω       (unit upper; W = Λ Ω, D = diag(Ω))
    """
    nb = W.shape[0]
    iota = jnp.arange(nb)
    M = jnp.concatenate([W, jnp.eye(nb, dtype=jnp.int32)], axis=1)

    def step(t, M):
        v = M[t, t]
        below = iota > t
        g = jnp.where(below, M[:, t], 0)
        piv = M[t, :]
        Mnew = _mulsub(v, M, g[:, None], piv[None, :], p, small, rounds)
        return jnp.where(below[:, None], Mnew, M)

    M = jax.lax.fori_loop(0, nb, step, M)
    dvals = M[iota, iota]
    dinv = dnorm64(modinv(dvals, p), p).astype(jnp.int32)
    Zlu = _scale_rows(dinv, M[:, nb:], p, small, rounds)
    Vup = _scale_rows(dinv, M[:, :nb], p, small, rounds)
    return Zlu, Vup


def _unit_upper_inverse_small(V, p, small: bool):
    """Inverse of a unit upper-triangular (NB, NB) matrix mod p."""
    nb = V.shape[0]

    def step(t, Vinv):
        i = nb - 1 - t
        if small:
            terms = _reduce31(V[i, :, None] * Vinv, p)
            prod = jnp.sum(terms, axis=0)                 # <= nb * p/2
            row = _reduce31(-prod, p).at[i].add(1)
            return Vinv.at[i, :].set(_reduce31(row, p))
        terms = mulmod(V[i, :, None], Vinv, p)
        prod = jnp.sum(terms, axis=0)
        row = dnorm(-prod, p).at[i].add(1)
        return Vinv.at[i, :].set(dnorm(row.astype(jnp.int64), p))

    return jax.lax.fori_loop(0, nb, step, jnp.zeros_like(V))


def _panel_step(S, j0, is_piv, L, p, weights, d: int, nb: int,
                rref: bool, small: bool, rounds: int):
    """One full panel update at column offset j0 (traced scalar).

    Returns (S', lrows, lhas, is_piv', L').  In LU mode, L receives the
    multiplier columns at global columns [j0, j0+nb).
    """
    n, m = S.shape
    P0 = jax.lax.dynamic_slice(S, (0, j0), (n, nb))
    piv = _discovery_sweep(P0, is_piv, p, small, rounds)
    lrows_safe = jnp.where(piv.lhas, piv.lrows, 0)
    rows0 = jnp.where(piv.lhas[:, None], S[lrows_safe, :], 0)   # (nb, m)
    Wfull = jax.lax.dynamic_slice(rows0, (0, j0), (nb, nb))
    both = jnp.logical_and(piv.lhas[:, None], piv.lhas[None, :])
    W = jnp.where(both, Wfull, jnp.eye(nb, dtype=jnp.int32))

    colmask = (jnp.arange(m) >= j0)[None, :]
    slot = jnp.arange(nb)
    if rref:
        Z = _jordan_inverse(W, p, small, rounds)
        U = matmul_digits(Z, rows0, p, weights, d)               # (nb, m)
        U = jnp.where(jnp.logical_and(colmask, piv.lhas[:, None]), U, 0)
        G = jnp.where(piv.lhas[None, :], P0, 0)
        G = G.at[lrows_safe, slot].add(
            jnp.where(piv.lhas, jnp.int32(-1), 0))
    else:
        Zlu, Vup = _forward_factor(W, p, small, rounds)
        Vinv = _unit_upper_inverse_small(Vup, p, small)
        U = matmul_digits(Zlu, rows0, p, weights, d)
        U = jnp.where(jnp.logical_and(colmask, piv.lhas[:, None]), U, 0)
        # multipliers for every not-yet-pivotal row (incl. the panel's
        # own pivot rows: ell[r_t] = (Λ D)[t, :], lower in slot order)
        Cf = jnp.where(jnp.logical_and(~is_piv[:, None],
                                       piv.lhas[None, :]), P0, 0)
        ell = matmul_digits(Cf, Vinv, p, weights, d)             # (n, nb)
        ell = jnp.where(piv.lhas[None, :], ell, 0)
        L = jax.lax.dynamic_update_slice(L, ell, (0, j0))
        # the update coefficients against the *forward-reduced* U are the
        # multipliers themselves (rows0 = Λ D U, so ell[r_t] - e_t makes
        # pivot row r_t land exactly on U[t])
        G = ell.at[lrows_safe, slot].add(
            jnp.where(piv.lhas, jnp.int32(-1), 0))
    delta = matmul_digits(G, U, p, weights, d)                   # (n, m)
    S = _submod(S, delta, p, small)
    return S, piv.lrows, piv.lhas, piv.is_piv, L


@functools.partial(jax.jit,
                   static_argnames=("d", "rref", "nb", "sweep_small",
                                    "nblk"))
def _eliminate(S, p, weights, d: int, rref: bool, nb: int = _NB,
               sweep_small: bool = False, nblk: int = 0):
    """Full blocked elimination.  S: (n, m) int32 balanced, m % nb == 0.

    Two-level blocking: thin nb-panels discover pivots and update only the
    current nblk-wide column block; the trailing matrix then receives ONE
    composed update per block (contraction dim nblk, so the matmul runs at
    high arithmetic intensity instead of the nb-wide panels' low one).  The
    composed update is exact block Gaussian elimination on the block's
    pre-values: with R/J the block's pivot rows/columns and W = S_pre[R, J]
    (nonsingular leading minors by construction, empty slots masked to
    identity),
        U     = W^-1 @ S[R, trail]          (RREF; Zlu @ ... for LU)
        S    -= G @ U,   G = coeffs - I_at_pivot_slots
    where the coefficients are S_pre[:, J] (RREF) or the multipliers the
    inner panels already recorded in L (LU).

    Returns (S_final, pivrow_of_col (m,), is_piv (n,), L (n, m) or (n,1)).
    In LU mode, L slot column t of panel q holds the multiplier column of
    local step t (zero for empty slots); the host compacts it.
    """
    n, m = S.shape
    if nblk <= 0:
        nblk = _NBLK
    nblk = min(nblk, m)
    if m % nblk != 0:        # padded sizes are 2^k or 512q: only tiny m
        nblk = nb
    npanels_blk = nblk // nb
    nblocks = m // nblk
    want_l = not rref
    small = d == 2
    # Division-free updates are bounded by 2*(p/2)^2 <= p*(p/2); one
    # Barrett round is exact for |x| <= p * 2^22, i.e. p <= 2^23
    # (sweep_small is threaded from the host with exactly that bound).
    rounds = 1 if sweep_small else 2
    eyeb = jnp.eye(nblk, dtype=jnp.int32)
    slot = jnp.arange(nblk)
    colids = jnp.arange(m)

    def block(qb, carry):
        S, pivrow_of_col, is_piv, L = carry
        j0 = qb * nblk
        P_pre = jax.lax.dynamic_slice(S, (0, j0), (n, nblk))

        def panel(q, c):
            B, is_piv, lrows_a, lhas_a, Lb = c
            jl = q * nb
            B, lrows, lhas, is_piv, Lb = _panel_step(
                B, jl, is_piv, Lb, p, weights, d, nb, rref, small,
                rounds)
            lrows_a = jax.lax.dynamic_update_slice(lrows_a, lrows, (jl,))
            lhas_a = jax.lax.dynamic_update_slice(lhas_a, lhas, (jl,))
            return B, is_piv, lrows_a, lhas_a, Lb

        Lb0 = jnp.zeros((n, nblk if want_l else 1), jnp.int32)
        B, is_piv, lrows, lhas, Lb = jax.lax.fori_loop(
            0, npanels_blk, panel,
            (P_pre, is_piv, jnp.full((nblk,), -1, jnp.int32),
             jnp.zeros((nblk,), bool), Lb0))
        S = jax.lax.dynamic_update_slice(S, B, (0, j0))
        if want_l:
            L = jax.lax.dynamic_update_slice(L, Lb, (0, j0))
        pivrow_of_col = jax.lax.dynamic_update_slice(
            pivrow_of_col, jnp.where(lhas, lrows, -1), (j0,))

        def with_trailing(S):
            lsafe = jnp.where(lhas, lrows, 0)
            rows_pre = jnp.where(lhas[:, None], P_pre[lsafe, :], 0)
            both = jnp.logical_and(lhas[:, None], lhas[None, :])
            W = jnp.where(both, rows_pre, eyeb)
            rows_cur = jnp.where(lhas[:, None], S[lsafe, :], 0)  # (nblk, m)
            colmask = (colids >= j0 + nblk)[None, :]
            if rref:
                Z = _jordan_inverse(W, p, small, rounds)
                G = jnp.where(lhas[None, :], P_pre, 0)
            else:
                Z, _ = _forward_factor(W, p, small, rounds)
                G = jnp.where(lhas[None, :], Lb, 0)
            U = matmul_digits(Z, rows_cur, p, weights, d)
            U = jnp.where(jnp.logical_and(colmask, lhas[:, None]), U, 0)
            G = G.at[lsafe, slot].add(jnp.where(lhas, jnp.int32(-1), 0))
            delta = matmul_digits(G, U, p, weights, d)
            return _submod(S, jnp.where(colmask, delta, 0), p, small)

        if nblocks > 1:
            S = jax.lax.cond(qb < nblocks - 1, with_trailing,
                             lambda s: s, S)
        return S, pivrow_of_col, is_piv, L

    L0 = jnp.zeros((n, m if want_l else 1), jnp.int32)
    init = (S, jnp.full((m,), -1, jnp.int32),
            jnp.zeros((n,), bool), L0)
    S, pivrow_of_col, is_piv, L = jax.lax.fori_loop(0, nblocks, block, init)
    return S, pivrow_of_col, is_piv, L


def _size_bucket(x: int, quantum: int) -> int:
    """Round up to a power of two (<= 1024) or to a multiple of 512.

    Zero padding is algebraically inert here (no pivots from zero
    rows/columns); bucketing bounds the number of jit variants.  The
    power-of-two ladder stops at 1024: above that, coarser buckets waste
    cubic work in the elimination (e.g. 2304 -> 4096 would triple the
    FLOPs) while multiples of 512 add at most ~2 variants per doubling.
    """
    x = max(x, quantum)
    if x <= 1024:
        b = quantum
        while b < x:
            b <<= 1
        return b
    return -(-x // 512) * 512


def _pad(S: np.ndarray, nb: int, rows_quantum: int = 32) -> np.ndarray:
    n, m = S.shape
    mp = _size_bucket(max(m, 1), nb)
    np_ = _size_bucket(max(n, 1), rows_quantum)
    if mp == m and np_ == n:
        return S
    out = np.zeros((np_, mp), dtype=np.int32)
    out[:n, :m] = S
    return out


def _run(S: np.ndarray, p: int, rref: bool, nb: int):
    from ..parallel.context import shard_cols
    F = device_field(p)
    Sp = _pad(np.ascontiguousarray(S, np.int32), nb)
    # active mesh: column-sharded right-looking elimination (panel sweep
    # where the panel lives, trailing matmul updates local per column
    # shard)
    return _eliminate(shard_cols(jnp.asarray(Sp)), jnp.int64(p),
                      jnp.asarray(F.weights), F.ndigits, rref, nb,
                      p <= (1 << 23))


def dense_rref_device(Xd, p: int, nb: int = _NB):
    """Device-resident RREF: no matrix-sized device->host transfer.

    Xd: (n, m) int32 balanced, resident on device.  Returns
    (Rd, pivcols): Rd is the (rank, m) device array of reduced pivot rows
    (ordered by pivot column, unit pivots); pivcols the ascending host
    pivot-column indices.  Only the (m,) pivot-row map crosses to host.
    """
    from ..parallel.context import shard_cols
    F = device_field(p)
    n, m = Xd.shape
    mp = _size_bucket(max(m, 1), nb)
    np_ = _size_bucket(max(n, 1), 32)
    if (np_, mp) != (n, m):
        Xd = jnp.pad(Xd, ((0, np_ - n), (0, mp - m)))
    Sf, pivrow_of_col, _, _ = _eliminate(
        shard_cols(Xd), jnp.int64(p), jnp.asarray(F.weights), F.ndigits,
        True, nb, p <= (1 << 23))
    pivrow = np.asarray(pivrow_of_col)[:m]          # small: m int32
    pivcols = np.nonzero(pivrow >= 0)[0]
    rows = jnp.asarray(pivrow[pivcols], jnp.int32)
    Rd = Sf[rows, :m] if pivcols.size else jnp.zeros((0, m), jnp.int32)
    return Rd, pivcols.astype(np.int64)


@functools.partial(jax.jit, static_argnames=("d", "small"))
def _normalize_rows(Ud, pv, p, d: int, small: bool):
    inv = dnorm64(modinv(pv, p), p).astype(jnp.int32)
    return _scale_rows(inv, Ud, p, small, 2)


def dense_lu_device(Xd, p: int, nb: int = _NB):
    """Device-resident column-pivoted LU of a device block Xd (n, m).

    Returns (prows, pivcols, Ld, Ud): prows/pivcols host (rank,) int64;
    Ld (n_pad, rank) device multiplier columns (S == Ld @ Ud_unnorm...,
    exactly S == Ld' @ Ud with Ld' = Ld, Ud the unit-pivot rows — the
    diagonal pivot value lives in Ld, matching dense_lu); Ud (rank, m)
    device unit-pivot upper rows.  Only the (m,) pivot map crosses to
    host.  The device analog of spasm_ffpack_LU (spasm_ffpack.cpp:88-96).
    """
    from ..parallel.context import shard_cols
    F = device_field(p)
    n, m = Xd.shape
    mp = _size_bucket(max(m, 1), nb)
    np_ = _size_bucket(max(n, 1), 32)
    if (np_, mp) != (n, m):
        Xd = jnp.pad(Xd, ((0, np_ - n), (0, mp - m)))
    Sf, pivrow_of_col, _, Lslots = _eliminate(
        shard_cols(Xd.astype(jnp.int32)), jnp.int64(p),
        jnp.asarray(F.weights), F.ndigits, False, nb,
        p <= (1 << 23))
    pivrow = np.asarray(pivrow_of_col)[:m]
    pivcols = np.nonzero(pivrow >= 0)[0].astype(np.int64)
    rank = pivcols.size
    if rank == 0:
        return (np.empty(0, np.int64), pivcols,
                jnp.zeros((n, 0), jnp.int32), jnp.zeros((0, m), jnp.int32))
    prows = pivrow[pivcols].astype(np.int64)
    rows_d = jnp.asarray(prows)
    cols_d = jnp.asarray(pivcols)
    pv = Sf[rows_d, cols_d]
    Ud = _normalize_rows(Sf[rows_d, :m], pv, jnp.int64(p), F.ndigits,
                         F.ndigits == 2)
    Ld = Lslots[:n, cols_d]
    return prows, pivcols, Ld, Ud


# Below this many elements a numpy sweep beats device dispatch + compile.
_HOST_LIMIT = 1 << 16


def _norm_np(x: np.ndarray, p: int) -> np.ndarray:
    r = x % p
    return np.where(r > p // 2, r - p, r)


def _sweep_np(S: np.ndarray, p: int, rref: bool):
    """Host reference elimination with the same pivot choices as the
    device kernel (first not-yet-pivotal row per column, no swapping)."""
    A = np.ascontiguousarray(S, np.int64)
    n, m = A.shape
    is_piv = np.zeros(n, dtype=bool)
    prows, pcols = [], []
    L = np.zeros((n, min(n, m)), np.int64) if not rref else None
    for j in range(m):
        col = A[:, j]
        avail = (~is_piv) & (col != 0)
        if not avail.any():
            continue
        r = int(np.argmax(avail))
        pivval = int(A[r, j])
        inv = pow(pivval, -1, p)
        inv = inv - p if inv > p // 2 else inv
        u = _norm_np(A[r] * inv, p)
        if rref:
            g = col.copy()
            g[r] = pivval - 1
            A = _norm_np(A - np.outer(g, u), p)
        else:
            g = np.where(avail, col, 0)
            g[r] = 0
            A = _norm_np(A - np.outer(g, u), p)
            L[:, len(prows)] = g
            L[r, len(prows)] = pivval
        prows.append(r)
        pcols.append(j)
        is_piv[r] = True
    prows = np.asarray(prows, np.int64)
    pcols = np.asarray(pcols, np.int64)
    return A, prows, pcols, L


def dense_rref(S: np.ndarray, p: int, nb: int = _NB, force: str = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Reduced row echelon form with column pivoting of S mod p.

    Input: (n, m) balanced int32 (numpy).  Output:
      R    (rank, m) fully reduced rows, pivot entry 1 at `pivcols[i]`,
           zero on every other pivot column, ordered by pivot column;
      pivcols (rank,) ascending pivot column indices.
    The analog of spasm_ffpack_rref (spasm_ffpack.cpp:78-86).
    """
    n, m = S.shape
    if force != "device" and (force == "host" or S.size <= _HOST_LIMIT):
        A, prows, pivcols, _ = _sweep_np(S, p, True)
        R = A[prows].astype(np.int32) if prows.size else \
            np.empty((0, m), np.int32)
        return R, pivcols
    Sf, pivrow_of_col, _, _ = _run(S, p, True, nb)
    pivrow_of_col = np.asarray(pivrow_of_col)[:m]
    pivcols = np.nonzero(pivrow_of_col >= 0)[0]
    rows = pivrow_of_col[pivcols]
    R = np.asarray(Sf)[rows][:, :m] if pivcols.size else \
        np.empty((0, m), np.int32)
    return R, pivcols.astype(np.int64)


def dense_lu(S: np.ndarray, p: int, nb: int = _NB, force: str = None):
    """Column-pivoted PLUQ-style factorization of S mod p.

    Returns (rank, prows, pivcols, L, Urows):
      prows   (rank,) pivot row of each pivot, in pivot (column) order
      pivcols (rank,) pivot column of each pivot (ascending)
      L       (n, rank)  with  S == L @ Urows  (exact, mod p)
      Urows   (rank, m)  unit-pivot upper rows (U[k, pivcols[k]] == 1)
    The analog of spasm_ffpack_LU (spasm_ffpack.cpp:88-96).
    """
    from ..field import Field
    n, m = S.shape
    if force != "device" and (force == "host" or S.size <= _HOST_LIMIT):
        F = Field(p)
        A, prows, pivcols, L = _sweep_np(S, p, False)
        rank = prows.size
        if rank:
            invs = F.inverse_array(A[prows, pivcols]).astype(np.int64)
            Urows = F.narray(A[prows] * invs[:, None])
            Lc = F.narray(L[:, :rank])
        else:
            Urows = np.empty((0, m), np.int32)
            Lc = np.empty((n, 0), np.int32)
        return rank, prows, pivcols, Lc, Urows
    Sf, pivrow_of_col, _, Lslots = _run(S, p, False, nb)
    pivrow_of_col = np.asarray(pivrow_of_col)[:m]
    pivcols = np.nonzero(pivrow_of_col >= 0)[0]
    rows = pivrow_of_col[pivcols]
    rank = pivcols.size
    Sf = np.asarray(Sf)
    F = Field(p)
    if rank:
        pivvals = Sf[rows, pivcols].astype(np.int64)
        inv = F.inverse_array(pivvals).astype(np.int64)
        Urows = F.narray(Sf[rows][:, :m].astype(np.int64) * inv[:, None])
        L = np.asarray(Lslots)[:n, pivcols]
    else:
        Urows = np.empty((0, m), np.int32)
        L = np.empty((n, 0), np.int32)
    return rank, rows.astype(np.int64), pivcols.astype(np.int64), L, Urows


def dense_rank(S: np.ndarray, p: int, nb: int = _NB,
               force: str = None) -> int:
    """Rank of a dense balanced int32 matrix mod p."""
    n, m = S.shape
    if n == 0 or m == 0:
        return 0
    if force != "device" and (force == "host" or S.size <= _HOST_LIMIT):
        _, prows, _, _ = _sweep_np(S, p, True)
        return int(prows.size)
    _, pivrow_of_col, _, _ = _run(S, p, True, nb)
    return int(np.count_nonzero(np.asarray(pivrow_of_col)[:m] >= 0))
