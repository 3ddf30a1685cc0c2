"""Plain host references for the device kernels of this package.

Straightforward numpy implementations of the same semantics, sharing no
code with the device paths they check: exact GF(p) matrix products, the
row-sweep RREF of `rowrref.rref_rows_device`, and the reduced pivot
basis of `reduced.ReducedBasis`.  Every function is exact for every odd
p <= 2^32 - 5 and returns balanced residues.  Tests and `chip_smoke.py`
compare the device results with these.
"""
from __future__ import annotations

import numpy as np


def balanced(x: np.ndarray, p: int) -> np.ndarray:
    """Balanced representative in [-(p-1)/2, (p-1)/2], int64."""
    r = np.asarray(x, np.int64) % p
    return np.where(r > p // 2, r - p, r)


def mulmod(a, b, p: int) -> np.ndarray:
    """(a * b) mod p in [0, p), elementwise with broadcasting.

    a and b are taken mod p first; a is split into 16-bit halves so no
    int64 product exceeds 2^48.
    """
    a = np.asarray(a, np.int64) % p
    b = np.asarray(b, np.int64) % p
    lo = (a & 0xFFFF) * b % p
    hi = (a >> 16) * b % p
    return (lo + hi * 65536 % p) % p


def matmul_modp(A: np.ndarray, B: np.ndarray, p: int,
                block: int = 2048) -> np.ndarray:
    """Exact (A @ B) mod p, balanced int64 out.

    Residues in [0, p) are split into three 11-bit digits.  One digit
    product summed over at most `block` terms stays below 2^33, so each
    of the nine digit matmuls is exact in float64 (53-bit mantissa);
    the digit planes are recombined by Horner steps in int64 mod p.
    """
    A = np.asarray(A, np.int64) % p
    B = np.asarray(B, np.int64) % p
    n, k = A.shape
    out = np.zeros((n, B.shape[1]), np.int64)
    for k0 in range(0, k, block):
        Ad = [((A[:, k0:k0 + block] >> (11 * s)) & 2047).astype(np.float64)
              for s in range(3)]
        Bd = [((B[k0:k0 + block] >> (11 * s)) & 2047).astype(np.float64)
              for s in range(3)]
        acc = np.zeros_like(out)
        for s in range(4, -1, -1):          # Horner over digit weight s
            plane = np.zeros_like(out)
            for i in range(3):
                if 0 <= s - i < 3:
                    plane += (Ad[i] @ Bd[s - i]).astype(np.int64) % p
            acc = (acc * 2048 + plane) % p
        out = (out + acc) % p
    return balanced(out, p)


def rref_rows(X: np.ndarray, p: int):
    """Row-sweep RREF: rows in order, pivot at the leftmost nonzero.

    Each row is reduced against the pivot rows found so far; a nonzero
    remainder is normalized to a unit pivot at its leftmost nonzero
    column and back-reduced out of the earlier pivot rows.  Returns
    (R, pivcol): R (B, M) balanced int64 with row i the fully reduced
    pivot row of input row i (zero if it reduced to zero), pivcol[i] its
    pivot column or -1.
    """
    R = np.asarray(X, np.int64) % p
    B, M = R.shape
    pivcol = np.full(B, -1, np.int64)
    done = []
    for i in range(B):
        r = R[i]
        if done:
            rows = np.asarray(done)
            c = r[pivcol[rows]]                   # (k,) in [0, p)
            Pm = R[rows]
            sub = ((c & 0xFFFF) @ Pm % p
                   + (c >> 16) @ Pm % p * 65536 % p)
            r = (r - sub) % p
        nz = np.flatnonzero(r)
        if nz.size == 0:
            R[i] = 0
            continue
        j = int(nz[0])
        r = mulmod(r, pow(int(r[j]), -1, p), p)
        if done:
            rows = np.asarray(done)
            R[rows] = (R[rows] - mulmod(R[rows, j][:, None], r[None, :], p)
                       ) % p
        R[i] = r
        pivcol[i] = j
        done.append(i)
    return balanced(R, p), pivcol


def reduced_basis(offs, cols, vals, pivcols, groups, qfree, p: int,
                  X: np.ndarray = None) -> np.ndarray:
    """Host substitution model of `ReducedBasis.build`, times X.

    The basis rows are given flat (row k: cols/vals[offs[k]:offs[k+1]]),
    with pivot column pivcols[k] (its own entry is skipped) and
    topological group groups[k]: a row references only rows of strictly
    greater group.  R[k] = (row k on the free columns qfree) - sum over
    its entries on other rows' pivot columns of coef * R[that row],
    solved one group at a time in descending order.  Returns R @ X
    (npiv, X.shape[1]) balanced int64; X defaults to the identity, which
    gives R itself (npiv, len(qfree)).
    """
    offs = np.asarray(offs, np.int64)
    pivcols = np.asarray(pivcols, np.int64)
    groups = np.asarray(groups, np.int64)
    qfree = np.asarray(qfree, np.int64)
    npiv, nq = pivcols.size, qfree.size
    if X is None:
        X = np.eye(nq, dtype=np.int64)
    X = np.asarray(X, np.int64) % p
    nnz = int(offs[-1])
    cols = np.asarray(cols, np.int64)[:nnz]
    vals = np.asarray(vals, np.int64)[:nnz]
    rr = np.repeat(np.arange(npiv), np.diff(offs))
    width = int(max(cols.max(initial=0), pivcols.max(initial=0),
                    qfree.max(initial=0))) + 1
    row_of = np.full(width, -1, np.int64)
    row_of[pivcols] = np.arange(npiv)
    slot_of = np.full(width, -1, np.int64)
    slot_of[qfree] = np.arange(nq)
    own = cols == pivcols[rr]
    free = (slot_of[cols] >= 0) & ~own
    ref = (row_of[cols] >= 0) & ~own

    def add_rows(Y, rows, terms, sign):     # terms in [0, p), per entry
        u, inv = np.unique(rows, return_inverse=True)
        acc = np.zeros((u.size, Y.shape[1]), np.int64)
        np.add.at(acc, inv, terms)
        Y[u] = (Y[u] + sign * (acc % p)) % p

    Y = np.zeros((npiv, X.shape[1]), np.int64)
    fe_all = np.flatnonzero(free)
    for e0 in range(0, fe_all.size, 1 << 16):
        fe = fe_all[e0:e0 + (1 << 16)]
        add_rows(Y, rr[fe], mulmod(vals[fe, None], X[slot_of[cols[fe]]], p),
                 1)
    re = np.flatnonzero(ref)
    re = re[np.argsort(-groups[rr[re]], kind="stable")]
    bounds = np.flatnonzero(np.diff(groups[rr[re]])) + 1
    for chunk in np.split(re, bounds):      # one group per chunk
        if chunk.size:
            add_rows(Y, rr[chunk],
                     mulmod(vals[chunk, None], Y[row_of[cols[chunk]]], p), -1)
    return balanced(Y, p)
