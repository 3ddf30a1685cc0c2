"""Symbolic reachability and triangular solves (host side).

The Gilbert-Peierls machinery of the reference
(/root/reference/src/spasm_reach.c, spasm_triangular.c), restructured:

  * `reach` — iterative DFS over the bipartite pivot graph; returns the
    union of columns reachable from the pattern of B[k] in topological
    order (last-finished first).
  * `sparse_triangular_solve` — symbolic reach + numeric elimination of
    B[k] against the unitary pivots of U.
  * dense forward/back solves used by the LU system solver.

These remain on the host: they are irregular, data-dependent graph walks.
The device path (spasm_tpu.dense) batches whole row *blocks* instead and
eliminates them level-by-level with matmuls; these per-row versions are
the exact scalar reference used by the engine for very sparse residues and
by the test-suite property checks.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .csr import CSR
from .spmv import scatter


def reach(U: CSR, B: CSR, k: int, qinv: np.ndarray) -> np.ndarray:
    """Columns reachable from the pattern of B[k] by alternating paths.

    qinv[j] = row of U holding the pivot of column j, or -1.
    Returns the reachable column set in topological order (a column appears
    after every column reachable from it), as the reference's xj[top:m].
    """
    m = U.m
    Up, Uj = U.indptr, U.indices
    Bcols, _ = B.row(k)
    marks = np.zeros(m, dtype=bool)
    out = []                     # post-order; reversed at the end
    # iterative DFS with explicit stacks
    stack = np.empty(m, dtype=np.int64)
    pstack = np.empty(m, dtype=np.int64)
    for jstart in Bcols:
        if marks[jstart]:
            continue
        head = 0
        stack[head] = jstart
        pstack[head] = 0
        marks[jstart] = True
        while head >= 0:
            j = stack[head]
            i = qinv[j]
            if i < 0:
                out.append(j)
                head -= 1
                continue
            lo, hi = Up[i], Up[i + 1]
            px = lo + pstack[head]
            advanced = False
            while px < hi:
                jj = Uj[px]
                px += 1
                if not marks[jj]:
                    pstack[head] = px - lo
                    head += 1
                    stack[head] = jj
                    pstack[head] = 0
                    marks[jj] = True
                    advanced = True
                    break
            if not advanced:
                out.append(j)
                head -= 1
    # reference emits nodes by prepending at xj[--top]: reverse post-order
    return np.asarray(out[::-1], dtype=np.int64)


def sparse_triangular_solve(U: CSR, B: CSR, k: int, qinv: np.ndarray,
                            x: Optional[np.ndarray] = None
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Solve xs * U = B[k] for the sparse row B[k].

    U's pivots must be unitary (== 1); qinv locates them.  Returns
    (pattern, x): `pattern` is the topologically ordered nonzero pattern,
    `x` a dense m-vector with the scattered solution.  Entries of x on
    non-pivotal columns are the residue (the Schur complement row);
    entries on pivotal columns are the elimination coefficients.
    (reference: spasm_triangular.c:109-147)
    """
    m = U.m
    pattern = reach(U, B, k, qinv)
    if x is None:
        x = np.zeros(m, dtype=np.int64)
    else:
        x[pattern] = 0
    scatter(B, k, 1, x)
    F = U.field
    Up, Uj, Ux = U.indptr, U.indices, U.data
    for j in pattern:
        i = qinv[j]
        if i < 0:
            continue
        xj = x[j]
        if xj == 0:
            continue
        lo, hi = Up[i], Up[i + 1]
        cols = Uj[lo:hi]
        # pivot of row i is 1 at column j: x -= x[j] * U[i]
        x[cols] = F.narray(x[cols].astype(np.int64)
                           - np.int64(xj) * Ux[lo:hi].astype(np.int64))
        x[j] = xj
    return pattern, x


def dense_forward_solve(U: CSR, b: np.ndarray, q: Optional[np.ndarray]
                        ) -> Tuple[bool, np.ndarray]:
    """Solve x.U = b with dense b (destroyed).  U is permuted
    upper-triangular with unit pivots; q[i] = pivot column of row i.
    Returns (ok, x); ok is False when b is not in rowspace(U).
    (reference: spasm_triangular.c:65-89)"""
    n = U.n
    x = np.zeros(n, dtype=np.int64)
    for i in range(n):
        j = q[i] if q is not None else i
        if b[j] == 0:
            continue
        x[i] = b[j]
        scatter(U, i, -int(b[j]), b)
    ok = not np.any(b)
    return ok, x.astype(np.int32)


def dense_back_solve(L: CSR, b: np.ndarray, p: Optional[np.ndarray]
                     ) -> np.ndarray:
    """Solve x.L = b with dense b (destroyed).  L is permuted
    lower-triangular with nonzero "diagonal"; p[j] = row with the diagonal
    entry of column j.  (reference: spasm_triangular.c:21-53)"""
    n, r = L.n, L.m
    F = L.field
    x = np.zeros(n, dtype=np.int64)
    Lp, Lj, Lx = L.indptr, L.indices, L.data
    for j in range(r - 1, -1, -1):
        i = int(p[j]) if p is not None else j
        lo, hi = Lp[i], Lp[i + 1]
        sel = np.nonzero(Lj[lo:hi] == j)[0]
        assert sel.size, "missing diagonal entry"
        diag = int(Lx[lo + sel[0]])
        alpha = F.inverse(diag)
        xi = F.normalize(alpha * int(b[j]))
        scatter(L, i, -xi, b)
        x[i] = xi
    return x.astype(np.int32)
