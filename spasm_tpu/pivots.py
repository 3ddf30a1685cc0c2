"""Structural (arithmetic-free) pivot selection.

Re-implements the three pivot-search passes of the reference
(/root/reference/src/spasm_pivots.c) with host-side vectorized / graph
code — these passes are O(nnz) symbolic work and never the FLOP
bottleneck; the arithmetic they unlock runs on the device:

  1. Faugere-Lachartre: for every column, the sparsest row whose leftmost
     entry lies on it (vectorized lexsort selection).
  2. FL-on-columns: rows with an entry on a column absent from every
     pivotal row (greedy sequential sweep).
  3. Greedy alternating-cycle-free search [PASCO'17]: per-row BFS over
     alternating paths; entries unreachable from the row's other entries
     through existing pivots can be adopted as new pivots.  The
     reference's lock-free transactional OpenMP version collapses to the
     sequential algorithm here (deterministic by construction).

Then pivotal rows are reordered topologically (DFS) so that the selected
pivot block is upper-triangular up to a column permutation.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .csr import CSR


def find_fl_pivots(A: CSR, pinv: np.ndarray, qinv: np.ndarray) -> int:
    """Faugere-Lachartre pass (spasm_pivots.c:41-66), vectorized.

    For each column j: among rows whose *leftmost* entry is on j, pick the
    sparsest (ties: smallest row index).  No conflicts are possible.
    """
    n = A.n
    weights = A.row_weights()
    nonempty = np.nonzero(weights > 0)[0]
    if nonempty.size == 0:
        return 0
    # leftmost column of each nonempty row
    leftmost = np.minimum.reduceat(
        A.indices[:A.nnz], A.indptr[nonempty].astype(np.int64))
    w = weights[nonempty]
    order = np.lexsort((nonempty, w, leftmost))
    lm_sorted = leftmost[order]
    first = np.ones(order.size, dtype=bool)
    first[1:] = lm_sorted[1:] != lm_sorted[:-1]
    rows = nonempty[order][first]
    cols = lm_sorted[first]
    pinv[rows] = cols
    qinv[cols] = rows
    return int(rows.size)


def find_fl_column_pivots(A: CSR, pinv: np.ndarray, qinv: np.ndarray) -> int:
    """FL-on-columns pass (spasm_pivots.c:76-122).

    w[j] == True while column j does not appear on any pivotal row.
    """
    from . import native
    if native.HAVE_NATIVE:
        return native.fl_column_pivots(A, pinv, qinv)
    m = A.m
    open_col = np.ones(m, dtype=bool)
    rows = A.row_ids()
    piv_entries = pinv[rows] >= 0
    open_col[A.indices[:A.nnz][piv_entries]] = False
    npiv = 0
    indptr, indices = A.indptr, A.indices
    for i in np.nonzero(pinv < 0)[0]:
        cols = indices[indptr[i]:indptr[i + 1]]
        ok = open_col[cols] & (qinv[cols] < 0)
        hits = np.nonzero(ok)[0]
        if hits.size:
            j = cols[hits[0]]
            pinv[i] = j
            qinv[j] = i
            open_col[cols] = False
            npiv += 1
    return npiv


def find_cycle_free_pivots(A: CSR, pinv: np.ndarray,
                           qinv: np.ndarray,
                           work_budget: int = 0) -> int:
    """Greedy alternating-cycle-free pass (spasm_pivots.c:146-294).

    Sequential deterministic variant of the PASCO'17 transactional search:
    for each non-pivotal row, BFS the columns reachable from its entries
    through existing pivots; a surviving (unreachable, non-pivotal) entry
    becomes a new pivot.

    work_budget > 0 caps the total BFS expansion count: on expander-like
    matrices the full search costs O(n*nnz) host time for marginal gain
    (the device dense finisher absorbs the leftover rows far cheaper), while
    FL-friendly instances complete well inside the budget.  Early stop is
    sound — greedy pivots are valid incrementally.
    """
    from . import native
    if native.HAVE_NATIVE:
        return native.cycle_free_pivots(A, pinv, qinv, work_budget)
    return _find_cycle_free_pivots_py(A, pinv, qinv, work_budget)


def _find_cycle_free_pivots_py(A: CSR, pinv: np.ndarray,
                               qinv: np.ndarray,
                               work_budget: int = 0) -> int:
    m = A.m
    indptr, indices = A.indptr, A.indices
    state = np.zeros(m, dtype=np.int8)   # 0 clean, 1 survivor, -1 reached
    queue = np.empty(m, dtype=np.int64)
    npiv = 0
    work = 0
    for i in np.nonzero(pinv < 0)[0]:
        if work_budget > 0 and work > work_budget:
            break
        cols = indices[indptr[i]:indptr[i + 1]]
        head = tail = 0
        surviving = 0
        for j in cols:
            if qinv[j] < 0:
                state[j] = 1
                surviving += 1
            elif state[j] >= 0:
                surviving -= state[j]
                state[j] = -1
                queue[tail] = j
                tail += 1
        while head < tail and surviving > 0:
            j = queue[head]
            head += 1
            r = qinv[j]
            if r < 0:
                continue
            work += int(indptr[r + 1] - indptr[r])
            for jj in indices[indptr[r]:indptr[r + 1]]:
                if state[jj] >= 0:
                    surviving -= state[jj]
                    state[jj] = -1
                    queue[tail] = jj
                    tail += 1
        if surviving > 0:
            for j in cols:
                if state[j] == 1:
                    pinv[i] = j
                    qinv[j] = i
                    npiv += 1
                    break
        # cleanup marks
        state[cols] = 0
        state[queue[:tail]] = 0
    return npiv


def topo_order_pivots(A: CSR, pinv: np.ndarray, qinv: np.ndarray,
                      npiv: int) -> np.ndarray:
    """Row permutation: pivotal rows first in topological order, then the
    rest (spasm_pivots.c:325-362).

    The DFS runs on the alternating-path digraph: pivotal column j ->
    row qinv[j] -> that row's columns.
    """
    from . import native
    if native.HAVE_NATIVE:
        p = native.topo_order(A, pinv, qinv)
        return p
    n, m = A.n, A.m
    indptr, indices = A.indptr, A.indices
    marks = np.zeros(m, dtype=bool)
    post = []          # post-order of columns
    stack = np.empty(m, dtype=np.int64)
    pstack = np.empty(m, dtype=np.int64)
    for jroot in range(m):
        if qinv[jroot] < 0 or marks[jroot]:
            continue
        head = 0
        stack[0] = jroot
        pstack[0] = 0
        marks[jroot] = True
        while head >= 0:
            j = stack[head]
            i = qinv[j]
            if i < 0:
                post.append(j)
                head -= 1
                continue
            lo, hi = indptr[i], indptr[i + 1]
            px = lo + pstack[head]
            advanced = False
            while px < hi:
                jj = indices[px]
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
                post.append(j)
                head -= 1
    # reverse post-order = topological order of pivotal columns
    p = np.empty(n, dtype=np.int64)
    k = 0
    for j in reversed(post):
        i = qinv[j]
        if i >= 0:
            p[k] = i
            k += 1
    assert k == npiv, (k, npiv)
    rest = np.nonzero(pinv < 0)[0]
    p[k:] = rest
    return p


def row_levels(A: CSR, rows: np.ndarray, pinv: np.ndarray) -> np.ndarray:
    """Topological levels of pivotal rows (extension over the reference).

    `rows` must be in a valid topological order (a row's support only
    contains pivot columns of rows at the same index or later).  Rows in
    the same level never contain each other's pivot columns, so a level
    can be eliminated from a dense block as ONE batched update with no
    intra-chunk (I+W)^-1 composition (dense/block.py) — the device
    analog of level-scheduled sparse triangular solves.
    """
    from . import native
    rows = np.asarray(rows, np.int64)
    npiv = rows.size
    if npiv == 0:
        return np.zeros(0, np.int64)
    if native.HAVE_NATIVE:
        return native.row_levels(A, rows, pinv)
    col2k = np.full(A.m, -1, np.int64)
    col2k[np.asarray(pinv)[rows]] = np.arange(npiv)
    lev = np.zeros(npiv, np.int64)
    indptr, indices = A.indptr, A.indices
    for k in range(npiv):
        t = col2k[indices[indptr[rows[k]]:indptr[rows[k] + 1]]]
        t = t[t > k]
        if t.size:
            np.maximum.at(lev, t, lev[k] + 1)
    return lev


def find_structural_pivots(A: CSR, enable_greedy: bool = True,
                           greedy_work_budget: int = -1
                           ) -> Tuple[int, np.ndarray, np.ndarray,
                                      np.ndarray, np.ndarray]:
    """All passes + topological reorder + level scheduling.

    Returns (npiv, p, pinv, qinv, levels): p puts pivotal rows first in
    level-major topological order (a valid topological order in which
    rows of equal level are consecutive — maximizing the number of
    composition-free eliminator chunks); levels[k] is the level of row
    p[k] (k < npiv); pinv[i] / qinv[j] locate the pivots (-1 if none).
    greedy_work_budget: -1 = auto (32 * nnz), 0 = unlimited, else cap.
    """
    n, m = A.n, A.m
    pinv = np.full(n, -1, dtype=np.int64)
    qinv = np.full(m, -1, dtype=np.int64)
    npiv = find_fl_pivots(A, pinv, qinv)
    npiv += find_fl_column_pivots(A, pinv, qinv)
    if enable_greedy:
        budget = 32 * max(A.nnz, 1) if greedy_work_budget < 0 \
            else greedy_work_budget
        npiv += find_cycle_free_pivots(A, pinv, qinv, budget)
    p = topo_order_pivots(A, pinv, qinv, npiv)
    lev = row_levels(A, p[:npiv], pinv)
    if npiv:
        order = np.argsort(lev, kind="stable")
        p[:npiv] = p[:npiv][order]
        lev = lev[order]
    return npiv, p, pinv, qinv, lev
