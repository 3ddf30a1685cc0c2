"""The echelonization engine: round-structured structural pivoting + Schur
complements + dense finishers.

The capability equivalent of /root/reference/src/spasm_echelonize.c, with
the execution model inverted for an accelerator (SURVEY.md §7): structural
pivot rounds run as host graph passes; all arithmetic-heavy elimination flows
through the chunked device eliminator and the blocked device RREF/PLUQ
(spasm_tpu.dense), with the per-row Gilbert-Peierls solver kept as the
sparse finisher of last resort.

Round loop (defaults mirror spasm_echelonize_init_opts,
spasm_echelonize.c:9-28): find structural pivots -> stop if too few
(min_pivot_proportion) or the Schur complement is too dense
(sparsity_threshold) or max_round reached -> else compute the sparse Schur
complement and iterate on it.  Device-first extension: as soon as the
free-column count fits a dense device block (device_dense_width), the
round loop stops and the DEVICE-RESIDENT finisher takes over — one
upload of the matrix entries, then combination forming, chunked
elimination, compaction and row-sweep RREF entirely on device, with
only pivot-column maps crossing back.  Classic finalization (aspect
ratio > tall_and_skinny_ratio -> randomized low-rank; density >
threshold -> blocked dense; else GPLU) remains for L-mode, huge widths
and no-device runs.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import sys
import time
from typing import List, Optional

import jax.numpy as jnp
import numpy as np

from .csr import CSR
from .field import Field
from .pivots import find_structural_pivots
from .schur import (estimate_density, schur_sparse, schur_dense_block,
                    schur_dense_randomized)
from .triangular import sparse_triangular_solve
from .dense.elim import dense_rref, dense_lu, dense_rank
from .dense.modp import storage_dtype
from .dense.block import UEliminator
from . import checkpoint as ckpt
from .profiling import phase, annotate

log = logging.getLogger("spasm_tpu")
if not log.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("%(message)s"))
    log.addHandler(_h)
    log.setLevel(logging.INFO)


@dataclasses.dataclass
class EchelonizeOptions:
    """Mirror of struct echelonize_opts (spasm.h:84-108) with the
    reference defaults (spasm_echelonize.c:9-28)."""
    enable_greedy_pivot_search: bool = True
    enable_tall_and_skinny: bool = True
    enable_dense: bool = True
    enable_GPLU: bool = True
    L: bool = False
    complete: bool = False
    min_pivot_proportion: float = 0.1
    max_round: int = 3
    sparsity_threshold: float = 0.05
    tall_and_skinny_ratio: float = 5.0
    dense_block_size: int = 1000
    low_rank_ratio: float = 0.5
    low_rank_start_weight: int = -1
    # Extension (not in the reference): BFS expansion budget for
    # the greedy pivot search; -1 = auto (32 * nnz), 0 = unlimited.
    greedy_work_budget: int = -1
    # Extension: the device-resident dense finisher takes over
    # as soon as the number of free (non-pivotal) columns fits this
    # width — the remaining rank lives in a dense block that belongs on
    # the device, so further sparse Schur rounds are skipped (SURVEY.md §7
    # "invert the reference's emphasis").  0 disables (reference-shaped
    # round loop + host/hybrid finishers).
    device_dense_width: int = 65536
    # Minimum remaining work (rows * free columns) before the device
    # finisher pays for its dispatches; below it the host paths win.
    device_dense_min: int = 1 << 22
    # Device-memory budget (bytes) for the finisher's state: the reduced
    # basis R (pivot_rows * free_cols) plus the accumulated finisher
    # basis (~ remaining_rank * free_cols); widths whose state would
    # exceed it fall back to the sparse-round / host finishers.  None:
    # 5/8 of what the device may allocate (device_memory_budget).
    device_dense_mem: Optional[int] = None
    # Extension: mid-engine checkpoint/resume (SURVEY.md §5.4).
    # When set, the engine snapshots its state to this file after every
    # round and every dense-finisher block; re-running with the same input
    # resumes from the snapshot.  The file is removed on completion.
    checkpoint_file: Optional[str] = None
    # Minimum seconds between dense-finisher snapshots (each save repacks
    # U + S, O(nnz); unthrottled per-block saves can dominate the
    # finisher).  Round-boundary snapshots are never throttled.
    checkpoint_interval_s: float = 30.0


def device_memory_budget(device=None) -> int:
    """Default `device_dense_mem`: 5/8 of what the device may allocate.

    The rest is headroom for each finisher round's transient blocks.  A
    device that reports no allocator limit (the CPU backend) is bounded
    by physical host memory instead.
    """
    import jax
    if device is None:
        device = jax.devices()[0]
    limit = (device.memory_stats() or {}).get("bytes_limit")
    if not limit:
        limit = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return int(limit) * 5 // 8


# L-mode dense blocks at or above this many elements (rows x free
# columns) run the device-resident Schur+LU path; smaller blocks keep
# the host sweep (dispatch + compile overhead dominates below it).
_DEVICE_LU_MIN = 1 << 16


class _LBuilder:
    """Triplet accumulator for L (the reference's Ltmp).

    Dense-factor parts may stay DEVICE-RESIDENT via add_pending: a
    thunk returning (rows, cols, vals) host triplets runs only when the
    L matrix is actually built, so factorization wall-clock excludes
    the factors' device->host transfer (~GBs on big complete PLUQs —
    solves can consume device factors without ever paying it)."""

    def __init__(self, prime: int):
        self.prime = prime
        self.rows: List[np.ndarray] = []
        self.cols: List[np.ndarray] = []
        self.vals: List[np.ndarray] = []
        self._pending: List = []

    def add_pending(self, thunk):
        self._pending.append(thunk)

    def flush_pending(self):
        pending, self._pending = self._pending, []
        for th in pending:
            r, c, v = th()
            if len(r):
                self.add_batch(r, c, v)

    def add(self, i: int, j: int, x: int):
        self.add_batch(np.asarray([i], np.int64), np.asarray([j], np.int64),
                       np.asarray([x], np.int64))

    def add_batch(self, i, j, x):
        self.rows.append(np.asarray(i, np.int64))
        self.cols.append(np.asarray(j, np.int64))
        self.vals.append(np.asarray(x, np.int64))

    def truncate(self) -> int:
        return len(self.rows)

    def rollback_filter(self, mark: int, keep_row) -> None:
        """Drop entries added after `mark` whose row fails keep_row."""
        for k in range(mark, len(self.rows)):
            sel = keep_row(self.rows[k])
            self.rows[k] = self.rows[k][sel]
            self.cols[k] = self.cols[k][sel]
            self.vals[k] = self.vals[k][sel]

    def build(self, n: int, ncols: int) -> CSR:
        from .csr import COO
        self.flush_pending()
        if self.rows:
            r = np.concatenate(self.rows)
            c = np.concatenate(self.cols)
            v = np.concatenate(self.vals)
        else:
            r = c = v = np.empty(0, np.int64)
        T = COO.from_entries(n, max(ncols, 1), self.prime, r, c, v)
        T.n, T.m = n, max(ncols, 1)
        A = T.tocsr()
        A.resize(n, ncols)
        return A


class _UBuilder:
    """Incremental U accumulator: rows with unitary pivots first.

    Rows live in *segments* — flat CSR-style arrays (offs, cols, vals,
    pivcols, levels) — so bulk pushes (structural pivot extraction with
    its 10^5+ rows, dense RREF blocks) never loop per row in Python.
    Rows may also arrive as *device-resident dense blocks* (the pivot
    rows of a device RREF), materialized to host lazily so the engine's
    hot path never waits on a matrix-sized device->host transfer.

    Segment `levels` (optional) are topological levels: rows of equal
    level never contain each other's pivot columns.  A segment without
    levels asserts all its rows are mutually independent (true for RREF
    blocks and single-row appends).  Any row only references pivot
    columns of *later* rows (the engine's upper-triangular invariant) —
    the property the reduced-basis finisher builds on.
    """

    def __init__(self, m: int, prime: int):
        self.m = m
        self.prime = prime
        self.field = Field(prime)
        self.qinv = np.full(m, -1, dtype=np.int64)
        # (offs, cols int32, vals int32, pivcols int64, levels or None)
        self._segs: List[tuple] = []
        # deferred device blocks: (Rd, colmap, pivcols_global, base_row)
        self._pending: List[tuple] = []
        self._n = 0
        self._rows_cache: Optional[List[tuple]] = None

    @property
    def n(self) -> int:
        return self._n

    @property
    def pivcol(self) -> np.ndarray:
        """Pivot column of each U row (device blocks included)."""
        self.flush_device()
        if not self._segs:
            return np.empty(0, np.int64)
        return np.concatenate([s[3] for s in self._segs])

    @property
    def rows(self) -> List[tuple]:
        """Per-row (cols, vals) views, pivot first (lazy)."""
        self.flush_device()
        if self._rows_cache is None:
            out = []
            for offs, cols, vals, _, _ in self._segs:
                for k in range(len(offs) - 1):
                    sl = slice(offs[k], offs[k + 1])
                    out.append((cols[sl], vals[sl]))
            self._rows_cache = out
        return self._rows_cache

    def add_row(self, pivcol: int, cols: np.ndarray, vals: np.ndarray):
        """cols/vals: full row with value 1 at pivcol; pivot stored
        first.  Returns the stored (cols, vals) pair."""
        sel = cols != pivcol
        c = np.concatenate(([pivcol], cols[sel])).astype(np.int32)
        v = np.concatenate(([1], vals[sel])).astype(np.int32)
        self.add_rows_bulk(np.asarray([pivcol], np.int64),
                           np.asarray([0, c.size], np.int64), c, v)
        return c, v

    def add_rows_bulk(self, pivcols: np.ndarray, offs: np.ndarray,
                      cols: np.ndarray, vals: np.ndarray, levels=None):
        """Bulk append of pivot-first rows (value 1 at pivcols[k])."""
        npiv = len(pivcols)
        if npiv == 0:
            return
        self.flush_device()
        self._segs.append((np.asarray(offs, np.int64),
                           np.asarray(cols, np.int32),
                           np.asarray(vals, np.int32),
                           np.asarray(pivcols, np.int64),
                           None if levels is None
                           else np.asarray(levels, np.int64)))
        self.qinv[np.asarray(pivcols, np.int64)] = \
            self._n + np.arange(npiv)
        self._n += npiv
        if self._rows_cache is not None:
            c, v, o = cols, vals, offs
            for k in range(npiv):
                self._rows_cache.append((c[o[k]:o[k + 1]],
                                         v[o[k]:o[k + 1]]))

    def add_dense_rows_device(self, Rd, colmap: np.ndarray,
                              pivcols_global: np.ndarray):
        """Register device RREF rows without transferring them.

        Rd: (rank, w) device block (row k has value 1 at the column
        mapping to pivcols_global[k]); colmap: (w,) global column ids.
        """
        pivcols = np.asarray(pivcols_global, np.int64)
        self.qinv[pivcols] = self._n + np.arange(len(pivcols))
        self._pending.append((Rd, np.asarray(colmap, np.int64),
                              pivcols, self._n))
        self._n += len(pivcols)
        self._rows_cache = None

    def flush_device(self):
        """Materialize pending device blocks into host sparse segments."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        for Rd, colmap, pivcols, k0 in pending:
            R = np.asarray(Rd)                     # the one D2H transfer
            K = R.shape[0]
            nz_r, nz_c = np.nonzero(R)
            # pivot-first: order key puts each row's own pivot col first
            # (ppos[i] = position of pivcols[i] inside colmap)
            order_cm = np.argsort(colmap, kind="stable")
            ppos = order_cm[np.searchsorted(colmap, pivcols,
                                            sorter=order_cm)]
            first = nz_c == ppos[nz_r]
            order = np.lexsort((~first, nz_r))
            nz_r, nz_c = nz_r[order], nz_c[order]
            counts = np.bincount(nz_r, minlength=K)
            offs = np.concatenate(([0], np.cumsum(counts)))
            self._segs.append((offs.astype(np.int64),
                               colmap[nz_c].astype(np.int32),
                               R[nz_r, nz_c].astype(np.int32),
                               pivcols, None))
        self._rows_cache = None

    def flat_store(self):
        """All rows as one flat store for the reduced-basis build.

        Returns (offs, cols, vals, pivcols, groups): groups are
        non-decreasing ints; equal-group rows are mutually independent
        and rows only reference strictly-greater groups.
        """
        self.flush_device()
        if not self._segs:
            z = np.zeros(1, np.int64)
            return (z, np.empty(0, np.int32), np.empty(0, np.int32),
                    np.empty(0, np.int64), np.empty(0, np.int64))
        offs_all = [np.zeros(1, np.int64)]
        cols_all, vals_all, piv_all, grp_all = [], [], [], []
        base = 0
        gid = 0
        for offs, cols, vals, pivcols, levels in self._segs:
            offs_all.append(offs[1:] + base)
            base += offs[-1]
            cols_all.append(cols[:offs[-1]])
            vals_all.append(vals[:offs[-1]])
            piv_all.append(pivcols)
            if levels is None:
                levels = _intra_levels(offs, cols, pivcols)
            grp_all.append(gid + levels)
            gid += int(levels.max(initial=0)) + 1
        return (np.concatenate(offs_all), np.concatenate(cols_all),
                np.concatenate(vals_all), np.concatenate(piv_all),
                np.concatenate(grp_all))

    def snapshot_csr(self) -> CSR:
        self.flush_device()
        offs, cols, vals, pivcols, _ = self.flat_store()
        A = CSR(self._n, self.m, self.field, offs, cols, vals)
        return A

    def nnz(self) -> int:
        if self._pending:
            return -1          # unknown without forcing a transfer
        return int(sum(int(s[0][-1]) for s in self._segs))


def _intra_levels(offs: np.ndarray, cols: np.ndarray,
                  pivcols: np.ndarray) -> np.ndarray:
    """Forward topological levels of an upper-triangular row set.

    Row k's entries on *later* rows' pivot columns force those rows to a
    level > level(k); equal-level rows never reference each other.  Used
    for segments that arrive without level data (e.g. checkpoint
    restores); returns zeros fast when no intra-segment references
    exist (mutually reduced blocks).
    """
    n = len(pivcols)
    lev = np.zeros(n, np.int64)
    if n <= 1:
        return lev
    pivcols = np.asarray(pivcols, np.int64)
    order = np.argsort(pivcols, kind="stable")
    sorted_piv = pivcols[order]
    nnz = int(offs[-1])
    pos = np.searchsorted(sorted_piv, cols[:nnz])
    pos = np.minimum(pos, n - 1)
    hit = sorted_piv[pos] == cols[:nnz]
    ref = np.where(hit, order[pos], -1)
    rowid = np.repeat(np.arange(n), np.diff(offs))
    intra = hit & (ref != rowid)
    if not np.any(intra):
        return lev
    src = rowid[intra]
    dst = ref[intra]
    o = np.argsort(src, kind="stable")
    s2, d2 = src[o], dst[o]
    bounds = np.concatenate(
        ([0], np.nonzero(np.diff(s2))[0] + 1, [len(s2)]))
    for i in range(len(bounds) - 1):              # ascending source rows
        k = s2[bounds[i]]
        t = d2[bounds[i]:bounds[i + 1]]
        np.maximum.at(lev, t, lev[k] + 1)
    return lev


class _GrowingCSR:
    """Append-only CSR view with capacity doubling.

    The GPLU finisher solves each chunk against the *current* U; repacking
    U with CSR.from_rows per chunk costs O(nnz(U)) every time — quadratic
    over the run.  This buffer appends new rows in amortized O(row nnz)
    and exposes trimmed views compatible with the native solver.
    """

    def __init__(self, base: CSR):
        self.n = base.n
        self.m = base.m
        self.prime = base.prime
        self.field = base.field
        nnz = base.nnz
        cap_r = max(2 * base.n + 8, 64)
        cap_e = max(2 * nnz + 64, 256)
        self._indptr = np.zeros(cap_r + 1, np.int64)
        self._indptr[:base.n + 1] = base.indptr[:base.n + 1]
        self._indices = np.empty(cap_e, np.int32)
        self._indices[:nnz] = base.indices[:nnz]
        self._data = np.empty(cap_e, np.int32)
        self._data[:nnz] = base.data[:nnz]
        self._nnz = nnz

    @property
    def indptr(self) -> np.ndarray:
        return self._indptr[:self.n + 1]

    @property
    def indices(self) -> np.ndarray:
        return self._indices[:self._nnz]

    @property
    def data(self) -> np.ndarray:
        return self._data[:self._nnz]

    def append_row(self, cols: np.ndarray, vals: np.ndarray):
        k = len(cols)
        if self._nnz + k > self._indices.size:
            cap = max(2 * self._indices.size, self._nnz + k)
            for name in ("_indices", "_data"):
                old = getattr(self, name)
                new = np.empty(cap, np.int32)
                new[:self._nnz] = old[:self._nnz]
                setattr(self, name, new)
        if self.n + 2 > self._indptr.size:
            new = np.zeros(2 * self._indptr.size, np.int64)
            new[:self.n + 1] = self._indptr[:self.n + 1]
            self._indptr = new
        self._indices[self._nnz:self._nnz + k] = cols
        self._data[self._nnz:self._nnz + k] = vals
        self._nnz += k
        self.n += 1
        self._indptr[self.n] = self._nnz


class LU:
    """Result object (the reference's struct spasm_lu, spasm.h:64-72).

    U may be deferred: when constructed with a thunk, the CSR is
    materialized from the device on first access, so rank-only flows
    (e.g. tools/rank) never pay the matrix-sized device->host transfer.
    """

    def __init__(self, r: int, U: Optional[CSR] = None,
                 qinv: Optional[np.ndarray] = None,
                 L: Optional[CSR] = None,
                 p: Optional[np.ndarray] = None, complete: bool = False,
                 u_thunk=None, l_thunk=None):
        self.r = r
        self._U = U
        self._u_thunk = u_thunk
        self.qinv = qinv        # (m,) pivot of col j on row qinv[j] of U
        self._L = L
        self._l_thunk = l_thunk
        self.p = p              # (r,) original row of pivot k
        self.complete = complete

    @property
    def U(self) -> CSR:
        if self._U is None and self._u_thunk is not None:
            self._U = self._u_thunk()
            self._u_thunk = None
        return self._U

    @U.setter
    def U(self, value):
        self._U = value
        self._u_thunk = None

    @property
    def L(self) -> Optional[CSR]:
        if self._L is None and self._l_thunk is not None:
            self._L = self._l_thunk()
            self._l_thunk = None
        return self._L

    @L.setter
    def L(self, value):
        self._L = value
        self._l_thunk = None


class _Engine:
    def __init__(self, A: CSR, opts: EchelonizeOptions):
        self.A0 = A
        self.opts = opts
        self.m = A.m
        self.prime = A.prime
        self.field = A.field
        self.U = _UBuilder(A.m, A.prime)
        self.L = _LBuilder(A.prime) if opts.L else None
        self.Lp: List[int] = []          # original pivot row per U row
        self.elim = UEliminator(A.m, A.prime)
        self._fp: Optional[bytes] = None

    @property
    def fingerprint(self) -> bytes:
        """SHA-256 of the input matrix (binds randomized draws to it)."""
        if self._fp is None:
            self._fp = ckpt.matrix_fingerprint(self.A0)
        return self._fp

    # -- U update helpers --------------------------------------------------

    def _push_u_row(self, pivcol: int, cols, vals):
        cols_p, vals_p = self.U.add_row(pivcol, np.asarray(cols),
                                        np.asarray(vals))
        self.elim.append_rows(
            [(cols_p.astype(np.int64), vals_p, int(pivcol))], flush=False)

    def extract_structural(self, S: CSR, p_in) -> tuple:
        """Find structural pivots in S, push them to U/L.
        Returns (npiv, p) with pivotal rows of S first in topo order.
        (reference: spasm_pivots_extract_structural, spasm_pivots.c:369-448)
        """
        t0 = time.time()
        with phase("pivots"):
            npiv, p, pinv, qinv_loc, levels = find_structural_pivots(
                S, self.opts.enable_greedy_pivot_search,
                self.opts.greedy_work_budget)
        F = self.field
        if npiv:
            # vectorized row extraction + batch normalization
            from .csr import _concat_ranges
            rows = p[:npiv]
            starts = S.indptr[rows]
            lens = (S.indptr[rows + 1] - starts).astype(np.int64)
            gather = _concat_ranges(starts, lens)
            cols_flat = S.indices[gather].astype(np.int64)
            vals_flat = S.data[gather].astype(np.int64)
            rowrep = np.repeat(np.arange(npiv), lens)
            pivcols = pinv[rows]
            on_piv = cols_flat == pivcols[rowrep]
            pv = np.zeros(npiv, np.int64)
            pv[rowrep[on_piv]] = vals_flat[on_piv]
            alpha = F.inverse_array(pv).astype(np.int64)
            scaled = F.narray(vals_flat * alpha[rowrep]).astype(np.int32)
            offs = np.concatenate(([0], np.cumsum(lens)))
            iorigs = (np.asarray(p_in, np.int64)[rows]
                      if p_in is not None else rows)
            if self.L is not None:
                self.L.add_batch(iorigs,
                                 self.U.n + np.arange(npiv), pv)
            self.Lp.extend(int(v) for v in iorigs)
            # pivot-first reordering, fully vectorized: swap the pivot
            # entry of each row with the row's first slot
            piv_pos = np.flatnonzero(on_piv)
            first = offs[:-1]
            cols2 = cols_flat.copy()
            vals2 = scaled.copy()
            cols2[piv_pos] = cols_flat[first]
            vals2[piv_pos] = scaled[first]
            cols2[first] = pivcols
            vals2[first] = 1
            cols32 = cols2.astype(np.int32)
            self.U.add_rows_bulk(pivcols, offs, cols32, vals2,
                                 levels=levels)
            self.elim.append_segment(offs, cols2, vals2, pivcols, levels)
        log.info("[pivots] %d structural pivots found [%.2fs]",
                 npiv, time.time() - t0)
        return npiv, p

    def update_after_rref(self, R: np.ndarray, pivcols: np.ndarray,
                          q: np.ndarray):
        """Push dense RREF rows (columns compacted by q) into U.
        (reference: update_U_after_rref, spasm_echelonize.c:192-223)"""
        nz_r, nz_c = np.nonzero(R)
        counts = np.bincount(nz_r, minlength=R.shape[0])
        offs = np.concatenate(([0], np.cumsum(counts)))
        vals_flat = R[nz_r, nz_c]
        cols_flat = q[nz_c]
        for k in range(len(pivcols)):
            sl = slice(offs[k], offs[k + 1])
            self._push_u_row(int(q[pivcols[k]]), cols_flat[sl],
                             vals_flat[sl])

    def update_after_lu(self, rank: int, prows, pivcols, Ld, Urows,
                        q: np.ndarray, p_out: np.ndarray, lmark: int):
        """Push dense LU into U and L.
        (reference: update_fact_after_LU, spasm_echelonize.c:228-313)"""
        if not self.opts.complete:
            pivotal = set(int(p_out[r]) for r in prows)
            self.L.rollback_filter(
                lmark, lambda rows: np.isin(rows,
                                            np.asarray(list(pivotal) or [-1])))
        ubase = self.U.n
        # L entries from the dense factor
        nrows = Ld.shape[0]
        rows_iter = range(nrows) if self.opts.complete else \
            [int(r) for r in prows]
        for i in rows_iter:
            iorig = int(p_out[i])
            nz = np.nonzero(Ld[i])[0]
            if nz.size:
                self.L.add_batch(np.full(nz.size, iorig, np.int64),
                                 ubase + nz, Ld[i][nz])
        for k in range(rank):
            self.Lp.append(int(p_out[prows[k]]))
            nz = np.nonzero(Urows[k])[0]
            self._push_u_row(int(q[pivcols[k]]), q[nz], Urows[k][nz])

    def _dense_lu_block_device(self, S: CSR, rows: np.ndarray, p_in,
                               lmark: int) -> int:
        """Device-resident L-mode dense block (round-4 redesign of the
        host path): Schur elimination, column-pivoted LU and factor
        merge all run on device.  The factors themselves STAY on device:
        L receives lazy materialization thunks, U registers the dense
        block as a pending device segment, and the eliminator gets a
        device-COMPOSED chunk (with its (I+W)^-1 so later blocks park
        correct per-U-row coefficients) — no factor-sized device->host
        transfer happens unless the caller reads L/U.
        (reference: update_fact_after_LU, spasm_echelonize.c:228-313)
        Returns the block's rank."""
        from .dense.elim import dense_lu_device
        from .dense.block import _unit_upper_inverse_log
        from .dense.modp import matmul_digits, device_field
        from .schur import schur_dense_block_device
        Xq, q, p_out, (Cd, piv_cols) = schur_dense_block_device(
            S, rows, p_in, self.U.qinv, self.elim, want_L=True)
        prows, pivcols, Ld, Ud = dense_lu_device(Xq, self.prime)
        rank = int(pivcols.size)
        complete = self.opts.complete
        B = len(rows)
        keep_mask = None
        if not complete:
            keep_mask = np.zeros(B, bool)
            if rank:
                keep_mask[prows] = True
        # deferred L part 1: coefficients against prior pivots
        ucols_of = self.U.qinv[piv_cols].copy()

        def thunk_C(Cd=Cd, npc=piv_cols.size, uc=ucols_of, po=p_out,
                    keep=keep_mask, B=B):
            C = np.asarray(Cd)[:B, :npc]
            if keep is not None:
                C = np.where(keep[:, None], C, 0)
            r, c = np.nonzero(C)
            return po[r], uc[c], C[r, c].astype(np.int64)

        self.L.add_pending(thunk_C)
        ubase = self.U.n
        if rank:
            # deferred L part 2: the dense factor's multipliers
            def thunk_Ld(Ld=Ld, po=p_out, ubase=ubase, keep=keep_mask,
                         B=B):
                Lh = np.asarray(Ld)[:B]
                if keep is not None:
                    Lh = np.where(keep[:, None], Lh, 0)
                r, c = np.nonzero(Lh)
                return po[r], ubase + c, Lh[r, c].astype(np.int64)

            self.L.add_pending(thunk_Ld)
            # U rows stay device-resident (lazy pivot-first rows)
            gpiv = q[pivcols]
            colmap = np.full(Ud.shape[1], self.m, np.int64)
            colmap[:q.size] = q
            self.U.add_dense_rows_device(Ud, colmap, gpiv)
            # eliminator: compose (I+W)^-1 ON DEVICE so later blocks
            # eliminate against this factor without a 10^7-entry host
            # restaging; winv rides along for coefficient parking
            F = device_field(self.prime)
            p64 = jnp.int64(self.prime)
            wts = jnp.asarray(F.weights)
            W = Ud[:, jnp.asarray(pivcols)]
            tri = jnp.triu(jnp.ones((rank, rank), bool), 1)
            W = jnp.where(tri, W, 0)
            Winv = _unit_upper_inverse_log(W, p64, wts, F.ndigits)
            V = matmul_digits(Winv, Ud, p64, wts, F.ndigits)
            self.elim.flush()
            self.elim._register_device_chunk(
                V, colmap, np.asarray(pivcols, np.int64), winv=Winv)
            self.Lp.extend(p_out[prows].tolist())
        return rank

    def schur_sparse_reduced(self, S: CSR, rows_p: np.ndarray, n: int,
                             p_in) -> tuple:
        """Sparse Schur complement through the reduced basis (no-L
        path): residues form directly in the compacted free-column
        domain — per-row reference gathers instead of the full-width
        chunked scans of schur_sparse — then pack back to CSR.
        (reference: spasm_schur, spasm_schur.c:61-193)"""
        from .dense.reduced import ReducedBasis
        from .schur import _pack_nonzero_device
        from .schur import _pack_nonzero_dispatch, _pack_nonzero_finish
        qfree = np.nonzero(self.U.qinv < 0)[0]
        rb = ReducedBasis(self.m, self.prime, qfree, self.U.n)
        offs_u, cols_u, vals_u, piv_u, grp_u = self.U.flat_store()
        with phase("reduced_basis"):
            rb.build(offs_u, cols_u, vals_u, piv_u, grp_u)
        rb.set_entries(S.indices, S.data, S.nnz)
        B = 8192
        tri_r, tri_c, tri_v = [], [], []
        counts = np.zeros(n, np.int64)
        p_out = np.asarray(p_in, np.int64)[rows_p[:n]] \
            if p_in is not None else np.asarray(rows_p[:n], np.int64)
        # one-deep software pipeline (SURVEY §2.4 PP): block b's device
        # forming/counting overlaps block b-1's device->host drain and
        # host packing; SPASM_NO_OVERLAP=1 reverts to strict order
        overlap = not os.environ.get("SPASM_NO_OVERLAP")
        pending = None

        def drain(pend):
            b0p, r, c, v = pend[0], *_pack_nonzero_finish(pend[1])
            np.add.at(counts, b0p + r.astype(np.int64), 1)
            tri_r.append(b0p + r.astype(np.int64))
            tri_c.append(qfree[c.astype(np.int64)].astype(np.int32))
            tri_v.append(v)

        for b0 in range(0, n, B):
            idx = rows_p[b0:b0 + B]
            eidx, coeff = rb.flat_rows(S.indptr, idx)
            Xd = rb.form_block(eidx, coeff, Bp=B)
            disp = _pack_nonzero_dispatch(Xd, len(idx), rb.nq)
            if pending is not None:
                drain(pending)
            pending = (b0, disp)
            if not overlap:
                drain(pending)
                pending = None
        if pending is not None:
            drain(pending)
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        S2 = CSR(n, self.m, self.field, indptr,
                 np.concatenate(tri_c) if tri_c else np.empty(0, np.int32),
                 np.concatenate(tri_v) if tri_v else np.empty(0, np.int32))
        return S2, p_out

    # -- completion test ---------------------------------------------------

    def test_completion(self, S: CSR, p: np.ndarray, n: int) -> bool:
        """Probabilistic early-abort test with ceil(128/log2 p) random
        combinations (spasm_echelonize.c:30-51)."""
        if n == 0 or S.nnz == 0:
            return True
        Sn = int(np.ceil(128 / np.log2(self.prime)))
        if self.elim.nrows > 0:
            # device-resident: only the (m,) pivot map returns to host
            from .dense.elim import dense_rref_device
            Xd, _ = schur_dense_randomized(S, p, n, None, self.U.qinv,
                                           Sn, 0, eliminator=self.elim,
                                           return_device=True)
            _, pivcols = dense_rref_device(Xd, self.prime)
            return len(pivcols) == 0
        U = self.U.snapshot_csr()
        X, _ = schur_dense_randomized(S, p, n, U, self.U.qinv, Sn, 0,
                                      eliminator=self.elim)
        return dense_rank(X, self.prime) == 0

    # -- finishers ---------------------------------------------------------

    @annotate("finish_lowrank")
    def finish_dense_lowrank(self, S: CSR, p: np.ndarray, n: int):
        """Randomized tall-and-skinny finisher
        (echelonize_dense_lowrank, spasm_echelonize.c:315-379)."""
        opts = self.opts
        Sm = self.m - self.U.n
        rank_ub = min(n, Sm)
        w = int(np.ceil(-np.log(0.01) * n / max(rank_ub, 1))) \
            if opts.low_rank_start_weight < 0 else opts.low_rank_start_weight
        t0 = time.time()
        old_un = self.U.n
        seed = 0
        rounds = 0
        use_device = self.elim.nrows > 0
        while True:
            Sn = min(rank_ub, opts.dense_block_size)
            if Sn <= 0:
                break
            if use_device:
                from .dense.elim import dense_rref_device
                Xd, q = schur_dense_randomized(
                    S, p, n, None, self.U.qinv, Sn, w,
                    eliminator=self.elim, seed_base=seed,
                    return_device=True)
                seed += Sn
                Rd, pivcols = dense_rref_device(Xd, self.prime)
                rr = len(pivcols)
                if rr:
                    self.elim.append_device_chunk(Rd, q, pivcols)
                    self.U.add_dense_rows_device(Rd, q, q[pivcols])
            else:
                U = self.U.snapshot_csr()
                X, q = schur_dense_randomized(S, p, n, U, self.U.qinv,
                                              Sn, w, eliminator=self.elim,
                                              seed_base=seed)
                seed += Sn
                R, pivcols = dense_rref(X, self.prime)
                rr = len(pivcols)
                if rr:
                    self.update_after_rref(R, pivcols, q)
            if rr == 0:
                if self.test_completion(S, p, n):
                    break
                log.info("[lowrank] failed termination test; full combos")
                w = 0
                continue
            if rr < 0.9 * Sn:
                w = max(2 * w, 2)
            use_device = self.elim.nrows > 0
            rank_ub -= rr
            rounds += 1
            log.info("[lowrank] round %d: %d new pivots", rounds, rr)
        log.info("[lowrank] done in %.1fs, %d new pivots",
                 time.time() - t0, self.U.n - old_un)

    @annotate("finish_dense")
    def finish_dense(self, S: CSR, p: np.ndarray, n: int, p_in,
                     checkpoint_cb=None, processed: int = 0):
        """Blocked dense finisher (echelonize_dense,
        spasm_echelonize.c:385-463)."""
        opts = self.opts
        t0 = time.time()
        old_un = self.U.n
        lowrank_mode = False
        # The reference caps blocks at dense_block_size (1000) for host
        # RAM; on the device bigger blocks amortize dispatch, so scale up
        # to an element budget (carried over untuned; ROADMAP A3).
        elem_budget = 64 << 20
        while True:
            # the device Schur paths materialize a transient FULL-width
            # (B, m) block before compaction, so the element budget must
            # divide by m, not by the free-column count
            auto_bs = max(opts.dense_block_size,
                          elem_budget // max(self.m, 1))
            Sn = min(auto_bs, n - processed)
            if Sn <= 0:
                break
            rows = p[processed:processed + Sn]
            lmark = self.L.truncate() if self.L is not None else 0
            if opts.L and Sn * max(self.m - self.U.n, 1) >= _DEVICE_LU_MIN:
                # device-resident L-mode: Schur + LU + merge on device
                rr = self._dense_lu_block_device(S, rows, p_in, lmark)
            elif opts.L:
                X, q, p_out = schur_dense_block(S, rows, p_in, self.U.qinv,
                                                self.elim, self.L,
                                                U_csr=self.U.snapshot_csr())
                rank, prows, pivcols, Ld, Urows = dense_lu(X, self.prime)
                self.update_after_lu(rank, prows, pivcols, Ld, Urows, q,
                                     p_out, lmark)
                rr = rank
            else:
                # device-resident: eliminate -> RREF -> register the pivot
                # rows as a device chunk; no matrix-sized D2H transfer
                from .dense.elim import dense_rref_device
                from .schur import schur_dense_block_device
                Xd, q, p_out = schur_dense_block_device(
                    S, rows, p_in, self.U.qinv, self.elim)
                Rd, pivcols = dense_rref_device(Xd, self.prime)
                rr = len(pivcols)
                if rr:
                    self.elim.append_device_chunk(Rd, q, pivcols)
                    self.U.add_dense_rows_device(Rd, q, q[pivcols])
            processed += Sn
            log.info("[dense] block of %d rows: %d new pivots", Sn, rr)
            if checkpoint_cb is not None:
                checkpoint_cb(processed)
            rank_ub = min(S.n - self.U.n, self.m - self.U.n)
            if opts.enable_tall_and_skinny and rr < opts.low_rank_ratio * Sn:
                lowrank_mode = True
                break
        if lowrank_mode and n - processed > 0:
            log.info("[dense] too few pivots; switching to low-rank mode")
            self.finish_dense_lowrank(S, p[processed:], n - processed)
        else:
            log.info("[dense] done in %.1fs, %d new pivots",
                     time.time() - t0, self.U.n - old_un)

    # -- device-resident finisher ------------------------------------------

    def _completion_device(self, dcsr, cand_rows: np.ndarray,
                           vals: np.ndarray, rb, basis) -> bool:
        """Probabilistic completion test, fully on device: random full
        combinations of the candidate rows, eliminated against the whole
        basis; complete iff every residue is zero.  One scalar crosses
        device->host.  (spasm_echelonize.c:30-51 with the combination
        formed by a device SpMV instead of a host scatter loop.)
        vals: (Sn, len(cand_rows)) balanced coefficients drawn from the
        reference PRNG (SURVEY §4 randomness discipline)."""
        Sn = vals.shape[0]
        XT = np.zeros((Sn, dcsr.n), np.int32)
        XT[:, cand_rows] = vals
        Y = dcsr.spmv(jnp.asarray(XT))          # (Sn, mp), dead col zero
        Yq = rb.eliminate_full_width(Y)         # (Sn, M) compact residue
        Yq = basis.apply(Yq)
        return not bool(np.asarray(jnp.any(Yq != 0)))

    @annotate("finish_device")
    def finish_device_dense(self, S: CSR, p: np.ndarray, n: int):
        """Device-resident dense finisher — the device replacement for
        both echelonize_dense (spasm_echelonize.c:385-463) and
        echelonize_dense_lowrank (:315-379).

        Redesign (round 4): the pivot basis is compiled ONCE into the
        reduced operator R = (U|piv)^-1 @ (U|free) on the compacted
        free-column domain (dense/reduced.py).  Every block row (actual
        candidate rows, or random sparse-weight combinations when the
        residual is tall) is then eliminated against the ENTIRE basis in
        one shot: scatter its free entries + subtract the weighted sum
        of its <= K referenced R rows — contiguous row gathers, not the
        full-width column-gather chunk scans of the round-3 design
        (which measured ~5% effective utilization).  No (B, m)
        full-width block ever forms, so the finisher's width budget is
        set by R's footprint, not by padded-block HBM.  The eliminated
        compact block then flows as before: CompactBasis elimination ->
        row-sweep RREF -> new basis chunk.  Per round, only the (B,)
        pivot-column map crosses device->host.
        """
        from .dense.elim import _size_bucket
        from .dense.reduced import ReducedBasis
        from .dense.rowrref import CompactBasis, rref_rows_device

        opts = self.opts
        m = self.m
        prime = self.prime
        t0 = time.time()
        old_un = self.U.n

        # SPASM_PROFILE_FINISH=1: per-stage wall clocks, each stage
        # drained with block_until_ready (the syncs serialize the
        # pipelined stages, so opt-in only)
        import jax
        prof = os.environ.get("SPASM_PROFILE_FINISH")
        tprof = {}

        def tick(name, value=None):
            if not prof:
                return
            if value is not None:
                jax.block_until_ready(value)
            now = time.time()
            tprof[name] = tprof.get(name, 0.0) + now - tick.last
            tick.last = now
        tick.last = time.time()

        qfree = np.nonzero(self.U.qinv < 0)[0]
        nq = qfree.size
        rb = ReducedBasis(m, prime, qfree, self.U.n)
        offs_u, cols_u, vals_u, piv_u, grp_u = self.U.flat_store()
        tick("flat_store")
        with phase("reduced_basis"):
            rb.build(offs_u, cols_u, vals_u, piv_u, grp_u)
        tick("build", rb.R)
        rb.set_entries(S.indices, S.data, S.nnz)
        M = rb.M
        q_ext = np.full(M, m, np.int64)      # slot -> global column
        q_ext[:nq] = qfree

        rank_ub = min(n, nq)
        aspect = n / max(nq, 1)
        lowrank = (opts.enable_tall_and_skinny
                   and aspect > opts.tall_and_skinny_ratio)
        # round height: the row-sweep RREF's panel matmuls cost ~2*B^2*M
        # per round, so several 4096-rounds beat few 8192-rounds (the
        # extra CompactBasis applies are linear in B and cheaper); the
        # cap is carried over untuned (ROADMAP A3)
        B = min(_size_bucket(rank_ub + 64, 64), 4096)
        # residual cleanup rounds run at a small fixed height: a full-B
        # round costs ~B^2*M in the row-sweep RREF regardless of how few
        # live rows it carries
        B_SMALL = min(1024, B)
        # sparse combination weight: the reference's coupon-collector
        # start (-log(0.01) * n / rank) capped low — shortfalls are
        # caught by the completion test + weight doubling, and a small w
        # keeps the per-row reference gather count (w * maxlen) cheap
        w = int(np.ceil(-np.log(0.01) * n / max(rank_ub, 1))) \
            if opts.low_rank_start_weight < 0 else \
            max(opts.low_rank_start_weight, 1)
        if opts.low_rank_start_weight < 0:
            w = min(w, 8)
        # combination-weight ceiling: _form_chunk's small-tier scatter
        # accumulates up to w colliding balanced entries in int32, so
        # w * (p//2) must stay below 2^31 (advisor r4 finding #1)
        w_cap = max(1, ((1 << 31) - 1) // max(prime // 2, 1))
        w = min(w, w_cap)
        # deterministic draws bound to the input matrix through the
        # reference PRNG (SURVEY §4 randomness discipline): SHA-256
        # counter mode seeded by the matrix fingerprint; seq 0 feeds the
        # combination draws, seq 1 the completion-test coefficients
        from .hashing import PRNG
        gen = PRNG(prime, self.fingerprint)
        Sn_test = int(np.ceil(128 / np.log2(prime)))
        comp_pool: dict = {}

        def _pregen():                       # overlaps device work
            g2 = PRNG(prime, self.fingerprint, seq=1)
            comp_pool["vals"] = g2.zzp_array(Sn_test * n).reshape(
                Sn_test, n)

        import threading
        comp_thread = threading.Thread(target=_pregen, daemon=True)
        comp_thread.start()

        def comp_vals(pos: np.ndarray) -> np.ndarray:
            """(Sn, len(pos)) coefficients for candidates p[pos]."""
            comp_thread.join()
            return comp_pool["vals"][:, pos]

        basis = CompactBasis(M, prime, rank_ub + 4096)
        dcsr = None
        processed = 0
        rounds = 0
        log.info("[finish/device] %s mode: %d rows x %d free cols, "
                 "block %d, basis %d", "lowrank" if lowrank else "rows",
                 n, nq, B, self.U.n)
        def make_block(nrows, rows_from):
            """Host prep + device dispatch of one eliminated block."""
            if lowrank:
                sel = p[gen.uniform_array(nrows * w, n)
                        .reshape(nrows, w)]
                coeffs = gen.zzp_array(nrows * w).reshape(
                    nrows, w).astype(np.int32)
                coeffs[:, 0] = 1
                eidx, coeff = rb.flat_rows(S.indptr, sel, coeffs)
            else:
                eidx, coeff = rb.flat_rows(
                    S.indptr, p[rows_from:rows_from + nrows])
            return rb.form_block(
                eidx, coeff, Bp=B_SMALL if nrows <= B_SMALL else B)

        prefetched = None           # (N, formed block)
        while rank_ub > 0:
            if prefetched is not None:
                N, Xq = prefetched
                prefetched = None
            else:
                if lowrank:
                    N = min(B, rank_ub + 64)
                else:
                    N = min(B, n - processed)
                    if N <= 0:
                        break
                    processed += N
                tick("host_prep")
                Xq = make_block(N, processed - N)
                tick("form", Xq)
            Xq = basis.apply(Xq)
            tick("apply", Xq)
            # nb=512 panels: the per-panel back-reduction sweeps the whole
            # (B, M) block, so fewer/larger panels cut that traffic
            # ~2x (measured 175 -> 94 ms per 4096x22528 block)
            Xq, pivd = rref_rows_device(Xq, prime, nb=512, sync=False)
            tick("rref_dispatch")
            # overlap the next block's host prep + forming with the
            # in-flight RREF: its gathers only touch R (not the basis),
            # so a block formed now is still valid next round
            if lowrank and rank_ub - N > 0:
                N2 = min(B, rank_ub - N + 64)   # full-yield assumption
                prefetched = (N2, make_block(N2, 0))
            elif not lowrank and processed < n:
                N2 = min(B, n - processed)
                prefetched = (N2, make_block(N2, processed))
                processed += N2
            tick("prefetch_host")
            pivcol = np.asarray(pivd)
            tick("rref", Xq)
            hit = np.nonzero(pivcol >= 0)[0]
            rr = hit.size
            if rr:
                # pad the new chunk to a row bucket (dead rows pivot at
                # the dead column) to bound compile variants
                Kp = _size_bucket(rr, 64)
                hit_p = np.zeros(Kp, np.int64)
                hit_p[:rr] = hit
                Rd = Xq[jnp.asarray(hit_p)]
                Rd = Rd * (jnp.arange(Kp) < rr)[:, None].astype(Rd.dtype)
                jpos = np.full(Kp, M - 1, np.int64)
                jpos[:rr] = pivcol[hit]
                basis.add(Rd, jpos)
                rank_ub -= rr
            tick("basis_add")
            rounds += 1
            log.info("[finish/device] round %d: %d rows -> %d new pivots",
                     rounds, N, rr)
            if lowrank and rank_ub > 0 and rr < 0.9 * N:
                # a weak round doubles the weight and keeps going —
                # follow-up rounds shrink to B_SMALL; the dense
                # completion test runs only once combinations stop
                # yielding almost entirely
                if rr >= 0.02 * N:
                    log.info("[finish/device] weak round; weight "
                             "%d -> %d", w, 2 * w)
                    w = min(2 * w, max(n, 1), w_cap)
                    prefetched = None    # formed with the stale weight
                    continue
                if dcsr is None:
                    from .device_csr import DeviceCSR
                    dcsr = DeviceCSR(S)
                done = self._completion_device(
                    dcsr, p[:n], comp_vals(np.arange(n)), rb, basis)
                tick("completion")
                if done:
                    break
                log.info("[finish/device] completion test failed; "
                         "weight %d -> %d", w, 2 * w)
                w = min(2 * w, max(n, 1), w_cap)
                prefetched = None        # formed with the stale weight
            elif not lowrank and rr == 0 and rank_ub > 0:
                # rows-mode early abort (the GPLU analog,
                # spasm_echelonize.c:84-95): a zero-yield block with
                # many rows left triggers the probabilistic completion
                # test over the UNCONSUMED rows (including a prefetched
                # block, whose rows are not in the basis yet)
                rem0 = processed - (prefetched[0] if prefetched else 0)
                if n - rem0 > B:
                    if dcsr is None:
                        from .device_csr import DeviceCSR
                        dcsr = DeviceCSR(S)
                    done = self._completion_device(
                        dcsr, p[rem0:n], comp_vals(np.arange(rem0, n)),
                        rb, basis)
                    tick("completion")
                    if done:
                        log.info("[finish/device] early abort: remaining "
                                 "%d rows lie in the span", n - rem0)
                        break
        # register the basis (final back-reduced versions) into U; the
        # engine's eliminator gets it too so later engine stages (host
        # finishers, schur) see the full pivot set.  jpos comes from the
        # host-side copies — no device sync on this path.
        Rall, jall = basis.export()
        real = jall < M - 1
        if np.any(real):
            jr = jall[real]
            Rr = Rall[jnp.asarray(np.nonzero(real)[0])]
            # elim registration defers to first use: the gathers, pads
            # and metadata uploads cost real wall-clock and nothing on
            # the rank path ever eliminates after the finisher
            self.elim.append_deferred(
                lambda el, V=Rr, jj=jr: el._register_device_chunk(
                    V, q_ext, jj, dead_col=True), int(jr.size))
            self.U.add_dense_rows_device(Rr, q_ext, q_ext[jr])
        tick("register")
        if prof:
            log.info("[finish/device] profile: %s",
                     {k: round(v, 4) for k, v in tprof.items()})
        log.info("[finish/device] done in %.1fs, %d new pivots",
                 time.time() - t0, self.U.n - old_un)

    @annotate("finish_gplu")
    def finish_gplu(self, S: CSR, p: np.ndarray, n: int, p_in):
        """Sparse Gilbert-Peierls finisher with leftmost pivoting and
        probabilistic early abort (echelonize_GPLU,
        spasm_echelonize.c:54-187).  Native C++ when available."""
        from . import native
        if native.HAVE_NATIVE:
            return self._finish_gplu_native(S, p, n, p_in)
        return self._finish_gplu_py(S, p, n, p_in)

    def _finish_gplu_native(self, S: CSR, p: np.ndarray, n: int, p_in,
                            chunk: int = 8192):
        from . import native
        want_L = self.L is not None
        k = 0
        t0 = time.time()
        old_un = self.U.n
        # ONE snapshot; new pivot rows append in amortized O(nnz) instead
        # of an O(nnz(U)) repack per chunk (quadratic over the run)
        Ug = _GrowingCSR(self.U.snapshot_csr())
        while k < n:
            rows = np.asarray(p[k:k + chunk], np.int64)
            row_origin = (np.asarray(p_in, np.int64)[rows]
                          if p_in is not None else rows)
            # without L we may stop once no free column remains; with L
            # every row must be processed (elimination coefficients)
            max_piv = n if want_L else min(n - k, self.m - self.U.n)
            if max_piv <= 0 and not want_L:
                break
            npiv, urows, (li, lj, lx), piv_origin = native.gplu(
                S, rows, row_origin, Ug, self.U.qinv, self.prime,
                want_L, max(max_piv, 1))
            if urows:
                goffs = np.zeros(len(urows) + 1, np.int64)
                goffs[1:] = np.cumsum([len(c) for c, _ in urows])
                gpiv = np.asarray([int(c[0]) for c, _ in urows], np.int64)
                gcols = np.concatenate([c for c, _ in urows])
                gvals = np.concatenate([v for _, v in urows])
                self.U.add_rows_bulk(gpiv, goffs,
                                     gcols.astype(np.int32),
                                     gvals.astype(np.int32))
                self.elim.append_segment(goffs, gcols, gvals, gpiv)
                for cols, vals in urows:
                    Ug.append_row(cols, vals)
            if want_L and li.size:
                self.L.add_batch(li, lj, lx)
            self.Lp.extend(int(v) for v in piv_origin)
            k += chunk
            if k < n and npiv == 0 and not want_L:
                if self.test_completion(S, p[k:], n - k):
                    log.info("[GPLU] early abort: completion test passed")
                    break
        log.info("[GPLU] done in %.1fs, %d new pivots",
                 time.time() - t0, self.U.n - old_un)

    def _finish_gplu_py(self, S: CSR, p: np.ndarray, n: int, p_in):
        opts = self.opts
        m = self.m
        r_ub = min(S.n, m)
        x = np.zeros(m, dtype=np.int64)
        F = self.field
        rows_since_piv = 0
        early_done = False
        qinv = self.U.qinv
        # ONE snapshot, then amortized-O(row nnz) appends — the repack-
        # per-row variant was quadratic over the run (round-3 weak #5)
        Ug = _GrowingCSR(self.U.snapshot_csr())
        for k in range(n):
            if self.L is None and self.U.n == r_ub:
                log.info("[GPLU] full rank reached")
                break
            if (self.L is None and not early_done and rows_since_piv > 10
                    and rows_since_piv > n / 100):
                log.info("[GPLU] testing for early abort...")
                if self.test_completion(S, p[k:], n - k):
                    break
                early_done = True
            rows_since_piv += 1
            inew = int(p[k])
            iorig = int(p_in[inew]) if p_in is not None else inew
            pattern, x = sparse_triangular_solve(Ug, S, inew, qinv, x)
            live = pattern[x[pattern] != 0]
            cand = live[qinv[live] < 0]
            if self.L is not None:
                onpiv = live[qinv[live] >= 0]
                if onpiv.size:
                    self.L.add_batch(np.full(onpiv.size, iorig, np.int64),
                                     qinv[onpiv], x[onpiv])
            if cand.size == 0:
                continue
            jpiv = int(cand.min())
            pivval = int(x[jpiv])
            if self.L is not None:
                self.L.add(iorig, self.U.n, pivval)
            self.Lp.append(iorig)
            beta = F.inverse(pivval)
            keep = np.sort(cand)
            vals = F.mul(np.int64(beta), x[keep])
            cp, vp = self.U.add_row(jpiv, keep, vals)
            self.elim.append_rows(
                [(cp.astype(np.int64), vp, jpiv)], flush=False)
            Ug.append_row(cp, vp)
            rows_since_piv = 0
            early_done = False


def echelonize(A: CSR, opts: Optional[EchelonizeOptions] = None) -> LU:
    """Compute a row echelon form of A (optionally a full PLUQ).

    Returns an LU object: U (rank x m CSR, unitary first-entry pivots),
    qinv; plus L and p when opts.L (A == L@U when opts.complete).
    (reference: spasm_echelonize, spasm_echelonize.c:473-617)
    """
    if opts is None:
        opts = EchelonizeOptions()
    else:
        opts = dataclasses.replace(opts)
    if opts.complete:
        opts.L = True
    if opts.L:
        opts.enable_tall_and_skinny = False

    n, m = A.n, A.m
    t0 = time.time()
    log.info("[echelonize] start on %d x %d, %d nnz", n, m, A.nnz)
    eng = _Engine(A, opts)
    dense_mem = (opts.device_dense_mem if opts.device_dense_mem is not None
                 else device_memory_budget())

    S = A
    p_in = None
    npiv = 0
    p = np.arange(n, dtype=np.int64)
    status = 0
    rnd = 0
    density = A.nnz / max(n * m, 1)

    # -- checkpoint/resume (extension, SURVEY.md §5.4) ---------------------
    ckfile = opts.checkpoint_file
    fp = ckpt.matrix_fingerprint(A) if ckfile else None
    resume_phase = None
    dense_processed = 0
    if ckfile:
        state = ckpt.load_checkpoint(ckfile, fp, A.prime, opts.L,
                                     opts.complete)
        if state is not None:
            ckpt.restore_engine(eng, state)
            S = ckpt.restored_S(state, A.prime)
            p_in = state.get("p_in")
            rnd = int(state["rnd"])
            density = float(state["density"])
            status = int(state["status"])
            resume_phase = int(state["phase"])
            npiv = int(state["npiv"])
            p = state["p"] if "p" in state \
                else np.arange(S.n, dtype=np.int64)
            dense_processed = int(state["processed"])
            log.info("[checkpoint] resumed from %s: phase=%d rnd=%d "
                     "rank=%d", ckfile, resume_phase, rnd, eng.U.n)

    in_finisher = resume_phase in (ckpt.PHASE_FINISH, ckpt.PHASE_DENSE)
    if not in_finisher:
        while rnd < opts.max_round:
            if S.nnz == 0:
                status = 1
                break
            log.info("[echelonize] round %d", rnd)
            npiv, p = eng.extract_structural(S, p_in)
            if eng.U.n == m and not opts.L:
                # full column rank: nothing left to eliminate (every
                # further row reduces to zero) — mk14.b6-style matrices
                # reach this straight from structural pivots
                log.info("[echelonize] full column rank from "
                         "structural pivots")
                status = 1
                break
            # device-first policy: once the free-column count fits a
            # dense device block, the remaining rank belongs on the device —
            # skip further sparse Schur rounds (each would eliminate
            # EVERY remaining row just to look for more structural
            # pivots; the device finisher touches ~rank rows instead)
            nfree = m - eng.U.n
            itemsize = jnp.dtype(storage_dtype(A.prime)).itemsize
            # the d >= 3 arithmetic tiers run int64-emulated reductions
            # whose temporaries (and compile times) grow steeply with
            # width: cap them at a quarter of the d = 2 width.  Under
            # an active mesh the reduced basis shards its width over
            # 'cols' (SP axis), so both budgets scale with the mesh.
            from .parallel.context import col_quantum
            kcols = col_quantum()
            wcap = (opts.device_dense_width if itemsize == 2
                    else opts.device_dense_width // 4) * kcols
            basis_bytes = (eng.U.n + min(S.n - npiv, nfree)) \
                * nfree * itemsize // max(kcols, 1)
            if (not opts.L and opts.enable_dense
                    and 0 < nfree <= wcap
                    and (S.n - npiv) * nfree >= opts.device_dense_min
                    and basis_bytes <= dense_mem):
                log.info("[echelonize] %d free columns fit the device "
                         "finisher; skipping sparse rounds", nfree)
                status = 3
                break
            if npiv < opts.min_pivot_proportion * min(S.n, m - eng.U.n):
                log.info("[echelonize] not enough pivots found; stopping")
                status = 2
                break
            U_csr = eng.U.snapshot_csr()
            with phase("density_estimate"):
                # fresh sample rows every round (the reference samples
                # through its PRNG, spasm_schur.c:24)
                density = estimate_density(S, p[npiv:], S.n - npiv, U_csr,
                                           eng.U.qinv, 100, seed=1 + rnd)
            if density > opts.sparsity_threshold:
                log.info("[echelonize] Schur complement is dense (%.2f%%)",
                         100 * density)
                status = 2
                break
            fact_view = LU(eng.U.n, U_csr, eng.U.qinv)
            nrows_s = S.n - npiv
            use_rb_schur = (
                eng.L is None and nfree > 0
                and eng.U.n * nfree * itemsize
                <= dense_mem // 2
                and nrows_s * m >= (1 << 21))
            with phase("schur_sparse"):
                if use_rb_schur:
                    S2, p_out = eng.schur_sparse_reduced(
                        S, p[npiv:], nrows_s, p_in)
                else:
                    S2, p_out = schur_sparse(S, p[npiv:], nrows_s,
                                             fact_view, density, eng.L,
                                             p_in, eliminator=eng.elim)
            S = S2
            p_in = p_out
            npiv = 0
            p = np.arange(S.n, dtype=np.int64)
            rnd += 1
            if ckfile:
                ckpt.save_checkpoint(ckfile, fingerprint=fp, engine=eng,
                                     S=S, p_in=p_in, rnd=rnd,
                                     phase=ckpt.PHASE_ROUND,
                                     density=density)

        if status == 0:
            npiv = 0
            p = np.arange(S.n, dtype=np.int64)

    if status != 1:
        nrem = S.n - npiv
        if ckfile and not in_finisher:
            ckpt.save_checkpoint(ckfile, fingerprint=fp, engine=eng, S=S,
                                 p_in=p_in, rnd=rnd,
                                 phase=ckpt.PHASE_FINISH, p=p, npiv=npiv,
                                 density=density, status=status)

        # snapshotting repacks U + S (O(nnz)); per-block that can dominate
        # the finisher, so throttle to one save per interval (the last
        # finished block is re-done on resume — bounded, not quadratic)
        last_save = [time.time()]

        def dense_cb(processed):
            if time.time() - last_save[0] < opts.checkpoint_interval_s:
                return
            ckpt.save_checkpoint(ckfile, fingerprint=fp, engine=eng, S=S,
                                 p_in=p_in, rnd=rnd,
                                 phase=ckpt.PHASE_DENSE, p=p, npiv=npiv,
                                 density=density, status=status,
                                 processed=processed)
            last_save[0] = time.time()

        cb = dense_cb if ckfile else None
        aspect = nrem / max(m - eng.U.n, 1)
        log.info("[echelonize] finishing; density=%.3f aspect=%.1f",
                 density, aspect)
        nfree = m - eng.U.n
        itemsize = jnp.dtype(storage_dtype(A.prime)).itemsize
        from .parallel.context import col_quantum
        kcols = col_quantum()
        wcap = (opts.device_dense_width if itemsize == 2
                else opts.device_dense_width // 4) * kcols
        use_device_finish = (
            status == 3
            or (not opts.L and opts.enable_dense
                and 0 < nfree <= wcap
                and nrem * nfree >= opts.device_dense_min
                and (eng.U.n + min(nrem, nfree)) * nfree * itemsize
                // max(kcols, 1) <= dense_mem
                and (density > opts.sparsity_threshold
                     or (opts.enable_tall_and_skinny
                         and aspect > opts.tall_and_skinny_ratio))))
        if resume_phase == ckpt.PHASE_DENSE:
            # re-enter the blocked dense finisher where it left off
            eng.finish_dense(S, p[npiv:], nrem, p_in, checkpoint_cb=cb,
                             processed=dense_processed)
        elif use_device_finish:
            eng.finish_device_dense(S, p[npiv:], nrem)
        elif (opts.enable_tall_and_skinny
                and aspect > opts.tall_and_skinny_ratio):
            eng.finish_dense_lowrank(S, p[npiv:], nrem)
        elif opts.enable_dense and density > opts.sparsity_threshold:
            eng.finish_dense(S, p[npiv:], nrem, p_in, checkpoint_cb=cb)
        elif opts.enable_GPLU:
            eng.finish_gplu(S, p[npiv:], nrem, p_in)
        else:
            log.info("[echelonize] no finisher enabled; "
                     "incomplete echelonization returned")

    if ckfile:
        if os.path.exists(ckfile):
            os.unlink(ckfile)

    # U materializes lazily: rank-only consumers (tools/rank) never pay
    # the matrix-sized device->host transfer of the basis
    r = eng.U.n
    fact = LU(r, None, eng.U.qinv.copy(), u_thunk=eng.U.snapshot_csr)
    if opts.L:
        # L materializes lazily too: complete-PLUQ factors can be
        # gigabytes, and device-resident consumers never pay the
        # device->host transfer
        fact._l_thunk = lambda: eng.L.build(n, r)
        fact.p = np.asarray(eng.Lp[:r], dtype=np.int64)
        fact.complete = opts.complete
    nnz = eng.U.nnz()
    log.info("[echelonize] done in %.1fs; rank %d%s",
             time.time() - t0, r,
             ", %d nz in basis" % nnz if nnz >= 0 else "")
    return fact
