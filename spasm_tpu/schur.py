"""Schur complement formation (sparse and dense) and density estimation.

Functional equivalents of /root/reference/src/spasm_schur.c, re-architected
for an accelerator: rows are processed in dense *blocks* eliminated against U by
the chunked device eliminator (spasm_tpu.dense.block.UEliminator) instead
of per-row DFS triangular solves under OpenMP.  Row commit order is the
input order — deterministic by construction, unlike the reference's
first-come `omp critical` ordering (spasm_schur.c:114-149).

A scalar (per-row, host) path is kept for very sparse residues and as the
reference oracle in tests.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .csr import CSR
from .triangular import sparse_triangular_solve
from .hashing import PRNG
from .spmv import scatter


def solve_rows(U: CSR, B: CSR, rows, qinv: np.ndarray, prime: int):
    """Batch of x*U = B[row] solves -> [(cols, vals)] (column-sorted,
    coefficients on pivotal columns, residue elsewhere).  Native C++
    (parallel) when available, scalar Python otherwise."""
    from . import native
    rows = np.asarray(rows, np.int64)
    if native.HAVE_NATIVE and len(rows):
        return native.solve_batch(U, B, rows, np.asarray(qinv, np.int64),
                                  prime)
    out = []
    x = np.zeros(U.m, dtype=np.int64)
    for r in rows:
        pattern, x = sparse_triangular_solve(U, B, int(r), qinv, x)
        live = np.sort(pattern[x[pattern] != 0])
        out.append((live.astype(np.int32), x[live].astype(np.int32)))
    return out


def estimate_density(A: CSR, p: np.ndarray, n: int, U: CSR,
                     qinv: np.ndarray, R: int = 100,
                     seed: int = 1) -> float:
    """Sample R random non-pivotal rows through the triangular solver and
    average the residue density (spasm_schur.c:11-44).  Rows are drawn
    from the deterministic SHA-256 PRNG (SURVEY §4 randomness anchor),
    so estimates are reproducible run-to-run and across machines."""
    if n == 0 or A.m == U.n:
        return 0.0
    gen = PRNG.from_u64(A.prime, seed, 0xDE)
    sample = p[gen.uniform_array(R, n)]
    nnz = 0
    for cols, _ in solve_rows(U, A, sample, qinv, A.prime):
        nnz += int(np.count_nonzero(qinv[cols] < 0))
    return nnz / (A.m - U.n) / R


def _block_rows_dense(A: CSR, rows: np.ndarray) -> np.ndarray:
    """Densify the given rows of A into a (len(rows), m) int32 block."""
    X = np.zeros((len(rows), A.m), dtype=np.int32)
    for k, i in enumerate(rows):
        cols, vals = A.row(int(i))
        X[k, cols] = vals
    return X


def _block_rows_device(A: CSR, rows: np.ndarray, Bp: int, mp: int):
    """Densify the given rows of A directly ON DEVICE: only the sparse
    entries (nnz of the block, not B*m dense words) cross host->device,
    then one scatter materializes the padded (Bp, mp) block."""
    import jax.numpy as jnp
    from .csr import _concat_ranges
    rows = np.asarray(rows, np.int64)
    starts = A.indptr[rows]
    lens = (A.indptr[rows + 1] - starts).astype(np.int64)
    gather = _concat_ranges(starts, lens)
    cols = A.indices[gather].astype(np.int64)
    vals = A.data[gather].astype(np.int32)
    rowrep = np.repeat(np.arange(len(rows), dtype=np.int64), lens)
    Xd = jnp.zeros((Bp, mp), jnp.int32)
    if cols.size:
        Xd = Xd.at[jnp.asarray(rowrep), jnp.asarray(cols)].set(
            jnp.asarray(vals))
    from .parallel.context import shard_rows
    return shard_rows(Xd)


_DEVICE_THRESHOLD = 1 << 21    # rows*m below this: scalar host path wins


def _jit_live_count():
    import jax
    import jax.numpy as jnp

    @jax.jit
    def _live_count(Xd, nrows, m):
        live = Xd != 0
        live = live & (jnp.arange(Xd.shape[0]) < nrows)[:, None]
        live = live & (jnp.arange(Xd.shape[1]) < m)[None, :]
        return live, jnp.sum(live)

    import functools

    @functools.partial(jax.jit, static_argnames=("cap",))
    def _pack(Xd, live, cap: int):
        r, c = jnp.nonzero(live, size=cap, fill_value=0)
        return r.astype(jnp.int32), c.astype(jnp.int32), Xd[r, c]

    return _live_count, _pack


_PACK_FNS = None


def _pack_nonzero_dispatch(Xd, nrows: int, m: int):
    """Async half of _pack_nonzero_device: dispatch the live-entry
    count; no device sync happens until the matching _finish.  Lets a
    caller overlap the NEXT block's device work with this block's
    devicehost drain (SURVEY §2.4 PP)."""
    global _PACK_FNS
    if _PACK_FNS is None:
        _PACK_FNS = _jit_live_count()
    _live_count, _pack = _PACK_FNS
    live, cnt = _live_count(Xd, nrows, m)
    return (Xd, live, cnt)


def _pack_nonzero_finish(state):
    """Sync half: count scalar crosses device->host, then the packed
    entries (capacity-bucketed so compile variants stay bounded)."""
    Xd, live, cnt = state
    _live_count, _pack = _PACK_FNS
    cnt = int(cnt)
    if cnt == 0:
        e = np.empty(0, np.int32)
        return e, e, e
    cap = 256
    while cap < cnt:
        cap <<= 1
    r, c, v = _pack(Xd, live, cap)
    return (np.asarray(r)[:cnt], np.asarray(c)[:cnt],
            np.asarray(v)[:cnt].astype(np.int32))


def _pack_nonzero_device(Xd, nrows: int, m: int):
    """Pack the nonzero entries of Xd[:nrows, :m] into flat (rows, cols,
    vals) numpy arrays, row-major sorted.  The dense block never crosses
    device->host — only one count scalar and the packed entries."""
    return _pack_nonzero_finish(_pack_nonzero_dispatch(Xd, nrows, m))


def schur_sparse(A: CSR, p: np.ndarray, n: int, fact, est_density: float,
                 L, p_in: Optional[np.ndarray],
                 eliminator=None, block_size: int = 2048,
                 use_device="auto") -> Tuple[CSR, np.ndarray]:
    """Schur complement of rows p[0:n] of A w.r.t. the pivots in fact.U.

    Returns (S, p_out): S has A.m columns with entries only on non-pivotal
    columns; row k of S corresponds to original row p_out[k].
    Elimination coefficients are appended to the L builder when present.
    (reference: spasm_schur, spasm_schur.c:61-193)

    Device path (any width): rows densify ON DEVICE from a one-time
    upload of A's entries, eliminate against the chunked basis, and come
    back as packed nonzeros (bulk, no per-row work on either side).
    """
    qinv = fact.qinv
    U = fact.U
    m = A.m
    rows_out: List[tuple] = []
    p_out = np.empty(n, dtype=np.int64)

    if use_device == "auto":
        use_device = n * m >= _DEVICE_THRESHOLD
    if use_device and eliminator is not None and eliminator.nrows > 0:
        from .dense.elim import _size_bucket
        from .device_csr import DeviceCSR
        # block height bounded by an element budget on the padded block
        mp = _size_bucket(m + 1, 64)
        bs = block_size
        while bs > 256 and bs * mp > (256 << 20):
            bs //= 2
        dcsr = DeviceCSR(A, mp=mp)
        piv_mask = qinv >= 0
        tri_r: List[np.ndarray] = []       # flat triplets of S
        tri_c: List[np.ndarray] = []
        tri_v: List[np.ndarray] = []
        counts = np.zeros(n, np.int64)
        for b0 in range(0, n, bs):
            idx = p[b0:b0 + bs].astype(np.int64)
            Xd = dcsr.densify(idx, Bp=_size_bucket(len(idx), 8))
            Xd = eliminator.eliminate_device(Xd)
            r, c, v = _pack_nonzero_device(Xd, len(idx), m)
            piv = piv_mask[c]
            iorigs = (np.asarray(p_in, np.int64)[idx]
                      if p_in is not None else idx)
            p_out[b0:b0 + len(idx)] = iorigs
            rs = r[~piv]
            np.add.at(counts, b0 + rs.astype(np.int64), 1)
            tri_r.append(b0 + rs.astype(np.int64))
            tri_c.append(c[~piv])
            tri_v.append(v[~piv])
            if L is not None and np.any(piv):
                L.add_batch(iorigs[r[piv].astype(np.int64)],
                            qinv[c[piv]], v[piv])
        # assemble S directly from row-major-sorted triplets
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        S = CSR(n, m, A.field, indptr,
                np.concatenate(tri_c) if tri_c else np.empty(0, np.int32),
                np.concatenate(tri_v) if tri_v else np.empty(0, np.int32))
        return S, p_out
    else:
        solved = solve_rows(U, A, p[:n], qinv, A.prime)
        for k, (cols, vals) in enumerate(solved):
            inew = int(p[k])
            iorig = int(p_in[inew]) if p_in is not None else inew
            p_out[k] = iorig
            piv = qinv[cols] >= 0
            rows_out.append((cols[~piv], vals[~piv]))
            if L is not None and np.any(piv):
                L.add_batch(np.full(int(piv.sum()), iorig, np.int64),
                            qinv[cols[piv]], vals[piv])

    S = CSR.from_rows(n, m, A.prime, rows_out)
    return S, p_out


def schur_dense_block(A: CSR, rows: np.ndarray, p_in: Optional[np.ndarray],
                      qinv: np.ndarray, eliminator,
                      L=None, U_csr: Optional[CSR] = None
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense Schur complement of the given rows w.r.t. U (device path).

    Returns (S, q, p_out): S is (len(rows), Sm) dense on the non-pivotal
    columns listed in q; p_out maps block rows to original row ids.
    Elimination coefficients go to the L builder (all rows — the caller
    filters non-pivotal rows when complete=False, mirroring
    update_fact_after_LU, spasm_echelonize.c:249-271).
    (reference: spasm_schur_dense, spasm_schur.c:257-333)
    """
    m = A.m
    q = np.nonzero(qinv < 0)[0]
    has_pivots = bool(np.any(qinv >= 0))
    if has_pivots and eliminator is not None and eliminator.nrows > 0 \
            and (U_csr is None or len(rows) * m >= _DEVICE_THRESHOLD):
        X = _block_rows_dense(A, rows)
        X = eliminator.eliminate(X)
    elif has_pivots:
        if U_csr is None:
            raise ValueError("schur_dense_block requires an eliminator or "
                             "a U snapshot when U is nonempty")
        # host path: batched (parallel) sparse triangular solves
        X = np.zeros((len(rows), m), dtype=np.int32)
        for k, (cols, vals) in enumerate(
                solve_rows(U_csr, A, rows, qinv, A.prime)):
            X[k, cols] = vals
    else:
        X = _block_rows_dense(A, rows)
    p_out = np.asarray([int(p_in[i]) if p_in is not None else int(i)
                        for i in rows], dtype=np.int64)
    if L is not None:
        piv_cols = np.nonzero(qinv >= 0)[0]
        C = X[:, piv_cols]
        for k in range(len(rows)):
            nz = np.nonzero(C[k])[0]
            if nz.size:
                L.add_batch(np.full(nz.size, p_out[k], np.int64),
                            qinv[piv_cols[nz]], C[k, nz])
    return X[:, q], q, p_out


def schur_dense_block_device(A: CSR, rows: np.ndarray,
                             p_in: Optional[np.ndarray],
                             qinv: np.ndarray, eliminator,
                             want_L: bool = False):
    """Device-resident dense Schur block for the dense finishers.

    Densifies the rows on host (cheap, H2D only), eliminates against the
    device chunk basis, and *keeps the result on device*.  Returns
    (Xd, q, p_out): Xd a (len(rows), |q|) device block compacted to the
    non-pivotal columns q.

    want_L additionally returns (Cd, piv_cols): the elimination
    coefficients parked on pivotal columns, as a DEVICE block (Bp,
    cpad) over the global pivot columns piv_cols — the caller decides
    when (if ever) their nonzeros cross to host.
    """
    import jax.numpy as jnp
    from .dense.elim import _size_bucket
    q = np.nonzero(qinv < 0)[0]
    B = len(rows)
    Bp = _size_bucket(B, 8)
    mp = _size_bucket(A.m + 1, 64)
    Xd = _block_rows_device(A, rows, Bp, mp)
    if eliminator.nrows > 0:
        Xd = eliminator.eliminate_device(Xd)
    p_out = np.asarray([int(p_in[i]) if p_in is not None else int(i)
                        for i in rows], dtype=np.int64)
    if want_L:
        # the dead column mp-1 absorbs padded-slot writes during
        # elimination; clear it so bucket-padded gathers stay clean
        Xd = Xd.at[:, mp - 1].set(0)
        piv_cols = np.nonzero(qinv >= 0)[0]
        cpad = _size_bucket(piv_cols.size + 1, 64)
        csel = np.full(cpad, mp - 1, np.int64)
        csel[:piv_cols.size] = piv_cols
        Cd = Xd[:, jnp.asarray(csel)]            # (Bp, cpad) coefficients
        qpad = _size_bucket(q.size + 1, 64)
        qsel = np.full(qpad, mp - 1, np.int64)
        qsel[:q.size] = q
        Xq = Xd[:B][:, jnp.asarray(qsel)]        # (B, qpad), pad cols zero
        return Xq, q, p_out, (Cd, piv_cols)
    Xd = Xd[:B][:, jnp.asarray(q)]
    return Xd, q, p_out


def schur_dense_randomized(A: CSR, p: np.ndarray, n: int, U: CSR,
                           qinv: np.ndarray, N: int, w: int,
                           eliminator=None,
                           seed_base: int = 0,
                           return_device: bool = False
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """N random linear combinations of the Schur complement rows.

    w > 0: combinations of w randomly chosen rows (first coeff 1);
    w <= 0: combinations of all n rows with PRNG coefficients.
    Returns (S, q) like schur_dense_block; with return_device=True the
    block stays resident on device (no D2H transfer).
    (reference: spasm_schur_dense_randomized, spasm_schur.c:346-413)
    """
    import jax.numpy as jnp
    m = A.m
    prime = A.prime
    q = np.nonzero(qinv < 0)[0]
    X = np.zeros((N, m), dtype=np.int64)
    F = A.field
    for k in range(N):
        gen = PRNG.from_u64(prime, k + seed_base, 0)
        y = X[k]
        if w <= 0:
            coeffs = gen.zzp_array(n)
            _combine_rows(A, p[:n], coeffs, y, F)
        else:
            # row selection and coefficients both come from the same
            # deterministic per-combination PRNG stream
            sel = gen.uniform_array(w, n)
            coeffs = np.empty(w, np.int32)
            coeffs[0] = 1
            if w > 1:
                coeffs[1:] = gen.zzp_array(w - 1)
            _combine_rows(A, p[sel], coeffs, y, F)
    Xi = F.narray(X).astype(np.int32)
    if eliminator is not None and eliminator.nrows > 0 \
            and (return_device or N * m >= _DEVICE_THRESHOLD):
        Xd = eliminator.eliminate_device(eliminator.pad_block(Xi))
        if return_device:
            return Xd[:N][:, jnp.asarray(q)], q
        Xi = np.asarray(Xd)[:N, :m]
    elif U.n:
        from . import native
        if native.HAVE_NATIVE:
            B = CSR.from_dense(Xi, prime)
            out = np.zeros_like(Xi)
            for k, (cols, vals) in enumerate(
                    solve_rows(U, B, np.arange(N), qinv, prime)):
                out[k, cols] = vals
            Xi = out
        else:
            Xi = _eliminate_scalar(Xi, U, qinv)
    if return_device:
        return jnp.asarray(Xi[:, q]), q
    return Xi[:, q], q


def _combine_rows(A: CSR, rows, coeffs, y: np.ndarray, F):
    """y += sum coeffs[k] * A[rows[k]] (int64 accumulator, term-reduced)."""
    for c, i in zip(coeffs, rows):
        cols, vals = A.row(int(i))
        if cols.size == 0 or c == 0:
            continue
        y[cols] = F.narray(y[cols] + np.int64(c) * vals.astype(np.int64))


def _eliminate_scalar(X: np.ndarray, U: CSR, qinv: np.ndarray) -> np.ndarray:
    """Host fallback: eliminate dense rows against U pivots in order."""
    F = U.field
    # pivot column of U row i
    upiv = np.full(U.n, -1, np.int64)
    cols_of = np.nonzero(qinv >= 0)[0]
    upiv[qinv[cols_of]] = cols_of
    X = X.astype(np.int64)
    for i in range(U.n):
        j = upiv[i]
        coeff = X[:, j].copy()
        live = np.nonzero(coeff)[0]
        if live.size == 0:
            continue
        cols, vals = U.row(i)
        X[np.ix_(live, cols)] = F.narray(
            X[np.ix_(live, cols)]
            - coeff[live, None] * vals.astype(np.int64)[None, :])
        X[live, j] = coeff[live]
    return F.narray(X).astype(np.int32)
