"""Batched elimination of dense row blocks against a sparse pivot basis U.

This is the device replacement for the reference's per-row sparse
triangular solves (spasm_sparse_triangular_solve called row-by-row under
OpenMP, /root/reference/src/spasm_schur.c:86-193): instead of a DFS and a
scalar scatter chain per row, a whole *block* X of B dense rows is
eliminated against U with exact int8-digit matmuls.

Key ideas:
  * U's rows, in the order the engine created them, already form a valid
    sequential elimination order (within a pivot round they are
    topologically sorted; later rounds never touch earlier pivot columns).
  * consecutive U rows are grouped into *chunks*.  The effect of a chunk
    on X is composed exactly:
        alpha = X[:, J] @ (I + W)^-1        (B x K coefficients)
        X     = X - alpha @ U_chunk         (mod p)
    where J are the chunk's pivot columns and W[l, k] = U[l, j_k]
    (strictly upper, the intra-chunk corrections).  V = (I+W)^-1 @ U_chunk
    is precomputed once per chunk and reused for every block.
  * chunks are column-compacted: U_chunk is densified only on the union
    support C of its rows, so memory tracks nnz(U_chunk), not m.
  * after the update, alpha is written back into X[:, J], matching the
    convention of the scalar solver (coefficients on pivotal columns,
    Schur residue on the rest).
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .modp import device_field, dnorm, dnorm64, matmul_digits, mulmod

_DEFAULT_CHUNK = 1024
_DENSE_BUDGET = 32 << 20      # max int32 elements per densified chunk
                              # (carried over untuned; ROADMAP A3)


class _Run(NamedTuple):
    """A stack of same-shape composed chunks, applied in order.

    Keeping chunks pre-stacked on device means eliminate() issues ONE
    scan dispatch per run instead of re-stacking host-side every call.

    winv: for a chunk whose rows interact, V = (I+W)^-1 @ U — parking
    the raw coefficient gather F would record coefficients against the
    COMPOSED rows; the true per-U-row coefficients are F @ winv.  None
    for composition-free chunks (winv == I there).
    """
    cols: jnp.ndarray       # (g, Cp) global column ids (padded -> m)
    jpos: jnp.ndarray       # (g, Kp) pivot-column positions inside cols
    V: jnp.ndarray          # (g, Kp, Cp) composed elimination rows
    k: int                  # total real pivot rows across the run
    winv: Optional[jnp.ndarray] = None   # (Kp, Kp), single-chunk runs


def _unit_upper_inverse_log(W, p, weights, d: int):
    """(I + W)^-1 for strictly upper-triangular W mod p, by log-squaring.

    W nilpotent (W^K = 0), so (I+W)^-1 = sum_i (-W)^i; the partial sums
    satisfy S_{2j} = S_j (I + (-W)^j), giving ceil(log2 K) rounds of two
    matmuls instead of a K-step sequential loop, whose per-step latency
    would dominate chunk composition.
    """
    k = W.shape[0]
    eye = jnp.eye(k, dtype=jnp.int32)
    N = dnorm(-W.astype(jnp.int64), p)
    S = dnorm(eye.astype(jnp.int64) + N.astype(jnp.int64), p)
    P = matmul_digits(N, N, p, weights, d)
    rounds = max(int(np.ceil(np.log2(max(k, 2)))), 1)
    for _ in range(rounds):
        S = dnorm(S.astype(jnp.int64)
                  + matmul_digits(S, P, p, weights, d).astype(jnp.int64), p)
        P = matmul_digits(P, P, p, weights, d)
    return S


@functools.partial(jax.jit, static_argnames=("kp", "cp", "as_i8"))
def _scatter_chunk_entries(rowrep, posidx, vals, kp: int, cp: int,
                           as_i8: bool = False):
    """Densify one chunk's sparse entries into a (kp, cp) block ON
    DEVICE.  Only the nnz of the chunk crosses host->device, not the
    kp*cp dense block.  Padded entries carry value 0 at a dead slot
    (scatter-add is inert).

    as_i8 (host asserts every value fits int8, e.g. the +-1 entries of
    boundary-map matrices): the chunk is stored as a single base-256
    digit, which halves the int8 dots and quarters the V traffic of
    every subsequent application (matmul_digits_i8B)."""
    Ud = jnp.zeros((kp, cp), jnp.int32)
    Ud = Ud.at[rowrep, posidx].add(vals)
    return Ud.astype(jnp.int8) if as_i8 else Ud


@functools.partial(jax.jit, static_argnames=("d", "kp", "cp"))
def _compose_chunk_entries(rowrep, posidx, vals, jpos, p, weights,
                           d: int, kp: int, cp: int):
    """Chunk composition V = (I + W)^-1 @ U for a chunk whose rows
    interact (a later row's pivot column appears in an earlier row's
    support).  W is gathered on device: W[l, t] = Ud[l, jpos[t]]
    strictly above the diagonal (pivots are unit by convention).

    Chunks whose rows are mutually independent (the common case after
    level-major pivot ordering, pivots.py:row_levels) skip this and use
    _scatter_chunk_entries directly — W == 0 there, so V == Ud.
    """
    Ud = _scatter_chunk_entries(rowrep, posidx, vals, kp, cp)
    W = Ud[:, jpos]                                   # (kp, kp)
    tri = jnp.triu(jnp.ones((kp, kp), bool), 1)
    W = jnp.where(tri, W, 0)
    Winv = _unit_upper_inverse_log(W, p, weights, d)
    return matmul_digits(Winv, Ud, p, weights, d), Winv


from .elim import _submod


@functools.partial(jax.jit, static_argnames=("d", "park", "has_winv"),
                   donate_argnums=(0,))
def _apply_chunk(X, cols, jpos, V, winv, p, weights, d: int,
                 park: bool = True, has_winv: bool = False):
    """One chunk update on a dense block X (B, m).  X is donated —
    full-width blocks are hundreds of MB and the caller never reuses the
    input (async dispatch would otherwise stack one fresh output per
    queued chunk application).

    park=True writes the elimination coefficients back onto the pivot
    columns (the scalar-solver convention, needed for L / sparse Schur);
    park=False leaves them zero (V's pivot columns are an embedded
    identity, so the update itself clears them) — the finisher path.
    For composed chunks (has_winv) the per-U-row coefficients are
    F @ winv, not the raw gather F.
    """
    Xc = X[:, cols]                                   # (B, |C|)
    F = Xc[:, jpos]                                   # (B, K) current coeffs
    delta = matmul_digits(F.astype(jnp.int32), V, p, weights, d)
    Xc = _submod(Xc, delta, p, d == 2).astype(X.dtype)
    if park:
        if has_winv:
            Fp = matmul_digits(F.astype(jnp.int32), winv, p, weights,
                               d).astype(X.dtype)
        else:
            Fp = F
        Xc = Xc.at[:, jpos].set(Fp)  # park coefficients on pivot columns
    return X.at[:, cols].set(Xc)


@functools.partial(jax.jit, static_argnames=("d", "park", "skip_empty"),
                   donate_argnums=(0,))
def _apply_chunk_run(X, cols, jpos, V, p, weights, d: int,
                     park: bool = True, skip_empty: bool = True):
    """Apply a run of same-bucket chunks sequentially in ONE dispatch.
    X is donated: callers never reuse the input block, and aliasing
    halves the scan's HBM footprint for full-width blocks.

    cols: (nc, Cp), jpos: (nc, Kp), V: (nc, Kp, Cp).  With skip_empty a
    chunk whose coefficient block is all zero is skipped (lax.cond),
    which makes re-elimination against already-cleared history chunks
    nearly free; the finisher passes skip_empty=False (its blocks are
    never empty and the reduction + branch cost real time per chunk).
    """
    def body(X, ch):
        c, j, v = ch
        Xc = X[:, c]
        F = Xc[:, j]

        def live(X):
            delta = matmul_digits(F.astype(jnp.int32), v, p, weights, d)
            Xc2 = _submod(Xc, delta, p, d == 2).astype(X.dtype)
            if park:
                Xc2 = Xc2.at[:, j].set(F)
            return X.at[:, c].set(Xc2)

        if skip_empty:
            X = jax.lax.cond(jnp.any(F != 0), live, lambda X: X, X)
        else:
            X = live(X)
        return X, None

    X, _ = jax.lax.scan(body, X, (cols, jpos, V))
    return X


def _bucket(k: int) -> int:
    """Round up to a power of two (min 32) to bound jit variants."""
    b = 32
    while b < k:
        b <<= 1
    return b


class UEliminator:
    """Incrementally built chunked eliminator for a growing pivot basis U.

    append_rows() registers new U rows (in engine order); eliminate()
    applies the full composed elimination to a dense block.
    """

    def __init__(self, m: int, p: int, chunk: int = _DEFAULT_CHUNK):
        self.m = m
        self.p = p
        self.F = device_field(p)
        self.chunk = chunk
        self.runs: List[_Run] = []
        self._dispatch: Optional[List[_Run]] = None
        self._dispatch_src = 0
        # staged items not yet composed into chunks, in INSERTION
        # order (advisor r4 #3: segments and deferred registrations
        # must replay in the order they arrived, or a deferred chunk
        # queued before later row segments would register after them):
        # ("seg", (offs, cols, vals, pivcols, levels|None)) or
        # ("def", thunk, k).  Expansion happens only when an
        # elimination actually needs the chunk basis (paths that never
        # eliminate, e.g. the reduced-basis finisher, pay nothing).
        self._staged: List[tuple] = []

    @property
    def _segments(self):
        return [it[1] for it in self._staged if it[0] == "seg"]

    @property
    def nrows(self) -> int:
        return sum(r.k for r in self.runs) \
            + sum(len(it[1][3]) if it[0] == "seg" else it[2]
                  for it in self._staged)

    def append_segment(self, offs, cols, vals, pivcols, levels=None):
        """Stage a flat bulk of pivot-first rows (value 1 at pivcols[k]);
        `levels` as in append_rows."""
        if len(pivcols) == 0:
            return
        self._staged.append(("seg", (np.asarray(offs, np.int64),
                                     np.asarray(cols, np.int64),
                                     np.asarray(vals, np.int32),
                                     np.asarray(pivcols, np.int64),
                                     None if levels is None
                                     else np.asarray(levels, np.int64))))

    def append_rows(self, rows, flush: bool = True, levels=None):
        """rows: iterable of (cols int64[], vals int32[], pivcol).

        Each row must have value 1 at its pivot column.  `levels`
        (optional, one int per row): topological levels — rows of equal
        level never contain each other's pivot columns, letting flush
        build wide composition-free chunks (pivots.py:row_levels).
        """
        rows = list(rows)
        if not rows:
            return
        offs = np.zeros(len(rows) + 1, np.int64)
        offs[1:] = np.cumsum([len(c) for c, _, _ in rows])
        self.append_segment(
            offs, np.concatenate([c for c, _, _ in rows]),
            np.concatenate([v for _, v, _ in rows]),
            np.asarray([pc for _, _, pc in rows], np.int64), levels)
        if flush:
            self.flush()

    def append_deferred(self, thunk, k: int) -> None:
        """Stage a registration thunk for k pivot rows (e.g. a device
        chunk the finisher produced); it runs at the next flush, so
        paths that never eliminate again (rank-only) never pay for its
        gathers/pads/uploads."""
        self._staged.append(("def", thunk, k))

    @staticmethod
    def _expand_segments(segs):
        """Expand staged segments to per-row tuples (flush-time only)."""
        out = []
        for offs, cols, vals, pivcols, levels in segs:
            for k in range(len(pivcols)):
                sl = slice(offs[k], offs[k + 1])
                out.append((cols[sl], vals[sl], int(pivcols[k]),
                            -1 if levels is None else int(levels[k])))
        return out

    # level-aligned chunks can grow to this many rows (one scan step
    # each); level-unknown or interacting chunks stay at self.chunk so
    # the (I+W)^-1 composition stays cheap
    _WIDE_CHUNK = 4096

    def flush(self):
        staged, self._staged = self._staged, []
        run: List[tuple] = []
        for it in staged:                 # replay in insertion order
            if it[0] == "seg":
                run.append(it[1])
            else:
                if run:
                    self._flush_segments(self._expand_segments(run))
                    run = []
                it[1](self)
        if run:
            self._flush_segments(self._expand_segments(run))

    def _flush_segments(self, stage):
        # partition the stage into chunks: aligned to level boundaries
        # (same-level rows -> no composition, so the wider the better),
        # respecting the dense budget
        batches = []
        i = 0
        while i < len(stage):
            lv = stage[i][3]
            take = 1
            limit = min(len(stage) - i,
                        self._WIDE_CHUNK if lv >= 0 else self.chunk)
            while take < limit and stage[i + take][3] == lv \
                    and (lv >= 0 or take < self.chunk):
                take += 1
            if lv >= 0 and take < self.chunk:
                # short level run: merge consecutive short runs into one
                # (composed) chunk rather than paying a scan step each
                while take < min(len(stage) - i, self.chunk):
                    take += 1
            while take > 1:
                u = np.unique(np.concatenate(
                    [stage[j][0] for j in range(i, i + take)])).size
                if take * u <= _DENSE_BUDGET:
                    break
                take //= 2
            batches.append(stage[i:i + take])
            i += take
        # one scatter (+ one composition when rows interact) per chunk;
        # only sparse entries cross host->device, densification is on
        # device.  Shapes are power-of-two bucketed, so the number of
        # compiled variants is bounded and INDEPENDENT of the matrix —
        # the persistent compile cache makes them one-time-ever costs.
        p64 = jnp.int64(self.p)
        w = jnp.asarray(self.F.weights)
        pending: List[tuple] = []   # (cols (Cp,), jpos (Kp,), V, K, winv)
        for b in batches:
            rowrep, posidx, vals, jp, colsp, K, interacts = \
                self._prep_entries(b)
            kp, cp = jp.size, colsp.size
            if interacts and K > 1:
                V, Winv = _compose_chunk_entries(
                    jnp.asarray(rowrep), jnp.asarray(posidx),
                    jnp.asarray(vals), jnp.asarray(jp), p64, w,
                    self.F.ndigits, kp, cp)
            else:
                as_i8 = bool(np.abs(vals).max(initial=0) <= 127)
                V = _scatter_chunk_entries(
                    jnp.asarray(rowrep), jnp.asarray(posidx),
                    jnp.asarray(vals), kp, cp, as_i8)
                Winv = None
            pending.append((colsp, jp, V, K, Winv))
        # stack consecutive same-shape composition-free chunks into runs
        # (one scan dispatch per run in eliminate_device), bounded per
        # run so no multi-GB stacked copy ever forms; composed chunks
        # dispatch alone (they carry a winv for coefficient parking)
        j = 0
        while j < len(pending):
            if pending[j][4] is not None:
                colsp, jp, V, K, Winv = pending[j]
                self.runs.append(_Run(jnp.asarray(colsp)[None],
                                      jnp.asarray(jp)[None], V[None], K,
                                      Winv))
                j += 1
                continue
            shape = (pending[j][2].shape, pending[j][2].dtype)
            per = int(np.prod(shape[0])) * pending[j][2].dtype.itemsize
            gmax = max(self._MERGE_LIMIT // max(per, 1), 1)
            j2 = j
            while (j2 < len(pending)
                   and pending[j2][4] is None
                   and (pending[j2][2].shape,
                        pending[j2][2].dtype) == shape
                   and j2 - j < gmax):
                j2 += 1
            group = pending[j:j2]
            cols = jnp.asarray(np.stack([g[0] for g in group]))
            jpos = jnp.asarray(np.stack([g[1] for g in group]))
            V = jnp.stack([g[2] for g in group])
            self.runs.append(_Run(cols, jpos, V,
                                  sum(g[3] for g in group)))
            j = j2

    def _prep_entries(self, batch):
        """Host prep of one chunk: union support + flat sparse entries,
        padded to buckets.  Returns (rowrep (Ep,), posidx (Ep,),
        vals (Ep,), jp (Kp,), colsp (Cp,), K, interacts).
        Densification happens on device (_scatter_chunk_entries);
        `interacts` is False when no row's support contains another
        row's pivot column (W == 0 — no composition needed)."""
        K = len(batch)
        cols_cat = np.concatenate([b[0] for b in batch])
        union = np.unique(cols_cat)
        pivcols = np.asarray([b[2] for b in batch], np.int64)
        Kp = _bucket(K)
        # always leave at least one padded (dead) column so padded pivot
        # slots never clamp onto a real column
        Cp = _bucket(union.size + 1)
        lens = np.asarray([b[0].size for b in batch], np.int64)
        E = int(lens.sum())
        Ep = _bucket(E)
        rowrep = np.zeros(Ep, np.int32)
        posidx = np.full(Ep, Cp - 1, np.int32)      # dead slot for padding
        vals = np.zeros(Ep, np.int32)
        rowrep[:E] = np.repeat(np.arange(K, dtype=np.int32), lens)
        posidx[:E] = np.searchsorted(union, cols_cat).astype(np.int32)
        vals[:E] = np.concatenate([b[1] for b in batch]).astype(np.int32)
        # interaction check: each row contains its own pivot column, so
        # exactly K hits on pivot columns <=> W == 0
        interacts = int(np.isin(cols_cat, pivcols).sum()) > K
        jpos = np.searchsorted(union, pivcols)
        # padded pivot slots point at padded (zero) columns
        jp = np.full(Kp, 0, np.int64)
        jp[:K] = jpos
        if Kp > K:
            jp[K:] = union.size + np.arange(Kp - K) % (Cp - union.size)
        colsp = np.full(Cp, self.m, np.int64)     # padded cols -> dead col m
        colsp[:union.size] = union
        return rowrep, posidx, vals, jp, colsp, K, interacts

    def append_device_chunk(self, V, cols: np.ndarray, jpos: np.ndarray,
                            dead_col: bool = False):
        """Register an already-composed chunk resident on device.

        V: (K, C) int32 device array of mutually reduced rows (value 1 at
        the pivot slots — e.g. the pivot rows of a device RREF, whose
        intra-chunk corrections are zero by construction, so V needs no
        (I+W)^-1 composition).  cols: (C,) global column ids (host);
        jpos: (K,) positions of the pivot columns inside cols (host).
        No host<->device transfer of V takes place.

        dead_col=True asserts that V's trailing column(s) are already
        dead (zero, cols mapped to self.m) so no column padding is
        added — used by the device finisher whose blocks carry the dead
        column by construction.
        """
        self.flush()        # keep engine ordering: staged rows first
        self._register_device_chunk(V, cols, jpos, dead_col)

    def _register_device_chunk(self, V, cols, jpos, dead_col=False,
                               winv=None):
        """winv: for a COMPOSED device chunk (rows interact), the
        (K, K) inverse used to convert parked coefficient gathers back
        to per-U-row coefficients (see _Run.winv)."""
        K, C = V.shape
        Kp = _bucket(K)
        Cp = C if dead_col else _bucket(C + 1)   # >= 1 dead column
        if (Kp, Cp) != (K, C):
            V = jnp.pad(V, ((0, Kp - K), (0, Cp - C)))
        jp = np.full(Kp, 0, np.int64)
        jp[:K] = np.asarray(jpos, np.int64)
        if Kp > K:
            # padded pivot slots point at a dead column
            jp[K:] = Cp - 1 if dead_col else \
                C + np.arange(Kp - K) % (Cp - C)
        colsp = np.full(Cp, self.m, np.int64)
        colsp[:C] = np.asarray(cols, np.int64)
        if winv is not None and Kp != K:
            wpad = jnp.eye(Kp, dtype=jnp.int32)
            winv = wpad.at[:K, :K].set(winv.astype(jnp.int32))
        self.runs.append(_Run(jnp.asarray(colsp)[None], jnp.asarray(jp)[None],
                              V[None], K, winv))

    def pad_block(self, X: np.ndarray):
        """Host block (B, m) -> padded device array (row/col buckets;
        the extra dead column absorbs padded-slot writes).  Under an
        active mesh the block is placed row-sharded (pure DP)."""
        from .elim import _size_bucket
        from ..parallel.context import shard_rows
        B, m = X.shape
        Bp = _size_bucket(B, 8)
        mp = _size_bucket(m + 1, 64)
        Xp = np.zeros((Bp, mp), np.int32)
        Xp[:B, :m] = X
        return shard_rows(jnp.asarray(Xp))

    # above this V byte size a run is never merged/copied: it dispatches
    # as its own _apply_chunk call (one extra dispatch beats duplicating
    # a multi-hundred-MB basis chunk in HBM)
    _MERGE_LIMIT = 256 << 20

    def _dispatch_runs(self) -> List[_Run]:
        """Merge consecutive same-shape small runs and pad each merged
        run's chunk count to a power of two with dead (skipped) chunks,
        so the number of distinct _apply_chunk_run compilations stays
        bounded.  The merged list REPLACES self.runs (the originals are
        dropped — holding both doubles HBM).  Under an active mesh the
        chunk bases are placed replicated (DP: sharded rows x
        replicated U)."""
        from ..parallel.context import current_mesh, replicated
        mesh = current_mesh()
        key = (len(self.runs), sum(r.V.shape[0] for r in self.runs),
               None if mesh is None else id(mesh))
        if getattr(self, "_dispatch", None) is not None and \
                self._dispatch_src == key:
            return self._dispatch

        def vbytes(run):
            return run.V.size * run.V.dtype.itemsize

        merged: List[_Run] = []
        for run in self.runs:
            if (run.winv is None and merged
                    and merged[-1].winv is None
                    and merged[-1].V.shape[1:] == run.V.shape[1:]
                    and merged[-1].V.dtype == run.V.dtype
                    and vbytes(merged[-1]) + vbytes(run)
                    <= self._MERGE_LIMIT):
                prev = merged[-1]
                merged[-1] = _Run(
                    jnp.concatenate([prev.cols, run.cols]),
                    jnp.concatenate([prev.jpos, run.jpos]),
                    jnp.concatenate([prev.V, run.V]), prev.k + run.k)
            else:
                merged.append(run)
        out: List[_Run] = []
        for run in merged:
            g, Kp, Cp = run.V.shape
            gp = 1
            while gp < g:
                gp <<= 1
            if run.winv is None and gp > g \
                    and g * Kp * Cp * run.V.dtype.itemsize \
                    <= self._MERGE_LIMIT:
                # dead chunks: all-dead columns -> zero coefficient block
                # -> lax.cond skips them
                dcols = jnp.full((gp - g, Cp), self.m, jnp.int64)
                djpos = jnp.zeros((gp - g, Kp), jnp.int64)
                dV = jnp.zeros((gp - g, Kp, Cp), run.V.dtype)
                run = _Run(jnp.concatenate([run.cols, dcols]),
                           jnp.concatenate([run.jpos, djpos]),
                           jnp.concatenate([run.V, dV]), run.k)
            if mesh is not None:
                run = _Run(replicated(run.cols, mesh),
                           replicated(run.jpos, mesh),
                           replicated(run.V, mesh), run.k,
                           None if run.winv is None
                           else replicated(run.winv, mesh))
            out.append(run)
        # the merged runs supersede the originals run-for-run (dead
        # chunks are inert, merging preserves order), so they are safe
        # to adopt as the canonical list — this both avoids holding two
        # copies of the basis and makes future merges incremental
        self.runs = out if mesh is None else merged
        self._dispatch = out
        self._dispatch_src = (len(self.runs),
                              sum(r.V.shape[0] for r in self.runs),
                              None if mesh is None else id(mesh))
        return out

    def eliminate_device(self, Xd, park: bool = True,
                         skip_empty: bool = True):
        """Device-resident eliminate: Xd (Bp, mp) padded int32 on device;
        returns the updated device array (no host transfers).

        park=False skips writing the elimination coefficients back onto
        pivot columns (they are left zero); skip_empty=False drops the
        per-chunk emptiness cond — both for the finisher's hot path.
        """
        self.flush()
        if not self.runs:
            return Xd
        p64 = jnp.int64(self.p)
        w = jnp.asarray(self.F.weights)
        for run in self._dispatch_runs():
            if run.V.shape[0] == 1:
                winv = run.winv
                Xd = _apply_chunk(Xd, run.cols[0], run.jpos[0], run.V[0],
                                  jnp.zeros((1, 1), jnp.int32)
                                  if winv is None else winv,
                                  p64, w, self.F.ndigits, park,
                                  winv is not None)
            else:
                Xd = _apply_chunk_run(Xd, run.cols, run.jpos, run.V, p64,
                                      w, self.F.ndigits, park, skip_empty)
        return Xd

    def eliminate(self, X: np.ndarray) -> np.ndarray:
        """Eliminate dense block X (B, m) against all registered U rows.

        Returns X with elimination coefficients on pivotal columns and the
        Schur residue elsewhere (same convention as the scalar
        sparse_triangular_solve).
        """
        self.flush()
        if not self.runs:
            return X
        B = X.shape[0]
        Xd = self.eliminate_device(self.pad_block(X))
        return np.asarray(Xd)[:B, :self.m]
