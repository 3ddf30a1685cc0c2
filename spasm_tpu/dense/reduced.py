"""Reduced pivot basis: one-matmul-free elimination in the compacted
free-column domain.

The engine's pivot basis U is unit *upper* triangular on its pivot
columns (topological pivot order; a row never contains an earlier
pivot's column).  Eliminating a row x against the whole basis therefore
has a closed form on the free (non-pivotal) columns:

    x_out|free = x|free - x|piv @ R,      R := (U|piv)^-1 @ (U|free)

where x|piv are x's ORIGINAL values on the pivot columns — no sequential
chunk-by-chunk elimination is needed once R is known.  R is the "fully
reduced" basis restricted to the free columns.

This module builds R entirely on device and then forms eliminated row
blocks (actual rows, or random sparse-weight combinations) directly in
the compacted domain: each block row gathers its ≤K referenced R rows
(contiguous row reads — HBM-friendly, unlike the full-width column
gathers of the chunked eliminator) and subtracts one exact weighted sum.
No (B, m) full-width intermediate ever exists, which removes both the
finisher's HBM ceiling on the free-column width and its dominant cost
(measured ~5% effective utilization in round 3).

Phase A (build): R[k] = U[k]|free - sum_{j in refs(k)} U[k, pivcol_j] R[j]
with refs(k) the entries of U row k on *later* pivots' columns — a
backward substitution swept level-by-level (rows of one topological
level never reference each other), batched into lax.scan groups of
equal padded chunk shape.

Phase B (use): for a block of rows given as flat sparse entries
(eidx into A's entry arrays + a coefficient per slot),
    X = scatter(free entries) - sum_slots v_slot * R[ref_slot]
computed chunk-wise with the gather + weighted-sum fused by XLA.

Capability reference: this replaces the full-width block elimination the
reference performs inside spasm_schur_dense / spasm_schur_dense_randomized
(/root/reference/src/spasm_schur.c:257-413) for the dense finishers
(/root/reference/src/spasm_echelonize.c:315-463).
"""
from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .modp import (device_field, dnorm, dnorm64, matmul_digits, _digits,
                   _reduce31, storage_dtype)
from .elim import _submod, _size_bucket


def _ref_combine(V, G, p, weights, d: int, small_acc: bool = False):
    """Exact sum_k V[:, k] * G[:, k, :] mod p, balanced int32 out.

    V (S, K) int32 balanced, G (S, K, M) balanced (int16/int32).
    Computed as batched int8 digit contractions
    (dot_general, batch dim S, contraction K): per-anti-diagonal
    partial sums are exact in int32 for K * 128^2 < 2^31, recombined
    with weighted Barrett passes exactly like matmul_digits.  An int64
    elementwise formulation is avoided deliberately: XLA materializes
    the (S, K, M) int64 product (multi-GB at finisher shapes).

    small_acc (static; caller guarantees K * (p//2)^2 < 2^31): a single
    int32 multiply-reduce replaces the d*d digit passes — no digit
    extraction, one pass over G instead of ~4 (the measured phase-A
    bottleneck).
    """
    if small_acc:
        acc = jnp.sum(V[:, :, None] * G.astype(jnp.int32), axis=1,
                      dtype=jnp.int32)
        return _reduce31(acc, p)
    Vd = _digits(V, d, p)                       # (d, S, K) int8
    Gd = _digits(G, d, p)                       # (d, S, K, M) int8
    dot = functools.partial(
        jax.lax.dot_general,
        dimension_numbers=(((1,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.int32)
    parts = [None] * (2 * d - 1)
    for d1 in range(d):
        for d2 in range(d):
            P = dot(Vd[d1], Gd[d2])             # (S, M) int32
            s = d1 + d2
            parts[s] = P if parts[s] is None else parts[s] + P
    if d == 2:
        b = [_reduce31(parts[s], p) for s in range(3)]
        w32 = weights.astype(jnp.int32)
        return _reduce31(b[0] + w32[1] * b[1] + w32[2] * b[2], p)
    acc = jnp.zeros(parts[0].shape, jnp.int64)
    for s in range(2 * d - 1):
        if d == 3:
            b = _reduce31(parts[s], p).astype(jnp.int64)
        else:
            b = parts[s].astype(jnp.int64)
        acc = acc + dnorm64(b * weights[s], p)
    return dnorm(acc, p)


def _balance32(X, p, small: bool):
    """Balanced reduction of an int32 scatter accumulator."""
    if small:
        return _reduce31(X, p)
    return dnorm(X.astype(jnp.int64), p)


@functools.partial(jax.jit,
                   static_argnames=("S", "K", "d", "small", "small_acc"),
                   donate_argnums=(0,))
def _phase_a_scan(R, rowids, cols, vals, colmap, pivmap, p, weights,
                  d: int, small: bool, S: int, K: int,
                  small_acc: bool = False):
    """Backward-substitution sweep over a group of row chunks.

    R (npad, M) donated.  Per chunk: basis rows rowids[c] (S,) get
    R[k] = scatter(free entries) - refs @ R, where every ref points at
    an already-computed row (strictly greater group).  Padded row slots
    carry only dead entries, compute exact zeros, and scatter onto the
    dead row npad-1 (which must stay zero) — no masking needed.
    """
    M = R.shape[1]
    iota_S = jnp.arange(S)

    def body(R, x):
        rid, C, V = x                          # rid (S,); C,V: (S, K)
        fc = colmap[C]                         # free slot or M-1 (dead)
        pr = pivmap[C]                         # R row or npad-1 (zero row)
        G = R[pr]                              # (S, K, M) row gather
        # combine with NEGATED coefficients, then scatter the free
        # entries straight onto the result — skips a zeros+scatter+
        # balance round trip over the (S, M) block
        blk = _ref_combine(-V, G, p, weights, d, small_acc)
        blk = blk.at[jnp.broadcast_to(iota_S[:, None], (S, K)),
                     fc].add(V)
        blk = _balance32(blk, p, small)
        # the dead column absorbed the reference-slot scatter values; it
        # must stay zero (a rowspan-dependent row would otherwise carry
        # junk there and claim a false pivot in the row-sweep RREF)
        blk = blk.at[:, M - 1].set(0)
        return R.at[rid].set(blk.astype(R.dtype)), None

    R, _ = jax.lax.scan(body, R, (rowids, cols, vals))
    return R


@functools.partial(jax.jit,
                   static_argnames=("Bc", "K", "M", "d", "small",
                                    "small_acc"))
def _form_chunk(eidx, coeff, indices, data, colmap, pivmap, R, p, weights,
                Bc: int, K: int, M: int, d: int, small: bool,
                small_acc: bool = False):
    """Eliminated compact block for Bc rows given as flat entry slots.

    eidx (Bc, K): positions into the entry arrays (dead slot -> the
    padded entry with col = m, val = 0); coeff (Bc, K): coefficient per
    slot.  Returns (Bc, M) int32 balanced: scatter(free entries) minus
    the weighted sum of referenced R rows.
    """
    C = indices[eidx]                           # (Bc, K) global columns
    raw = data[eidx]
    if small:
        v = _reduce31(raw * coeff, p)           # |raw*coeff| <= 2^30
    else:
        v = dnorm(raw.astype(jnp.int64) * coeff.astype(jnp.int64), p)
    fc = colmap[C]
    pr = pivmap[C]
    iota = jnp.arange(Bc)
    # colliding entries (two combined rows sharing a column) sum in the
    # scatter: K balanced terms stay in int32 only for the small tier
    acc_t = jnp.int32 if small else jnp.int64
    X = jnp.zeros((Bc, M), acc_t)
    X = X.at[jnp.broadcast_to(iota[:, None], (Bc, K)), fc].add(
        v.astype(acc_t))
    Xb = _reduce31(X, p) if small else dnorm(X, p)
    G = R[pr]                                   # (Bc, K, M)
    delta = _ref_combine(v.astype(jnp.int32), G, p, weights, d,
                         small_acc)
    out = _submod(Xb, delta, p, small)
    # scatter routed reference-slot values onto the dead column; keep it
    # zero so rowspan-dependent rows cannot claim a false pivot there
    return out.at[:, M - 1].set(0)


@functools.partial(jax.jit, static_argnames=("d",))
def _elim_full_width(Y, R, pivcol_of_row, qsel, p, weights, d: int):
    """Eliminate full-width device rows Y (Sn, mp) against the basis,
    returning the compacted free-column residue (Sn, M).

    pivcol_of_row (npad,): global pivot column of each R row (dead rows
    -> the dead column mp-1 where Y is zero); qsel (M,): global column
    of each compact slot (dead -> mp-1).
    """
    Cf = Y[:, pivcol_of_row]                    # (Sn, npad) coefficients
    # R passes through as int16: matmul_digits digitizes chunk slices
    # directly (an .astype(int32) of the whole basis would materialize
    # a 2x-R-sized temp — multi-GB at finisher shapes)
    delta = matmul_digits(Cf.astype(jnp.int32), R, p, weights, d)
    small = d == 2
    return _submod(Y[:, qsel].astype(jnp.int32), delta, p, small)


class ReducedBasis:
    """Device-resident R = (U|piv)^-1 @ (U|free) over the compacted
    free-column domain, plus block formation against it."""

    # (chunk height, scan length) tiers for the phase-A sweeps: FIXED
    # shapes so at most one compiled scan exists per tier (per K) —
    # dead-padded chunks/slots are inert, and the read waste of
    # rounding a level up to a tier is bounded by the tier ratio
    _TIERS = ((64, 64), (512, 16), (4096, 4), (8192, 2))
    # element budget for one (Bc, K, M) reference gather (tiers and
    # budget carried over untuned; see ROADMAP A3)
    _GATHER_BUDGET = 1 << 28

    def __init__(self, m: int, prime: int, qfree: np.ndarray,
                 npiv: int):
        self.m = m
        self.prime = prime
        self.F = device_field(prime)
        self.small = self.F.ndigits == 2
        self.nq = int(qfree.size)
        # width rounds to a 2048 multiple (bounds the compiled width
        # variants); the pad is dead-column zeros
        self.M = max(-(-(self.nq + 1) // 2048) * 2048, 2048)
        self.npad = _size_bucket(npiv + 1, 64)
        self.npiv = npiv
        self.dtype = storage_dtype(prime)
        self.p64 = jnp.int64(prime)
        self.w = jnp.asarray(self.F.weights)
        # global column -> compact slot / R row (index m = dead)
        colmap = np.full(m + 1, self.M - 1, np.int32)
        colmap[qfree] = np.arange(self.nq, dtype=np.int32)
        self._colmap_np = colmap
        self.colmap = jnp.asarray(colmap)
        self.qfree = qfree
        self.R = None                    # (npad, M) device array
        self.pivmap = None
        self._pivcol_of_row = None

    # -- phase A -----------------------------------------------------------

    def build(self, offs: np.ndarray, cols: np.ndarray, vals: np.ndarray,
              pivcols: np.ndarray, groups: np.ndarray):
        """Build R from the basis rows (flat CSR-style arrays).

        offs (npiv+1,), cols/vals flat entries, pivcols (npiv,) pivot
        column of each row, groups (npiv,) ints; rows with equal group
        id never reference each other's pivot columns and only reference
        rows of strictly greater group id (any valid assignment — the
        build sorts by group itself).
        """
        npiv = self.npiv
        pivmap = np.full(self.m + 1, self.npad - 1, np.int32)
        if npiv:
            pivmap[np.asarray(pivcols, np.int64)] = \
                np.arange(npiv, dtype=np.int32)
        self.pivmap = jnp.asarray(pivmap)
        pcr = np.full(self.npad, self.m, np.int64)
        pcr[:npiv] = pivcols
        self._pivcol_of_row = pcr
        from ..parallel.context import shard_cols
        # SP axis (SURVEY §2.4): under an active mesh the reduced basis
        # shards its WIDTH over 'cols' — every per-row gather stays
        # local to a column shard, and the free-column budget scales
        # with the mesh instead of one chip's HBM
        R = shard_cols(jnp.zeros((self.npad, self.M), self.dtype))
        if npiv == 0:
            self.R = R
            return
        lens = np.diff(offs)
        pivcols = np.asarray(pivcols, np.int64)
        # process groups in DESCENDING order (refs point at greater
        # groups = already-computed rows); rows inside one group are
        # mutually independent, so chunks may split a group anywhere
        order = np.argsort(-np.asarray(groups), kind="stable")
        gsorted = np.asarray(groups)[order]
        runs = np.concatenate(
            ([0], np.nonzero(np.diff(gsorted))[0] + 1, [npiv]))
        # one chunk never spans a group boundary: a row may reference a
        # greater-group row, which inside the same chunk would still
        # read as zero.  Splitting WITHIN a group is always safe.
        K = _k_bucket(int(lens.max(initial=1)))
        # keep one chunk's (S, K, M) reference gather within budget
        # (skewed row lengths raise K for everyone; shrink S to match).
        # When even S=64 would blow the budget (one very long row in a
        # wide basis), shrink the chunk height further instead of
        # allocating past the budget (advisor r4 finding #2).
        tiers = [t for t in self._TIERS
                 if t[0] * K * self.M <= (1 << 30)]
        if not tiers:
            s_small = max(1, (1 << 30) // max(K * self.M, 1))
            s_small = 1 << (s_small.bit_length() - 1)
            tiers = [(s_small, 64)]
        Smax = tiers[-1][0]
        chunks: List[Tuple[int, int, int]] = []     # (o0, sz, S-tier)
        for ri in range(len(runs) - 1):
            lo, hi = int(runs[ri]), int(runs[ri + 1])
            k = lo
            while k < hi:
                take = min(hi - k, Smax)
                S = next(t for t, _ in tiers if take <= t)
                chunks.append((k, take, S))
                k += take
        # --- tail doubling: the long chain of small levels (deep
        # topological tail) costs one sequential scan step per level;
        # instead, solve (I + P) R_tail = B by log-depth squaring of the
        # sparse intra-tail reference matrix P — ceil(log2 depth) bulk
        # rounds over a compact buffer replace ~1000 tiny scan steps.
        i0, R = self._build_tail(chunks, order, offs, cols, vals, lens,
                                 pivcols, pivmap, R)
        # one flat padded entry table for ALL rows (the per-chunk numpy
        # loop it replaces cost ~1.2 s of device idle at 10^5 pivots):
        # chunk slices then reduce to single fancy-index gathers
        npad_rows = npiv
        Call = np.full((npad_rows, K), self.m, np.int32)
        Vall = np.zeros((npad_rows, K), np.int32)
        nnz_u = int(offs[-1])
        rr_all = np.repeat(np.arange(npiv), lens)
        pos_all = _slot_positions(rr_all)
        cc_all = cols[:nnz_u].astype(np.int64)
        vv_all = vals[:nnz_u].astype(np.int32)
        own_all = cc_all == pivcols[rr_all]
        Call[rr_all, pos_all] = np.where(own_all, self.m, cc_all)
        Vall[rr_all, pos_all] = np.where(own_all, 0, vv_all)

        # pack consecutive same-S chunks into fixed-length scans
        import os
        prof = os.environ.get("SPASM_PROFILE_FINISH")
        import time as _t
        tb0 = _t.time()
        nscan = 0
        gp_of = dict(tiers)
        i = i0
        while i < len(chunks):
            S = chunks[i][2]
            gp = gp_of[S]
            # only the consecutive same-tier PREFIX may share a scan:
            # skipping a different-tier chunk in the middle would process
            # later chunks before their (greater-group) references exist
            j = i
            while j < len(chunks) and chunks[j][2] == S and j - i < gp:
                j += 1
            group = chunks[i:j]
            g = len(group)
            rids = np.full((gp, S), self.npad - 1, np.int32)
            Cs = np.full((gp, S, K), self.m, np.int32)   # dead column
            Vs = np.zeros((gp, S, K), np.int32)
            for t in range(g):
                o0, sz, _ = group[t]
                rows_t = order[o0:o0 + sz]
                rids[t, :sz] = rows_t
                Cs[t, :sz] = Call[rows_t]
                Vs[t, :sz] = Vall[rows_t]
            R = _phase_a_scan(R, jnp.asarray(rids),
                              jnp.asarray(Cs), jnp.asarray(Vs),
                              self.colmap, self.pivmap, self.p64, self.w,
                              self.F.ndigits, self.small, S, K,
                              self._small_acc(K))
            nscan += 1
            if prof:
                jax.block_until_ready(R)
                print(f"[rb.build] scan {nscan} S={S} g={gp} "
                      f"t={_t.time() - tb0:.2f}", flush=True)
                tb0 = _t.time()
            i = j
        self.R = R

    # tail-doubling budgets: max rows, max chunk tier, fill/round caps
    _TAIL_CAP = 65536
    _TAIL_TIER = 512
    _TAIL_MIN_CHUNKS = 24
    _TAIL_MAX_FILL = 128
    _TAIL_MAX_ROUNDS = 24

    def _build_tail(self, chunks, order, offs, cols, vals, lens,
                    pivcols, pivmap_np, R):
        """Process the deep-tail prefix of `chunks` by log-depth doubling
        (see build()).  Returns (chunks consumed, R)."""
        tc = 0
        t = 0
        while tc < len(chunks) and chunks[tc][2] <= self._TAIL_TIER \
                and t + chunks[tc][1] <= self._TAIL_CAP:
            t += chunks[tc][1]
            tc += 1
        if tc < self._TAIL_MIN_CHUNKS or t < 2048:
            return 0, R
        p = self.prime
        tail_rows = order[:t]
        loc = np.full(self.npiv, -1, np.int64)
        loc[tail_rows] = np.arange(t)
        ls = lens[tail_rows]
        src = _flat_gather(offs[tail_rows], ls)
        rr = np.repeat(np.arange(t), ls)
        cc = cols[src].astype(np.int64)
        vv = vals[src].astype(np.int64)
        own = cc == pivcols[tail_rows[rr]]
        refg = pivmap_np[cc]
        is_ref = (refg != self.npad - 1) & ~own
        # closure: every reference of a tail row lands inside the tail
        refl = loc[refg[is_ref]]
        if refl.size and refl.min() < 0:        # pragma: no cover
            return 0, R
        # precompute the Q = (-P)^(2^i) powers on host; bail out to the
        # scan path if fill or round count explodes (non-chain DAGs)
        qoffs = np.zeros(t + 1, np.int64)
        np.add.at(qoffs, rr[is_ref] + 1, 1)
        np.cumsum(qoffs, out=qoffs)
        qcols = refl
        qvals = (-vv[is_ref]) % p
        qvals = np.where(qvals > p // 2, qvals - p, qvals)
        powers = []
        while qcols.size:
            mx = int(np.diff(qoffs).max(initial=0))
            if mx > self._TAIL_MAX_FILL or \
                    len(powers) >= self._TAIL_MAX_ROUNDS:
                return 0, R
            powers.append((qoffs, qcols, qvals, mx))
            qoffs, qcols, qvals = _host_spmm_modp(
                qoffs, qcols, qvals, qoffs, qcols, qvals, t, p)
        tpad = _size_bucket(t + 1, 64)
        # free-entry scatter -> compact X
        is_free = (~is_ref) & ~own
        Kf = _k_bucket(int(np.bincount(rr[is_free], minlength=t)
                           .max(initial=1)))
        Cf = np.full((tpad, Kf), self.m, np.int32)
        Vf = np.zeros((tpad, Kf), np.int32)
        rf = rr[is_free]
        pos = _slot_positions(rf)
        Cf[rf, pos] = cc[is_free]
        Vf[rf, pos] = vv[is_free]
        SC = 16384
        parts = []
        for r0 in range(0, tpad, SC):
            S = min(SC, tpad - r0)
            Sb = _size_bucket(S, 64)
            cpad = np.full((Sb, Kf), self.m, np.int32)
            vpad = np.zeros((Sb, Kf), np.int32)
            cpad[:S] = Cf[r0:r0 + S]
            vpad[:S] = Vf[r0:r0 + S]
            blk = _tail_scatter(jnp.asarray(cpad), jnp.asarray(vpad),
                                self.colmap, self.p64, Sb, Kf, self.M,
                                self.small)
            parts.append(blk[:S].astype(self.dtype))
        X = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
        # doubling rounds (double-buffered; pad rows stay zero)
        for qoffs, qcols, qvals, mx in powers:
            Kq = _k_bucket(mx)
            refs = np.full((tpad, Kq), tpad - 1, np.int32)
            qv = np.zeros((tpad, Kq), np.int32)
            qr = np.repeat(np.arange(t), np.diff(qoffs))
            pos = _slot_positions(qr)
            refs[qr, pos] = qcols
            qv[qr, pos] = qvals
            budget = self._GATHER_BUDGET
            Bc = max(min(1 << (max(budget // max(Kq * self.M, 1),
                                   1).bit_length() - 1), tpad, 4096), 64)
            while tpad % Bc:
                Bc //= 2
            outs = []
            for r0 in range(0, tpad, Bc):
                outs.append(_tail_combine_chunk(
                    X, r0, jnp.asarray(refs[r0:r0 + Bc]),
                    jnp.asarray(qv[r0:r0 + Bc]), self.p64, self.w,
                    Bc, Kq, self.F.ndigits, self.small,
                    self._small_acc(Kq)))
            X = outs[0] if len(outs) == 1 else jnp.concatenate(outs)
        tids = np.full(tpad, self.npad - 1, np.int32)
        tids[:t] = tail_rows
        R = _tail_scatter_into_R(R, jnp.asarray(tids), X)
        return tc, R

    # -- phase B -----------------------------------------------------------

    def set_entries(self, indices: np.ndarray, data: np.ndarray, nnz: int):
        """Upload the matrix entry arrays once (with one dead entry at
        index nnz: column m, value 0 — the target of padded slots)."""
        ind = np.empty(nnz + 1, np.int32)
        ind[:nnz] = indices[:nnz]
        ind[nnz] = self.m
        dat = np.zeros(nnz + 1, np.int32)
        dat[:nnz] = data[:nnz]
        self.dead_eidx = nnz
        self.indices = jnp.asarray(ind)
        self.data = jnp.asarray(dat)

    def form_block(self, eidx: np.ndarray, coeff: np.ndarray,
                   Bp: Optional[int] = None):
        """Eliminated compact block (Bp, M) for rows given as flat entry
        slots.  eidx/coeff: (B, K) host arrays (pad with dead_eidx/0).
        Passing a fixed Bp keeps the compiled chunk shapes identical
        across rounds (dead-padded rows come out zero).  Returns a
        device array of self.dtype."""
        B, K = eidx.shape
        Bc = max(self._GATHER_BUDGET // max(K * self.M, 1), 1)
        Bc = max(min(1 << (Bc.bit_length() - 1), B, 4096), 64)
        if Bp is None:
            Bp = -(-B // Bc) * Bc
        else:
            Bc = min(Bc, Bp)
            while Bp % Bc:
                Bc //= 2
        if Bp != B:
            ep = np.full((Bp, K), self.dead_eidx, np.int64)
            ep[:B] = eidx
            cp = np.zeros((Bp, K), np.int32)
            cp[:B] = coeff
            eidx, coeff = ep, cp
        from ..parallel.context import shard_cols
        outs = []
        for b0 in range(0, Bp, Bc):
            X = _form_chunk(jnp.asarray(eidx[b0:b0 + Bc], np.int64),
                            jnp.asarray(coeff[b0:b0 + Bc], np.int32),
                            self.indices, self.data, self.colmap,
                            self.pivmap, self.R, self.p64, self.w,
                            Bc, K, self.M, self.F.ndigits, self.small,
                            self._small_acc(K))
            outs.append(X.astype(self.dtype))
        Xd = outs[0] if len(outs) == 1 else jnp.concatenate(outs)
        return shard_cols(Xd)

    def flat_rows(self, A_indptr: np.ndarray, rows: np.ndarray,
                  coeffs: Optional[np.ndarray] = None):
        """Host prep: flat (B, K) entry slots for combinations.

        rows (B, w) row ids (w == 1 for plain row blocks); coeffs
        (B, w) or None (all-ones).  Returns (eidx, coeff)."""
        rows = np.asarray(rows, np.int64)
        if rows.ndim == 1:
            rows = rows[:, None]
        B, w = rows.shape
        starts = A_indptr[rows]                    # (B, w)
        lens = (A_indptr[rows + 1] - starts).astype(np.int64)
        tot = lens.sum(axis=1)
        K = _k_bucket(int(tot.max(initial=1)))
        eidx = np.full((B, K), self.dead_eidx, np.int64)
        coeff = np.zeros((B, K), np.int32)
        lf = lens.reshape(-1)
        src = _flat_gather(starts.reshape(-1), lf)
        nrep = np.repeat(np.arange(B * w) // w, lf)
        pos_in_row = (np.arange(lf.sum())
                      - np.repeat(np.cumsum(lf) - lf, lf)
                      + np.repeat(np.cumsum(lens, axis=1).reshape(-1)
                                  - lf, lf))
        eidx[nrep, pos_in_row] = src
        if coeffs is None:
            coeff[nrep, pos_in_row] = 1
        else:
            coeff[nrep, pos_in_row] = np.repeat(
                np.asarray(coeffs, np.int32).reshape(-1), lf)
        return eidx, coeff

    def eliminate_full_width(self, Y):
        """Compact + eliminate full-width device rows Y (Sn, mp); the
        dead column mp-1 of Y must be zero.  Returns (Sn, M) int32."""
        mp = Y.shape[1]
        pcr = np.where(self._pivcol_of_row >= self.m, mp - 1,
                       self._pivcol_of_row)
        qsel = np.full(self.M, mp - 1, np.int64)
        qsel[:self.nq] = self.qfree
        return _elim_full_width(Y, self.R, jnp.asarray(pcr),
                                jnp.asarray(qsel), self.p64, self.w,
                                self.F.ndigits)

    def _small_acc(self, K: int) -> bool:
        """True when K balanced products fit one int32 accumulator."""
        return K * (self.prime // 2) ** 2 < (1 << 31)


def _host_spmm_modp(offs1, cols1, vals1, offs2, cols2, vals2, n: int,
                    p: int):
    """C = A @ B over GF(p) for tiny host CSR operands (balanced values,
    duplicate coalescing, zero dropping) — used to square the sparse
    tail-reference matrix during the log-depth backward substitution."""
    lens1 = np.diff(offs1)
    e_r = np.repeat(np.arange(n), lens1)
    e_c = cols1
    e_v = vals1
    cnt = (offs2[e_c + 1] - offs2[e_c]).astype(np.int64)
    r2 = np.repeat(e_r, cnt)
    v1r = np.repeat(e_v.astype(np.int64), cnt)
    src = _flat_gather(offs2[e_c], cnt)
    c2 = cols2[src]
    v2 = (v1r * vals2[src].astype(np.int64)) % p
    key = r2 * np.int64(n) + c2
    order = np.argsort(key, kind="stable")
    key = key[order]
    v2 = v2[order]
    bounds = np.concatenate(([0], np.nonzero(np.diff(key))[0] + 1,
                             [key.size])) if key.size else np.zeros(1,
                                                                    np.int64)
    sums = np.add.reduceat(v2 % p, bounds[:-1]) % p if key.size else \
        np.empty(0, np.int64)
    ukey = key[bounds[:-1]] if key.size else np.empty(0, np.int64)
    live = sums != 0
    ukey, sums = ukey[live], sums[live]
    sums = np.where(sums > p // 2, sums - p, sums)
    out_r = (ukey // n).astype(np.int64)
    out_c = (ukey % n).astype(np.int64)
    offs = np.zeros(n + 1, np.int64)
    np.add.at(offs, out_r + 1, 1)
    np.cumsum(offs, out=offs)
    return offs, out_c, sums.astype(np.int64)


@functools.partial(jax.jit, static_argnames=("S", "K", "M", "small"))
def _tail_scatter(cols, vals, colmap, p, S: int, K: int, M: int,
                  small: bool):
    """Free-entry scatter of S rows -> (S, M) int32 balanced."""
    fc = colmap[cols]
    iota = jnp.arange(S)
    X = jnp.zeros((S, M), jnp.int32)
    X = X.at[jnp.broadcast_to(iota[:, None], (S, K)), fc].add(vals)
    return _balance32(X, p, small)


@functools.partial(jax.jit,
                   static_argnames=("Bc", "K", "d", "small", "small_acc"))
def _tail_combine_chunk(Xold, r0, refs, vals, p, weights, Bc: int,
                        K: int, d: int, small: bool,
                        small_acc: bool = False):
    """Rows [r0, r0+Bc) of X + Q @ X for a sparse Q given as per-row
    (refs, vals) slots.  refs point at rows of the OLD X (dead -> a
    zero pad row), so rounds run double-buffered."""
    M = Xold.shape[1]
    Xrows = jax.lax.dynamic_slice(Xold, (r0, 0), (Bc, M))
    G = Xold[refs]                                # (Bc, K, M)
    delta = _ref_combine(vals, G, p, weights, d, small_acc)
    return _balance32(Xrows.astype(jnp.int32) + delta, p,
                      small).astype(Xold.dtype)


@functools.partial(jax.jit, donate_argnums=(0,))
def _tail_scatter_into_R(R, tids, X):
    return R.at[tids].set(X.astype(R.dtype))


def _k_bucket(k: int) -> int:
    """Entry-slot bucket: powers of two to 32, then multiples of 16
    (the slot count scales the dominant reference-gather traffic, so
    coarse pow2 rounding above 32 would cost real bandwidth)."""
    if k <= 4:
        return 4
    if k <= 32:
        b = 8
        while b < k:
            b <<= 1
        return b
    return -(-k // 16) * 16


def _slot_positions(row_ids: np.ndarray) -> np.ndarray:
    """Per-entry slot index within its (sorted, grouped) row run."""
    n = row_ids.size
    if n == 0:
        return np.empty(0, np.int64)
    starts = np.concatenate(([0], np.nonzero(np.diff(row_ids))[0] + 1))
    runlens = np.diff(np.concatenate((starts, [n])))
    return np.arange(n) - np.repeat(starts, runlens)


def _flat_gather(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenate ranges [starts[i], starts[i]+lens[i]) (vectorized)."""
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, np.int64)
    rep = np.repeat(starts - np.concatenate(([0], np.cumsum(lens)[:-1])),
                    lens)
    return rep + np.arange(total)
