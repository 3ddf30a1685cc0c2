"""Mid-engine checkpoint/resume for the echelonization engine.

The reference has no mid-computation persistence (SURVEY.md §5.4), but its
round-structured engine is naturally checkpointable between rounds: the
full state is (U, qinv, L-triplets, S, p_in).  This module first-classes
that for preemptible accelerators: `echelonize(..., opts.checkpoint_file=PATH)`
writes an atomic snapshot after every round and after every dense-finisher
block; re-running the same command resumes from the last snapshot when the
input fingerprint matches.

Format: a single compressed .npz with flat numpy arrays (no pickle), plus
a fingerprint binding the checkpoint to the exact input matrix and the
options that affect the factorization (prime, L).
"""
from __future__ import annotations

import logging
import os
import tempfile
from typing import Optional

import numpy as np

from .csr import CSR
from .hashing import sha256_new

log = logging.getLogger("spasm_tpu")

_VERSION = 2

# phases a checkpoint may snapshot
PHASE_ROUND = 0      # between rounds of the main loop
PHASE_FINISH = 1     # finisher entry (p/npiv/density frozen)
PHASE_DENSE = 2      # inside the blocked dense finisher


def matrix_fingerprint(A: CSR) -> bytes:
    """SHA-256 over the exact CSR content (dims, prime, structure, values).

    Binds a checkpoint to one input matrix: resuming against a different
    matrix is detected and refused.
    """
    h = sha256_new()
    h.update(np.asarray([A.n, A.m, A.prime], np.int64).tobytes())
    h.update(np.ascontiguousarray(A.indptr, np.int64).tobytes())
    h.update(np.ascontiguousarray(A.indices, np.int32).tobytes())
    h.update(np.ascontiguousarray(A.data, np.int32).tobytes())
    return h.digest()


def _pack_rows(rows) -> tuple:
    """Ragged [(cols, vals)] -> (cols_flat, vals_flat, offs)."""
    if rows:
        offs = np.concatenate(
            ([0], np.cumsum([c.size for c, _ in rows]))).astype(np.int64)
        cols = np.concatenate([c for c, _ in rows]).astype(np.int32) \
            if offs[-1] else np.empty(0, np.int32)
        vals = np.concatenate([v for _, v in rows]).astype(np.int32) \
            if offs[-1] else np.empty(0, np.int32)
    else:
        offs = np.zeros(1, np.int64)
        cols = vals = np.empty(0, np.int32)
    return cols, vals, offs


def _unpack_rows(cols, vals, offs):
    return [(cols[offs[k]:offs[k + 1]], vals[offs[k]:offs[k + 1]])
            for k in range(len(offs) - 1)]


def save_checkpoint(path: str, *, fingerprint: bytes, engine,
                    S: CSR, p_in: Optional[np.ndarray], rnd: int,
                    phase: int, p: Optional[np.ndarray] = None,
                    npiv: int = 0, density: float = 0.0, status: int = 0,
                    processed: int = 0) -> None:
    """Atomically snapshot the engine + round-loop state to `path`."""
    eng = engine
    eng.U.flush_device()
    u_offs, u_cols, u_vals, u_piv, _ = eng.U.flat_store()
    payload = dict(
        version=np.int64(_VERSION),
        fingerprint=np.frombuffer(fingerprint, np.uint8),
        prime=np.int64(eng.prime),
        m=np.int64(eng.m),
        want_L=np.int64(0 if eng.L is None else 1),
        complete=np.int64(1 if eng.opts.complete else 0),
        phase=np.int64(phase),
        rnd=np.int64(rnd),
        status=np.int64(status),
        npiv=np.int64(npiv),
        density=np.float64(density),
        processed=np.int64(processed),
        u_cols=u_cols, u_vals=u_vals, u_offs=u_offs,
        u_pivcol=np.asarray(u_piv, np.int64),
        qinv=eng.U.qinv,
        Lp=np.asarray(eng.Lp, np.int64),
        s_indptr=S.indptr, s_indices=S.indices, s_data=S.data,
        s_shape=np.asarray([S.n, S.m], np.int64),
    )
    if p_in is not None:
        payload["p_in"] = np.asarray(p_in, np.int64)
    if p is not None:
        payload["p"] = np.asarray(p, np.int64)
    if eng.L is not None:
        eng.L.flush_pending()
        l_rows, l_cols, l_vals = eng.L.rows, eng.L.cols, eng.L.vals
        payload["l_rows"] = (np.concatenate(l_rows).astype(np.int64)
                             if l_rows else np.empty(0, np.int64))
        payload["l_cols"] = (np.concatenate(l_cols).astype(np.int64)
                             if l_cols else np.empty(0, np.int64))
        payload["l_vals"] = (np.concatenate(l_vals).astype(np.int64)
                             if l_vals else np.empty(0, np.int64))
    # fixed tmp name: a SIGKILL mid-save leaves at most ONE orphan, which
    # the next save (or load_checkpoint's cleanup) overwrites/removes
    tmp = os.path.abspath(path) + ".ck.tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    log.info("[checkpoint] saved %s (phase=%d rnd=%d rank=%d)",
             path, phase, rnd, eng.U.n)


def load_checkpoint(path: str, fingerprint: bytes, prime: int,
                    want_L: bool, complete: bool = False) -> Optional[dict]:
    """Load and validate a checkpoint; None if absent or incompatible.

    Also removes a stale '<path>.ck.tmp' orphan left by a preemption that
    struck mid-save.
    """
    stale = os.path.abspath(path) + ".ck.tmp"
    if os.path.exists(stale):
        try:
            os.unlink(stale)
        except OSError:                             # pragma: no cover
            pass
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            if int(z["version"]) != _VERSION:
                log.warning("[checkpoint] version mismatch in %s; ignoring",
                            path)
                return None
            # `complete` changes what L must contain (rollback-filtered vs
            # full); resuming across that flag would silently produce an
            # L with missing entries — reject like the prime/want_L checks
            if bytes(z["fingerprint"].tobytes()) != fingerprint \
                    or int(z["prime"]) != prime \
                    or bool(int(z["want_L"])) != want_L \
                    or bool(int(z["complete"])) != complete:
                log.warning("[checkpoint] %s does not match this "
                            "input/options; ignoring", path)
                return None
            state = {k: z[k] for k in z.files}
    except Exception as e:                      # corrupt snapshot: ignore
        log.warning("[checkpoint] unreadable %s (%s); ignoring", path, e)
        return None
    state["rows"] = _unpack_rows(state["u_cols"], state["u_vals"],
                                 state["u_offs"])
    return state


def restore_engine(engine, state: dict) -> None:
    """Rebuild the engine's U/L builders and the staged chunk basis."""
    eng = engine
    offs = state["u_offs"].astype(np.int64)
    pivcols = state["u_pivcol"].astype(np.int64)
    eng.U.add_rows_bulk(pivcols, offs, state["u_cols"], state["u_vals"])
    eng.U.qinv = state["qinv"].copy()
    eng.Lp = [int(v) for v in state["Lp"]]
    if eng.L is not None:
        eng.L.rows = [state["l_rows"]]
        eng.L.cols = [state["l_cols"]]
        eng.L.vals = [state["l_vals"]]
    eng.elim.append_segment(offs, state["u_cols"].astype(np.int64),
                            state["u_vals"], pivcols)


def restored_S(state: dict, prime: int) -> CSR:
    from .field import Field
    n, m = (int(v) for v in state["s_shape"])
    return CSR(n, m, Field(prime), state["s_indptr"],
               state["s_indices"], state["s_data"])
