"""Mid-engine checkpoint/resume (extension over the reference, SURVEY.md §5.4).

The reference has no mid-computation persistence; the round-structured
engine state (U, qinv, L-triplets, S, p_in) is snapshotted between rounds
and between dense-finisher blocks.  These tests simulate preemption by
aborting after the k-th snapshot and verifying that a resumed run produces
a factorization with the same rank and the same self-verifying properties
as an uninterrupted one.
"""
import numpy as np
import pytest

from spasm_tpu import sio, echelonize
from spasm_tpu.echelonize import EchelonizeOptions
from spasm_tpu import checkpoint as ckpt
from spasm_tpu import spmv

from tests.test_echelonize import echelon_form_check, inclusion_check


class _Preempt(RuntimeError):
    pass


def _preempting_save(monkeypatch, after: int):
    """Patch save_checkpoint to raise after the `after`-th snapshot."""
    real = ckpt.save_checkpoint
    count = {"n": 0}

    def wrapper(*a, **kw):
        real(*a, **kw)
        count["n"] += 1
        if count["n"] >= after:
            raise _Preempt()

    monkeypatch.setattr(ckpt, "save_checkpoint", wrapper)
    return count


def _dense_synthetic(n, m, p, seed=7):
    """A matrix whose Schur complement densifies: exercises rounds + the
    blocked dense finisher (several PHASE_DENSE snapshots)."""
    rng = np.random.default_rng(seed)
    from spasm_tpu.csr import COO
    w = 6
    rows = np.repeat(np.arange(n, dtype=np.int64), w)
    cols = rng.integers(0, m, size=n * w)
    vals = rng.integers(1, p, size=n * w)
    T = COO.from_entries(n, m, p, rows, cols, vals)
    T.n, T.m = n, m
    return T.tocsr()


@pytest.mark.parametrize("after", [1, 2])
def test_resume_after_preemption(tmp_path, monkeypatch, after):
    p = 42013
    A = _dense_synthetic(600, 600, p)
    ref = echelonize(A.copy())

    ckfile = str(tmp_path / "state.ck")
    opts = EchelonizeOptions(checkpoint_file=ckfile,
                             dense_block_size=64,
                             checkpoint_interval_s=0.0)
    count = _preempting_save(monkeypatch, after)
    with pytest.raises(_Preempt):
        echelonize(A.copy(), opts)
    assert (tmp_path / "state.ck").exists()
    assert count["n"] == after

    # resume: no more preemption
    monkeypatch.undo()
    fact = echelonize(A.copy(), opts)
    assert fact.r == ref.r
    echelon_form_check(fact.U, fact.qinv)
    inclusion_check(A, fact.U, fact.qinv)
    # checkpoint removed on success
    assert not (tmp_path / "state.ck").exists()


def test_resume_with_L(tmp_path, monkeypatch, matrix_dir):
    """PLUQ mode: resumed factorization still satisfies A == L@U rows."""
    p = 257
    A, _ = sio.load_csr(matrix_dir / "medium.sms", p)
    ref = echelonize(A.copy())

    ckfile = str(tmp_path / "state.ck")
    opts = EchelonizeOptions(L=True, complete=True, checkpoint_file=ckfile,
                             dense_block_size=32,
                             checkpoint_interval_s=0.0)
    _preempting_save(monkeypatch, 1)
    with pytest.raises(_Preempt):
        echelonize(A.copy(), opts)
    monkeypatch.undo()
    fact = echelonize(A.copy(), opts)
    assert fact.r == ref.r
    # verify A == L @ U on random unit vectors (probabilistic, exact)
    F = A.field
    rng = np.random.default_rng(3)
    for _ in range(5):
        x = rng.integers(0, p, size=A.n).astype(np.int64)
        xA = spmv.xApy(x, A, np.zeros(A.m, np.int64))
        xL = spmv.xApy(x, fact.L, np.zeros(fact.L.m, np.int64))
        xLU = spmv.xApy(xL, fact.U, np.zeros(A.m, np.int64))
        assert np.array_equal(F.narray(xA), F.narray(xLU))


def test_checkpoint_rejects_wrong_matrix(tmp_path, monkeypatch):
    """A snapshot from a different input must be ignored, not resumed."""
    p = 42013
    A = _dense_synthetic(300, 300, p, seed=1)
    B = _dense_synthetic(300, 300, p, seed=2)
    ckfile = str(tmp_path / "state.ck")
    opts = EchelonizeOptions(checkpoint_file=ckfile, dense_block_size=64)
    _preempting_save(monkeypatch, 1)
    with pytest.raises(_Preempt):
        echelonize(A.copy(), opts)
    monkeypatch.undo()
    ref_b = echelonize(B.copy())
    fact = echelonize(B.copy(), opts)   # fingerprint mismatch -> fresh run
    assert fact.r == ref_b.r
    echelon_form_check(fact.U, fact.qinv)
    inclusion_check(B, fact.U, fact.qinv)


def test_checkpoint_roundtrip_state(tmp_path, matrix_dir):
    """Low-level: a saved snapshot restores to an identical engine state."""
    p = 257
    A, _ = sio.load_csr(matrix_dir / "medium.sms", p)
    from spasm_tpu.echelonize import _Engine
    eng = _Engine(A, EchelonizeOptions())
    npiv, prows = eng.extract_structural(A, None)
    assert npiv > 0
    fp = ckpt.matrix_fingerprint(A)
    path = str(tmp_path / "s.ck")
    ckpt.save_checkpoint(path, fingerprint=fp, engine=eng, S=A, p_in=None,
                         rnd=1, phase=ckpt.PHASE_ROUND, density=0.01)
    state = ckpt.load_checkpoint(path, fp, p, False)
    assert state is not None
    eng2 = _Engine(A, EchelonizeOptions())
    ckpt.restore_engine(eng2, state)
    assert eng2.U.n == eng.U.n
    assert np.array_equal(eng2.U.qinv, eng.U.qinv)
    U1 = eng.U.snapshot_csr()
    U2 = eng2.U.snapshot_csr()
    assert np.array_equal(U1.indptr, U2.indptr)
    assert np.array_equal(U1.indices, U2.indices)
    assert np.array_equal(U1.data, U2.data)
    S2 = ckpt.restored_S(state, p)
    assert S2.n == A.n and S2.m == A.m and S2.nnz == A.nnz
    # wrong prime / wrong fingerprint / wrong `complete` are refused
    assert ckpt.load_checkpoint(path, fp, 65537, False) is None
    assert ckpt.load_checkpoint(path, b"\0" * 32, p, False) is None
    assert ckpt.load_checkpoint(path, fp, p, False, complete=True) is None
    # a stale mid-save orphan is cleaned up on load
    orphan = path + ".ck.tmp"
    open(orphan, "wb").write(b"partial")
    assert ckpt.load_checkpoint(path, fp, p, False) is not None
    import os
    assert not os.path.exists(orphan)
