"""The device paths of the dense engine against plain host references.

Each device path here is the only implementation the engine has (plain
jax.numpy/lax, compiled by XLA); the references are straightforward
numpy code from spasm_tpu.dense.reference or written out below.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from spasm_tpu.dense import reference as ref
from spasm_tpu.dense.elim import (_discovery_sweep, _jordan_inverse,
                                  _forward_factor,
                                  _unit_upper_inverse_small)
from spasm_tpu.dense.modp import storage_dtype
from spasm_tpu.dense.reduced import ReducedBasis
from spasm_tpu.dense.rowrref import CompactBasis, rref_rows_device


def _inverse_np(W, p):
    """W^-1 mod p by Gauss-Jordan with row swaps (Python ints)."""
    n = W.shape[0]
    M = [[int(v) % p for v in row] + [int(i == j) for j in range(n)]
         for i, row in enumerate(W)]
    for t in range(n):
        r = next(i for i in range(t, n) if M[i][t])
        M[t], M[r] = M[r], M[t]
        inv = pow(M[t][t], -1, p)
        M[t] = [v * inv % p for v in M[t]]
        for i in range(n):
            if i != t and M[i][t]:
                f = M[i][t]
                M[i] = [(a - f * b) % p for a, b in zip(M[i], M[t])]
    return np.asarray([row[n:] for row in M], np.int64)


def _unit_upper_np(W, p):
    """U of W = L D U (L unit lower, U unit upper), no pivoting."""
    n = W.shape[0]
    M = [[int(v) % p for v in row] for row in W]
    for t in range(n):
        inv = pow(M[t][t], -1, p)
        for i in range(t + 1, n):
            f = M[i][t] * inv % p
            M[i] = [(a - f * b) % p for a, b in zip(M[i], M[t])]
        M[t] = [v * inv % p for v in M[t]]
    return np.asarray(M, np.int64)


def _panel_pivots_np(P0, p):
    """Column-by-column pivot rows of a panel: the first not-yet-pivotal
    row with a nonzero in the column, after eliminating earlier pivots."""
    A = np.asarray(P0, np.int64) % p
    n, nb = A.shape
    is_piv = np.zeros(n, bool)
    lrows = np.full(nb, -1, np.int64)
    for t in range(nb):
        avail = ~is_piv & (A[:, t] != 0)
        if not avail.any():
            continue
        r = int(np.argmax(avail))
        u = ref.mulmod(A[r], pow(int(A[r, t]), -1, p), p)
        g = A[:, t].copy()
        g[r] = 0
        A = (A - ref.mulmod(g[:, None], u[None, :], p)) % p
        lrows[t] = r
        is_piv[r] = True
    return lrows, is_piv


@pytest.mark.parametrize("rref", [True, False])
@pytest.mark.parametrize("p", [3, 257, 42013, 65269])
def test_panel_path_matches_numpy_gauss_jordan(p, rref):
    # 65269: the largest prime of the d == 2 digit tier (p <= 65279)
    rng = np.random.default_rng(p)
    n, nb = 256, 64
    P0 = rng.integers(-(p // 2), p // 2 + 1, (n, nb)).astype(np.int32)
    P0[:, 7] = P0[:, 2]          # duplicate column -> rank deficiency
    P0[:, 40] = 0                # empty column
    p64 = jnp.int64(p)
    rounds = 1                   # the engine's setting for p <= 2^23
    piv = _discovery_sweep(jnp.asarray(P0), jnp.zeros(n, bool), p64,
                           True, rounds)
    want_rows, want_is_piv = _panel_pivots_np(P0, p)
    lhas = np.asarray(piv.lhas)
    assert np.array_equal(np.where(lhas, np.asarray(piv.lrows), -1),
                          want_rows)
    assert np.array_equal(np.asarray(piv.is_piv), want_is_piv)
    assert not lhas[7] and not lhas[40]

    lsafe = np.where(lhas, want_rows, 0)
    W = np.where(lhas[:, None] & lhas[None, :], P0[lsafe, :],
                 np.eye(nb, dtype=np.int32))
    Winv = _inverse_np(W, p)
    if rref:
        Z = _jordan_inverse(jnp.asarray(W), p64, True, rounds)
        assert np.array_equal(np.asarray(Z), ref.balanced(Winv, p))
        return
    Zlu, Vup = _forward_factor(jnp.asarray(W), p64, True, rounds)
    Vinv = _unit_upper_inverse_small(Vup, p64, True)
    U = _unit_upper_np(W, p)
    assert np.array_equal(np.asarray(Vup), ref.balanced(U, p))
    assert np.array_equal(np.asarray(Zlu),
                          ref.matmul_modp(U, Winv, p))
    assert np.array_equal(np.asarray(Vinv),
                          ref.balanced(_inverse_np(U, p), p))


@pytest.mark.parametrize("p", [257, 42013, 67108859, 4294967291])
def test_rref_rows_device_matches_host(p):
    rng = np.random.default_rng(p % 1000)
    B, M = 128, 512
    X = rng.integers(-(p // 2), p // 2 + 1, (B, M))
    X[70] = X[3]                              # dependent row
    X[90] = 0                                 # zero row
    X[100] = (X[5] + X[6]) % p                # another dependent row
    X[:, 200] = 0                             # dead interior column
    X[:, -1] = 0                              # the required dead column
    X = ref.balanced(X, p)
    R, pivcol = rref_rows_device(jnp.asarray(X.astype(storage_dtype(p))),
                                 p)
    want_R, want_piv = ref.rref_rows(X, p)
    assert np.array_equal(pivcol, want_piv)
    assert np.array_equal(np.asarray(R).astype(np.int64), want_R)
    assert (pivcol >= 0).sum() == B - 3


def _random_basis(rng, m, npiv, ngroups, p, chain=False):
    """Flat unit-upper basis rows with topological groups: row k refers
    only to pivot columns of rows in strictly greater groups."""
    cols_all = rng.permutation(m)
    pivcols = cols_all[:npiv]
    qfree = np.sort(cols_all[npiv:])
    groups = (np.arange(npiv) if chain
              else rng.integers(0, ngroups, npiv))
    offs, cols, vals = [0], [], []
    for k in range(npiv):
        later = np.flatnonzero(groups > groups[k])
        if chain:
            refs = [k + 1] if k + 1 < npiv else []
        else:
            refs = rng.choice(later, min(3, later.size), replace=False) \
                if later.size else []
        fr = rng.choice(qfree, 4, replace=False)
        rc = [pivcols[k]] + [pivcols[j] for j in refs] + list(fr)
        rv = [1] + list(rng.integers(-(p // 2), p // 2 + 1, len(rc) - 1))
        order = np.argsort(rc)
        cols.extend(np.asarray(rc)[order])
        vals.extend(np.asarray(rv)[order])
        offs.append(len(cols))
    return (np.asarray(offs, np.int64), np.asarray(cols, np.int32),
            np.asarray(vals, np.int32), pivcols.astype(np.int64),
            groups.astype(np.int64), qfree.astype(np.int64))


@pytest.mark.parametrize("p, chain", [(257, False), (42013, False),
                                      (65279, False), (42013, True)])
def test_reduced_basis_build_matches_host_model(p, chain):
    """The scan build (and, for a deep chain, the log-depth tail) against
    the host substitution model."""
    rng = np.random.default_rng(p + chain)
    m, npiv = (2400, 2100) if chain else (400, 150)
    offs, cols, vals, pivcols, groups, qfree = _random_basis(
        rng, m, npiv, 6, p, chain)
    rb = ReducedBasis(m, p, qfree, npiv)
    rb.build(offs, cols, vals, pivcols, groups)
    R = np.asarray(rb.R).astype(np.int64)
    want = ref.reduced_basis(offs, cols, vals, pivcols, groups, qfree, p)
    assert R.dtype == np.int64 and rb.R.dtype == storage_dtype(p)
    assert np.array_equal(R[:npiv, :qfree.size], want)
    assert not R[npiv:].any() and not R[:, qfree.size:].any()


@pytest.mark.parametrize("p", [42013, 67108859, 4294967291])
def test_compact_basis_roundtrip(p):
    """Rows stored and exported exactly: above 65535 the values no longer
    fit int16, and the storage dtype follows p."""
    M = 256
    rng = np.random.default_rng(3)
    basis = CompactBasis(M, p, cap=100)
    assert basis.Rbuf.dtype == storage_dtype(p)
    h = p // 2
    rows = rng.integers(-h, h + 1, (64, M))
    rows[0, :4] = [h, -h, min(499992, h), 1]
    rows[:, -1] = 0
    jpos = rng.choice(M - 1, 64, replace=False)
    basis.add(jnp.asarray(rows.astype(storage_dtype(p))), jpos)
    got, got_j = basis.export()
    assert np.array_equal(np.asarray(got).astype(np.int64), rows)
    assert np.array_equal(got_j, jpos)


def test_storage_dtype():
    assert storage_dtype(3) == jnp.int16
    assert storage_dtype(65521) == jnp.int16
    assert storage_dtype(65537) == jnp.int32
    assert storage_dtype(4294967291) == jnp.int32


def test_device_memory_budget_from_stats():
    import sys
    budget = sys.modules["spasm_tpu.echelonize"].device_memory_budget

    class Dev:
        def __init__(self, stats):
            self.stats = stats

        def memory_stats(self):
            return self.stats

    assert budget(Dev({"bytes_limit": 64 << 30})) == 40 << 30
    host = budget(Dev(None))                 # no allocator stats: host RAM
    assert 0 < host < 1 << 50


def test_explicit_device_dense_mem_wins(monkeypatch):
    """A budget the caller passes is used as is; None derives it."""
    import sys
    from spasm_tpu import EchelonizeOptions, echelonize
    from spasm_tpu.gen import synthetic_sparse
    em = sys.modules["spasm_tpu.echelonize"]
    calls = []
    monkeypatch.setattr(em, "device_memory_budget",
                        lambda *a: calls.append(1) or (1 << 40))
    A = synthetic_sparse(300, 300, 4, 42013)
    r1 = echelonize(A.copy(), EchelonizeOptions(device_dense_mem=1)).r
    assert not calls
    r2 = echelonize(A.copy()).r
    assert calls and r1 == r2
