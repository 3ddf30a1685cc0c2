"""Benchmark driver (one real chip).  Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "detail": {...}}

Headline (BASELINE.md config 1 analog): rank of mk13.b5 — the exact
135135 x 270270 boundary matrix of the matching complex M_13, one of the
three instances the reference ranks "in a few seconds"
(/root/reference/README.md:68-72), generated locally by
spasm_tpu.gen.matching_complex_boundary (hpac.imag.fr is unreachable).

vs_baseline := reference_wall / our_warm_wall with reference_wall = 3 s
("a few seconds", taken at 3, on an unspecified multicore with OpenMP).
Values > 1 mean faster than the reference's published claim.

cold_s is the first in-process run (includes XLA compile not covered by
the persistent cache); warm_s is the steady state.

detail.configs carries the rest of the BASELINE.md grid:
  2: SpMV + batched sparse triangular solves (trefethen_2000)
  3: synthetic echelonize at n=4k / n=16k (size-scaling check)
  4: full PLUQ + gesv + kernel basis (tests/Matrix fixtures)
  5: DM + SCC + rank certificate roundtrip
  int8: int8 matmul microbench (achieved TOPS / % of the device's
        published peak) and the exact-GF(p) matmul_digits throughput
        (the FFPACK-analog surface)

The CLI cells start fresh processes; they run before this process
touches the device, so each child has the card to itself.  Every result
carries the device it ran on.
"""
import json
import sys
import time

import numpy as np

REF_WALL_MK13 = 3.0          # "a few seconds" -> 3 s (README.md:68-72)

# Published dense peaks per device_kind (NVIDIA H100 SXM data sheet:
# int8 1,979 TOP/s, bf16 989 TFLOP/s, HBM3 3.35 TB/s, at 700 W).  A
# device missing here is an error, never a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"int8_tops": 1979.0, "bf16_tflops": 989.0,
                              "hbm_tbs": 3.35},
}


def peaks(device_kind: str) -> dict:
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device {device_kind!r}; "
                       "add its data-sheet numbers to bench.PEAKS")
    return PEAKS[device_kind]


def device_info() -> dict:
    import jax
    from spasm_tpu.profiling import gpu_name_power
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "name_power": gpu_name_power() or "unknown"}


def _rank(A, **kw):
    from spasm_tpu import echelonize, EchelonizeOptions
    opts = EchelonizeOptions(**kw) if kw else None
    return echelonize(A, opts).r


def bench_mk13():
    from spasm_tpu.gen import matching_complex_boundary
    t0 = time.time()
    A = matching_complex_boundary(13, 5)
    gen_s = time.time() - t0
    A = A.transpose()            # the rank tool's auto-transpose (n < m)
    t0 = time.time()
    r1 = _rank(A.copy())
    cold = time.time() - t0
    t0 = time.time()
    r2 = _rank(A)
    warm = time.time() - t0
    assert r1 == r2 == 134211, (r1, r2)   # published rank of mk13.b5
    return {"rank": r1, "gen_s": round(gen_s, 2), "cold_s": round(cold, 2),
            "warm_s": round(warm, 2),
            "nnz": 810810, "n": 270270, "m": 135135}


def bench_mk_ladder():
    """Config-1 size ladder around the headline instance: mk12.b4 and
    mk14.b6 (exact matching-complex boundary matrices, like mk13.b5).
    kneser_10_4_1 itself is NOT reproducible offline: the 'kneser'
    instances of the Dumas collection come from a simplicial family
    whose exact construction (and hence entry layout) is not recoverable
    from the reference repo, and hpac.imag.fr is unreachable — see
    BASELINE.md; the mk ladder covers the same regime (structural-pivot-
    rich boundary matrices at 3 sizes)."""
    from spasm_tpu.gen import matching_complex_boundary
    out = {}
    for n, j, tag in ((12, 4, "mk12.b4"), (14, 6, "mk14.b6")):
        t0 = time.time()
        A = matching_complex_boundary(n, j)
        gen_s = time.time() - t0
        if A.n < A.m:
            A = A.transpose()
        t0 = time.time()
        r = _rank(A.copy())
        warm1 = time.time() - t0
        t0 = time.time()
        r2 = _rank(A)
        warm = min(warm1, time.time() - t0)
        assert r == r2
        out[tag] = {"n": A.n, "m": A.m, "nnz": int(A.nnz), "rank": int(r),
                    "gen_s": round(gen_s, 2), "warm_s": round(warm, 2)}
    return out


def bench_gl7d_workflow():
    """Config 3: GL7d-shaped workload (dense leftmost columns) through
    the reference's published recipe — `vertical_swap` preprocessing,
    then rank with --dense-threshold 0.01
    (/root/reference/README.md:86-91) — end-to-end via the CLI tools."""
    import subprocess
    import os
    import tempfile
    from spasm_tpu.gen import gl7d_like
    from spasm_tpu import sio
    A = gl7d_like(60000, 30000, 42013)
    fd, path = tempfile.mkstemp(suffix=".sms")
    with os.fdopen(fd, "w") as f:
        sio.save_csr(A, f)
    try:
        t0 = time.time()
        sw = subprocess.run(
            [sys.executable, "-m", "spasm_tpu.cli.vertical_swap"],
            stdin=open(path), capture_output=True, text=True, check=True)
        t_swap = time.time() - t0
        t1 = time.time()
        rk = subprocess.run(
            [sys.executable, "-m", "spasm_tpu.cli.rank", "--modulus",
             "42013", "--dense-threshold", "0.01"],
            input=sw.stdout, capture_output=True, text=True, check=True)
        t_rank = time.time() - t1
        wall = time.time() - t0
        rank = int(rk.stdout.strip().split()[-1])
    finally:
        os.unlink(path)
    return {"n": A.n, "m": A.m, "nnz": int(A.nnz), "rank": rank,
            "pipeline_s": round(wall, 2),
            "phases": {"swap_proc_s": round(t_swap, 2),
                       "rank_proc_s": round(t_rank, 2)}}, sw.stdout


def bench_gl7d_in_process(swapped_sms: str, rank: int):
    """In-process parse and engine wall of the GL7d workflow's rank
    step, isolating the subprocesses' startup + compile."""
    import io
    from spasm_tpu import sio, echelonize, EchelonizeOptions
    t0 = time.time()
    Av, _ = sio.load_csr(io.StringIO(swapped_sms), 42013)
    t_parse = time.time() - t0
    t0 = time.time()
    r2 = echelonize(Av, EchelonizeOptions(sparsity_threshold=0.01)).r
    t_engine = time.time() - t0
    assert r2 == rank
    return {"parse_s": round(t_parse, 2), "engine_s": round(t_engine, 2)}


def bench_synthetic(n, w=8, p=42013):
    from spasm_tpu.gen import synthetic_sparse
    A = synthetic_sparse(n, n, w, p)
    t0 = time.time()
    _rank(A.copy())
    cold = time.time() - t0
    t0 = time.time()
    r = _rank(A)
    warm = time.time() - t0
    return {"n": n, "nnz": int(A.nnz), "rank": int(r),
            "cold_s": round(cold, 2), "warm_s": round(warm, 2),
            "nnz_per_s_warm": round(A.nnz / warm, 1)}


def bench_trefethen():
    from spasm_tpu import sio
    A, _ = sio.load_csr("tests/Matrix/trefethen_2000.sms", 42013)
    t0 = time.time()
    r = _rank(A.copy())
    cold = time.time() - t0
    t0 = time.time()
    _rank(A)
    warm = time.time() - t0
    return {"rank": int(r), "cold_s": round(cold, 2),
            "warm_s": round(warm, 2)}


def bench_spmv_trisolve():
    """Config 2: SpMV + batched sparse triangular solves."""
    from spasm_tpu import sio
    from spasm_tpu.spmv import xApy
    from spasm_tpu.schur import solve_rows
    from spasm_tpu import echelonize
    A, _ = sio.load_csr("tests/Matrix/trefethen_2000.sms", 42013)
    rng = np.random.default_rng(0)
    x = rng.integers(-21006, 21006, A.n).astype(np.int32)
    y = np.zeros(A.m, np.int64)
    t0 = time.time()
    reps = 50
    for _ in range(reps):
        y[:] = 0
        xApy(x, A, y)
    spmv_s = (time.time() - t0) / reps
    fact = echelonize(A.copy())
    U, qinv = fact.U, fact.qinv
    rows = np.arange(min(1000, A.n))
    t0 = time.time()
    solve_rows(U, A, rows, qinv, A.prime)
    tri_s = time.time() - t0
    return {"spmv_nnz_per_s": round(A.nnz / spmv_s, 1),
            "trisolve_rows_per_s": round(len(rows) / tri_s, 1)}


def bench_pluq_gesv_kernel():
    """Config 4: full PLUQ + system solve + kernel basis.

    gesv: 1024 RHS rows (the reference's row-parallel workhorse,
    /root/reference/src/spasm_solve.c:52-93).  kernel: a genuinely
    rank-deficient instance (n x n+512 synthetic, kernel_dim >= 512 —
    the analog of the reference's kernel.c property tests on singular
    fixtures)."""
    from spasm_tpu import sio, echelonize, EchelonizeOptions, gesv, kernel
    from spasm_tpu.csr import CSR
    from spasm_tpu.gen import synthetic_sparse
    A, _ = sio.load_csr("tests/Matrix/medium.sms", 42013)
    t0 = time.time()
    fact = echelonize(A.copy(), EchelonizeOptions(L=True, complete=True))
    pluq_s = time.time() - t0
    rng = np.random.default_rng(1)
    NRHS = 1024
    X = rng.integers(0, 42013, (NRHS, A.n)).astype(np.int64)
    B = CSR.from_dense((X @ A.todense().astype(np.int64)) % 42013, 42013)
    t0 = time.time()
    gesv(fact, B)
    gesv_s = time.time() - t0
    # rank-deficient instance: n x (n + 512) => kernel dim >= 512
    Ak = synthetic_sparse(2048, 2560, 8, 42013)
    fk = echelonize(Ak.copy())
    t0 = time.time()
    K = kernel(fk)
    kernel_s = time.time() - t0
    assert K.n == Ak.m - fk.r and K.n >= 512
    # complete PLUQ at scale: 16000^2 synthetic, device-resident
    # factors (round-3's host path measured 320.8 s on this instance)
    A16 = synthetic_sparse(16000, 16000, 8, 42013)
    opts16 = EchelonizeOptions(L=True, complete=True)
    f16 = echelonize(A16.copy(), opts16)      # compile pass
    t0 = time.time()
    f16 = echelonize(A16.copy(), opts16)
    pluq16k_s = time.time() - t0
    return {"pluq_s": round(pluq_s, 3),
            "pluq16k_warm_s": round(pluq16k_s, 2),
            "pluq16k_rank": int(f16.r),
            "gesv_rhs": NRHS, "gesv_s": round(gesv_s, 3),
            "kernel_s": round(kernel_s, 3), "kernel_dim": int(K.n)}


def _scc_banded(n: int, blk: int, extra: int, p: int):
    """n x n instance with ~n/blk SCCs of size blk: unit diagonal, a
    superdiagonal within each block, a band-closing entry per block, and
    `extra` random strictly-upper entries (cross-SCC DAG edges)."""
    from spasm_tpu.csr import COO
    rng = np.random.default_rng(7)
    di = np.arange(n)
    sup_i = np.asarray([i for i in range(n) if (i + 1) % blk], np.int64)
    sup_j = sup_i + 1
    base = np.arange(0, n - blk + 1, blk)
    close_i, close_j = base, base + blk - 1          # cycle closers
    xi = rng.integers(0, n - 1, extra)
    xj = rng.integers(1, n, extra)
    up = xi < xj
    # within-block chain points UP (i -> i+1); the closer points DOWN
    # (base+blk-1 -> base), so each block is one directed cycle = 1 SCC
    rows = np.concatenate([di, sup_i, close_j, xi[up]])
    cols = np.concatenate([di, sup_j, close_i, xj[up]])
    vals = rng.integers(1, p, rows.size)
    T = COO.from_entries(n, n, p, rows, cols, vals)
    return T.tocsr()


def bench_dm_cert():
    """Config 5: DM + SCC + rank certificates at >= 1e5 rows
    (round-4 verdict task 6): 120k x 120k with 15k SCC blocks through
    DM, and a full certificate roundtrip on a 120k-row factorization."""
    from spasm_tpu import (sio, dulmage_mendelsohn, echelonize,
                           EchelonizeOptions, rank_certificate_create,
                           rank_certificate_verify)
    import hashlib
    N = 120_000
    A = _scc_banded(N, 8, 4 * N, 42013)
    t0 = time.time()
    dm = dulmage_mendelsohn(A)
    dm_s = time.time() - t0
    # certificate on a 120k full-rank instance whose pivots are all
    # structural (upper-triangular + random upper fill) — the timed
    # section is the certificate roundtrip, not the factorization
    from spasm_tpu.csr import COO
    rng = np.random.default_rng(11)
    di = np.arange(N)
    xi = rng.integers(0, N - 1, 4 * N)
    xj = rng.integers(1, N, 4 * N)
    keep = xi < xj
    T = COO.from_entries(N, N, 42013,
                         np.concatenate([di, xi[keep]]),
                         np.concatenate([di, xj[keep]]),
                         rng.integers(1, 42013, N + int(keep.sum())))
    T.n = T.m = N
    Ac = T.tocsr()
    fp = hashlib.sha256(b"dm_cert_bench").digest()
    fact = echelonize(Ac.copy(),
                      EchelonizeOptions(L=True, complete=True))
    t0 = time.time()
    cert = rank_certificate_create(Ac, fp, fact)
    ok = rank_certificate_verify(Ac, fp, cert)
    cert_s = time.time() - t0
    # keep the fixture-scale smoke numbers too
    As, _ = sio.load_csr("tests/Matrix/dm.sms", 42013)
    t0 = time.time()
    dulmage_mendelsohn(As)
    dm_small_s = time.time() - t0
    return {"n": N, "dm_s": round(dm_s, 2), "dm_blocks": int(dm.nb),
            "cert_roundtrip_s": round(cert_s, 2), "cert_ok": bool(ok),
            "cert_rank": int(cert.r), "dm_small_s": round(dm_small_s, 3)}


def bench_published_workflows():
    """The reference's published hard-instance regimes, end-to-end via
    the CLI tools (round-4 verdict task 7):
      * relat8-shaped — huge advertized dimensions with many empty
        rows/columns, requiring `stack` preprocessing before rank
        (/root/reference/README.md:80-84);
      * M0,6-D9-shaped — rank with the greedy pivot search disabled
        (/root/reference/README.md:75-78)."""
    import os
    import subprocess
    import tempfile
    from spasm_tpu.csr import COO
    from spasm_tpu import sio
    from spasm_tpu.gen import synthetic_sparse
    out = {}
    rng = np.random.default_rng(3)
    N, M_, ln, lm, nnz = 250_000, 120_000, 80_000, 50_000, 600_000
    lr = rng.choice(N, ln, replace=False)
    lc = rng.choice(M_, lm, replace=False)
    T = COO.from_entries(N, M_, 42013, lr[rng.integers(0, ln, nnz)],
                         lc[rng.integers(0, lm, nnz)],
                         rng.integers(1, 42013, nnz))
    T.n, T.m = N, M_
    A = T.tocsr()
    fd, path = tempfile.mkstemp(suffix=".sms")
    with os.fdopen(fd, "w") as f:
        sio.save_csr(A, f)
    try:
        t0 = time.time()
        st = subprocess.run(
            [sys.executable, "-m", "spasm_tpu.cli.stack"],
            stdin=open(path), capture_output=True, text=True, check=True)
        rk = subprocess.run(
            [sys.executable, "-m", "spasm_tpu.cli.rank", "--modulus",
             "42013"], input=st.stdout, capture_output=True, text=True,
            check=True)
        out["relat_like_stack_rank"] = {
            "n": N, "m": M_, "nnz": int(A.nnz),
            "rank": int(rk.stdout.strip().split()[-1]),
            "pipeline_s": round(time.time() - t0, 2)}
    finally:
        os.unlink(path)
    B = synthetic_sparse(60_000, 30_000, 10, 42013, seed=77)
    fd, path = tempfile.mkstemp(suffix=".sms")
    with os.fdopen(fd, "w") as f:
        sio.save_csr(B, f)
    try:
        t0 = time.time()
        rk = subprocess.run(
            [sys.executable, "-m", "spasm_tpu.cli.rank", "--modulus",
             "42013", "--no-greedy-pivot-search"],
            stdin=open(path), capture_output=True, text=True, check=True)
        out["m06d9_like_no_greedy"] = {
            "n": B.n, "m": B.m, "nnz": int(B.nnz),
            "rank": int(rk.stdout.strip().split()[-1]),
            "pipeline_s": round(time.time() - t0, 2)}
    finally:
        os.unlink(path)
    return out


def bench_int8(peak_int8_tops: float):
    """int8 matmul utilization + exact-GF(p) matmul throughput (the
    reference's FFPACK peak-FLOPs surface, spasm_ffpack.cpp)."""
    import jax
    import jax.numpy as jnp
    n = 8192
    Ai = jax.jit(lambda: jnp.ones((n, n), jnp.int8))()
    dot = jax.jit(lambda A: jax.lax.dot_general(
        A, A, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32).astype(jnp.int8))
    Y = jax.block_until_ready(dot(Ai))
    t0 = time.time()
    Y = Ai
    reps = 10
    for _ in range(reps):
        Y = dot(Y)
    jax.block_until_ready(Y)
    dt = (time.time() - t0) / reps
    tops = 2 * n ** 3 / dt / 1e12
    # exact GF(p) matmul (d=2 digit tier): useful-op rate = n^3 MACs
    from spasm_tpu.dense.modp import modp_matmul
    p = 42013
    Xi = jax.jit(lambda k: jax.random.randint(
        k, (n, n), -p // 2, p // 2, jnp.int32))(jax.random.PRNGKey(0))
    Z = jax.block_until_ready(modp_matmul(Xi, Xi, p))
    t0 = time.time()
    reps = 20
    for _ in range(reps):
        Z = modp_matmul(Z, Z, p)
    jax.block_until_ready(Z)
    gf_dt = (time.time() - t0) / reps
    gf_gops = 2 * n ** 3 / gf_dt / 1e9
    # one exact GF(p) MAC costs 4 int8 MACs in the d=2 digit scheme, so
    # the achievable ceiling is peak/4; report utilization against it
    return {"int8_tops": round(tops, 1),
            "int8_util_pct": round(100 * tops / peak_int8_tops, 1),
            "gfp_matmul_gops": round(gf_gops, 1),
            "gfp_int8_util_pct": round(
                100 * 4 * gf_gops / 1000 / peak_int8_tops, 1)}


def main():
    import logging
    logging.getLogger("spasm_tpu").setLevel(logging.WARNING)

    quick = "--quick" in sys.argv
    detail = {}
    if not quick:
        # fresh-process cells first: this process stays off the device
        # until they end, so each child has the card to itself
        gl7d, swapped = bench_gl7d_workflow()
        detail["config3_gl7d_workflow"] = gl7d
        detail["published_workflows"] = bench_published_workflows()

    def _gc():
        # long benchmark processes fragment HBM; collect dropped device
        # buffers between configs so the big PLUQ/finisher allocations
        # get contiguous space
        import gc
        gc.collect()

    dev = device_info()
    detail["device"] = dev
    detail["int8"] = bench_int8(peaks(dev["kind"])["int8_tops"])
    _gc()
    if not quick:
        gl7d["phases"].update(bench_gl7d_in_process(swapped, gl7d["rank"]))
        _gc()
    detail["config2_spmv_trisolve"] = bench_spmv_trisolve()
    _gc()
    detail["trefethen_2000"] = bench_trefethen()
    _gc()
    detail["config3_synthetic"] = {
        "n4000": bench_synthetic(4000),
        "n16000": bench_synthetic(16000) if not quick else None,
    }
    _gc()
    detail["config4_pluq_gesv_kernel"] = bench_pluq_gesv_kernel()
    _gc()
    detail["config5_dm_cert"] = bench_dm_cert()
    _gc()
    mk13 = bench_mk13() if not quick else {"warm_s": float("nan")}
    detail["mk13_b5"] = mk13
    _gc()
    if not quick:
        detail["config1_mk_ladder"] = bench_mk_ladder()

    vs = REF_WALL_MK13 / mk13["warm_s"]
    print(f"device: {dev['platform']} {dev['kind']} x{dev['count']} "
          f"({dev['name_power']})")
    out = {
        "metric": "mk13.b5_rank_warm_wall",
        "value": mk13["warm_s"],
        "unit": "s",
        "vs_baseline": round(vs, 3),
        "detail": detail,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
