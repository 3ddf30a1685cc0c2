#!/usr/bin/env python3
"""Smoke run of spasm_tpu's main path on one NVIDIA GPU.

Run from the repository root:

    python chip_smoke.py              # phases a-f on one card
    python chip_smoke.py --four       # phase g only, on four cards
    python chip_smoke.py --trace DIR  # also trace one warm mk13.b5 run

Phases (one line each; any failure, a wrong rank included, exits 1):
  a. the published GL7d recipe as fresh CLI processes (vertical_swap ->
     rank --dense-threshold 0.01) while this process stays off the card;
     the stack / vertical_swap / transpose filters must not start JAX;
  b. exact GF(p) matmul at the digit tiers d = 2, 3, 4 against a numpy
     reference (exact equality), GF(p)-MAC/s at 8192^2, and what XLA made
     of the engine's int8 dots;
  c. the rank of mk13.b5 (135135 x 270270, published rank 134211)
     through `echelonize`: cold and warm wall, finisher, stage clocks,
     peak device memory;
  d. complete PLUQ of a 16k synthetic matrix with factorization_verify,
     and gesv with 1024 right-hand sides checked by X.A == B;
  e. the device finisher at p = 2^32 - 5: certificate roundtrip, and the
     rank equal to the host finishers';
  f. rref_rows_device, the blocked dense RREF and the mk13.b5
     ReducedBasis against plain host references, exactly;
  g. (--four only) the mesh path on four cards against one card.

Every phase line ends with the card's name and power limit.  HLO dumps
(and, with --trace, a trace summary) go to chiprun_out/chip_smoke/.  Only when
every phase passed is the last line of stdout
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
Without a GPU, or without the native library, it fails before any phase.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import logging
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

SIZES = {
    "full": dict(gl7d=(60000, 30000), mm=2048, mm_rate=8192, mk=(13, 5),
                 mk_rank=134211, mk_dense_min=None, pluq=16000,
                 gesv_rhs=1024, e_n=16000, rref=(256, 22528), proj=64,
                 dense=(4096, 8192), census=(22528, 4096, 2048, 4096),
                 elim=(512, 1024)),
    # for the CPU rehearsal in the tests: the same phases at sizes a CPU
    # runs in seconds (the device finisher forced, the host finishers
    # deciding the rank)
    "tiny": dict(gl7d=(600, 300), mm=96, mm_rate=128, mk=(9, 3),
                 mk_rank=None, mk_dense_min=0, pluq=300, gesv_rhs=16,
                 e_n=400, rref=(64, 512), proj=4, dense=(128, 256),
                 census=(512, 64, 64, 128), elim=(64, 128)),
}
# the largest primes of the d = 2 and d = 3 digit tiers are 65269 and
# 16711421; 67108859 and 2^32 - 5 are d = 4 (reference moduli grid)
MATMUL_PRIMES = (42013, 16711421, 67108859, 4294967291)   # d = 2, 3, 4, 4
BIG_P = 4294967291
HERE = os.path.dirname(os.path.abspath(__file__))

_FILTER_PROBE = (
    "import runpy, sys\n"
    "from jax._src import xla_bridge\n"
    "mod = sys.argv[1]\n"
    "sys.argv = [mod]\n"
    "code = 0\n"
    "try:\n"
    "    runpy.run_module(mod, run_name='__main__')\n"
    "except SystemExit as e:\n"
    "    code = e.code or 0\n"
    "sys.stdout.flush()\n"
    "print('backend_initialized=%s' % xla_bridge.backends_are_initialized(),"
    " file=sys.stderr)\n"
    "sys.exit(code)\n")


class PhaseError(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def probe_devices():
    """(platform, count) as a fresh JAX process sees them, without
    reserving the card's memory."""
    env = dict(os.environ, XLA_PYTHON_CLIENT_PREALLOCATE="false")
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax; d = jax.devices(); print(d[0].platform, len(d))"],
        capture_output=True, text=True, env=env, timeout=300)
    if r.returncode != 0:
        return "none", 0
    plat, count = r.stdout.split()[-2:]
    return plat, int(count)


# -- spies on the engine ----------------------------------------------------

_FINISHERS = ("finish_device_dense", "finish_dense", "finish_dense_lowrank",
              "finish_gplu")


@contextlib.contextmanager
def spy_finishers():
    """Record which finishers of the engine run inside the block."""
    em = sys.modules["spasm_tpu.echelonize"]
    ran = []
    orig = {name: getattr(em._Engine, name) for name in _FINISHERS}

    def wrap(name, fn):
        def spy(self, *a, **kw):
            ran.append(name)
            return fn(self, *a, **kw)
        return spy

    for name, fn in orig.items():
        setattr(em._Engine, name, wrap(name, fn))
    try:
        yield ran
    finally:
        for name, fn in orig.items():
            setattr(em._Engine, name, fn)


@contextlib.contextmanager
def capture_reduced_basis(store: dict):
    """Keep the last ReducedBasis built inside the block, with copies of
    its host inputs."""
    from spasm_tpu.dense.reduced import ReducedBasis
    orig = ReducedBasis.build

    def spy(self, offs, cols, vals, pivcols, groups):
        orig(self, offs, cols, vals, pivcols, groups)
        store["rb"] = self
        store["args"] = tuple(np.array(a, copy=True) for a in
                              (offs, cols, vals, pivcols, groups))

    ReducedBasis.build = spy
    try:
        yield store
    finally:
        ReducedBasis.build = orig


class LogCapture(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


# -- phases -----------------------------------------------------------------

def phase_a(sz, work):
    """CLI recipe in fresh processes; this process is off the card."""
    from spasm_tpu import sio
    from spasm_tpu.gen import gl7d_like
    n, m = sz["gl7d"]
    A = gl7d_like(n, m, 42013)
    src = os.path.join(work, "gl7d_like.sms")
    with open(src, "w") as f:
        sio.save_csr(A, f)
    walls = {}
    for tool in ("vertical_swap", "stack", "transpose"):
        dst = os.path.join(work, f"{tool}.sms")
        t0 = time.perf_counter()
        with open(src) as fi, open(dst, "w") as fo:
            r = subprocess.run([sys.executable, "-c", _FILTER_PROBE,
                                f"spasm_tpu.cli.{tool}"], stdin=fi,
                               stdout=fo, stderr=subprocess.PIPE, text=True,
                               cwd=HERE)
        walls[tool] = time.perf_counter() - t0
        check(r.returncode == 0, f"{tool} failed: {r.stderr[-2000:]}")
        check("backend_initialized=False" in r.stderr,
              f"{tool} initialised a JAX backend")
    t0 = time.perf_counter()
    with open(os.path.join(work, "vertical_swap.sms")) as fi:
        r = subprocess.run(
            [sys.executable, "-m", "spasm_tpu.cli.rank", "--modulus",
             "42013", "--dense-threshold", "0.01"], stdin=fi,
            capture_output=True, text=True, cwd=HERE)
    t_rank = time.perf_counter() - t0
    check(r.returncode == 0, f"rank failed: {r.stderr[-3000:]}")
    rank = int(r.stdout.split()[-1])
    check(0 < rank <= min(n, m), f"rank {rank} out of range")
    return (f"gl7d_like {n}x{m} nnz={A.nnz} rank={rank} "
            f"swap_s={walls['vertical_swap']:.3f} rank_proc_s={t_rank:.3f} "
            f"pipeline_s={walls['vertical_swap'] + t_rank:.3f} "
            f"filters_backend_free=yes"), {"gl7d_rank": rank}


def _gemm_census(hlo: str) -> dict:
    """How the dots of an optimized HLO module were lowered: cuBLAS
    calls, and dots left inside fusions (XLA:GPU's Triton GEMMs)."""
    return {"cublas": hlo.count('custom_call_target="__cublas$gemm"')
            + hlo.count('custom_call_target="__cublas$lt$matmul'),
            "fused_dots": sum(1 for ln in hlo.splitlines() if " dot(" in ln),
            "triton": "__triton" in hlo}


def _engine_dot_census(sz, out_dir):
    """Lower the engine's hot programs at mk13.b5 widths (finisher
    width M, round height B, a dense block) and count what their int8
    dots became."""
    import jax
    import jax.numpy as jnp
    from spasm_tpu.dense import elim, rowrref
    from spasm_tpu.dense.modp import device_field
    F = device_field(42013)
    sd = jax.ShapeDtypeStruct
    w = sd((3,), jnp.int64)
    p = sd((), jnp.int64)
    M, B, dn, dm = sz["census"]
    cap = 2 * rowrref._CHUNK
    progs = {
        "basis_apply_at": rowrref._basis_apply_at.lower(
            sd((B, M), jnp.int16), sd((cap, M), jnp.int16),
            sd((cap,), jnp.int64), sd((), jnp.int32), p, w, d=2),
        "rref_rows": rowrref._rref_rows.lower(
            sd((B, M), jnp.int16), p, w, d=2, nb=min(512, B),
            sweep_small=True),
        "eliminate": elim._eliminate.lower(
            sd((dn, dm), jnp.int32), p, w, d=F.ndigits, rref=True,
            nb=64, sweep_small=True),
    }
    out = {}
    for name, low in progs.items():
        hlo = low.compile().as_text()
        if out_dir:
            with open(os.path.join(out_dir, f"hlo_{name}.txt"), "w") as f:
                f.write(hlo)
        out[name] = _gemm_census(hlo)
    return out


def phase_b(sz, out_dir):
    """Exact GF(p) matmul at every digit tier; rates; dot lowering."""
    import jax
    import jax.numpy as jnp
    from spasm_tpu.dense import reference as ref
    from spasm_tpu.dense.modp import device_field, modp_matmul
    n, N = sz["mm"], sz["mm_rate"]
    parts = []
    tiers = {device_field(p).ndigits for p in MATMUL_PRIMES}
    check(tiers == {2, 3, 4}, f"digit tiers covered: {sorted(tiers)}")
    for p in MATMUL_PRIMES:
        d = device_field(p).ndigits
        rng = np.random.default_rng(p % 9973)
        h = p // 2
        A = rng.integers(-h, h + 1, (n, n)).astype(np.int32)
        B = rng.integers(-h, h + 1, (n, n)).astype(np.int32)
        C = np.asarray(jax.block_until_ready(modp_matmul(A, B, p)))
        exact = np.array_equal(C.astype(np.int64), ref.matmul_modp(A, B, p))
        check(exact, f"modp_matmul p={p} d={d} differs from the reference")
        kx, ky = jax.random.split(jax.random.PRNGKey(p % 9973))
        X = jax.random.randint(kx, (N, N), -h, h + 1, jnp.int32)
        Y = jax.random.randint(ky, (N, N), -h, h + 1, jnp.int32)
        jax.block_until_ready(modp_matmul(X, Y, p))           # compile
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            Z = modp_matmul(X, Y, p)
        jax.block_until_ready(Z)
        dt = (time.perf_counter() - t0) / reps
        parts.append(f"p={p} d={d} exact={n}^3 "
                     f"gfp_mac_per_s@{N}^2={N ** 3 / dt:.6e}")
    census = _engine_dot_census(sz, out_dir)
    return "; ".join(parts) + f"; dots={json.dumps(census)}", {}


def phase_c(sz, store, trace_dir, out_dir):
    """mk13.b5 rank through echelonize."""
    import jax
    from spasm_tpu import EchelonizeOptions, echelonize
    from spasm_tpu.gen import matching_complex_boundary
    A = matching_complex_boundary(*sz["mk"])
    if A.n < A.m:
        A = A.transpose()                # the rank tool's auto-transpose
    opts = (EchelonizeOptions() if sz["mk_dense_min"] is None
            else EchelonizeOptions(device_dense_min=sz["mk_dense_min"]))
    with spy_finishers() as ran:
        t0 = time.perf_counter()
        r_cold = echelonize(A.copy(), opts).r
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        r_warm = echelonize(A.copy(), opts).r
        warm = time.perf_counter() - t0
    want = sz["mk_rank"]
    if want is None:                     # tiny: the host finishers decide
        want = echelonize(A.copy(),
                          EchelonizeOptions(device_dense_width=0)).r
    check(r_cold == r_warm == want, f"rank {r_cold}/{r_warm} != {want}")
    cap = LogCapture()
    log = logging.getLogger("spasm_tpu")
    log.addHandler(cap)
    os.environ["SPASM_PROFILE_FINISH"] = "1"
    try:
        with capture_reduced_basis(store):
            r_prof = echelonize(A.copy(), opts).r
    finally:
        del os.environ["SPASM_PROFILE_FINISH"]
        log.removeHandler(cap)
    check(r_prof == want, f"profiled rank {r_prof} != {want}")
    stages = [ln.split("profile: ", 1)[1] for ln in cap.lines
              if ln.startswith("[finish/device] profile:")]
    peak = jax.devices()[0].memory_stats() or {}
    line = (f"mk{sz['mk'][0]}.b{sz['mk'][1]} {A.n}x{A.m} nnz={A.nnz} "
            f"rank={r_cold} cold_s={cold:.3f} warm_s={warm:.3f} "
            f"finisher={'+'.join(sorted(set(ran)))} "
            f"stage_s={stages[-1] if stages else 'none'} "
            f"peak_bytes_in_use={peak.get('peak_bytes_in_use', 'n/a')} "
            f"bytes_limit={peak.get('bytes_limit', 'n/a')}")
    if trace_dir:
        with jax.profiler.trace(trace_dir):
            r_tr = echelonize(A.copy(), opts).r
        check(r_tr == want, "traced rank differs")
        line += f" trace={trace_summary(trace_dir, out_dir)}"
    return line, {}


def trace_summary(trace_dir, out_dir, top=25):
    """Busy share of the GPU and the kernels that took the most device
    time, from the newest xplane file under trace_dir."""
    import glob
    import jax
    files = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not files:
        return "no-trace"
    pd = jax.profiler.ProfileData.from_file(files[-1])
    per_name, spans = {}, []
    for plane in pd.planes:
        if "/device:GPU:0" not in plane.name:
            continue
        for line in plane.lines:
            if "stream" not in line.name.lower():
                continue
            for ev in line.events:
                per_name[ev.name] = per_name.get(ev.name, 0.0) \
                    + ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not spans:
        return "no-device-events"
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    rows = sorted(per_name.items(), key=lambda kv: -kv[1])[:top]
    with open(os.path.join(out_dir, "trace_summary.txt"), "w") as f:
        f.write(f"window_ns={window} busy_ns={busy} kernels={len(spans)}\n")
        for name, ns in rows:
            f.write(f"{ns:.0f}\t{name}\n")
    return (f"busy_share={busy / window:.4f} kernels={len(spans)} "
            f"window_s={window / 1e9:.4f}")


def phase_d(sz):
    """Complete PLUQ + factorization_verify; gesv checked by X.A == B."""
    from spasm_tpu import (EchelonizeOptions, echelonize,
                           factorization_verify, gesv, sio)
    from spasm_tpu.csr import CSR
    from spasm_tpu.gen import synthetic_sparse
    n = sz["pluq"]
    A = synthetic_sparse(n, n, 8, 42013)
    opts = EchelonizeOptions(L=True, complete=True)
    t0 = time.perf_counter()
    f = echelonize(A.copy(), opts)
    t_pluq = time.perf_counter() - t0
    t0 = time.perf_counter()
    ok = all(factorization_verify(A, f, seed) for seed in (42, 1337))
    t_ver = time.perf_counter() - t0
    check(ok, "factorization_verify failed (A != L.U)")
    p = 42013
    M, _ = sio.load_csr(os.path.join(HERE, "tests", "Matrix", "medium.sms"),
                        p)
    fm = echelonize(M.copy(), opts)
    rng = np.random.default_rng(1)
    X = rng.integers(0, p, (sz["gesv_rhs"], M.n)).astype(np.int64)
    Md = M.todense().astype(np.int64)
    Bd = (X @ Md) % p
    B = CSR.from_dense(Bd, p)
    t0 = time.perf_counter()
    Xs, oks = gesv(fm, B)
    t_gesv = time.perf_counter() - t0
    check(oks is None or bool(np.all(oks)), "gesv: a right-hand side failed")
    XA = (Xs.todense().astype(np.int64) % p) @ Md % p
    check(np.array_equal(XA, Bd), "gesv: X.A != B")
    return (f"pluq n={n} rank={f.r} pluq_s={t_pluq:.3f} "
            f"factorization_verify=ok verify_s={t_ver:.3f}; gesv "
            f"medium.sms {M.n}x{M.m} rhs={B.n} gesv_s={t_gesv:.3f} "
            f"XA==B"), {}


def phase_e(sz):
    """The device finisher at p = 2^32 - 5."""
    from spasm_tpu import (EchelonizeOptions, echelonize,
                           rank_certificate_create, rank_certificate_verify)
    from spasm_tpu.gen import synthetic_sparse
    n = sz["e_n"]
    A = synthetic_sparse(n, n, 8, BIG_P)
    forced = False
    with spy_finishers() as ran:
        t0 = time.perf_counter()
        r_dev = echelonize(A.copy()).r
        t_dev = time.perf_counter() - t0
    if "finish_device_dense" not in ran:
        forced = True
        with spy_finishers() as ran:
            t0 = time.perf_counter()
            r_dev = echelonize(A.copy(),
                               EchelonizeOptions(device_dense_min=0)).r
            t_dev = time.perf_counter() - t0
    check("finish_device_dense" in ran,
          f"device finisher did not run ({ran})")
    with spy_finishers() as ran_host:
        r_host = echelonize(A.copy(),
                            EchelonizeOptions(device_dense_width=0)).r
    check(r_dev == r_host, f"device rank {r_dev} != host rank {r_host}")
    h = hashlib.sha256(b"chip_smoke phase e").digest()
    t0 = time.perf_counter()
    fL = echelonize(A.copy(), EchelonizeOptions(L=True))
    cert = rank_certificate_create(A, h, fL)
    ok = rank_certificate_verify(A, h, cert)
    t_cert = time.perf_counter() - t0
    check(ok and cert.r == r_dev,
          f"certificate: verify={ok} r={cert.r} vs {r_dev}")
    return (f"p={BIG_P} n={n} rank={r_dev} device_finisher=ran"
            f"{' (device_dense_min=0)' if forced else ''} "
            f"device_s={t_dev:.3f} host_rank={r_host} "
            f"host_finishers={'+'.join(sorted(set(ran_host)))} "
            f"certificate=ok cert_s={t_cert:.3f}"), {}


def phase_f(sz, store):
    """Row-sweep RREF, blocked dense RREF and the reduced basis against
    host references."""
    import jax
    import jax.numpy as jnp
    from spasm_tpu.dense import reference as ref
    from spasm_tpu.dense.elim import dense_rref
    from spasm_tpu.dense.modp import modp_matmul, storage_dtype
    from spasm_tpu.dense.rowrref import rref_rows_device
    B, M = sz["rref"]
    parts = []
    for p in (42013, BIG_P):                 # the blocked column sweep
        rng = np.random.default_rng(p % 4099)
        n, m = sz["elim"]
        S = rng.integers(-(p // 2), p // 2 + 1, (n, m)).astype(np.int32)
        S[n // 2:n // 2 + n // 8] = S[:n // 8]
        R_dev, piv_dev = dense_rref(S, p, force="device")
        R_host, piv_host = dense_rref(S, p, force="host")
        check(np.array_equal(piv_dev, piv_host)
              and np.array_equal(R_dev, R_host),
              f"dense_rref differs from the host sweep at p={p}")
        n, m = sz["dense"]
        S = rng.integers(-(p // 2), p // 2 + 1, (n, m)).astype(np.int32)
        dense_rref(S, p, force="device")             # compile
        t0 = time.perf_counter()
        dense_rref(S, p, force="device")
        t_warm = time.perf_counter() - t0
        parts.append(f"dense_rref p={p} {sz['elim'][0]}x{sz['elim'][1]} "
                     f"exact==host; {n}x{m} warm_s={t_warm:.3f} "
                     f"per_column_us={t_warm / m * 1e6:.2f}")
    for p in (42013, BIG_P):
        rng = np.random.default_rng(p % 7919)
        X = rng.integers(-(p // 2), p // 2 + 1, (B, M))
        X[B // 2:B // 2 + 8] = X[:8]              # planted dependence
        X[:, -1] = 0                              # the dead column
        X = ref.balanced(X, p)
        t0 = time.perf_counter()
        R, piv = rref_rows_device(jnp.asarray(X.astype(storage_dtype(p))), p)
        t_dev = time.perf_counter() - t0
        want_R, want_piv = ref.rref_rows(X, p)
        check(np.array_equal(piv, want_piv), f"pivots differ at p={p}")
        check(np.array_equal(np.asarray(R).astype(np.int64), want_R),
              f"RREF rows differ at p={p}")
        parts.append(f"rref_rows ({B},{M}) p={p} rank={(piv >= 0).sum()} "
                     f"exact dev_s={t_dev:.3f}")
    rb = store.get("rb")
    check(rb is not None, "phase c built no ReducedBasis")
    offs, cols, vals, pivcols, groups = store["args"]
    p = rb.prime
    rng = np.random.default_rng(64)
    k = sz["proj"]
    Xp = rng.integers(-(p // 2), p // 2 + 1, (rb.nq, k))
    Xpad = np.zeros((rb.M, k), np.int32)
    Xpad[:rb.nq] = Xp
    Xd = jnp.asarray(Xpad)
    got = []
    for r0 in range(0, rb.npiv, 16384):
        got.append(np.asarray(jax.block_until_ready(modp_matmul(
            rb.R[r0:min(r0 + 16384, rb.npiv)], Xd, p))))
    got = np.concatenate(got).astype(np.int64)
    want = ref.reduced_basis(offs, cols, vals, pivcols, groups, rb.qfree, p,
                             Xp)
    check(np.array_equal(got, want), "R.x differs from the host model")
    parts.append(f"reduced_basis npiv={rb.npiv} nfree={rb.nq} "
                 f"R.x==host on {k} vectors")
    return "; ".join(parts), {}


def phase_g(sz, devices):
    """The mesh path on four devices against one device."""
    import jax.numpy as jnp
    from spasm_tpu import EchelonizeOptions, echelonize
    from spasm_tpu.csr import COO
    from spasm_tpu.dense import elim
    from spasm_tpu.dense.elim import dense_rref
    from spasm_tpu.gen import gl7d_like
    from spasm_tpu.parallel.context import shard_cols, use_mesh
    from spasm_tpu.parallel.dist import make_mesh
    check(len(devices) >= 4, f"need 4 devices, have {len(devices)}")
    mesh = make_mesh(devices=devices[:4])
    n, m = sz["gl7d"]
    A = gl7d_like(n, m, 42013)
    T = COO.from_entries(n, m, 42013, np.repeat(np.arange(n), np.diff(
        A.indptr)), m - 1 - A.indices[:A.nnz].astype(np.int64),
        A.data[:A.nnz])                           # vertical_swap
    T.n, T.m = n, m
    A = T.tocsr()
    opts = EchelonizeOptions(sparsity_threshold=0.01)
    t0 = time.perf_counter()
    r1 = echelonize(A.copy(), opts).r
    t1 = time.perf_counter() - t0
    store = {}
    with use_mesh(mesh), capture_reduced_basis(store), \
            spy_finishers() as ran:
        t0 = time.perf_counter()
        r4 = echelonize(A.copy(), opts).r
        t4 = time.perf_counter() - t0
    check(r1 == r4, f"mesh rank {r4} != one-device rank {r1}")
    rb_devs = (len(store["rb"].R.sharding.device_set) if "rb" in store
               else 0)
    p = 42013
    rng = np.random.default_rng(4)
    rows, cols = sz["dense"]
    S = rng.integers(-(p // 2), p // 2 + 1, (rows, cols)).astype(np.int32)
    S[rows // 2:rows // 2 + rows // 8] = S[:rows // 8]   # rank deficiency
    t0 = time.perf_counter()
    want_R, want_piv = dense_rref(S, p, force="device")
    d1 = time.perf_counter() - t0
    with use_mesh(mesh):
        spread = len(shard_cols(jnp.asarray(S)).sharding.device_set)
        Sf = elim._run(S, p, True, elim._NB)[0]
        sf_devs = len(Sf.sharding.device_set)
        t0 = time.perf_counter()
        got_R, got_piv = dense_rref(S, p, force="device")
        d4 = time.perf_counter() - t0
    check(spread == 4 and sf_devs == 4,
          f"column sharding spans {spread}/{sf_devs} devices, not 4")
    check(np.array_equal(want_piv, got_piv)
          and np.array_equal(want_R, got_R), "sharded dense_rref differs")
    return (f"mesh={dict(mesh.shape)} gl7d_like {n}x{m} rank={r4} "
            f"one_device_rank={r1} wall_1={t1:.3f} wall_4={t4:.3f} "
            f"finisher={'+'.join(sorted(set(ran)))} "
            f"reduced_basis_devices={rb_devs}; dense_rref {rows}x{cols} "
            f"rank={len(got_piv)} exact==one-device sharded_devices="
            f"{sf_devs} wall_1={d1:.3f} wall_4={d4:.3f}"), {}


# -- driver -----------------------------------------------------------------

def run_phases(phases, tag, results):
    """Run (name, thunk) pairs; print one line per phase; keep going
    after a failure so one run shows every fault."""
    ok = True
    for name, thunk in phases:
        t0 = time.perf_counter()
        try:
            line, extra = thunk()
            results.update(extra)
            print(f"[{name}] ok {line} phase_s={time.perf_counter() - t0:.3f}"
                  f" | {tag}", flush=True)
        except Exception as e:                     # noqa: BLE001
            ok = False
            traceback.print_exc()
            print(f"[{name}] FAIL {type(e).__name__}: {e} | {tag}",
                  flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh phase")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="trace one warm mk13.b5 run into DIR")
    args = ap.parse_args(argv)
    sz = SIZES["full"]
    out = os.path.join("chiprun_out", "chip_smoke")
    try:
        import jax
        import spasm_tpu
        from spasm_tpu import native
        from spasm_tpu.profiling import gpu_name_power
    except ImportError as e:
        print(f"FAIL: spasm_tpu is not importable here ({e})",
              file=sys.stderr)
        return 2
    name_power = gpu_name_power()
    platform, count = probe_devices()
    if platform != "gpu" or not name_power:
        print(f"FAIL: no GPU (JAX sees platform {platform!r}, nvidia-smi "
              f"{'answers' if name_power else 'finds no card'})",
              file=sys.stderr)
        return 1
    if not native.HAVE_NATIVE:
        print("FAIL: the native library did not build", file=sys.stderr)
        return 1
    os.makedirs(out, exist_ok=True)
    print(f"card: {name_power}")
    print(f"jax {jax.__version__} spasm_tpu {spasm_tpu.__version__} "
          f"HAVE_NATIVE={native.HAVE_NATIVE} compile_cache="
          f"{jax.config.jax_compilation_cache_dir} | {name_power}",
          flush=True)
    tag = name_power
    results: dict = {}
    store: dict = {}
    with tempfile.TemporaryDirectory() as work:
        if args.four:
            ok = run_phases([("g", lambda: phase_g(sz, jax.devices()))],
                            tag, results)
        else:
            ok = run_phases([("a", lambda: phase_a(sz, work))], tag,
                            results)
            devs = jax.devices()
            if devs[0].platform != "gpu":
                print(f"FAIL: no GPU (platform {devs[0].platform})",
                      file=sys.stderr)
                return 1
            ok &= run_phases([
                ("b", lambda: phase_b(sz, out)),
                ("c", lambda: phase_c(sz, store, args.trace, out)),
                ("d", lambda: phase_d(sz)),
                ("e", lambda: phase_e(sz)),
                ("f", lambda: phase_f(sz, store)),
            ], tag, results)
    if not ok:
        print("FAIL: at least one phase failed", file=sys.stderr)
        return 1
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
