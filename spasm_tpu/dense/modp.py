"""Exact GF(p) arithmetic on device (int32 balanced representation).

The workhorse is `modp_matmul`: an exact modular matrix product built from
int8 x int8 -> int32 matmuls.  Balanced int32 values are decomposed
into D base-256 digits (each in [-128, 127], so any digit product is
<= 16384 and tens of thousands of them accumulate exactly in int32).  The
D*D digit products are computed as separate int8 dot_generals and recombined
with per-digit-weight modular reduction (cheap O(n*m) work vs the
O(n*m*k) matmuls).  For the D=2 tier (p <= 65279, which includes the
reference's default modulus 42013) the recombination runs entirely in
int32 + float32-reciprocal Barrett — no int64 lanes at all.

The prime is a *runtime* scalar: only the digit count D (and shapes) are
compile-time constants, so one compiled kernel serves every prime of a
given size tier.  D plays the role of the reference's float/double/i64
datatype choice (spasm_ffpack.cpp:130-139): D=2 up to 65279, D=3 up to
~2^24, D=4 for the full range p <= 2^32-5.

Overflow discipline: digit products accumulate in int32 (contraction
chunked so diagonal sums stay < 2^31); weighted recombination uses int64
lanes only for D >= 3, with every product of balanced operands < 2^62.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

_DIGIT_BITS = 8
_DIGIT_BASE = 1 << _DIGIT_BITS          # 256

# Max contraction depth per int8-matmul chunk so each anti-diagonal sum of
# digit products accumulates exactly in int32: balanced base-256 digits
# lie in [-128, 127], so |product| <= 128 * 127 = 16256 and
#   (#terms <= min(d, s+1)) * k * 16256 < 2^31
# holds for k = 2^16 at d == 2/3 (2 * 65536 * 16256 = 2.13e9 < 2^31).
def _k_chunk(d: int) -> int:
    # d == 3 diagonals sum up to 3 terms (3 * 2^15 * 16256 < 2^31);
    # d >= 4 up to 4 terms at 2^14
    if d == 2:
        return 1 << 16
    return 1 << 14 if d >= 4 else 1 << 15


class DeviceField(NamedTuple):
    """Per-prime constants; only `ndigits` is baked into compiled code."""
    p: int
    ndigits: int
    weights: np.ndarray      # (2*D - 1,) int64 balanced residues of 256^s


# Largest value representable by d balanced base-256 int8 digits is
# 127 * (256^d - 1) / 255 (and -128 * ... on the negative side); the
# binding constraint for |x| <= p//2 is the positive one.
def _digit_reach(d: int) -> int:
    return 127 * (_DIGIT_BASE ** d - 1) // (_DIGIT_BASE - 1)


@functools.lru_cache(maxsize=64)
def device_field(p: int) -> DeviceField:
    d = 2
    while d < 4 and _digit_reach(d) < p // 2:
        d += 1
    # d == 4 covers the full range p <= 2^32-5: values beyond the positive
    # digit reach are re-mapped to v - p inside _digits.
    halfp = p // 2
    w = np.empty(2 * d - 1, dtype=np.int64)
    for s in range(2 * d - 1):
        r = pow(_DIGIT_BASE, s, p)
        w[s] = r - p if r > halfp else r
    return DeviceField(p, d, w)


def storage_dtype(p: int):
    """Element type that holds every balanced residue mod p.

    |x| <= p // 2 fits int16 iff p <= 65535; larger primes need int32.
    The one owner of this choice: device buffers of residues (reduced
    basis, finisher basis, dense blocks) and the finisher's memory
    budget all ask here.
    """
    return jnp.int16 if p <= 65535 else jnp.int32


def dnorm64(x, p, rounds: int = 2):
    """Balanced representative of x mod p, staying in int64.

    Exact multiply-based reduction — **no integer division**, which
    lowers to long instruction sequences on accelerators.  `rounds` passes
    of float32-reciprocal Barrett (error recurrence
    |r'| <= |r|*2^-23 + 0.51p) followed by two conditional corrections.

    Exactness bounds (corrections cover |r| <= p + p//2):
      rounds=2: any |x| <= p * 2^30 — every call site in this package
                (products of balanced operands are <= (p/2)^2 <= p*2^30;
                digit-matmul partials are <= 2^31 * p/2).
      rounds=1: |x| <= p * 2^22 — products of balanced operands when
                p <= 16255 (digit tier d == 2).
    p may be a traced int64 scalar or a Python int.
    """
    x = x.astype(jnp.int64)
    p64 = jnp.asarray(p, jnp.int64)
    invp = 1.0 / p64.astype(jnp.float32)
    for _ in range(rounds):
        q = jnp.rint(x.astype(jnp.float32) * invp).astype(jnp.int64)
        x = x - q * p64
    half = p64 // 2
    x = jnp.where(x > half, x - p64, x)
    x = jnp.where(x < -half, x + p64, x)
    return x


def dnorm(x, p, rounds: int = 2):
    """Balanced representative of x mod p (device; -> int32)."""
    return dnorm64(x, p, rounds).astype(jnp.int32)


def mulmod(a, b, p, rounds: int = 2):
    """Balanced product of balanced operands; exact for p <= 2^32-5."""
    return dnorm64(a.astype(jnp.int64) * b.astype(jnp.int64), p, rounds)


def modinv(a, p):
    """Balanced modular inverse via Fermat (a^(p-2) mod p), runtime p.

    Square-and-multiply over the 32 exponent bits with balanced
    intermediates (products stay < 2^62).  0 maps to 0.
    """
    a64 = dnorm64(a, p)

    def body(_, st):
        result, base, e = st
        result = jnp.where(e & 1 == 1, mulmod(result, base, p), result)
        base = mulmod(base, base, p)
        return result, base, e >> 1

    e0 = jnp.asarray(p - 2, dtype=jnp.int64)
    result, _, _ = jax.lax.fori_loop(0, 32, body,
                                     (jnp.ones_like(a64), a64, e0))
    return jnp.where(a64 == 0, jnp.int64(0), result)


def _reduce31(x, p, rounds: int = 2):
    """Balanced x mod p for int32 x, |x| <= 2^31 - p; pure int32/float32.

    q = rint(x/p) has |q*p| <= |x| + p/2 so everything stays in int32.
    Two Barrett rounds + two conditional corrections are exact for any
    int32 input (round 1 leaves |r| <= |x|*2^-23 + 0.51p <= 256 + 0.51p,
    round 2 leaves |r| <= 0.52p, corrections cover |r| <= 1.5p).
    """
    x = x.astype(jnp.int32)
    p32 = jnp.asarray(p, jnp.int32)
    invp = 1.0 / p32.astype(jnp.float32)
    for _ in range(rounds):
        q = jnp.rint(x.astype(jnp.float32) * invp).astype(jnp.int32)
        x = x - q * p32
    half = (p32 - 1) >> 1
    x = jnp.where(x > half, x - p32, x)
    x = jnp.where(x < -half, x + p32, x)
    return x


def _digits(x, d: int, p=None):
    """Decompose balanced int32 -> (d, ...) int8 digits, base 256, balanced.

    x = sum_s digits[s] * 256^s with digits in [-128, 127].  For d == 4
    the positive digit reach (2139062143) is slightly below (2^32-5)//2,
    so values above it are re-mapped to v - p (same residue; lands inside
    the wider negative reach).
    """
    out = []
    if d >= 4:
        v = x.astype(jnp.int64)
        if p is not None:
            v = jnp.where(v > _digit_reach(d), v - jnp.asarray(p, jnp.int64),
                          v)
    else:
        v = x.astype(jnp.int32)   # |x| <= 8.4M for d <= 3: +-128 safe
    for _ in range(d):
        lo = ((v + 128) & (_DIGIT_BASE - 1)) - 128      # balanced digit
        out.append(lo.astype(jnp.int8))
        v = (v - lo) >> _DIGIT_BITS
    return jnp.stack(out)


def matmul_digits_i8B(A, B8, p, weights, d: int):
    """Exact (A @ B8) mod p where B8 is int8 (|values| <= 127 — a single
    base-256 digit).  Only A is digit-decomposed, so the product needs d
    dot_generals instead of d*d — structural pivot bases with +-1
    entries (e.g. boundary-map matrices) take this path."""
    n, k = A.shape
    kc = _k_chunk(d)
    nchunks = -(-k // kc)
    small = d == 2
    acc = jnp.zeros((n, B8.shape[1]), dtype=jnp.int32 if small
                    else jnp.int64)
    dot = functools.partial(
        jax.lax.dot_general, dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)
    for c in range(nchunks):
        lo = c * kc
        hi = min(k, lo + kc)
        Ad = _digits(A[:, lo:hi], d, p)
        Bc = B8[lo:hi, :]
        if small:
            b0 = _reduce31(dot(Ad[0], Bc), p)
            b1 = _reduce31(dot(Ad[1], Bc), p)
            w32 = weights.astype(jnp.int32)
            acc = acc + _reduce31(b0 + w32[1] * b1, p)
            if (c + 1) % (1 << 14) == 0:
                acc = _reduce31(acc, p)
        else:
            for s in range(d):
                # dot result magnitude <= kc * 128 * 127 < 2^31 (int32);
                # p may exceed int32 for d == 4, so reduce in int64
                b = dnorm64(dot(Ad[s], Bc).astype(jnp.int64), p)
                acc = acc + dnorm64(b * weights[s], p)
            if (c + 1) % 64 == 0:
                acc = dnorm64(acc, p)
    if small:
        return _reduce31(acc, p)
    return dnorm(acc, p)


def matmul_digits(A, B, p, weights, d: int):
    """Exact (A @ B) mod p; A, B balanced int32; p traced scalar;
    weights (2d-1,) int64; d static.  B may be int8 (single digit) —
    dispatches to the d-dot variant instead of d*d.

    The d*d int8 digit products are separate dot_generals accumulated
    per anti-diagonal: a batched einsum over (d, d) would materialize a
    (d, d, n, m) int32 intermediate — d^2 * 4 bytes per output element —
    which is memory-bound and OOMs at large n*m (measured 30x slower at
    (4608, 139776) than the pairwise form)."""
    if B.dtype == jnp.int8:
        return matmul_digits_i8B(A, B, p, weights, d)
    n, k = A.shape
    _, m = B.shape
    kc = _k_chunk(d)
    nchunks = -(-k // kc)
    small = d == 2   # weighted sum of balanced values fits int32
    acc = jnp.zeros((n, m), dtype=jnp.int32 if small else jnp.int64)
    dot = functools.partial(
        jax.lax.dot_general, dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)
    for c in range(nchunks):
        lo = c * kc
        hi = min(k, lo + kc)
        Ad = _digits(A[:, lo:hi], d, p)               # (d, n, kc) int8
        Bd = _digits(B[lo:hi, :], d, p)               # (d, kc, m) int8
        parts = [None] * (2 * d - 1)
        for d1 in range(d):
            for d2 in range(d):
                P = dot(Ad[d1], Bd[d2])               # (n, m) int32
                s = d1 + d2
                parts[s] = P if parts[s] is None else parts[s] + P
        if small:
            # int32-only: b_s balanced (<= p/2 <= 32639), weighted sum
            # <= p/2 + 2*(p/2)^2 < 2^31 for p <= 65279
            b = [_reduce31(parts[s], p) for s in range(3)]
            w32 = weights.astype(jnp.int32)
            x = b[0] + w32[1] * b[1] + w32[2] * b[2]
            acc = acc + _reduce31(x, p)
            if (c + 1) % (1 << 14) == 0:
                acc = _reduce31(acc, p)
        elif d == 3:
            # p <= 16.7M fits int32: reduce each diagonal in int32, then
            # weight in int64 (products of balanced operands < 2^47)
            for s in range(2 * d - 1):
                b = _reduce31(parts[s], p).astype(jnp.int64)
                acc = acc + dnorm64(b * weights[s], p)
            if (c + 1) % 64 == 0:                      # keep acc bounded
                acc = dnorm64(acc, p)
        else:
            # d == 4: p may exceed int32; diagonals are < 2^30 hence
            # |part * w| < 2^61, within dnorm64's exact range
            for s in range(2 * d - 1):
                acc = acc + dnorm64(
                    parts[s].astype(jnp.int64) * weights[s], p)
            if (c + 1) % 64 == 0:
                acc = dnorm64(acc, p)
    if small:
        return _reduce31(acc, p)
    return dnorm(acc, p)


@functools.partial(jax.jit, static_argnames=("d",))
def _matmul_jit(A, B, p, weights, d: int):
    return matmul_digits(A, B, p, weights, d)


def modp_matmul(A, B, p: int):
    """Exact (A @ B) mod p, balanced int32 in and out (host-facing)."""
    F = device_field(p)
    return _matmul_jit(jnp.asarray(A), jnp.asarray(B), jnp.int64(p),
                       jnp.asarray(F.weights), F.ndigits)


def modp_matmul_np(A: np.ndarray, B: np.ndarray, p: int) -> np.ndarray:
    """Host wrapper: numpy in/out."""
    A = np.ascontiguousarray(A, dtype=np.int32)
    B = np.ascontiguousarray(B, dtype=np.int32)
    return np.asarray(modp_matmul(A, B, p))
