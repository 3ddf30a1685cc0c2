"""spasm_tpu — exact sparse linear algebra over GF(p) on an accelerator.

A from-scratch JAX/XLA re-design of the capabilities of SpaSM
(cbouilla/spasm, reference v1.3): multithreaded sparse row-echelonization
modulo an odd prime p <= 2^32 - 5, and everything derived from it — rank,
row-space basis, kernel basis, RREF, full PLUQ factorization, linear-system
solving, rank certificates, Dulmage-Mendelsohn decomposition and strongly
connected components.  Its accelerator is an NVIDIA H100 (the package
name is historical).

Architecture (device-first, not a port):
  * host side: CSR/COO containers, I/O (SMS / MatrixMarket with SHA-256
    fingerprints), symbolic graph passes (reach, pivot search, matching,
    DM, SCC) — irregular pointer-chasing that has no business on a
    matrix unit.
  * device side (JAX/XLA): dense mod-p arithmetic — digit-decomposed int8
    matmuls, blocked rank-revealing RREF/PLUQ (replaces the reference's
    FFLAS-FFPACK bridge, /root/reference/src/spasm_ffpack.cpp), and chunked
    topological elimination of dense row blocks against U (replaces the
    per-row Gilbert-Peierls solves of /root/reference/src/spasm_schur.c).
  * multi-device: jax.sharding.Mesh + NamedSharding row/column partitions
    of the dense elimination path (replaces OpenMP, which is the
    reference's only parallelism).

Numbers are stored in the *balanced* representation x in [-(p-1)/2, (p-1)/2]
as int32, exactly like the reference (spasm.h:28, spasm_ZZp.c:17-24), so
artifacts (SMS files, certificates, PRNG streams) interoperate bit-for-bit.
"""

import os as _os

import jax as _jax

# The engine relies on int64 host/device scalars for exact arithmetic with
# p up to 2^32 - 5 (products reach 2^62); the hot inner loops use
# int8/int32 digit arithmetic instead.
_jax.config.update("jax_enable_x64", True)


def _enable_compile_cache():
    """Persistent XLA compile cache, shared by every process of a checkout.

    CLI tools and fresh benchmark processes would otherwise recompile
    every shape bucket.  JAX_COMPILATION_CACHE_DIR, when set, decides the
    directory (JAX reads it itself; nothing is set here).  Otherwise the
    cache lives at a fixed `<checkout>/.jax_cache`, so every process of
    one checkout finds the others' programs.
    """
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    root = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    _jax.config.update("jax_compilation_cache_dir",
                       _os.path.join(root, ".jax_cache"))


_enable_compile_cache()


__version__ = "0.1.0"

from .field import Field                                      # noqa: E402
from .csr import CSR, COO                                     # noqa: E402
from .hashing import PRNG, sha256_new                         # noqa: E402
from . import sio                                             # noqa: E402
from .echelonize import EchelonizeOptions, echelonize, LU     # noqa: E402
from .solve import solve, gesv                                # noqa: E402
from .kernel import kernel, kernel_from_rref                  # noqa: E402
from .rref import rref                                        # noqa: E402
from .certificate import (rank_certificate_create,            # noqa: E402
                          rank_certificate_verify,
                          factorization_verify,
                          certificate_save, certificate_load)
from .dm import dulmage_mendelsohn, strongly_connected_components  # noqa: E402
from .matching import maximum_matching, structural_rank       # noqa: E402

__all__ = [
    "Field", "CSR", "COO", "PRNG", "sha256_new", "sio",
    "EchelonizeOptions", "echelonize", "LU", "solve", "gesv",
    "kernel", "kernel_from_rref", "rref",
    "rank_certificate_create", "rank_certificate_verify",
    "factorization_verify", "certificate_save", "certificate_load",
    "dulmage_mendelsohn", "strongly_connected_components",
    "maximum_matching", "structural_rank",
]
