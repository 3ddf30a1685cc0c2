"""Device-side (JAX/XLA/Pallas) dense GF(p) linear algebra.

This package replaces the reference's FFLAS-FFPACK bridge
(/root/reference/src/spasm_ffpack.cpp) with device kernels in JAX:

  * modp.modp_matmul — exact mod-p matmul by int8 digit decomposition
    (the analog of FFPACK's delayed-reduction BLAS).
  * elim.dense_rref / elim.dense_lu — blocked rank-revealing reduced row
    echelonization / PLUQ with column pivoting (the analogs of
    FFPACK::pReducedRowEchelonForm and FFPACK::pPLUQ).
"""

from .modp import modp_matmul, dnorm, device_field  # noqa: F401
from .elim import dense_rref, dense_lu              # noqa: F401
