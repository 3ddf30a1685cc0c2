"""Compute a kernel basis (tools/kernel.c).  --left transposes first."""
from __future__ import annotations

import argparse
import sys

from .. import sio
from ..echelonize import echelonize
from ..kernel import kernel as compute_kernel
from .common import (add_echelonize_args, add_input_args,
                     load_input_triplet, open_output, opts_from_args, maybe_trace)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="spasm-kernel",
        description="Compute a kernel basis of a sparse matrix")
    add_input_args(ap)
    add_echelonize_args(ap)
    g = ap.add_argument_group("Kernel options")
    g.add_argument("--left", "-l", action="store_true",
                   help="Compute the left-kernel")
    g.add_argument("--output", "-o", metavar="FILE", default=None,
                   help="Write the kernel basis in FILE")
    args = ap.parse_args(argv)
    T, _ = load_input_triplet(args)
    if args.left:
        print("Left-kernel, transposing", file=sys.stderr)
        T.transpose_inplace()
    A = T.tocsr()
    with maybe_trace(args):
        fact = echelonize(A, opts_from_args(args))
    K = compute_kernel(fact)
    print(f"Kernel basis matrix is {K.n} x {K.m} with {K.nnz} nz",
          file=sys.stderr)
    f, close = open_output(args.output)
    sio.save_csr(K, f)
    if close:
        f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
