"""Solve sparse linear systems X.A == B (tools/solve.c)."""
from __future__ import annotations

import argparse
import sys
import time

from .. import sio
from ..echelonize import echelonize
from ..solve import gesv
from .common import (add_echelonize_args, add_input_args, load_input,
                     open_output, opts_from_args, maybe_trace)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="spasm-solve", description="Solve sparse linear systems")
    add_input_args(ap)
    add_echelonize_args(ap)
    g = ap.add_argument_group("solve options")
    g.add_argument("--rhs", "-r", metavar="FILE", required=True,
                   help="Load the RHS matrix from FILE")
    g.add_argument("--output", "-o", metavar="FILE", default=None,
                   help="Write the solution matrix in FILE")
    args = ap.parse_args(argv)

    print("Loading A", file=sys.stderr)
    A, _ = load_input(args)
    print("Loading B", file=sys.stderr)
    B, _ = sio.load_csr(args.rhs, args.modulus)
    print(f"Echelonizing A ({A.n} x {A.m}, {A.nnz} nnz)", file=sys.stderr)
    opts = opts_from_args(args)
    opts.L = True
    t0 = time.time()
    with maybe_trace(args):
        fact = echelonize(A, opts)
    print(f"echelonization done in {time.time() - t0:.3f} s "
          f"rank = {fact.r}", file=sys.stderr)
    print("Solving XA == B", file=sys.stderr)
    X, ok = gesv(fact, B)
    for i in range(B.n):
        if not ok[i]:
            print(f"WARNING: no solution for row {i}", file=sys.stderr)
    print("done", file=sys.stderr)
    f, close = open_output(args.output)
    sio.save_csr(X, f)
    if close:
        f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
