"""Operations and bytes of the dense ADMM kernel's segments (B8: the
narrow, wide and large builds of `csrc/admm_*.cu`), as the QP needs them,
whichever build runs.

A solve's QP has n variables, m rows and `nnz` static nonzeros of A, a
diagonal P, and K^-1 dense (n x n).  Each executed iteration takes A'w
and A x (2 operations a nonzero each), the K^-1 product (2 n^2) and 10 m
+ 5 n elementwise; each convergence check (every `check` iterations)
takes A x and A'y again and 10 m + 12 n.  A step's solves read each
input once (K^-1, A's nonzeros, and the vectors q, l, u, rho, x, z, y,
the scalings D, E, c and the unscaled P and q; the pattern once for the
batch) and write each output once (x, z, y, and 8 statistics): the same
bytes whether a build runs the step's iterations in one launch or in
several, and whether its tiles exit early or not.  Float32 throughout.
"""

from __future__ import annotations

import re

import torch

# the kernels the segments launch, by the names the device trace gives
KERNEL = re.compile(r"\badmm_(dense|large|wide)_kernel\b")


def operations(iterations, n: int, m: int, nnz: int, check: int) -> float:
    """Operations of the solves whose executed iteration counts are
    `iterations` (a tensor of per-solve totals over a step's
    segments)."""
    it = iterations.double()
    return float((it * (4 * nnz + 2 * n * n + 10 * m + 5 * n)
                  + torch.ceil(it / check) * (4 * nnz + 10 * m + 12 * n))
                 .sum())


def bytes_per_step(batch: int, n: int, m: int, nnz: int) -> float:
    """Bytes a step's `batch` solves need: each input read once and each
    output written once."""
    reads = n * n + nnz + 5 * n + 6 * m + 1
    writes = n + 2 * m + 8
    per_solve = 4 * (reads + writes)
    return batch * per_solve + 2 * nnz + 4 * (m + 1)


def least_seconds(ops: float, nbytes: float, peaks: dict) -> float:
    """The least time the card's published peaks allow."""
    return max(ops / peaks["fp32_flops_per_s"],
               nbytes / peaks["hbm_bytes_per_s"])
