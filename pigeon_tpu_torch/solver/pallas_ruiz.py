"""Batched Ruiz equilibration on a CUDA kernel (counterpart of
`pigeon_tpu/solver/pallas_ruiz.py`).

`ruiz_batched` launches `csrc/ruiz.cu` for CUDA tensors; its plain
version is the solver's own `admm.ruiz`, which computes the same function
(modified Ruiz plus cost scaling, OSQP semantics, zero-norm rows and
columns unscaled) for a diagonal P.  The kernel holds each instance's A
in shared memory for every sweep, its rows split over a thread block
cluster (`plan_smem`).
"""

from __future__ import annotations

import torch

from pigeon_tpu_torch import _kernels
from pigeon_tpu_torch.solver.admm import QPData, ruiz

# blocks per instance: the cluster `plan_smem` tries first (the fastest of
# 3..8 at the sparse QP's shape on an H100), and the largest portable one
CLUSTER = 6
CLUSTER_MAX = 8
SMEM_MAX = 232448          # a block's opt-in shared memory (227 KB)


def smem_bytes(n: int, m: int, cluster: int) -> int:
    """Shared memory of one block of `csrc/ruiz.cu` (its `smem_bytes`): D,
    P, q and two column partials (n each), four row partials and E (R
    each, R = ceil(m / cluster) rows a block), each vector rounded up to 4
    floats; the block reduction (16 floats) and the block's rows of A."""
    rows = -(-m // cluster)
    r4 = lambda v: -(-v // 4) * 4
    return 4 * (5 * r4(n) + 5 * r4(rows) + 16 + rows * n)


def plan_smem(n: int, m: int) -> tuple[int, int]:
    """(cluster, bytes a block): the smallest cluster from CLUSTER up whose
    blocks hold their share of A's rows, or ValueError when even
    CLUSTER_MAX blocks do not (6 blocks of 42,852 B at the sparse QP's
    n = 193, m = 290)."""
    for cluster in range(CLUSTER, CLUSTER_MAX + 1):
        need = smem_bytes(n, m, cluster)
        if need <= SMEM_MAX:
            return cluster, need
    raise ValueError(
        f"the Ruiz kernel holds A's rows in the shared memory of a cluster "
        f"of at most {CLUSTER_MAX} blocks: (n, m) = ({n}, {m}) needs "
        f"{smem_bytes(n, m, CLUSTER_MAX)} B a block of {SMEM_MAX}")


def max_active_clusters(n: int, m: int) -> int:
    """How many instances (clusters) of the kernel the card holds at once
    for (n, m) (cudaOccupancyMaxActiveClusters)."""
    return _kernels.occupancy("ruiz.cu", "ruiz_max_clusters", n, m,
                              plan_smem(n, m)[0])


def ruiz_batched(P_diag, q, A, l, u, iters: int = 4):
    """Ruiz equilibration of a batch: P_diag, q (B, n), A (B, m, n), l, u
    (B, m).  Returns (Pb, qb, Ab, lb, ub, D, E, c), the semantics of
    `admm.ruiz(QPData(P_diag, q, A, l, u), iters)`.

    Replaces the TPU kernel `pigeon_tpu/solver/pallas_ruiz.py:_kernel`.
    Each instance's A is read from device memory once, held in the shared
    memory of a cluster of blocks (rows split between them) for all
    sweeps, and written scaled once: bound by those two passes over A
    (0.458 GB each at B = 2048, m = 290, n = 193).  Raises ValueError for
    an (n, m) whose rows do not fit (`plan_smem`)."""
    B, m, n = A.shape
    _kernels.check_same(P_diag=(P_diag, (B, n)), q=(q, (B, n)),
                        A=(A, (B, m, n)), l=(l, (B, m)), u=(u, (B, m)))
    if A.device.type == "cpu":
        (Pb, qb, Ab, lb, ub), D, E, c = ruiz(QPData(P_diag, q, A, l, u),
                                             iters)
        return Pb, qb, Ab, lb, ub, D, E, c
    _kernels.check_cuda_f32(P_diag=P_diag, q=q, A=A, l=l, u=u)
    cluster, _ = plan_smem(n, m)
    Pb, qb, D = (torch.empty_like(q) for _ in range(3))
    lb, ub, E = (torch.empty_like(l) for _ in range(3))
    Ab = torch.empty_like(A)
    c = torch.empty((B,), dtype=A.dtype, device=A.device)
    _kernels.KERNELS["ruiz"].launch(P_diag, q, A, l, u, Pb, qb, Ab, lb, ub,
                                    D, E, c, B, n, m, int(iters), cluster)
    return Pb, qb, Ab, lb, ub, D, E, c
