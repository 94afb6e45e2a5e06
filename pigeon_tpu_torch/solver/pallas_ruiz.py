"""Batched Ruiz equilibration on a CUDA kernel (counterpart of
`pigeon_tpu/solver/pallas_ruiz.py`).

`ruiz_batched` launches `csrc/ruiz.cu` for CUDA tensors; its plain
version is the solver's own `admm.ruiz`, which computes the same function
(modified Ruiz plus cost scaling, OSQP semantics, zero-norm rows and
columns unscaled) for a diagonal P.
"""

from __future__ import annotations

import torch

from pigeon_tpu_torch import _kernels
from pigeon_tpu_torch.solver.admm import QPData, ruiz


def ruiz_batched(P_diag, q, A, l, u, iters: int = 4):
    """Ruiz equilibration of a batch: P_diag, q (B, n), A (B, m, n), l, u
    (B, m).  Returns (Pb, qb, Ab, lb, ub, D, E, c), the semantics of
    `admm.ruiz(QPData(P_diag, q, A, l, u), iters)`.

    Replaces the TPU kernel `pigeon_tpu/solver/pallas_ruiz.py:_kernel`.
    One thread block per instance; the sweeps read A from global memory
    (one instance's A at n=193, m=290 fills a block's shared memory), and
    the resident blocks' A stays in L2 between sweeps.  At B=2048 one read
    and one write of A are 0.46 GB each: bound by device memory."""
    B, m, n = A.shape
    _kernels.check_same(P_diag=(P_diag, (B, n)), q=(q, (B, n)),
                        A=(A, (B, m, n)), l=(l, (B, m)), u=(u, (B, m)))
    if A.device.type == "cpu":
        (Pb, qb, Ab, lb, ub), D, E, c = ruiz(QPData(P_diag, q, A, l, u),
                                             iters)
        return Pb, qb, Ab, lb, ub, D, E, c
    _kernels.check_cuda_f32(P_diag=P_diag, q=q, A=A, l=l, u=u)
    Pb, qb, D = (torch.empty_like(q) for _ in range(3))
    lb, ub, E = (torch.empty_like(l) for _ in range(3))
    Ab = torch.empty_like(A)
    c = torch.empty((B,), dtype=A.dtype, device=A.device)
    _kernels.KERNELS["ruiz"].launch(P_diag, q, A, l, u, Pb, qb, Ab, lb, ub,
                                    D, E, c, B, n, m, int(iters))
    return Pb, qb, Ab, lb, ub, D, E, c
