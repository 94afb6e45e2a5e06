"""Batched ADMM solve of the soft condensed MPC QP on two CUDA kernels.

Counterpart of `pigeon_tpu/solver/lane_admm.py`.  The per-instance QPs are
tiny (n=30 variables, m=124 rows, no equality rows), so every instance is
solved by its own warp:

- `chol_inverse` (`csrc/chol_inverse.cu`): K^-1 per instance by column
  Cholesky, forward substitution and one Newton-Schulz polish step, a
  warp per instance with its K in shared memory.
- `admm_iterations` (`csrc/admm_iterations.cu`): the OSQP iterations with
  the shrink-prox z-update for exact-penalty rows, in-kernel convergence
  checks and an early exit per group of `GROUP` consecutive instances;
  each instance's K^-1 and A stay in shared memory for the call, and a
  group is one cluster of 16 blocks of 8 instances.

Each wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version (same algorithm, same group exit) for CPU tensors.
`solve_lanes_batched` wraps them with Ruiz equilibration, the K assembly
and the OSQP segment loop with adaptive rho.

Layouts at the kernel boundary: `chol_inverse` takes (B, n, n); the
iteration operands are "lane" layouts with the instance index last --
matrices (rows, cols, B), vectors (len, B) -- so a block's 8 consecutive
instances read each entry as 32 contiguous bytes.
"""

from __future__ import annotations

import math

import torch

from pigeon_tpu_torch import _kernels
from pigeon_tpu_torch.config import SolverOptions
from pigeon_tpu_torch.solver.admm import (Pipeline, QPData, QPSolution,
                                          QPWarmStart, ruiz, run_segments)

# Instances per early-exit group.  This is semantics, not tiling: the TPU
# kernel stops a 128-lane block only when all of its lanes have converged,
# so a converged instance keeps iterating until its group has converged,
# and its x, z, y, statistics and executed count depend on the group.
GROUP = 128

# The iteration kernel holds one entry of x a lane (n <= 32), up to six
# rows a lane (m <= 192), and 8 instances' K^-1 and A (rows padded to an
# odd stride n | 1) with two vectors each in one block's 227 KB of shared
# memory.
N_MAX = 32
M_MAX = 192
INSTANCES_PER_BLOCK = 8
SMEM_MAX = 232448


def smem_bytes(n: int, m: int) -> int:
    """Shared memory of one block of the iteration kernel (`smem_bytes` in
    csrc/admm_iterations.cu): 4 flag words, each instance's two vectors
    (m rounded up to 4, and 32 floats), then each instance's K^-1 and A."""
    return 4 * (4 + INSTANCES_PER_BLOCK * (-(-m // 4) * 4 + 32
                                           + n * n + m * (n | 1)))


def plan_smem(n: int, m: int) -> int:
    """`smem_bytes`, or ValueError for an (n, m) the kernel does not take:
    n <= 32, m <= 192 and 8 instances' K^-1, A and vectors within 227 KB
    (156,816 B at (30, 124), 214,160 B at (30, 180))."""
    need = smem_bytes(n, m)
    if not (1 <= n <= N_MAX and 1 <= m <= M_MAX and need <= SMEM_MAX):
        raise ValueError(
            f"the ADMM iteration kernel takes n <= {N_MAX}, m <= {M_MAX} and "
            f"8 instances' K^-1 and A in one block's shared memory; (n, m) = "
            f"({n}, {m}) needs {need} B of {SMEM_MAX}")
    return need


def max_active_clusters(n: int, m: int) -> int:
    """How many exit groups (16-block clusters) of the iteration kernel's
    (n, m) build the card holds at once (cudaOccupancyMaxActiveClusters)."""
    return _kernels.occupancy("admm_iterations.cu",
                              "admm_iterations_max_clusters", n, m)


# ---------------------------------------------------------------------------
# KKT inverse
# ---------------------------------------------------------------------------

def chol_inverse_plain(K, polish: int = 1):
    """Plain PyTorch version of the per-instance Cholesky inverse:
    K (B, n, n) -> K^-1, the same steps as the kernel."""
    B, n, _ = K.shape
    rows_ge = torch.arange(n, device=K.device)
    Kw = K
    cols, dinvs = [], []
    for j in range(n):
        dinv = torch.rsqrt(Kw[:, j, j])
        colj = Kw[:, :, j] * dinv[:, None] * (rows_ge >= j).to(K.dtype)
        cols.append(colj)
        dinvs.append(dinv)
        Kw = Kw - colj[:, :, None] * colj[:, None, :]
    L = torch.stack(cols, dim=2)                     # L[:, i, j]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    rows = []                                        # rows of W = L^-1
    for j in range(n):
        s = torch.zeros((B, n), dtype=K.dtype, device=K.device)
        for k in range(j):
            s = s + L[:, j, k, None] * rows[k]
        rows.append((eye[j] - s) * dinvs[j][:, None])
    X = torch.zeros_like(K)
    for k in range(n):
        X = X + rows[k][:, :, None] * rows[k][:, None, :]
    for _ in range(polish):
        X = X @ (2.0 * eye - K @ X)
    return X


# The Cholesky-inverse kernel: a warp per instance, 2 a block, each with
# K padded to 32 x 32 (rows 33 floats apart) and two 32 x 36-float tiles
# for the rows and product operands the lanes exchange, in static shared
# memory.
CHOL_INSTANCES_PER_BLOCK = 2
CHOL_WARP_FLOATS = 32 * 33 + 2 * 32 * 36


def chol_inverse_plan(n: int) -> tuple:
    """(instances, shared bytes) of a block of the Cholesky-inverse kernel
    -- (2, 26,880) -- or ValueError for an n it does not take (n <= 32)."""
    if not 1 <= n <= N_MAX:
        raise ValueError(f"the CUDA kernel takes 1 <= n <= {N_MAX}, got {n}")
    return (CHOL_INSTANCES_PER_BLOCK,
            4 * CHOL_INSTANCES_PER_BLOCK * CHOL_WARP_FLOATS)


def chol_inverse(K, polish: int = 1):
    """K^-1 for each instance of K (B, n, n), n <= 32.

    Replaces the TPU kernel
    `pigeon_tpu/solver/lane_admm.py:_chol_inv_kernel`.  One warp per
    instance (`chol_inverse_plan`).  At n=30 it moves 7.2 KB and needs
    ~0.13 MFLOP per instance (59 MB and 1.1 GFLOP at B=8192): bound by
    the bytes on an H100 (0.018 ms).  The kernel skips the Cholesky's dead
    updates and computes its three 32 x 32 x 32 products in 4 x 8 register
    tiles, a lane reading 12 floats from shared memory for 32 FMAs; its
    shared-memory and shuffle traffic and the Cholesky's chain of 32
    pivots set the time."""
    if K.dim() != 3 or K.shape[1] != K.shape[2]:
        raise ValueError(f"K must be (B, n, n), got {tuple(K.shape)}")
    _kernels.check_same(K=(K, tuple(K.shape)))
    if K.device.type == "cpu":
        return chol_inverse_plain(K, polish)
    _kernels.check_cuda_f32(K=K)
    B, n, _ = K.shape
    chol_inverse_plan(n)
    out = torch.empty_like(K)
    _kernels.KERNELS["chol_inverse"].launch(K, out, B, n, polish)
    return out


# ---------------------------------------------------------------------------
# ADMM iterations
# ---------------------------------------------------------------------------

_ITER_FIELDS = ("Kinv", "A", "q", "l", "u", "rho", "cap", "x", "z", "y",
                "E", "PuD", "qu", "invDc")


def _stats(A, x, z, y, Einv, PuD, qu, invDc, eps_abs, eps_rel):
    """Unscaled residual statistics (8, B) and per-instance convergence."""
    ax = torch.einsum("rjb,jb->rb", A, x)
    aty = torch.einsum("rjb,rb->jb", A, y)
    Ax_u = ax * Einv
    z_u = z * Einv
    Px_u = torch.einsum("jkb,jb->kb", PuD, x)
    Aty_u = aty * invDc
    stat = lambda v: torch.abs(v).amax(dim=0)
    zero = torch.zeros_like(stat(qu))
    st = torch.stack([stat(Ax_u - z_u), stat(Px_u + qu + Aty_u), stat(Ax_u),
                      stat(z_u), stat(Px_u), stat(Aty_u), zero, zero])
    eps_p = eps_abs + eps_rel * torch.maximum(st[2], st[3])
    eps_d = eps_abs + eps_rel * torch.maximum(
        torch.maximum(st[4], st[5]), stat(qu))
    return st, (st[0] <= eps_p) & (st[1] <= eps_d)


def admm_iterations_plain(Kinv, A, q, l, u, rho, cap, x, z, y, E, PuD, qu,
                          invDc, n_iters: int, sigma: float, alpha: float,
                          check: int = 0, eps_abs: float = 1e-3,
                          eps_rel: float = 1e-3):
    """Plain PyTorch version of the iteration kernel, with the same group
    exit: lane layouts in, (x, z, y, stats) out."""
    B = q.shape[-1]
    inv_rho = 1.0 / rho
    Einv = 1.0 / E

    def body(x, z, y):
        w = rho * z - y
        rhs = sigma * x - q + torch.einsum("rjb,rb->jb", A, w)
        xt = torch.einsum("jkb,jb->kb", Kinv, rhs)
        zt = torch.einsum("rjb,jb->rb", A, xt)
        x_n = alpha * xt + (1.0 - alpha) * x
        z_mix = alpha * zt + (1.0 - alpha) * z
        v = z_mix + y * inv_rho
        z_n = (v - torch.minimum(torch.clamp(v - u, min=0.0), cap)
               - torch.clamp(torch.maximum(v - l, -cap), max=0.0))
        return x_n, z_n, y + rho * (z_mix - z_n)

    stats_of = lambda x, z, y: _stats(A, x, z, y, Einv, PuD, qu, invDc,
                                      eps_abs, eps_rel)
    if 0 < check < n_iters:
        n_groups = -(-B // GROUP)
        active = torch.ones(B, dtype=torch.bool, device=q.device)
        executed = torch.zeros(B, dtype=q.dtype, device=q.device)
        stats = torch.zeros((8, B), dtype=q.dtype, device=q.device)
        for it in range(-(-n_iters // check)):
            k_len = min(check, n_iters - it * check)
            for _ in range(k_len):
                x_n, z_n, y_n = body(x, z, y)
                x = torch.where(active, x_n, x)
                z = torch.where(active, z_n, z)
                y = torch.where(active, y_n, y)
            st, conv = stats_of(x, z, y)
            stats = torch.where(active, st, stats)
            executed = torch.where(active, executed + k_len, executed)
            padded = torch.ones(n_groups * GROUP, dtype=torch.bool,
                                device=q.device)
            padded[:B] = conv
            group_done = padded.view(n_groups, GROUP).all(dim=1)
            active = active & ~group_done.repeat_interleave(GROUP)[:B]
            if not bool(active.any()):
                break
        stats[6] = executed
    else:
        for _ in range(n_iters):
            x, z, y = body(x, z, y)
        stats, _ = stats_of(x, z, y)
        stats[6] = float(n_iters)
    return x, z, y, stats


def admm_iterations(Kinv, A, q, l, u, rho, cap, x, z, y, E, PuD, qu, invDc,
                    n_iters: int, sigma: float, alpha: float, check: int = 0,
                    eps_abs: float = 1e-3, eps_rel: float = 1e-3):
    """One ADMM segment on lane layouts: Kinv, PuD (n, n, B); A (m, n, B);
    q, x, qu, invDc (n, B); l, u, rho, cap, z, y, E (m, B).  Returns
    (x, z, y, stats) with stats (8, B) = [r_prim, r_dual, max|Ax|, max|z|,
    max|Px|, max|A'y|, executed iterations, 0], unscaled.

    Replaces the TPU kernel `pigeon_tpu/solver/lane_admm.py:_iter_kernel`.
    One warp per instance with its K^-1 and A in shared memory for the
    call (read from device memory once), 8 instances per block, and each
    exit group of 128 instances one cluster of 16 blocks that votes on
    the exit through distributed shared memory.  `plan_smem` raises
    ValueError for an (n, m) that does not fit."""
    n, B = q.shape
    m = l.shape[0]
    ops = dict(zip(_ITER_FIELDS, (Kinv, A, q, l, u, rho, cap, x, z, y, E,
                                  PuD, qu, invDc)))
    shapes = dict(Kinv=(n, n, B), A=(m, n, B), q=(n, B), l=(m, B),
                  u=(m, B), rho=(m, B), cap=(m, B), x=(n, B), z=(m, B),
                  y=(m, B), E=(m, B), PuD=(n, n, B), qu=(n, B),
                  invDc=(n, B))
    _kernels.check_same(**{k: (ops[k], shapes[k]) for k in _ITER_FIELDS})
    if q.device.type == "cpu":
        return admm_iterations_plain(
            Kinv, A, q, l, u, rho, cap, x, z, y, E, PuD, qu, invDc,
            n_iters, sigma, alpha, check, eps_abs, eps_rel)
    _kernels.check_cuda_f32(**ops)
    plan_smem(n, m)
    x, z, y = x.clone(), z.clone(), y.clone()
    stats = torch.empty((8, B), dtype=q.dtype, device=q.device)
    _kernels.KERNELS["admm_iterations"].launch(
        Kinv, A, q, l, u, rho, cap, x, z, y, E, PuD, qu, invDc, stats,
        B, n, m, n_iters, float(sigma), float(alpha), check,
        float(eps_abs), float(eps_rel))
    return x, z, y, stats


# ---------------------------------------------------------------------------
# Orchestration: Ruiz + K build + segments with adaptive rho
# ---------------------------------------------------------------------------

def _lane_vec(v):
    return v.T.to(torch.float32).contiguous()


def _lane_mat(M):
    return M.permute(1, 2, 0).to(torch.float32).contiguous()


def solve_lanes_batched(qp: QPData, warm: QPWarmStart, opts: SolverOptions,
                        w_soft=None) -> QPSolution:
    """Batched solve: Ruiz equilibration, then `admm.run_segments` (per-row
    rho, `max_iter // check_every` segments with in-kernel early exit
    every `opts.pallas_check_inner` iterations, OSQP adaptive rho with a
    refactor only when another segment follows) on the lane kernels.  A
    one-segment solve (max_iter == check_every) needs no host sync."""
    return run_segments(qp, warm, opts, *lanes_pipeline(qp, opts, w_soft))


def lanes_pipeline(qp: QPData, opts: SolverOptions, w_soft=None) -> Pipeline:
    """The lane solver's pieces for `admm.run_segments`: the Ruiz scalings
    (run here), the operands in lane layouts, `factor` (K by an einsum,
    K^-1 on `chol_inverse`) and the segment on `admm_iterations`."""
    dtype = qp.q.dtype
    B, n = qp.q.shape
    m = qp.l.shape[-1]
    dense_P = qp.P_diag.dim() == 3
    dev = qp.q.device

    if opts.scaling_iters > 0:
        qps, D, E, c = ruiz(qp, opts.scaling_iters)
    else:
        qps = qp
        D = torch.ones_like(qp.q)
        E = torch.ones_like(qp.l)
        c = torch.ones((B,), dtype=dtype, device=dev)
    Pb, qb, Ab, lb, ub = qps
    if not dense_P:
        Pb = torch.diag_embed(Pb)
    sigma = float(opts.sigma)

    if w_soft is None:
        w_soft = torch.full((m,), math.inf, dtype=dtype, device=dev)
    wb = c[:, None] * torch.broadcast_to(w_soft, (B, m)) / E

    A_l = _lane_mat(Ab)
    q_l, l_l, u_l = _lane_vec(qb), _lane_vec(lb), _lane_vec(ub)
    E_l = _lane_vec(E)
    qu_l = _lane_vec(qp.q)
    invDc_l = _lane_vec(1.0 / (D * c[:, None]))
    # unscaled-P stats operand: row-scaled so x_bar contracts to P_u x_u
    PuD = (D[:, :, None] * qp.P_diag if dense_P
           else torch.diag_embed(qp.P_diag * D))
    PuD_l = _lane_mat(PuD)
    eye = torch.eye(n, dtype=dtype, device=dev)

    def factor(rho_vec):
        """K^-1, rho and the soft rows' cap W / rho, in lane layouts."""
        K = Pb + torch.einsum("bmi,bm,bmj->bij", Ab, rho_vec, Ab)
        K = K + sigma * eye
        Kinv = chol_inverse(K.to(torch.float32).contiguous(),
                            polish=opts.lane_polish)
        return _lane_mat(Kinv), _lane_vec(rho_vec), _lane_vec(wb / rho_vec)

    def run_iters(fac, x_l, z_l, y_l):
        Kinv_l, rho_l, cap_l = fac
        x_l, z_l, y_l, stats = admm_iterations(
            Kinv_l, A_l, q_l, l_l, u_l, rho_l, cap_l, x_l, z_l, y_l, E_l,
            PuD_l, qu_l, invDc_l, opts.check_every, sigma,
            float(opts.alpha), check=int(opts.pallas_check_inner),
            eps_abs=float(opts.eps_abs), eps_rel=float(opts.eps_rel))
        return x_l, z_l, y_l, stats.T

    return Pipeline(D, E, c, factor, run_iters,
                    layout=(_lane_vec, lambda v: v.T))
