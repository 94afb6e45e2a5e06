"""Dense-K^-1 ADMM iterations on a CUDA kernel (counterpart of
`pigeon_tpu/solver/pallas_admm.py`, precision mode "highest" with a
diagonal P).

`admm_iterations` launches `csrc/admm_dense.cu` for CUDA tensors and runs
its plain PyTorch version, `admm_iterations_plain` (same iteration, same
statistics, same early exit per tile), for CPU tensors.  Both compute in
the inputs' dtype; the solver passes float32, as the JAX package's kernel
computes.
"""

from __future__ import annotations

import torch

from pigeon_tpu_torch import _kernels
from pigeon_tpu_torch.solver.admm import _mtv, _mv

# the kernel's limits (run-time n, m; one warp per instance of a tile in
# the statistics)
N_MAX, M_MAX, TILE_MAX = 256, 512, 8


def _stats(A, x, z, y, invE, PuD, qu, invDc, eps_abs, eps_rel):
    """Unscaled residual statistics (B, 8) and per-instance convergence."""
    ax = _mv(A, x)
    aty = _mtv(A, y)
    Ax_u = ax * invE
    z_u = z * invE
    Px_u = PuD * x
    Aty_u = aty * invDc
    stat = lambda v: torch.abs(v).amax(dim=-1)
    zero = torch.zeros_like(stat(qu))
    st = torch.stack([stat(Ax_u - z_u), stat(Px_u + qu + Aty_u), stat(Ax_u),
                      stat(z_u), stat(Px_u), stat(Aty_u), zero, zero],
                     dim=-1)
    eps_p = eps_abs + eps_rel * torch.maximum(st[:, 2], st[:, 3])
    eps_d = eps_abs + eps_rel * torch.maximum(
        torch.maximum(st[:, 4], st[:, 5]), stat(qu))
    return st, (st[:, 0] <= eps_p) & (st[:, 1] <= eps_d)


def admm_iterations_plain(Kinv, A, q, l, u, rho, x, z, y, E, PuD, qu, invDc,
                          n_iters: int, sigma: float, alpha: float,
                          tile: int = 1, check: int = 0,
                          eps_abs: float = 1e-3, eps_rel: float = 1e-3):
    """Plain PyTorch version of the dense ADMM kernel, with its early exit
    per tile of `tile` consecutive instances: (x, z, y, stats)."""
    B = q.shape[0]
    inv_rho = 1.0 / rho
    invE = 1.0 / E

    def body(x, z, y):
        w = rho * z - y
        rhs = sigma * x - q + _mtv(A, w)
        xt = _mtv(Kinv, rhs)
        zt = _mv(A, xt)
        x_n = alpha * xt + (1.0 - alpha) * x
        z_mix = alpha * zt + (1.0 - alpha) * z
        z_n = torch.clamp(z_mix + y * inv_rho, l, u)
        return x_n, z_n, y + rho * (z_mix - z_n)

    stats_of = lambda x, z, y: _stats(A, x, z, y, invE, PuD, qu, invDc,
                                      eps_abs, eps_rel)
    if 0 < check < n_iters:
        n_tiles = -(-B // tile)
        active = torch.ones(B, dtype=torch.bool, device=q.device)
        executed = torch.zeros(B, dtype=q.dtype, device=q.device)
        stats = torch.zeros((B, 8), dtype=q.dtype, device=q.device)
        for it in range(-(-n_iters // check)):
            k_len = min(check, n_iters - it * check)
            a1 = active[:, None]
            for _ in range(k_len):
                x_n, z_n, y_n = body(x, z, y)
                x = torch.where(a1, x_n, x)
                z = torch.where(a1, z_n, z)
                y = torch.where(a1, y_n, y)
            st, conv = stats_of(x, z, y)
            stats = torch.where(a1, st, stats)
            executed = torch.where(active, executed + k_len, executed)
            # instances past B count as converged
            padded = torch.ones(n_tiles * tile, dtype=torch.bool,
                                device=q.device)
            padded[:B] = conv
            tile_done = padded.view(n_tiles, tile).all(dim=1)
            active = active & ~tile_done.repeat_interleave(tile)[:B]
            if not bool(active.any()):
                break
        stats[:, 6] = executed
    else:
        for _ in range(n_iters):
            x, z, y = body(x, z, y)
        stats, _ = stats_of(x, z, y)
        stats[:, 6] = float(n_iters)
    return x, z, y, stats


def admm_iterations(Kinv, A, q, l, u, rho, x0, z0, y0, n_iters: int,
                    sigma: float, alpha: float, tile: int = 1,
                    bf16: bool = False, precision: str = "highest",
                    scalings=None, m_eq: int = 0, check: int = 0,
                    eps_abs: float = 1e-3, eps_rel: float = 1e-3,
                    dense_P: bool = False):
    """Run up to `n_iters` ADMM iterations for a batch of scaled QPs:
    Kinv (B, n, n), A (B, m, n), q, x0 (B, n), l, u, rho, z0, y0 (B, m).
    Returns (x, z, y, stats) with stats (B, 8) the unscaled residual
    statistics [r_prim, r_dual, max|Ax|, max|z|, max|Px|, max|A'y|,
    executed iterations, 0].

    scalings: (D, E, c, P_unscaled (B, n), q_unscaled) of the Ruiz step
    for the statistics; identity scalings (and no P term) when omitted.
    `check` > 0 checks convergence every `check` iterations and stops a
    tile of `tile` consecutive instances once all of them have converged.

    Replaces the TPU kernel `pigeon_tpu/solver/pallas_admm.py:_kernel`
    ("highest" mode).  One block per tile; K^-1 and A stream from device
    memory every iteration (0.6 MB per instance at n=193, m=290), so an
    iteration of a 2048-instance batch is bound by device memory."""
    if bf16 or precision != "highest":
        raise NotImplementedError(
            f"the dense ADMM kernel's precision mode "
            f"{'bf16' if bf16 else precision!r} is not ported (only "
            f"'highest')")
    if m_eq:
        raise NotImplementedError(
            "the equality-row split (m_eq) of the mixed precision modes is "
            "not ported")
    if dense_P:
        raise NotImplementedError(
            "the dense ADMM kernel with a dense P (the condensed QP) is not "
            "ported")
    B, m, n = A.shape
    if scalings is None:
        D = torch.ones_like(q)
        E = torch.ones_like(l)
        c = torch.ones((B,), dtype=q.dtype, device=q.device)
        Pu, qu = torch.zeros_like(q), q
    else:
        D, E, c, Pu, qu = scalings
    PuD = Pu * D
    invDc = 1.0 / (D * c[:, None])
    ops = dict(Kinv=(Kinv, (B, n, n)), A=(A, (B, m, n)), q=(q, (B, n)),
               l=(l, (B, m)), u=(u, (B, m)), rho=(rho, (B, m)),
               x0=(x0, (B, n)), z0=(z0, (B, m)), y0=(y0, (B, m)),
               E=(E, (B, m)), PuD=(PuD, (B, n)), qu=(qu, (B, n)),
               invDc=(invDc, (B, n)))
    _kernels.check_same(**ops)
    if q.device.type == "cpu":
        return admm_iterations_plain(
            Kinv, A, q, l, u, rho, x0, z0, y0, E, PuD, qu, invDc, n_iters,
            sigma, alpha, tile, check, eps_abs, eps_rel)
    _kernels.check_cuda_f32(**{k: v[0] for k, v in ops.items()})
    if n > N_MAX or m > M_MAX or not 1 <= tile <= TILE_MAX:
        raise ValueError(f"the CUDA kernel takes n <= {N_MAX}, m <= {M_MAX} "
                         f"and 1 <= tile <= {TILE_MAX}; got n={n}, m={m}, "
                         f"tile={tile}")
    x, z, y = x0.clone(), z0.clone(), y0.clone()
    stats = torch.empty((B, 8), dtype=q.dtype, device=q.device)
    _kernels.KERNELS["admm_dense"].launch(
        Kinv, A, q, l, u, rho, x, z, y, E, PuD, qu, invDc, stats, B, n, m,
        int(tile), int(n_iters), float(sigma), float(alpha), int(check),
        float(eps_abs), float(eps_rel))
    return x, z, y, stats
