"""Block-banded KKT factorization of the sparse coupled MPC QP, batched
over instances (counterpart of `pigeon_tpu/solver/banded.py`: the scan
and the cyclic-reduction methods).

Under a stage-interleaved variable ordering the reduced KKT matrix
K = diag(P + sigma) + A' diag(rho) A is block-tridiagonal: every
constraint row couples variables of at most two consecutive stages.  The
factor is a stage recursion of small (bw x bw) block operations, and the
dense K^-1 the dense ADMM kernel consumes follows from a forward
substitution against the identity (W = L^-1) and K^-1 = W'W.

- `chol_factor` (`csrc/banded_chol.cu`): the block-Cholesky stage
  recursion, each instance's stage blocks in the registers of a
  half-warp, bw fixed at compile time (`chol_build`);
  `chol_factor_plain` is its plain version (`_chol_factor_impl` of the
  JAX package).
- `factor_inv_banded`: K = A' rho A as one float32 matmul, static slot
  gathers, the recursion, the forward substitution and W'W as batched
  matmuls, and the un-permutation; with method "cr" block cyclic
  reduction of K X = I (`solve_block_tridiag_cr`, batched torch ops, as
  the JAX package runs it as XLA code) and one Newton polish; with
  `tp_axis` the identity's columns split over the members of a mesh
  axis and re-assembled by all_gather (`parallel/shard.py`).

Full float32 is required throughout: K's condition (the rho_eq = 1e3 rho
equality rows) amplifies matmul error into K^-1, and the JAX package
measured a lower-precision factor destroying ADMM convergence.  The
package keeps TF32 off (`pigeon_tpu_torch/__init__.py`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pigeon_tpu_torch import _kernels
from pigeon_tpu_torch.config import HorizonParams

# the kernel's builds: the sparse QP's block width, fixed at compile
# time, and the padded build for any other width up to BW_MAX (one lane
# per block row)
BW_EXACT = 13
BW_MAX = 16
# instances per block of the kernel (two warps of two)
CHOL_PER_BLOCK = 4
PIVOT_FLOOR = 1e-12


@functools.lru_cache(maxsize=None)
def coupled_stage_plan(hz: HorizonParams, use_walls: bool = False):
    """Block plan of the coupled layout: per-stage variable index blocks
    padded with dummy slots to a uniform width.  Returns (slots (nb, bw)
    int numpy, n, bw, nb); dummies point at index n (one past the end)."""
    from pigeon_tpu_torch.qp import coupled as qc
    L = qc.get_layout(hz, use_walls)
    S, T, N = hz.N_short, hz.N_short + hz.N_long, hz.N
    blocks = []
    for t in range(N):
        idx = list(L.q[t]) + list(L.u[t])
        if t < T:
            idx += list(L.sig[t]) + [L.dd[t], L.dF[t]]
            if use_walls:
                idx += [L.sw[t]]
        if t < S:
            idx += [L.sHJI[t]]
        blocks.append(np.asarray(idx, np.int32))
    bw = max(len(b) for b in blocks)
    nb = len(blocks)
    n = L.n
    slots = np.full((nb, bw), n, np.int32)
    for t, b in enumerate(blocks):
        slots[t, :len(b)] = b
    return slots, n, bw, nb


# ---------------------------------------------------------------------------
# Block-tridiagonal Cholesky factor (Linv_t, S_t per stage)
# ---------------------------------------------------------------------------

def _chol_unrolled(D):
    """Cholesky of (..., w, w) SPD blocks, column by column, pivots
    floored at PIVOT_FLOOR."""
    w = D.shape[-1]
    cols = []                     # cols[j]: column j of L, (..., w)
    rows = torch.arange(w, device=D.device)
    for j in range(w):
        if j == 0:
            r = D[..., 0, 0]
            acc = D[..., :, 0]
        else:
            Lj = torch.stack(cols, dim=-1)                   # (..., w, j)
            r = D[..., j, j] - torch.sum(Lj[..., j, :] ** 2, dim=-1)
            acc = D[..., :, j] - torch.einsum("...ik,...k->...i", Lj,
                                              Lj[..., j, :])
        d = torch.sqrt(torch.clamp(r, min=PIVOT_FLOOR))
        col = torch.where(rows > j, acc / d[..., None], 0.0)
        col = torch.where(rows == j, d[..., None], col)
        cols.append(col)
    return torch.stack(cols, dim=-1)


def _inv_lower_unrolled(L):
    """Inverse of lower-triangular (..., w, w) blocks by forward
    substitution against the identity, row by row."""
    w = L.shape[-1]
    rows = []
    for j in range(w):
        inv_d = 1.0 / L[..., j, j]
        row = torch.zeros_like(L[..., 0, :])
        if j > 0:
            X = torch.stack(rows, dim=-2)                    # (..., j, w)
            acc = -torch.einsum("...k,...kc->...c", L[..., j, :j], X)
            row = acc / L[..., j, j][..., None]
            row = torch.where(torch.arange(w, device=L.device) < j, row, 0.0)
        row[..., j] = inv_d
        rows.append(row)
    return torch.stack(rows, dim=-2)


def chol_factor_plain(K_diag, K_sub):
    """Plain PyTorch version of the block-Cholesky stage recursion
    (`_chol_factor_impl`): K_diag, K_sub (B, nb, bw, bw), K_sub[:, 0] == 0
    and K_sub[:, t] coupling stage t to t-1.  Returns (Linv, S), each
    (B, nb, bw, bw):
        S_t = K_{t,t-1} L_{t-1}^-T,  D_t = K_tt - S_t S_t',
        L_t = chol(D_t),  Linv_t = L_t^-1."""
    B, nb, bw, _ = K_diag.shape
    Linv_prev = torch.zeros((B, bw, bw), dtype=K_diag.dtype,
                            device=K_diag.device)
    Linvs, Ss = [], []
    for t in range(nb):
        S = K_sub[:, t] @ Linv_prev.transpose(-1, -2)
        D = K_diag[:, t] - S @ S.transpose(-1, -2)
        Linv_prev = _inv_lower_unrolled(_chol_unrolled(D))
        Linvs.append(Linv_prev)
        Ss.append(S)
    return torch.stack(Linvs, dim=1), torch.stack(Ss, dim=1)


def chol_build(bw: int) -> int:
    """The kernel build that takes block width `bw`: BW_EXACT for the
    sparse QP's stages, the padded BW_MAX build for any other bw <= BW_MAX
    (its padded rows and columns are exact fixed points); ValueError
    above."""
    if not 1 <= bw <= BW_MAX:
        raise ValueError(f"the banded Cholesky kernel takes 1 <= bw <= "
                         f"{BW_MAX}, got {bw}")
    return BW_EXACT if bw == BW_EXACT else BW_MAX


def chol_factor(K_diag, K_sub):
    """The block-Cholesky stage recursion for a batch (see
    `chol_factor_plain`), bw <= 16, any nb.

    Replaces the TPU kernel `pigeon_tpu/solver/banded.py:_chol_lane_kernel`.
    Each instance is a chain of nb dependent stages, and at B = 2048 all
    are in flight at once, so one instance's chain sets the time, not the
    bound (43,264 B in and out per instance at (nb, bw) = (16, 13): 0.0264
    ms of device memory at B = 2048).  The kernel keeps an instance's
    stage blocks in the registers of a half-warp, lane i on row i and on
    column i of Linv_t, with bw fixed at compile time (`chol_build`), the
    next stage loaded during this one, and the Cholesky and the inverse
    in one pass over the columns."""
    if K_diag.dim() != 4 or K_diag.shape[-1] != K_diag.shape[-2]:
        raise ValueError(f"K_diag must be (B, nb, bw, bw), got "
                         f"{tuple(K_diag.shape)}")
    _kernels.check_same(K_diag=(K_diag, tuple(K_diag.shape)),
                        K_sub=(K_sub, tuple(K_diag.shape)))
    if K_diag.device.type == "cpu":
        return chol_factor_plain(K_diag, K_sub)
    _kernels.check_cuda_f32(K_diag=K_diag, K_sub=K_sub)
    B, nb, bw, _ = K_diag.shape
    build = chol_build(bw)
    Linv = torch.empty_like(K_diag)
    S = torch.empty_like(K_diag)
    _kernels.KERNELS["banded_chol"].launch(K_diag, K_sub, Linv, S, B, nb, bw,
                                           build)
    return Linv, S


def chol_blocks_per_sm(bw: int) -> int:
    """Resident blocks per SM (CHOL_PER_BLOCK instances each) of the build
    `chol_build(bw)` picks (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    return _kernels.occupancy("banded_chol.cu", "banded_chol_blocks_per_sm",
                              bw, chol_build(bw))


# ---------------------------------------------------------------------------
# Block cyclic reduction (log-depth horizon solve)
# ---------------------------------------------------------------------------

def _spd_inv(D):
    """SPD block inverses through the unrolled Cholesky: D^-1 = L^-T L^-1."""
    Linv = _inv_lower_unrolled(_chol_unrolled(D))
    return Linv.transpose(-1, -2) @ Linv


def _cr_level(D, L, F):
    """One cyclic-reduction level over dim 1: D (B, k, bw, bw) diagonal
    blocks, L (B, k, bw, bw) sub-diagonal blocks with L[:, 0] == 0 (L[:, t]
    couples row t to column t-1), F (B, k, bw, r) right-hand sides, k odd
    >= 3.  Eliminates the even-indexed unknowns: the reduced
    ((k-1)/2)-block system over the odd ones and the pieces of the back
    substitution."""
    Dinv_e = _spd_inv(D[:, 0::2])
    LT = L.transpose(-1, -2)
    G1 = L[:, 1::2] @ Dinv_e[:, :-1]          # L_j D_{j-1}^-1
    G2 = LT[:, 2::2] @ Dinv_e[:, 1:]          # L_{j+1}' D_{j+1}^-1
    D2 = D[:, 1::2] - G1 @ LT[:, 1::2] - G2 @ L[:, 2::2]
    L2 = -G1 @ L[:, 0::2][:, :-1]             # L[:, 0] == 0 => L2[:, 0] == 0
    F2 = F[:, 1::2] - G1 @ F[:, 0::2][:, :-1] - G2 @ F[:, 2::2]
    return Dinv_e, D2, L2, F2


def _cr_back(Dinv_e, L, F, x_odd):
    """The even-indexed unknowns given the odd ones."""
    B, h = x_odd.shape[:2]
    bw = F.shape[-2]
    z = torch.zeros_like(x_odd[:, :1])
    x_prev = torch.cat([z, x_odd], dim=1)     # x_{j-1} for even j
    x_next = torch.cat([x_odd, z], dim=1)     # x_{j+1}
    LT_next = torch.cat([L[:, 1::2].transpose(-1, -2),
                         torch.zeros((B, 1, bw, bw), dtype=L.dtype,
                                     device=L.device)], dim=1)
    x_e = Dinv_e @ (F[:, 0::2] - L[:, 0::2] @ x_prev - LT_next @ x_next)
    out = torch.empty((B, 2 * h + 1) + F.shape[2:], dtype=F.dtype,
                      device=F.device)
    out[:, 0::2] = x_e
    out[:, 1::2] = x_odd
    return out


def _cr_solve(D, L, F):
    if D.shape[1] == 1:
        return _spd_inv(D) @ F
    Dinv_e, D2, L2, F2 = _cr_level(D, L, F)
    return _cr_back(Dinv_e, L, F, _cr_solve(D2, L2, F2))


def solve_block_tridiag_cr(K_diag, K_sub, rhs):
    """Solve the SPD block-tridiagonal systems K x = rhs of a batch by
    block cyclic reduction: ceil(log2(nb + 1)) elimination levels of
    batched block products and inverses in place of the nb-step stage
    recursion.  K_diag, K_sub (B, nb, bw, bw), K_sub[:, 0] == 0 and
    K_sub[:, t] coupling stage t to t-1; rhs (B, nb, bw, r).  Returns x
    (B, nb, bw, r).  The stages are padded with decoupled identity blocks
    to 2^q - 1, so every level has an odd count; padded unknowns solve to
    zero."""
    B, nb, bw = K_diag.shape[:3]
    like = dict(dtype=K_diag.dtype, device=K_diag.device)
    m = 2 ** max(1, int(np.ceil(np.log2(nb + 1)))) - 1
    pad = m - nb
    D, L, F = K_diag, K_sub, rhs
    if pad:
        D = torch.cat([D, torch.eye(bw, **like).expand(B, pad, bw, bw)],
                      dim=1)
        L = torch.cat([L, torch.zeros((B, pad, bw, bw), **like)], dim=1)
        F = torch.cat([F, torch.zeros((B, pad) + rhs.shape[2:], **like)],
                      dim=1)
    return _cr_solve(D, L, F)[:, :nb]


# ---------------------------------------------------------------------------
# Banded K^-1
# ---------------------------------------------------------------------------

def factor_inv_banded(Pb, Ab, rho_vec, sigma: float, slots, n: int,
                      bw: int, nb: int, tp_axis=None, method: str = "scan",
                      kernel: bool = True):
    """Dense K^-1 (B, n, n) through the block-tridiagonal Cholesky of the
    stage-permuted K = diag(Pb + sigma) + Ab' diag(rho) Ab, with Pb (B, n),
    Ab (B, m, n), rho_vec (B, m) and `slots` the static stage plan
    (`coupled_stage_plan`).

    `kernel`: the stage recursion through `chol_factor` (the batched
    route, as the JAX package's vmapped factor reaches its lane kernel);
    False runs the plain recursion on any device (the single-instance
    route, where the JAX package runs its XLA scan).

    method "cr": block cyclic reduction of K X = I
    (`solve_block_tridiag_cr`, torch ops on any device) and one Newton
    polish X <- X (2I - K X), which the JAX package adds because the
    log-depth elimination compounds float32 rounding across levels.

    `tp_axis`: the name of a mesh axis bound by `parallel.shard.axis_env`
    (`make_sharded_step` binds "tp"; unbound: NameError, as in JAX).  The
    members of that axis hold the same instances and split the identity's
    columns: each solves the forward substitution for its n_perm / tp
    columns (ValueError when tp does not divide n_perm, which JAX leaves
    unchecked), W is all-gathered along its columns, each forms its block
    W' W_shard of K^-1 and the blocks are all-gathered.  The stage factors
    come from `chol_factor` as without it.  Every member takes the same
    host decisions after the factor, since it holds the same K^-1 bits.
    With method "cr" it raises NotImplementedError, as in JAX."""
    if method not in ("scan", "cr"):
        raise ValueError(f"unknown banded factor method {method!r}")
    if method == "cr" and tp_axis is not None:
        raise NotImplementedError(
            "cyclic-reduction factor does not compose with tp_axis")
    B = Pb.shape[0]
    like = dict(dtype=Pb.dtype, device=Pb.device)
    slots_t = torch.as_tensor(np.asarray(slots, np.int64), device=Pb.device)
    P_ext = torch.cat([Pb + sigma, torch.ones((B, 1), **like)], dim=-1)
    P_blk = P_ext[:, slots_t]                               # (B, nb, bw)

    # K = A' rho A as one float32 matmul, then the stage blocks by static
    # gathers (dummy slots read the zero padding row and column)
    K_full = (Ab.transpose(-1, -2) * rho_vec[:, None, :]) @ Ab
    K_ext = torch.nn.functional.pad(K_full, (0, 1, 0, 1))
    K_diag = K_ext[:, slots_t[:, :, None], slots_t[:, None, :]]
    K_diag = K_diag + torch.diag_embed(P_blk)
    K_sub = torch.cat([
        torch.zeros((B, 1, bw, bw), **like),
        K_ext[:, slots_t[1:, :, None], slots_t[:-1, None, :]]], dim=1)
    n_perm = nb * bw
    eye = torch.eye(n_perm, **like)

    if method == "cr":
        X = solve_block_tridiag_cr(K_diag, K_sub,
                                   eye.reshape(nb, bw, n_perm).expand(
                                       B, nb, bw, n_perm))
        Kinv = _unpermute(X.reshape(B, n_perm, n_perm), slots, n)
        K_dense = K_full + torch.diag_embed(Pb + sigma)
        return Kinv @ (2.0 * torch.eye(n, **like) - K_dense @ Kinv)

    tp = None
    if tp_axis is not None:
        tp = _tp_member(tp_axis, n_perm)
        # this member's column slice of the identity
        eye = eye[:, tp[2] * tp[3]:(tp[2] + 1) * tp[3]]
    factor = chol_factor if kernel else chol_factor_plain
    Linvs, Ss = factor(K_diag.contiguous(), K_sub.contiguous())

    # forward substitution against the identity: y_t = Linv_t (I_t -
    # S_t y_{t-1}); the stacked y is W = L^-1 and K^-1 = W'W
    y = torch.zeros((B, bw, eye.shape[-1]), **like)
    ys = []
    for t in range(nb):
        y = Linvs[:, t] @ (eye[t * bw:(t + 1) * bw] - Ss[:, t] @ y)
        ys.append(y)
    W = torch.stack(ys, dim=1).reshape(B, n_perm, eye.shape[-1])
    if tp is None:
        return _unpermute(W.transpose(-1, -2) @ W, slots, n)
    # tensor parallel: the whole W on every member, each its own K^-1
    # column block W' W_shard, the blocks re-assembled; every member of
    # the group holds the same K^-1 bits afterwards
    W_full = _gather_columns(W, *tp[:2])
    Kinv_perm = _gather_columns(W_full.transpose(-1, -2) @ W, *tp[:2])
    return _unpermute(Kinv_perm, slots, n)


def _tp_member(tp_axis: str, n_perm: int):
    """(group, size, index, columns) of this rank's member of the named
    tp axis (bound by `parallel.shard.axis_env`); the size must divide
    the permuted width (ValueError)."""
    import torch.distributed as dist

    from pigeon_tpu_torch.parallel.shard import axis_group

    group = axis_group(tp_axis)
    size = dist.get_world_size(group)
    if n_perm % size:
        raise ValueError(f"tp={size} does not divide the banded factor's "
                         f"permuted width {n_perm}")
    return group, size, dist.get_rank(group), n_perm // size


def _gather_columns(X, group, size: int):
    """The members' (B, r, c) column blocks side by side, (B, r, size c),
    in member order (gathered along a leading axis, then permuted)."""
    from pigeon_tpu_torch.parallel.mesh import gather_leading

    parts = gather_leading(X, group, size)          # (size, B, r, c)
    return parts.permute(1, 2, 0, 3).reshape(X.shape[0], X.shape[1], -1)


def _unpermute(Kinv_perm, slots, n: int):
    """Real variable i sits at permuted position pos[i]."""
    slots = np.asarray(slots)
    pos = np.zeros(n + 1, np.int64)
    pos[slots.reshape(-1)] = np.arange(slots.size)
    pos = torch.as_tensor(pos[:n], device=Kinv_perm.device)
    return Kinv_perm[:, pos][:, :, pos]
