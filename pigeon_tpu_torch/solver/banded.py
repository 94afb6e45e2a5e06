"""Block-banded KKT factorization of the sparse coupled MPC QP, batched
over instances (counterpart of `pigeon_tpu/solver/banded.py`, scan
method).

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
  matmuls, and the un-permutation.

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
    route, where the JAX package runs its XLA scan)."""
    if tp_axis is not None:
        raise NotImplementedError(
            "the tensor-parallel banded factor (tp_axis) is not ported")
    if method != "scan":
        raise NotImplementedError(
            f"banded factor method {method!r} (cyclic reduction) is not "
            f"ported")
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

    factor = chol_factor if kernel else chol_factor_plain
    Linvs, Ss = factor(K_diag.contiguous(), K_sub.contiguous())

    # forward substitution against the identity: y_t = Linv_t (I_t -
    # S_t y_{t-1}); the stacked y is W = L^-1 and K^-1 = W'W
    n_perm = nb * bw
    eye = torch.eye(n_perm, **like)
    y = torch.zeros((B, bw, n_perm), **like)
    ys = []
    for t in range(nb):
        y = Linvs[:, t] @ (eye[t * bw:(t + 1) * bw] - Ss[:, t] @ y)
        ys.append(y)
    W = torch.stack(ys, dim=1).reshape(B, n_perm, n_perm)
    Kinv_perm = W.transpose(-1, -2) @ W
    # un-permute: real variable i sits at permuted position pos[i]
    pos = np.zeros(n + 1, np.int64)
    pos[np.asarray(slots).reshape(-1)] = np.arange(n_perm)
    pos = torch.as_tensor(pos[:n], device=Pb.device)
    return Kinv_perm[:, pos][:, :, pos]
