"""pigeon_tpu_torch.solver.pallas_ruiz's plain version (the solver's own
`admm.ruiz`, which the `ruiz` CUDA kernel computes) against the JAX
package's Ruiz kernel in interpret mode at float32, and against the JAX
package's `admm._ruiz` at float64, on the sparse QPs of a small fleet
(horizon (2, 3): n=70, m=104) with one all-zero row."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import oval_fleet, t64
from pigeon_tpu.solver import admm as JA
from pigeon_tpu.solver.pallas_ruiz import ruiz_batched as j_ruiz_batched
from pigeon_tpu_torch import hji as TH
from pigeon_tpu_torch import mpc as TM
from pigeon_tpu_torch import trajectory as TT
from pigeon_tpu_torch.config import HorizonParams as THP
from pigeon_tpu_torch.solver import admm as TA
from pigeon_tpu_torch.solver.pallas_ruiz import ruiz_batched

ITERS = 4
NAMES = ("Pb", "qb", "Ab", "lb", "ub", "D", "E", "c")


@pytest.fixture(scope="module")
def qps():
    """One cold step's sparse QPs (B=3, float64 numpy) with the first
    HJI row zeroed in every instance (a zero-norm row)."""
    B = 3
    cfg = TM.x1_coupled_config(hz=THP(N_short=2, N_long=3))
    q0, t0, cols = oval_fleet(B, seed=21)
    tube = TT.make_tube(**cols, pad_to=1024, device="cpu",
                        dtype=torch.float64)
    carry = TM.init_carry(cfg, B, dtype=torch.float64, device="cpu")
    oc = t64(np.broadcast_to([1e4, 1e4, 0.0, 0.0], (B, 4)))
    qp, _, _ = TM._pre_solve(cfg, tube, TH.inactive_cache(device="cpu"),
                             carry, t64(q0), t64(np.zeros((B, 3))), oc,
                             t64(t0))
    arrays = [t.numpy().copy() for t in qp]
    # first HJI half-plane row: after 48 equality rows, the 10 sigma, 2
    # sHJI, 6 Ux and 6 Fx rows
    row = 48 + 10 + 2 + 6 + 6
    arrays[2][:, row, :] = 0.0
    return arrays


def _rel(o, r):
    o, r = np.asarray(o, np.float64), np.asarray(r, np.float64)
    finite = np.isfinite(r)
    np.testing.assert_array_equal(np.isfinite(o), finite)
    np.testing.assert_array_equal(o[~finite], r[~finite])
    return np.abs(o[finite] - r[finite]).max() / np.abs(r[finite]).max()


def test_plain_matches_jax_kernel_fp32(qps):
    f32 = [a.astype(np.float32) for a in qps]
    ref = j_ruiz_batched(*[jnp.asarray(a) for a in f32], iters=ITERS,
                         tile=2, interpret=True)
    out = ruiz_batched(*[torch.as_tensor(a) for a in f32], iters=ITERS)
    assert all(t.dtype == torch.float32 for t in out)
    for name, o, r in zip(NAMES, out, ref):
        assert tuple(o.shape) == tuple(np.shape(r)), name
        assert _rel(o.numpy(), r) < 1e-5, name


def test_zero_row_stays_unscaled(qps):
    out = ruiz_batched(*[t64(a) for a in qps], iters=ITERS)
    E, Ab = out[6], out[2]
    zero = ~Ab.abs().amax(dim=-1).gt(0)
    assert zero.any(dim=-1).all()
    assert torch.equal(E[zero], torch.ones_like(E[zero]))
    assert all(torch.isfinite(t).all() for t in (out[0], out[1], Ab, E))


def test_plain_matches_jax_ruiz_fp64(qps):
    ref = jax.vmap(lambda P, q, A, l, u: JA._ruiz(
        JA.QPData(P, q, A, l, u), ITERS))(*[jnp.asarray(a) for a in qps])
    (Pb, qb, Ab, lb, ub), D, E, c = ref
    out = TA.ruiz(TA.QPData(*[t64(a) for a in qps]), ITERS)
    (tPb, tqb, tAb, tlb, tub), tD, tE, tc = out
    for name, o, r in zip(NAMES, (tPb, tqb, tAb, tlb, tub, tD, tE, tc),
                          (Pb, qb, Ab, lb, ub, D, E, c)):
        assert o.dtype == torch.float64
        assert _rel(o.numpy(), r) < 1e-12, name


@pytest.mark.parametrize("n, m, cluster, need", [
    (193, 290, 6, 42852),    # the sparse QP: 49 rows a block
    (156, 234, 6, 28320),    # the 12-stage horizon (4, 8): 39 rows a block
    (193, 2000, 7, 230536),  # 286 rows a block need a larger cluster
])
def test_plan_smem_takes_the_path_shapes(n, m, cluster, need):
    """The Ruiz kernel's plan: the smallest cluster from CLUSTER up whose
    blocks hold ceil(m / cluster) rows of A and the vectors (each rounded
    up to 4 floats) in a block's 227 KB."""
    from pigeon_tpu_torch.solver import pallas_ruiz as TP
    rows = -(-m // cluster)
    r4 = lambda v: -(-v // 4) * 4
    assert TP.smem_bytes(n, m, cluster) == 4 * (
        5 * r4(n) + 5 * r4(rows) + 16 + rows * n) == need
    assert TP.plan_smem(n, m) == (cluster, need)
    assert need <= TP.SMEM_MAX


@pytest.mark.parametrize("n, m", [(400, 1200), (10000, 8)])
def test_plan_smem_refuses_rows_over_a_cluster(n, m):
    from pigeon_tpu_torch.solver import pallas_ruiz as TP
    assert TP.smem_bytes(n, m, TP.CLUSTER_MAX) > TP.SMEM_MAX
    with pytest.raises(ValueError):
        TP.plan_smem(n, m)
