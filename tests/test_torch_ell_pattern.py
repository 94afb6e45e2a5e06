"""What surrounds the two shared-memory ADMM kernels, on the CPU:

- the sparse coupled QP's static nonzero pattern (`pallas_admm.
  layout_pattern`) against the JAX package's assembled and Ruiz-scaled A
  at float64, and the ELL forms the dense ADMM kernel reads (packing,
  unpacking, the union pattern of a batch, and the index arithmetic of
  its products, emulated in numpy);
- the shared-memory planners of both kernels' wrappers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import oval_fleet, t64
from pigeon_tpu.config import HorizonParams as JHP
from pigeon_tpu.qp import coupled as JC
from pigeon_tpu.solver import admm as JA
from pigeon_tpu_torch import hji as TH
from pigeon_tpu_torch import mpc as TM
from pigeon_tpu_torch import trajectory as TT
from pigeon_tpu_torch.config import HorizonParams as THP
from pigeon_tpu_torch.config import SolverOptions
from pigeon_tpu_torch.qp import condensed as TQC
from pigeon_tpu_torch.solver import lane_admm as TL
from pigeon_tpu_torch.solver import pallas_admm as TP

# horizon -> (n, m, nonzeros of the static pattern)
HORIZONS = {"live": ((5, 10), (193, 290, 1320)),
            "small": ((4, 8), (156, 234, 1058))}


def _cfg(hz):
    return TM.x1_coupled_config(hz=THP(N_short=hz[0], N_long=hz[1]),
                                solver=SolverOptions(backend="pallas"))


def _pattern(hz):
    return TM._a_pattern_for(_cfg(hz))


def _fleet_A(hz, B=4, seed=3):
    """The port's assembled A (float64) of one cold step of an oval
    fleet."""
    cfg = _cfg(hz)
    q0, t0, cols = oval_fleet(B, seed=seed)
    tube = TT.make_tube(**cols, pad_to=1024, device="cpu",
                        dtype=torch.float64)
    carry = TM.init_carry(cfg, B, dtype=torch.float64, device="cpu")
    oc = t64(np.broadcast_to([1e4, 1e4, 0.0, 0.0], (B, 4)))
    qp, _, _ = TM._pre_solve(cfg, tube, TH.inactive_cache(device="cpu"),
                             carry, t64(q0), t64(np.zeros((B, 3))), oc,
                             t64(t0))
    return qp.A


def _positions(pat):
    """(rows, cols) of a pattern's nonzeros, from its row-ELL codes."""
    valid = pat.row_code >= 0
    return (np.nonzero(valid)[0],
            (pat.row_code[valid] & 0xFFFF).astype(np.int64))


def _unpack(vals, pat):
    """The dense (B, m, n) matrices of row-ELL values."""
    rows, cols = _positions(pat)
    A = torch.zeros((vals.shape[0], pat.m, pat.n), dtype=vals.dtype)
    A[:, torch.as_tensor(rows), torch.as_tensor(cols)] = (
        vals[:, torch.as_tensor(pat.row_code >= 0)])
    return A


def _jax_A(hz, B=3):
    """The JAX package's assembled A and its Ruiz-scaled A (float64) on
    stage data seeded by the port along the oval, with a random HJI row
    per vehicle (the last one inactive, M = 0)."""
    cfg = _cfg(hz)
    q0, t0, cols = oval_fleet(B, seed=5)
    tube = TT.make_tube(**cols, pad_to=1024, device="cpu",
                        dtype=torch.float64)
    ts, dt = TM.compute_time_steps(cfg.hz, t64(t0))
    q0 = t64(q0)
    u0 = t64(np.tile([0.02, 300.0, 200.0], (B, 1)))
    s0, e0, _ = TT.path_coordinates(tube, q0[:, :2])
    qs, us, ps = TM._nodes_coupled_cold(cfg, tube, q0, u0, ts, dt, s0, e0)
    rng = np.random.default_rng(6)
    M = rng.normal(size=(B, 2)) * [1.0, 1e-4]
    b = rng.normal(size=B)
    M[-1], b[-1] = 0.0, 1.0
    data = JC.CoupledStageData(dt=jnp.asarray(dt.numpy()),
                               qs=jnp.asarray(qs.numpy()),
                               us=jnp.asarray(us.numpy()),
                               ps=jnp.asarray(ps.numpy()),
                               hji_M=jnp.asarray(M), hji_b=jnp.asarray(b))
    jhz = JHP(N_short=hz[0], N_long=hz[1])
    qp = jax.jit(jax.vmap(lambda s: JC.build_qp(cfg.veh, cfg.coupled, jhz,
                                                s)))(data)
    scaled = jax.jit(jax.vmap(lambda p: JA._ruiz(p, 4)[0]))(qp)
    return np.asarray(qp.A), np.asarray(scaled.A)


@pytest.mark.parametrize("name", list(HORIZONS))
def test_static_pattern_covers_jax_A(name):
    hz, (n, m, nnz) = HORIZONS[name]
    pat = _pattern(hz)
    assert (pat.n, pat.m, pat.nnz) == (n, m, nnz)
    assert (pat.row_width, pat.col_width) == (11, 15)
    inside = np.zeros((m, n), bool)
    inside[_positions(pat)] = True
    for A in _jax_A(hz):
        assert A.shape == (3, m, n)
        assert (A != 0).any() and not (A[:, ~inside] != 0).any()


@pytest.mark.parametrize("name", list(HORIZONS))
def test_pack_unpack_exact(name):
    """Every value at a pattern position survives the row-ELL round trip
    bit for bit: random values at every position, and a fleet's A."""
    hz, (n, m, _) = HORIZONS[name]
    pat = _pattern(hz)
    rows, cols = _positions(pat)
    rng = np.random.default_rng(1)
    A = torch.zeros((3, m, n), dtype=torch.float64)
    A[:, torch.as_tensor(rows), torch.as_tensor(cols)] = torch.as_tensor(
        rng.normal(size=(3, rows.size)))
    vals = TP.pack(A, pat)
    assert vals.shape == (3, m, pat.row_width)
    assert torch.equal(_unpack(vals, pat), A)
    A = _fleet_A(hz)
    assert torch.equal(_unpack(TP.pack(A, pat), pat), A)


@pytest.mark.parametrize("name", list(HORIZONS))
def test_union_pattern_of_a_batch(name):
    """The union pattern of a batch with every static position nonzero is
    the static pattern, array for array.  A real fleet's A leaves some
    static positions zero in every vehicle (Jacobian entries of the
    dynamics that are exactly zero, the inactive HJI row): its union
    pattern is a strict subset."""
    hz, (n, m, _) = HORIZONS[name]
    pat = _pattern(hz)
    rows, cols = _positions(pat)
    A = torch.zeros((2, m, n), dtype=torch.float32)
    A[:, torch.as_tensor(rows), torch.as_tensor(cols)] = torch.as_tensor(
        np.random.default_rng(2).uniform(0.5, 1.5, (2, rows.size)),
        dtype=torch.float32)
    union = TP.pattern_from(A)
    for name_ in ("flat", "row_code", "col_slot", "col_row"):
        np.testing.assert_array_equal(getattr(union, name_),
                                      getattr(pat, name_))
    fleet = TP.pattern_from(_fleet_A(hz))
    inside = set(zip(*_positions(pat)))
    assert set(zip(*_positions(fleet))) < inside
    assert fleet.nnz < pat.nnz


def _first_design_products(A, v, w):
    """The first (dense, streaming) kernel's orders in float32, without
    fused multiply-adds: A x as a warp per row (lane l sums columns
    j = l, l + 32, ... ascending, then the xor butterfly), A'w as a
    thread per column over rows ascending."""
    m, n = A.shape
    part = np.zeros((m, 32), np.float32)
    for j in range(n):
        part[:, j % 32] = part[:, j % 32] + A[:, j] * v[j]
    for o in (16, 8, 4, 2, 1):
        part = part + part[:, np.arange(32) ^ o]
    atw = np.zeros(n, np.float32)
    for r in range(m):
        atw = atw + A[r] * w[r]
    return part[:, 0], atw


def _ell_products(pat, vals, v, w):
    """The same products as the redesigned kernel walks the ELL forms: a
    thread per row over its slots' codes (a lane's sum, pushed on a stack
    of six and merged as the code says), and a thread per column over the
    column-ELL's slots."""
    m, n = pat.m, pat.n
    ax = np.zeros(m, np.float32)
    for r in range(m):
        acc, stack = np.float32(0.0), []
        for p, code in enumerate(pat.row_code[r]):
            if code < 0:
                break
            if code & TP.CODE_FIRST:
                acc = np.float32(0.0)
            acc = acc + vals[r, p] * v[code & 0xFFFF]
            if code & TP.CODE_LAST:
                stack.append(acc)
                for _ in range((code >> TP.CODE_MERGE_SHIFT) & 7):
                    right = stack.pop()
                    stack.append(stack.pop() + right)
                assert len(stack) <= 6
        ax[r] = stack[0] if stack else np.float32(0.0)
        assert len(stack) <= 1
    atw = np.zeros(n, np.float32)
    flat = vals.reshape(-1)
    for j in range(n):
        for slot, r in zip(pat.col_slot[j], pat.col_row[j]):
            if slot < 0:
                break
            atw[j] = atw[j] + flat[slot] * w[r]
    return ax, atw


@pytest.mark.parametrize("name", list(HORIZONS))
def test_ell_products_keep_the_first_design_rounding(name):
    """Skipping A's zeros in the dense loops' order leaves A x and A'w bit
    for bit as the dense loops give them, on a fleet's scaled A in
    float32."""
    hz, (n, m, _) = HORIZONS[name]
    pat = _pattern(hz)
    A = _fleet_A(hz, B=1)[0].to(torch.float32)
    rng = np.random.default_rng(3)
    v = rng.normal(size=n).astype(np.float32)
    w = rng.normal(size=m).astype(np.float32)
    vals = TP.pack(A[None], pat)[0].numpy()
    ax, atw = _ell_products(pat, vals, v, w)
    ax_d, atw_d = _first_design_products(A.numpy(), v, w)
    np.testing.assert_array_equal(ax, ax_d)
    np.testing.assert_array_equal(atw, atw_d)


def test_dense_admm_smem_planner():
    for hz, (n, m, _) in HORIZONS.values():
        pat = _pattern(hz)
        need = TP.plan_smem(n, m, pat.row_width, pat.col_width)
        assert need == TP.smem_bytes(n, m, 11, 15) <= TP.SMEM_MAX
    assert TP.plan_smem(211, 290, 11, 15) <= TP.SMEM_MAX
    for shape in ((212, 290, 11, 15), (193, 290, 11, 80),
                  (100, 3000, 11, 15)):
        with pytest.raises(ValueError):
            TP.plan_smem(*shape)


def test_lane_admm_smem_planner():
    m_small = TQC.get_soft_layout(THP(N_short=4, N_long=8), False).m
    for n, m in ((30, 124), (30, 180), (24, m_small)):
        assert TL.plan_smem(n, m) == TL.smem_bytes(n, m) <= TL.SMEM_MAX
    assert TL.plan_smem(30, 124) == 156816
    assert TL.plan_smem(30, 180) == 214160
    for n, m in ((32, 192), (30, 193), (33, 10), (0, 10)):
        with pytest.raises(ValueError):
            TL.plan_smem(n, m)


def test_pattern_reaches_the_pallas_pipeline_only():
    """`mpc` hands the layout's pattern to the pallas pipeline of the
    sparse QP, and to nothing else."""
    live = HORIZONS["live"][0]
    assert _pattern(live) is TP.layout_pattern(TM._layout(_cfg(live)).lay)
    xla = TM.x1_coupled_config()
    assert TM._a_pattern_for(xla) is None
    soft = TM.x1_coupled_config(soft=True,
                                solver=SolverOptions(backend="pallas"))
    assert TM._a_pattern_for(soft) is None
