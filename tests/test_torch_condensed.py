"""pigeon_tpu_torch.qp.condensed against pigeon_tpu.qp.condensed at
float64: the soft condensed layout, QP assembly at the full coupled horizon
(N_short=5, N_long=10) on nodes seeded along the oval, and the solution
extraction."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_port_helpers import oval_fleet, t64
from pigeon_tpu.qp import condensed as JQ
from pigeon_tpu.qp.coupled import CoupledStageData as JStage
from pigeon_tpu_torch import mpc as TM
from pigeon_tpu_torch import trajectory as TT
from pigeon_tpu_torch.qp import condensed as TQ
from pigeon_tpu_torch.qp.coupled import CoupledStageData as TStage

CFG = TM.x1_coupled_config(soft=True)


def _stage_data(B=3):
    """Cold nodes of an oval fleet (the port's seeding, float64) and a
    random HJI half-plane row per vehicle."""
    q0, t0, cols = oval_fleet(B, seed=5)
    tube = TT.make_tube(**cols, pad_to=1024, device="cpu",
                        dtype=torch.float64)
    ts, dt = TM.compute_time_steps(CFG.hz, t64(t0))
    q0 = t64(q0)
    u0 = t64(np.tile([0.02, 300.0, 200.0], (B, 1)))
    s0, e0, _ = TT.path_coordinates(tube, q0[:, :2])
    qs, us, ps = TM._nodes_coupled_cold(CFG, tube, q0, u0, ts, dt, s0, e0)
    rng = np.random.default_rng(6)
    return dict(dt=dt.numpy(), qs=qs.numpy(), us=us.numpy(), ps=ps.numpy(),
                hji_M=rng.normal(size=(B, 2)) * [1.0, 1e-4],
                hji_b=rng.normal(size=B))


def test_soft_layout_matches():
    jl = JQ.get_soft_layout(CFG.hz)
    tl = TQ.get_soft_layout(CFG.hz)
    assert (tl.n, tl.m) == (jl.n, jl.m) == (30, 124)
    assert jl.eq_rows.size == 0
    for name in ("u", "r_ux", "r_fx", "r_hji", "r_delta", "r_env", "r_rate",
                 "_sp_rows", "_sp_cols"):
        np.testing.assert_array_equal(getattr(tl, name), getattr(jl, name))


def test_build_qp_soft_matches_fp64():
    d = _stage_data()
    ref = jax.jit(jax.vmap(lambda s: JQ.build_qp_soft(
        CFG.veh, CFG.coupled, CFG.hz, s)))(
        JStage(**{k: jnp.asarray(v) for k, v in d.items()}))
    out = TQ.build_qp_soft(CFG.veh, CFG.coupled, CFG.hz,
                           TStage(**{k: t64(v) for k, v in d.items()}))
    for name in ref._fields:
        r = np.asarray(getattr(ref, name))
        o = getattr(out, name).numpy()
        assert o.shape == r.shape, name
        finite = np.isfinite(r)
        np.testing.assert_array_equal(np.isfinite(o), finite, err_msg=name)
        np.testing.assert_array_equal(o[~finite], r[~finite], err_msg=name)
        np.testing.assert_allclose(o[finite], r[finite], rtol=1e-9,
                                   atol=1e-9 * np.abs(r[finite]).max(),
                                   err_msg=name)


def test_extract_soft_matches():
    rng = np.random.default_rng(7)
    B, hz, veh = 3, CFG.hz, CFG.veh
    T, n = hz.N_short + hz.N_long, 30
    x = rng.normal(size=(B, n))
    G = rng.normal(size=(B, T, 6, n))
    g = rng.normal(size=(B, T, 6))
    qc = rng.normal(size=(B, 6))
    uc = rng.normal(size=(B, 2))
    ref_u = jax.vmap(lambda v: JQ.extract_control_soft(veh, hz, v))(
        jnp.asarray(x))
    np.testing.assert_allclose(
        TQ.extract_control_soft(veh, hz, t64(x)).numpy(), np.asarray(ref_u),
        rtol=1e-12)
    ref = jax.vmap(lambda v, a, b, c, e: JQ.extract_trajectory_soft(
        hz, v, veh, a, b, c, e))(*[jnp.asarray(a) for a in (x, G, g, qc,
                                                             uc)])
    out = TQ.extract_trajectory_soft(t64(x), veh, t64(G), t64(g), t64(qc),
                                     t64(uc))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-12,
                                   atol=1e-12)
