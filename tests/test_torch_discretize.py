"""pigeon_tpu_torch.discretize against pigeon_tpu.discretize: the plain
version of the structured Van Loan kernel against the TPU kernel run in
interpret mode (float32) and against the dense exponential (float64), and
the fused horizon linearization of the tracking ODE (float64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import t64
from pigeon_tpu import discretize as JZ
from pigeon_tpu import dynamics as JD
from pigeon_tpu.config import x1_params
from pigeon_tpu_torch import discretize as TZ
from pigeon_tpu_torch import dynamics as TD

VEH = x1_params()


def _rand_inputs(B, T, n, m, seed=0, dt_scale=0.05):
    rng = np.random.default_rng(seed)
    P0 = rng.normal(size=(B, T, n, n)) * dt_scale
    Cu0 = rng.normal(size=(B, T, n, m)) * dt_scale
    cc0 = rng.normal(size=(B, T, n, 1)) * dt_scale
    # mixed ZOH (0) / FOH (dt) ramp scalars
    rr = (rng.uniform(0.0, 0.2, size=(B, T))
          * rng.integers(0, 2, size=(B, T)))
    return P0, Cu0, cc0, rr


def test_vanloan_plain_matches_tpu_kernel_fp32():
    """B=130 spans two 128-lane blocks of the TPU kernel; the bar is the
    one tests/test_vanloan.py holds the kernel to."""
    ins = [a.astype(np.float32) for a in _rand_inputs(130, 15, 6, 6)]
    ref = JZ._vanloan_lane_batched(*[jnp.asarray(a) for a in ins], 4, 6,
                                   interpret=True)
    out = TZ.vanloan(*[torch.as_tensor(a) for a in ins], 4, 6)
    for o, r in zip(out, ref):
        assert o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=3e-5,
                                   atol=3e-6)


@pytest.mark.parametrize("T, n, squarings, order", [
    (30, 4, 4, 6),   # the decoupled fleet's lateral model (n = 4, T = 30)
    (15, 6, 3, 5),   # an order and squarings the kernel takes at run time
])
def test_vanloan_plain_matches_tpu_kernel_other_shapes_fp32(T, n, squarings,
                                                            order):
    ins = [a.astype(np.float32) for a in _rand_inputs(130, T, n, 6, seed=5)]
    ref = JZ._vanloan_lane_batched(*[jnp.asarray(a) for a in ins], squarings,
                                   order, interpret=True)
    out = TZ.vanloan(*[torch.as_tensor(a) for a in ins], squarings, order)
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=3e-5,
                                   atol=3e-6)


@pytest.mark.parametrize("n, m, plan", [(6, 6, (32, 192, 34816)),
                                        (4, 6, (64, 256, 40448))])
def test_vanloan_plan_takes_the_path_shapes(n, m, plan):
    """A chunk is `stages` consecutive stages; a block gives each n threads
    (a whole number of warps) and holds two chunks' input slabs (P0, Cu0,
    cc0, rr) and one chunk's output slabs (A, X, Y, z) in static shared
    memory."""
    assert TZ.vanloan_plan(n, m) == plan
    stages, threads, smem = plan
    assert threads == stages * n and threads % 32 == 0
    ins = n * n + n * m + n + 1
    outs = n * n + 2 * n * m + n
    assert smem == 4 * stages * (2 * ins + outs) <= TZ.VANLOAN_SMEM_MAX


@pytest.mark.parametrize("n, m", [(6, 6), (4, 6)])
def test_vanloan_block_slabs_stay_16_byte_aligned(n, m):
    """The kernel copies each slab with 16-byte copies and reads a stage's
    rows as float4 or float2: every slab of every chunk, in device and in
    shared memory, starts on 16 bytes, and every row on its vector."""
    stages = TZ.vanloan_plan(n, m)[0]
    # (floats a stage, floats a row) of P0, Cu0, cc0, rr twice, then A, X,
    # Y, z
    ins = ((n * n, n), (n * m, m), (n, n), (1, 1))
    slabs = ins + ins + ((n * n, n), (n * m, m), (n * m, m), (n, n))
    offsets = np.cumsum([0] + [stages * w for w, _ in slabs[:-1]])
    assert np.all(offsets % 4 == 0)
    for s0 in range(0, 130 * 15, stages):
        assert all((s0 * w) % 4 == 0 for w, _ in slabs)
    for off, (w, row) in zip(offsets, slabs):
        vec = 4 if row % 4 == 0 else 2 if row % 2 == 0 else 1
        assert all((off + st * w + k * row) % vec == 0
                   for st in range(stages) for k in range(w // row))


@pytest.mark.parametrize("n, m", [(5, 6), (6, 4), (8, 6), (6, 7)])
def test_vanloan_plan_refuses_other_shapes(n, m):
    with pytest.raises(ValueError, match="built for"):
        TZ.vanloan_plan(n, m)


def test_vanloan_plan_refuses_a_block_over_static_shared_memory(monkeypatch):
    monkeypatch.setitem(TZ.VANLOAN_STAGES, 6, 128)   # 139,264 B
    with pytest.raises(ValueError, match="shared memory"):
        TZ.vanloan_plan(6, 6)


def test_vanloan_zoh_ramp_zero_gives_zero_phiqv():
    P0, Cu0, cc0, _ = _rand_inputs(3, 4, 6, 6, seed=1)
    out = TZ.vanloan(t64(P0), t64(Cu0), t64(cc0), t64(np.zeros((3, 4))), 4, 6)
    np.testing.assert_array_equal(out[2].numpy(), 0.0)


def test_vanloan_plain_matches_dense_fp64():
    ins = _rand_inputs(5, 15, 6, 6, seed=2, dt_scale=0.3)
    vl = JZ._vanloan_cached(4, 6, "highest")
    ref = jax.vmap(vl)(*[jnp.asarray(a) for a in ins])
    out = TZ.vanloan_plain(*[t64(a) for a in ins], 4, 6)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-9,
                                   atol=1e-12)


def test_vanloan_rejects_bad_arguments():
    P0, Cu0, cc0, rr = (t64(a) for a in _rand_inputs(2, 3, 6, 6))
    with pytest.raises(ValueError, match="order"):
        TZ.vanloan(P0, Cu0, cc0, rr, 4, 1)
    with pytest.raises(ValueError, match="shape"):
        TZ.vanloan(P0, Cu0, cc0[:, :2], rr, 4, 6)
    with pytest.raises(ValueError):
        TZ.vanloan(P0, Cu0.float(), cc0, rr, 4, 6)


def _horizon_nodes(B, N, seed=3):
    rng = np.random.default_rng(seed)
    qs = np.stack([rng.uniform(-1, 1, (B, N)), rng.uniform(4, 10, (B, N)),
                   rng.uniform(-0.5, 0.5, (B, N)),
                   rng.uniform(-0.3, 0.3, (B, N)),
                   rng.uniform(-0.2, 0.2, (B, N)),
                   rng.uniform(-0.5, 0.5, (B, N))], axis=-1)
    urs = np.stack([rng.uniform(-0.2, 0.2, (B, N)),
                    rng.uniform(-4e3, 4e3, (B, N)),
                    rng.uniform(5, 9, (B, N)),
                    rng.uniform(-0.05, 0.05, (B, N)),
                    np.zeros((B, N)), np.zeros((B, N))], axis=-1)
    dts = np.concatenate([np.full((B, 5), 0.01),
                          rng.uniform(0.15, 0.2, (B, N - 6))], axis=1)
    return qs, urs, dts


def test_linearize_horizon_fused_tracking_fp64():
    B, N, S = 3, 16, 5
    qs, urs, dts = _horizon_nodes(B, N)

    def jf(q, ur):
        return JD.vehicle_ode(VEH, "tracking", q, ur[:2], ur[2:])

    def tf(q, ur):
        return TD.vehicle_ode(VEH, "tracking", q, ur[..., :2], ur[..., 2:])

    ref = jax.jit(jax.vmap(lambda q, u, d: JZ.linearize_horizon_fused(
        jf, q, u, d, S, 2, squarings=4, order=6, precision="highest")))(
        jnp.asarray(qs), jnp.asarray(urs), jnp.asarray(dts))
    out = TZ.linearize_horizon_fused(tf, t64(qs), t64(urs), t64(dts), S, 2,
                                     squarings=4, order=6)
    for o, r, name in zip(out, ref, ("A", "B0", "Bf", "c")):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-9,
                                   atol=1e-10, err_msg=name)
    np.testing.assert_array_equal(out[2][:, :S].numpy(), 0.0)


def test_expm_and_plant_step_fp64():
    rng = np.random.default_rng(4)
    M = rng.normal(size=(4, 7, 7))
    np.testing.assert_allclose(
        TZ.expm_fixed(t64(M)).numpy(),
        np.asarray(jax.vmap(JZ.expm_fixed)(jnp.asarray(M))), rtol=1e-10,
        atol=1e-12)
    q = np.stack([rng.uniform(-5, 5, 6), rng.uniform(-5, 5, 6),
                  rng.uniform(-1, 1, 6), rng.uniform(3, 9, 6),
                  rng.uniform(-0.5, 0.5, 6), rng.uniform(-0.3, 0.3, 6)], 1)
    ur = np.concatenate([np.stack([rng.uniform(-0.2, 0.2, 6),
                                   rng.uniform(-4e3, 4e3, 6)], 1),
                         np.zeros((6, 4))], axis=1)

    def jf(q_, r_):
        return JD.vehicle_ode(VEH, "bicycle", q_, r_[:2], r_[2:])

    def tf(q_, r_):
        return TD.vehicle_ode(VEH, "bicycle", q_, r_[..., :2], r_[..., 2:])

    ref = jax.vmap(lambda a, b: JZ.propagate(jf, a, b, 0.01, 2))(
        jnp.asarray(q), jnp.asarray(ur))
    out = TZ.propagate(tf, t64(q), t64(ur), 0.01, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)
