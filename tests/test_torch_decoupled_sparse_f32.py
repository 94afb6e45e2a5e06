"""The sparse decoupled QP's convergence at float32, in both packages:
one cold step of 16 vehicles of chip_smoke.py's oval fleet placement
(`oval_fleet`, seed 0) on chip_smoke's sparse budget (400 iterations in
segments of 50, 4 Ruiz sweeps, eps 1e-3) with backend "xla" (the JAX
package's "pallas" pipeline runs here only in interpret mode), each
package at float32 and at float64.

At float64 every vehicle converges, in both packages, to the same
iterations; at float32 both leave part of the fleet unconverged (its
155 stiff equality rows, rho_eq = 1e3 rho): the reason chip_smoke.py
holds the fleet's converged share to its plain version's and not to
0.99.  The float32 shares of the two packages are two roundings of the
same solves: each is recorded, and they may differ by a few vehicles.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import cache_arrays, oval_fleet, tube_arrays
from pigeon_tpu import hji as JH
from pigeon_tpu import mpc as JM
from pigeon_tpu import trajectory as JT
from pigeon_tpu.config import SolverOptions as JSO
from pigeon_tpu_torch import convert
from pigeon_tpu_torch import mpc as TM
from pigeon_tpu_torch.config import SolverOptions as TSO

B = 16
BUDGET = dict(max_iter=400, check_every=50, eps_abs=1e-3, eps_rel=1e-3,
              backend="xla", scaling_iters=4)


def _jax_step(q0, t0, cols, x64: bool):
    """The JAX package's cold step (converged, iterations), with 64-bit
    types on or off: at float32 the package runs with x64 off, as on a
    TPU (with x64 on its float32 carries promote)."""
    with jax.enable_x64(x64):
        dt = jnp.float64 if x64 else jnp.float32
        cfg = dataclasses.replace(JM.x1_decoupled_config(),
                                  solver=JSO(**BUDGET))
        tube = JT.make_tube(**cols, pad_to=1024)
        cache = JH.inactive_cache()
        carry = JM.init_carry(cfg, dtype=dt)
        jc = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape),
                          carry)
        oc = jnp.broadcast_to(jnp.asarray([1e4, 1e4, 0.0, 0.0], dt), (B, 4))
        _, _, d = jax.jit(lambda c, q, u, t: JM.mpc_step_batched(
            cfg, tube, cache, c, q, u, oc, t))(
            jc, jnp.asarray(q0, dt), jnp.zeros((B, 3), dt),
            jnp.asarray(t0, dt))
        assert d.prim_res.dtype == dt
        return np.asarray(d.converged), np.asarray(d.iterations)


@pytest.fixture(scope="module")
def converged():
    """Each package's converged flags and iterations of the cold step, at
    float32 and float64."""
    q0, t0, cols = oval_fleet(B, seed=0)
    jtube = JT.make_tube(**cols, pad_to=1024)
    tcache = convert.cache_from_numpy(cache_arrays(JH.inactive_cache()),
                                      device="cpu")
    tcfg = dataclasses.replace(TM.x1_decoupled_config(),
                               solver=TSO(**BUDGET))
    out = {}
    for name, tdt in (("f32", torch.float32), ("f64", torch.float64)):
        ttube = convert.tube_from_numpy(tube_arrays(jtube), device="cpu",
                                        dtype=tdt)
        as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=tdt)
        _, _, td = TM.mpc_step_batched(
            tcfg, ttube, tcache, TM.init_carry(tcfg, B, dtype=tdt,
                                               device="cpu"),
            as_t(q0), as_t(np.zeros((B, 3))),
            as_t(np.broadcast_to([1e4, 1e4, 0.0, 0.0], (B, 4))), as_t(t0))
        assert td.prim_res.dtype == tdt
        out[name] = dict(jax=_jax_step(q0, t0, cols, name == "f64"),
                         port=(td.converged.numpy(), td.iterations.numpy()))
    return out


def test_float64_converges_every_vehicle(converged):
    (jc, ji), (tc, ti) = converged["f64"]["jax"], converged["f64"]["port"]
    assert jc.all() and tc.all()
    np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_float32_leaves_vehicles_unconverged(converged, package):
    """Each package at float32 leaves some of the 16 unconverged within
    the budget, and converges at least half of them."""
    conv, _ = converged["f32"][package]
    assert B // 2 <= conv.sum() < B, conv.sum()
    other = converged["f32"]["port" if package == "jax" else "jax"][0]
    assert abs(int(conv.sum()) - int(other.sum())) <= 4
