"""`mpc_step(..., nodes_mode=)` in the port against the JAX package's
(pigeon_tpu/mpc.py:459-473, :649-666) at float64, on the sparse coupled
QP at horizon (2, 3) on the straight test path: a JAX cold step gives a
warm carry; from it and from the cold carry, one more step of each
package in each mode.  Commands within 1e-9 rad and 1e-6 N of the JAX
package's.  "warm_only" takes the warm nodes whatever the carry says:
on a warm carry it equals "auto", on a cold one it resamples the empty
previous solution, another QP.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import cache_arrays, carry_arrays, t64, tube_arrays
from pigeon_tpu import hji as JH
from pigeon_tpu import mpc as JM
from pigeon_tpu import trajectory as JT
from pigeon_tpu.config import HorizonParams as JHP
from pigeon_tpu_torch import convert
from pigeon_tpu_torch import mpc as TM
from pigeon_tpu_torch.config import HorizonParams as THP

F64 = torch.float64


@pytest.fixture(scope="module")
def warm_steps():
    """{(carry, mode): (JAX command, port command)}."""
    hz = (2, 3)
    jcfg = JM.x1_coupled_config(hz=JHP(N_short=hz[0], N_long=hz[1]))
    tcfg = TM.x1_coupled_config(hz=THP(N_short=hz[0], N_long=hz[1]))
    jtube = JT.straight_trajectory(60.0, 5.0, pad_to=32)
    ttube = convert.tube_from_numpy(tube_arrays(jtube), device="cpu",
                                    dtype=F64)
    jcache = JH.inactive_cache()
    tcache = convert.cache_from_numpy(cache_arrays(jcache), device="cpu")
    q0 = np.array([0.2, 0.3, 0.01, 5.0, 0.05, 0.0])
    oc = np.array([1e4, 1e4, 0.0, 0.0])
    J = jnp.asarray
    steps = {mode: jax.jit(lambda c, u, t, mode=mode: JM.mpc_step(
        jcfg, jtube, jcache, c, J(q0), u, J(oc), t, nodes_mode=mode))
        for mode in ("auto", "warm_only")}
    cold = JM.init_carry(jcfg, dtype=jnp.float64)
    warm, u1, _ = steps["auto"](cold, jnp.zeros(3), 0.0)
    out = {}
    for name, jc in (("warm", warm), ("cold", cold)):
        tc = convert.carry_from_numpy(carry_arrays(jc), device="cpu",
                                      dtype=F64)
        for mode, step in steps.items():
            _, ju, _ = step(jc, u1, 0.01)
            _, tu, _ = TM.mpc_step(tcfg, ttube, tcache, tc, t64(q0),
                                   t64(np.asarray(u1)), t64(oc), 0.01,
                                   nodes_mode=mode)
            out[name, mode] = (np.asarray(ju), tu.numpy())
    return out


@pytest.mark.parametrize("carry", ["warm", "cold"])
@pytest.mark.parametrize("mode", ["auto", "warm_only"])
def test_nodes_mode_matches(warm_steps, carry, mode):
    ju, tu = warm_steps[carry, mode]
    assert abs(tu[0] - ju[0]) < 1e-9 and np.abs(tu[1:] - ju[1:]).max() < 1e-6
    if carry == "warm":
        # a warm carry: both modes take the warm nodes
        np.testing.assert_array_equal(tu, warm_steps[carry, "auto"][1])


def test_nodes_mode_warm_only_on_a_cold_carry_differs(warm_steps):
    """On a cold carry "warm_only" resamples the empty previous solution
    instead of the trim rollout: another QP, in both packages."""
    assert np.abs(warm_steps["cold", "auto"][1]
                  - warm_steps["cold", "warm_only"][1]).max() > 1e-3
    with pytest.raises(ValueError):
        TM.mpc_step(TM.x1_coupled_config(), None, None, None, None, None,
                    None, 0.0, nodes_mode="cold")
