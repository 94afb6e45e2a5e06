"""The wall rows (`CoupledControlParams(use_walls=True)`) in the port's
`mpc_step_batched` against the JAX package's at float64: a 3-step closed
loop of the sparse, the hard condensed and the soft condensed coupled QP
on the oval with a 3.5 m lane (edges +1.2 / -2.3, the admissible band e
in [-1.3, 0.2]) -- vehicles inside the band, outside it on the left and
on the right, and one at the oval's seam (983 knots), where the horizon
runs past the last knot.  Commands within tests/test_torch_mpc.py's bar
(2e-4 rad, 2 N), converged flags and iterations equal, the planned states
within 1e-3; the wall slacks live on the vehicles outside the band only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_walls import EDGES, FORMS, F64, _configs
from torch_port_helpers import cache_arrays, t64, tube_arrays
from pigeon_tpu import hji as JH
from pigeon_tpu import mpc as JM
from pigeon_tpu import trajectory as JT
from pigeon_tpu_torch import convert
from pigeon_tpu_torch import mpc as TM
from pigeon_tpu_torch import trajectory as TT

# the vehicles: oval knot and lateral offset (m) -- inside the band,
# outside it left and right, and at the seam
PLACES = ((100, -0.5), (300, 0.7), (500, -1.9), (980, -0.4))


def _walls_fleet():
    """numpy (walls tube columns, q0 (4, 6), t0 (4,)): PLACES on the
    oval, the offset along the path's left normal (psi from north:
    the tangent is (-sin psi, cos psi))."""
    cols = TT.oval_columns()
    cols.update({k: np.full(len(cols["t"]), v) for k, v in EDGES.items()})
    k = np.array([p[0] for p in PLACES])
    off = np.array([p[1] for p in PLACES])
    psi = cols["psi"][k]
    q0 = np.stack([cols["E"][k] - off * np.cos(psi),
                   cols["N"][k] - off * np.sin(psi), psi + 0.02,
                   np.full(k.size, 6.0), np.zeros(k.size),
                   np.zeros(k.size)], axis=1)
    return cols, q0, cols["t"][k]


@pytest.fixture(scope="module", params=FORMS)
def loops(request):
    """Three closed-loop steps of each package (the plant held, so the
    vehicles outside the band stay there), from a cold carry."""
    form = request.param
    jcfg, tcfg = _configs(form)
    cols, q0, t0 = _walls_fleet()
    B = q0.shape[0]
    jtube = JT.make_tube(**cols, pad_to=1024)
    jcache = JH.inactive_cache()
    oc = np.broadcast_to([1e4, 1e4, 0.0, 0.0], (B, 4)).copy()
    J = jnp.asarray
    jc = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape),
                      JM.init_carry(jcfg, dtype=jnp.float64))
    jstep = jax.jit(lambda c, u, t: JM.mpc_step_batched(
        jcfg, jtube, jcache, c, J(q0), u, J(oc), t))
    ttube = convert.tube_from_numpy(tube_arrays(jtube), device="cpu",
                                    dtype=F64)
    tcache = convert.cache_from_numpy(cache_arrays(jcache), device="cpu")
    tc = TM.init_carry(tcfg, B, dtype=F64, device="cpu")
    ju, tu = J(np.zeros((B, 3))), t64(np.zeros((B, 3)))
    out = []
    for k in range(3):
        jc, ju, jd = jstep(jc, ju, J(t0 + 0.01 * k))
        tc, tu, td = TM.mpc_step_batched(tcfg, ttube, tcache, tc, t64(q0),
                                         tu, t64(oc), t64(t0 + 0.01 * k))
        out.append(((jc, ju, jd), (tc, tu, td)))
    return form, tcfg, out


@pytest.mark.parametrize("k", [0, 1, 2])
def test_walls_closed_loop_matches(loops, k):
    form, tcfg, out = loops
    (jc, ju, jd), (tc, tu, td) = out[k]
    d = np.abs(np.asarray(ju) - tu.numpy())
    assert np.all(np.isfinite(tu.numpy()))
    assert d[:, 0].max() < 2e-4 and d[:, 1:].max() < 2.0, d
    np.testing.assert_array_equal(td.converged.numpy(),
                                  np.asarray(jd.converged))
    np.testing.assert_array_equal(td.iterations.numpy(),
                                  np.asarray(jd.iterations))
    # the projections put the vehicles where PLACES says (e > 0 left)
    np.testing.assert_allclose(td.e.numpy(), [p[1] for p in PLACES],
                               atol=1e-3)
    np.testing.assert_allclose(tc.q_prev.numpy(), np.asarray(jc.q_prev),
                               atol=1e-3)


def test_walls_slacks_live(loops):
    """The vehicles outside the band [-1.3, 0.2] plan through a positive
    wall slack (the hard QPs' sw; the soft QP's wall row violated), the
    one inside it through none."""
    form, tcfg, out = loops
    (jc, _, _), (tc, _, _) = out[-1]
    L = TM._layout(tcfg)
    x = tc.warm_x.numpy()
    if form == "soft":
        q_plan = tc.q_prev.numpy()[:, 1:, 5]
        live = (q_plan > 0.2 + 1e-3) | (q_plan < -1.3 - 1e-3)
    else:
        live = x[:, L.sw] > 1e-3
        np.testing.assert_allclose(x[:, L.sw], np.asarray(jc.warm_x)[:, L.sw],
                                   atol=1e-3)
    assert live[1].any() and live[2].any() and not live[0].any(), live
