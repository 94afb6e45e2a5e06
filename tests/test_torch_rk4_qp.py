"""The coupled QPs built on the reference-faithful RK4 linearization
(lin_method "rk4") and on the per-hold-order exponentials ("expm_split")
in the port against the JAX package at float64 (rtol 1e-10), at the live
horizon (5, 10), on nodes seeded along the oval: the sparse QP with
"rk4" and "expm_split", the hard and the soft condensed QP with "rk4".
The condensed QPs take the RK4 path for every lin_method but "expm",
"expm_split" too, in both packages (pigeon_tpu/qp/condensed.py:168, :585):
the port's "expm_split" QP equals its "rk4" one there.  A float32 stage
gives a float32 QP.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_coupled_sparse import _stage_data
from test_torch_walls import _assert_qp_close
from torch_port_helpers import t64
from pigeon_tpu.config import HorizonParams as JHP
from pigeon_tpu.qp import condensed as JQC
from pigeon_tpu.qp import coupled as JC
from pigeon_tpu_torch import mpc as TM
from pigeon_tpu_torch.config import HorizonParams as THP
from pigeon_tpu_torch.qp import condensed as TQC
from pigeon_tpu_torch.qp import coupled as TC

HZ = (5, 10)
CFG = TM.x1_coupled_config(hz=THP(N_short=HZ[0], N_long=HZ[1]))
JHZ = JHP(N_short=HZ[0], N_long=HZ[1])
BUILDS = {"sparse": (JC.build_qp, TC.build_qp),
          "condensed": (JQC.build_qp, TQC.build_qp),
          "soft": (JQC.build_qp_soft, TQC.build_qp_soft)}


@pytest.fixture(scope="module")
def stage():
    d = _stage_data(CFG)
    return (JC.CoupledStageData(**{k: jnp.asarray(v) for k, v in d.items()}),
            TC.CoupledStageData(**{k: t64(v) for k, v in d.items()}))


def _jax_qps(data, forms, method):
    """The JAX package's QPs of `forms`, one jitted program (the forms
    share the linearization, which XLA compiles once)."""
    return jax.jit(jax.vmap(lambda s: [BUILDS[f][0](
        CFG.veh, CFG.coupled, JHZ, s, lin_method=method) for f in forms]))(
        data)


@pytest.fixture(scope="module")
def rk4_qps(stage):
    return dict(zip(BUILDS, _jax_qps(stage[0], list(BUILDS), "rk4")))


@pytest.mark.parametrize("form", list(BUILDS))
def test_build_qp_rk4_matches(stage, rk4_qps, form):
    out = BUILDS[form][1](CFG.veh, CFG.coupled, CFG.hz, stage[1],
                          lin_method="rk4")
    _assert_qp_close(rk4_qps[form], out)


def test_build_qp_expm_split_matches(stage):
    ref, = _jax_qps(stage[0], ["sparse"], "expm_split")
    out = TC.build_qp(CFG.veh, CFG.coupled, CFG.hz, stage[1],
                      lin_method="expm_split")
    _assert_qp_close(ref, out)


@pytest.mark.parametrize("form", ["condensed", "soft"])
def test_condensed_expm_split_is_rk4(stage, form):
    build = BUILDS[form][1]
    split = build(CFG.veh, CFG.coupled, CFG.hz, stage[1],
                  lin_method="expm_split")
    rk4 = build(CFG.veh, CFG.coupled, CFG.hz, stage[1], lin_method="rk4")
    for a, b in zip(split, rk4):
        assert torch.equal(a, b)


def test_build_qp_float32(stage):
    data = type(stage[1])(*[None if x is None else x.float()
                            for x in stage[1]])
    for form in BUILDS:
        qp = BUILDS[form][1](CFG.veh, CFG.coupled, CFG.hz, data,
                             lin_method="rk4", lin_substeps=1)
        assert all(x.dtype == torch.float32 for x in qp), form
