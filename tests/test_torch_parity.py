"""pigeon_tpu_torch.parity against pigeon_tpu.parity at float64: the
stiff eigenvalue and RK4 amplification (rtol 1e-10), `stable_substeps`
on two `.world` files the test writes from the oval (at the oval's speed
and at 2.7 m/s), the faithful and deviation configurations field by
field, and `compare` on the oval's `.world` (both modules' REFERENCE_PATHS
pointed at the test's directory) at horizon (2, 3), 3 steps: every
ParityResult field equal or within its tolerance -- the command deltas
within 1e-9 rad and 1e-6 N (they are differences of two commands, each
equal to ~1e-12 between the packages), the tracking errors within rtol
1e-9, the shares and flags equal.  The harness refuses the card (its
float32 kernels; the harness runs in float64).
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_trajectory_loaders import _world_text
from pigeon_tpu import mpc as JM
from pigeon_tpu import parity as JP
from pigeon_tpu import trajectory as JT
from pigeon_tpu.config import HorizonParams as JHP
from pigeon_tpu.config import x1_params as jax_x1
from pigeon_tpu_torch import mpc as TM
from pigeon_tpu_torch import parity as TP
from pigeon_tpu_torch import trajectory as TT
from pigeon_tpu_torch.config import HorizonParams as THP
from pigeon_tpu_torch.config import x1_params

VEH = x1_params()


def _oval_world(V=None) -> str:
    cols = TT.oval_columns()
    n = cols["s"].shape[0]
    return _world_text(dict(
        cols, V=cols["V"] if V is None else np.full(n, V),
        grade=np.zeros(n), edge_L=np.full(n, 4.0), edge_R=np.full(n, -4.0)))


@pytest.fixture
def worlds(tmp_path, monkeypatch):
    (tmp_path / "oval.world").write_text(_oval_world())
    (tmp_path / "slow.world").write_text(_oval_world(2.7))
    for mod in (JP, TP):
        monkeypatch.setattr(mod, "REFERENCE_PATHS", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("V", [1.0, 2.7, 6.0, 12.0])
def test_stiff_eigenvalue_matches(V):
    j = JP.stiff_eigenvalue(jax_x1(), V)
    t = TP.stiff_eigenvalue(VEH, V)
    assert abs(t - j) <= 1e-10 * abs(j)
    for sub in (1, 4, 8):
        z = t * 0.2 / sub
        assert TP.rk4_amplification(z) == JP.rk4_amplification(z)


@pytest.mark.parametrize("world,expect", [("oval", 4), ("slow", 8)])
def test_stable_substeps_matches(worlds, world, expect):
    path = str(worlds / f"{world}.world")
    jt = JT.tube_from_world(path, pad_to=1024)
    tt = TT.tube_from_world(path, pad_to=1024, device="cpu",
                            dtype=torch.float64)
    assert (TP.stable_substeps(VEH, tt) == JP.stable_substeps(jax_x1(), jt)
            == expect)


def test_configs_match():
    for sub in (1, 8):
        t = TP.faithful_config(TM.x1_coupled_config(), sub)
        j = JP.faithful_config(JM.x1_coupled_config(), sub)
        for f in ("tire_inverse", "lin_method", "lin_substeps",
                  "clamp_commands"):
            assert getattr(t, f) == getattr(j, f), f
        assert (dataclasses.asdict(t.solver)
                == dataclasses.asdict(j.solver)
                == dataclasses.asdict(TP.PARITY_SOLVER))
    d = TP.deviation_config(TM.x1_decoupled_config())
    assert d.solver == TP.PARITY_SOLVER and d.lin_method == "expm"
    assert TP.ALL_WORLDS == JP.ALL_WORLDS
    assert TP.REFERENCE_PATHS == "/root/reference/test/path"


def test_compare_matches(worlds):
    j = JP.compare("oval", "coupled", 3, 1, hz=JHP(N_short=2, N_long=3))
    t = TP.compare("oval", "coupled", 3, 1, hz=THP(N_short=2, N_long=3),
                   device="cpu")
    assert t._fields == j._fields
    for name, a, b in zip(t._fields, t, j):
        if name.startswith(("max_d_delta", "rms_d_delta")):
            assert abs(a - b) <= 1e-9, name
        elif name.startswith(("max_d_Fx", "rms_d_Fx")):
            assert abs(a - b) <= 1e-6, name
        elif name.startswith("max_e"):
            assert abs(a - b) <= 1e-9 * abs(b), name
        else:
            assert a == b, name
    assert t.prefix_steps == 3 and t.faithful_finite and t.deviation_finite


@pytest.mark.parametrize("entry", ["compare", "run_closed_loop"])
def test_harness_refuses_the_card(worlds, entry):
    """The harness runs in float64, which the card's float32 kernels do
    not take: a CUDA device raises before anything is loaded."""
    call = {"compare": lambda: TP.compare("oval", "coupled", 3,
                                          device="cuda"),
            "run_closed_loop": lambda: TP.run_closed_loop(
                TP.faithful_config(TM.x1_coupled_config()), "oval", 3,
                device="cuda")}[entry]
    with pytest.raises(ValueError, match="float64"):
        call()
