"""The port's configuration equals the JAX package's field by field, and
the port (and chip_smoke.py) import neither JAX nor `pigeon_tpu`."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

import torch_port_helpers  # noqa: F401  (thread count)
from pigeon_tpu import config as JC
from pigeon_tpu import mpc as JM
from pigeon_tpu_torch import config as TC
from pigeon_tpu_torch import mpc as TM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", [
    "VehicleParams", "HorizonParams", "DecoupledControlParams",
    "CoupledControlParams", "SolverOptions", "SimOptions"])
def test_config_dataclass_matches(name):
    jcls, tcls = getattr(JC, name), getattr(TC, name)
    jf = [(f.name, f.default, f.type) for f in dataclasses.fields(jcls)]
    tf = [(f.name, f.default, f.type) for f in dataclasses.fields(tcls)]
    assert jf == tf
    assert jcls.__dataclass_params__.frozen and tcls.__dataclass_params__.frozen
    if name != "VehicleParams":
        assert dataclasses.asdict(jcls()) == dataclasses.asdict(tcls())


def test_x1_params_match():
    assert dataclasses.asdict(JC.x1_params()) == \
        dataclasses.asdict(TC.x1_params())


def test_mpc_config_matches():
    jf = [f.name for f in dataclasses.fields(JM.MPCConfig)]
    tf = [f.name for f in dataclasses.fields(TM.MPCConfig)]
    assert jf == tf
    for kw in (dict(soft=True), dict(soft=True, hji_eps=0.1)):
        assert dataclasses.asdict(JM.x1_coupled_config(**kw)) == \
            dataclasses.asdict(TM.x1_coupled_config(**kw))


_PROBE = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import pigeon_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pigeon_tpu_torch.__path__,
                                               "pigeon_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = [k for k in sys.modules
       if k in ("jax", "pigeon_tpu") or k.startswith(("jax.", "pigeon_tpu."))]
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE, REPO], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for mod in ("pigeon_tpu_torch.mpc", "pigeon_tpu_torch.convert",
                "pigeon_tpu_torch._kernels",
                "pigeon_tpu_torch.solver.lane_admm",
                "pigeon_tpu_torch.qp.condensed"):
        assert mod in res["modules"]


def test_entry_points_default_to_cuda():
    """Without device="cpu" the constructors ask for the card, and raise
    where there is none."""
    import torch

    from pigeon_tpu_torch import hji, trajectory

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        trajectory.straight_trajectory(10.0, 5.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        hji.inactive_cache()
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.init_carry(TM.x1_coupled_config(soft=True), 2)
