"""The traffic generator on the CPU at B = 16."""

import json
import math

import torch

from conftest import ROOT
from benchmark.harness import load_module
from benchmark.reference.world import oval_columns

TRAFFIC = ROOT / "benchmark" / "traffic"


def _mix(name, fleet=16):
    mix = json.loads((TRAFFIC / f"{name}.json").read_text())
    return dict(mix, fleet=fleet)


def _world():
    cols = oval_columns()
    return cols, {k: torch.as_tensor(cols[k], dtype=torch.float32)
                  for k in ("E", "N", "psi", "t")}


def _draw(name, seed):
    gen = load_module(TRAFFIC / "closed_loop.py")
    _, world = _world()
    return gen.draw(_mix(name), world, torch.Generator().manual_seed(seed))


def test_same_seed_same_fleet_other_seed_other_fleet():
    for name in ("track", "encounter"):
        a, b, c = _draw(name, 7), _draw(name, 7), _draw(name, 2**31 + 5)
        for k in a:
            assert torch.equal(a[k], b[k])
        assert not torch.equal(a["q"], c["q"])


def test_track_fleet_within_its_parameters():
    cols, _ = _world()
    st = _draw("track", 3)
    q, t = st["q"].double(), st["t"].double()
    assert q.shape == (16, 6) and st["u"].abs().max() == 0
    assert torch.all(q[:, 3] == 6.0) and torch.all(q[:, 4:] == 0)
    # each vehicle within the jitter of a knot in 0-899 at that knot's time
    knots = torch.searchsorted(torch.as_tensor(cols["t"]), t)
    assert int(knots.max()) < 900
    dE = (q[:, 0] - torch.as_tensor(cols["E"])[knots]).abs()
    dN = (q[:, 1] - torch.as_tensor(cols["N"])[knots]).abs()
    assert float(dE.max()) <= 0.5 + 1e-5 and float(dN.max()) <= 0.5 + 1e-5
    assert torch.all(st["oc"][:, :2] == 1.0e4)


def test_encounter_other_car_ahead_and_oncoming():
    st = _draw("encounter", 4)
    q, oc = st["q"].double(), st["oc"].double()
    dE, dN = oc[:, 0] - q[:, 0], oc[:, 1] - q[:, 1]
    s, c = torch.sin(q[:, 2]), torch.cos(q[:, 2])
    ahead = -s * dE + c * dN
    lateral = -c * dE - s * dN
    assert float(ahead.min()) >= 3.0 - 1e-4 and float(ahead.max()) <= 15.0
    assert float(lateral.abs().max()) <= 1.0 + 1e-4
    turn = oc[:, 2] - q[:, 2] - math.pi
    assert float(turn.abs().max()) <= 0.1 + 1e-5
    assert float(oc[:, 3].min()) >= 2.0 and float(oc[:, 3].max()) <= 8.0


def test_other_car_drives_on_at_constant_velocity():
    gen = load_module(TRAFFIC / "closed_loop.py")
    oc = torch.tensor([[0.0, 0.0, 0.5, 4.0]])
    nxt = gen.advance(oc, 0.01)
    assert torch.allclose(nxt[0, :2], torch.tensor(
        [-0.04 * math.sin(0.5), 0.04 * math.cos(0.5)]))
    assert torch.equal(nxt[0, 2:], oc[0, 2:])
