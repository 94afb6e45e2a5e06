"""pigeon_tpu_torch.trajectory's loaders against pigeon_tpu.trajectory's at
float64: the VehicleTrajectory wire format (bytes, tube and stamp), a
path message and a `.world` text the test writes itself from the oval,
and `end_time`.

The tubes' columns are the same numpy values in both packages but time
for a spatial path, which each package integrates from speed over
arclength with its own cumulative sum: those agree to float64 rounding
(RTOL); everything else must be equal."""

import struct

import numpy as np
import pytest
import torch

from torch_port_helpers import t64
from pigeon_tpu import trajectory as JT
from pigeon_tpu_torch import trajectory as TT

RTOL = 1e-13
F64 = t64(0).dtype


def _columns():
    """The oval at a varying speed (so the reconstructed time is not a
    scaled arclength), with edges, grade and bank."""
    cols = TT.oval_columns()
    n = cols["s"].shape[0]
    rng = np.random.default_rng(0)
    V = 8.0 + np.sin(cols["s"] / 10.0)
    return dict(t=cols["t"], s=cols["s"], V=V,
                A=np.gradient(V, cols["s"]) * V, E=cols["E"], N=cols["N"],
                psi=cols["psi"], kappa=cols["kappa"],
                grade=rng.uniform(-0.02, 0.02, n),
                bank=rng.uniform(-0.01, 0.01, n),
                edge_L=np.full(n, 3.5), edge_R=np.full(n, -3.0))


def _same_tube(tt, jt, t_rtol=0.0):
    assert tt.n_valid == int(jt.n_valid)
    for name in TT.COLUMNS + ("packed",):
        got, want = getattr(tt, name).numpy(), np.asarray(getattr(jt, name))
        if name in ("t", "packed"):
            np.testing.assert_allclose(got, want, rtol=t_rtol, atol=0.0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    for name in ("t_idx", "s_idx"):
        a, b = getattr(tt, name), getattr(jt, name)
        np.testing.assert_array_equal(a.table.numpy(), np.asarray(b.table))
        assert (a.lo, a.h, a.fixups) == pytest.approx(
            (float(b.lo), float(b.h), b.fixups), rel=t_rtol)
    assert float(TT.end_time(tt)) == pytest.approx(
        float(JT.end_time(jt)), rel=t_rtol, abs=0.0)


@pytest.mark.parametrize("stamp,seq,frame_id", [(123.25, 7, "map"),
                                                (0.0, 0, ""),
                                                (1.7e9 + 0.123456789, 42,
                                                 "odom")])
def test_trajmsg_bytes_and_tube(stamp, seq, frame_id):
    c = _columns()
    args = [c[k] for k in ("t", "s", "V", "A", "E", "N", "psi", "kappa",
                           "grade", "bank", "edge_L", "edge_R")]
    buf = TT.serialize_trajmsg(*args, stamp=stamp, seq=seq,
                               frame_id=frame_id)
    assert buf == JT.serialize_trajmsg(*args, stamp=stamp, seq=seq,
                                       frame_id=frame_id)
    for pad_to in (None, 1024):
        tt, ts = TT.tube_from_trajmsg_bytes(buf, pad_to=pad_to,
                                            device="cpu", dtype=F64)
        jt, js = JT.tube_from_trajmsg_bytes(buf, pad_to=pad_to)
        assert ts == js
        _same_tube(tt, jt)
    with pytest.raises(ValueError):
        TT.tube_from_trajmsg_bytes(buf[:-9], device="cpu")


def _pathmsg(c) -> bytes:
    """A `safe_traffic_weaving/path` message in rospy's little-endian
    layout: the header, 12 float64 arrays (two unused, then s, E, N, psi,
    kappa, grade, edge_L, edge_R, Ux, Ax) and isOpen."""
    fid = b"world"
    out = [struct.pack("<III", 3, 100, 5), struct.pack("<I", len(fid)), fid]
    unused = np.zeros(4)
    for arr in (unused, unused, c["s"], c["E"], c["N"], c["psi"],
                c["kappa"], c["grade"], c["edge_L"], c["edge_R"], c["V"],
                c["A"]):
        a = np.asarray(arr, "<f8")
        out += [struct.pack("<I", a.size), a.tobytes()]
    out.append(struct.pack("<B", 1))
    return b"".join(out)


@pytest.mark.parametrize("pad_to", [None, 1024])
def test_tube_from_pathmsg(tmp_path, pad_to):
    path = tmp_path / "oval.msg"
    path.write_bytes(_pathmsg(_columns()))
    tt = TT.tube_from_pathmsg(str(path), pad_to=pad_to, device="cpu",
                              dtype=F64)
    _same_tube(tt, JT.tube_from_pathmsg(str(path), pad_to=pad_to),
               t_rtol=RTOL)
    path.write_bytes(_pathmsg(_columns())[:-200])
    with pytest.raises(ValueError):
        TT.tube_from_pathmsg(str(path), device="cpu")


def _world_text(c) -> str:
    """A `.world` file: one `key: v, v, ...` entry a line (values over
    several lines for one key), and two single-valued keys."""
    keys = dict(s_m="s", UxDes_mps="V", AxDes_mps2="A", posE_m="E",
                posN_m="N", psi_rad="psi", k_1pm="kappa", grade_rad="grade",
                edgeL_m="edge_L", edgeR_m="edge_R")
    lines = ["name: oval", "dt: 0.01"]
    for key, col in keys.items():
        vals = [repr(float(v)) for v in c[col]]
        half = len(vals) // 2
        lines.append(f"{key}: " + ", ".join(vals[:half]) + ",\n  "
                     + ", ".join(vals[half:]))
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("pad_to", [None, 1024])
def test_world_loaders(tmp_path, pad_to):
    path = tmp_path / "oval.world"
    path.write_text(_world_text(_columns()))
    tw, jw = TT.load_world_arrays(str(path)), JT.load_world_arrays(str(path))
    assert tw.keys() == jw.keys()
    assert tw["name"] == jw["name"] == "oval" and tw["dt"] == jw["dt"]
    for k, v in jw.items():
        np.testing.assert_array_equal(tw[k], v, err_msg=k)
    tt = TT.tube_from_world(str(path), pad_to=pad_to, device="cpu",
                            dtype=F64)
    _same_tube(tt, JT.tube_from_world(str(path), pad_to=pad_to),
               t_rtol=RTOL)


def test_end_time_and_default_device(monkeypatch):
    c = _columns()
    for pad_to in (None, 32, 1024):
        tt = TT.make_tube(**{k: c[k] for k in ("t", "s", "V", "A", "E",
                                              "N", "psi", "kappa")},
                          pad_to=pad_to, device="cpu", dtype=F64)
        assert float(TT.end_time(tt)) == c["t"][-1]
        assert TT.end_time(tt).shape == ()
    straight = TT.straight_trajectory(30.0, 5.0, pad_to=32, device="cpu")
    assert float(TT.end_time(straight)) == float(
        JT.end_time(JT.straight_trajectory(30.0, 5.0, pad_to=32))) == 6.0
    # the loaders default to the card, and raise without one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buf = TT.serialize_trajmsg(*[c[k] for k in (
        "t", "s", "V", "A", "E", "N", "psi", "kappa", "grade", "bank",
        "edge_L", "edge_R")])
    with pytest.raises(RuntimeError):
        TT.tube_from_trajmsg_bytes(buf)
