"""Trajectory representation: the nominal trajectory "tube" of knot
columns, time- and arclength-indexed lookup, and world-position path
projection.  Counterpart of `pigeon_tpu/trajectory.py` (the reference's
`src/trajectories.jl`).

A `TrajectoryTube` holds fixed-length (optionally padded) column tensors
on one device; `n_valid` marks the live prefix.  Lookups take query
tensors of any shape and return nodes of that shape.  The uniform-grid
`LookupIndex` is built on the host with numpy, as in the JAX package.
The loaders at the end read the `.world` text, the path message and the
`/des_traj` VehicleTrajectory message into tubes.
"""

from __future__ import annotations

import dataclasses
import math
import re
import struct
from typing import NamedTuple

import numpy as np
import torch

from pigeon_tpu_torch import resolve_device
from pigeon_tpu_torch.math_utils import (cross2, invcumtrapz,
                                         segment_distance2)


@dataclasses.dataclass(frozen=True)
class LookupIndex:
    """Uniform-grid acceleration index over one knot vector: table[j] is
    the segment index of grid point lo + j*h; the segment of a query in
    cell j is at most `fixups` increments past table[j] (exact)."""

    table: torch.Tensor   # (L_tab,) int64 segment index per uniform cell
    lo: float             # grid origin
    h: float              # grid step
    fixups: int = 1


class TrajectoryTube(NamedTuple):
    """Columns mirror the reference's 12-field trajectory node."""

    t: torch.Tensor        # time (s)
    s: torch.Tensor        # arclength (m)
    V: torch.Tensor        # longitudinal speed (m/s)
    A: torch.Tensor        # longitudinal accel (m/s^2)
    E: torch.Tensor        # world E (m)
    N: torch.Tensor        # world N (m)
    psi: torch.Tensor      # heading (rad)
    kappa: torch.Tensor    # curvature (1/m)
    theta: torch.Tensor    # grade (rad)
    phi: torch.Tensor      # bank (rad)
    edge_L: torch.Tensor   # left lateral bound (m)
    edge_R: torch.Tensor   # right lateral bound (m)
    n_valid: int           # number of live knots (<= padded length)
    t_idx: LookupIndex     # acceleration index over t
    s_idx: LookupIndex     # acceleration index over s
    packed: torch.Tensor   # (L, 11) row-major copy of _PACKED_FIELDS


class TrajectoryNode(NamedTuple):
    """One interpolated sample (unselected spatial fields are None)."""

    t: torch.Tensor
    s: torch.Tensor
    V: torch.Tensor
    A: torch.Tensor
    E: torch.Tensor
    N: torch.Tensor
    psi: torch.Tensor
    kappa: torch.Tensor
    theta: torch.Tensor
    phi: torch.Tensor
    edge_L: torch.Tensor
    edge_R: torch.Tensor


_SPATIAL_FIELDS = ("E", "N", "psi", "kappa", "theta", "phi", "edge_L",
                   "edge_R")
_PACKED_FIELDS = ("t", "s", "V") + _SPATIAL_FIELDS
_PCOL = {name: k for k, name in enumerate(_PACKED_FIELDS)}
COLUMNS = ("t", "s", "V", "A") + _SPATIAL_FIELDS


def _tube_columns(t, s, V, A, E, N, psi, kappa, theta=None, phi=None,
                  edge_L=None, edge_R=None, pad_to: int | None = None):
    """Host-side columns with the reference's defaults (theta=phi=0,
    edge_L=+4, edge_R=-4) and optional right-padding, exactly as
    `pigeon_tpu.trajectory.make_tube` builds them."""
    t = np.asarray(t, dtype=np.float64)
    n = t.shape[0]
    cols = dict(t=t, s=s, V=V, A=A, E=E, N=N, psi=psi, kappa=kappa)
    cols["theta"] = np.zeros(n) if theta is None else theta
    cols["phi"] = np.zeros(n) if phi is None else phi
    cols["edge_L"] = np.full(n, 4.0) if edge_L is None else edge_L
    cols["edge_R"] = np.full(n, -4.0) if edge_R is None else edge_R
    cols = {k: np.asarray(v, dtype=np.float64) for k, v in cols.items()}
    for k, v in cols.items():
        if v.shape[0] != n:
            raise ValueError(f"column {k} length {v.shape[0]} != {n}")
    if pad_to is not None and pad_to > n:
        pad = pad_to - n
        for k in ("t", "s"):
            # padded knots stay strictly increasing
            step = np.arange(1, pad + 1) * max(1.0, cols[k][-1] - cols[k][0])
            cols[k] = np.concatenate([cols[k], cols[k][-1] + step])
        for k in cols:
            if k not in ("t", "s"):
                cols[k] = np.concatenate([cols[k], np.full(pad, cols[k][-1])])
    return cols, n


def make_tube(t, s, V, A, E, N, psi, kappa, theta=None, phi=None,
              edge_L=None, edge_R=None, pad_to: int | None = None,
              device=None, dtype=torch.float32) -> TrajectoryTube:
    """Build a tube from numpy columns on `device` (None: the card)."""
    device = resolve_device(device)
    cols, n = _tube_columns(t, s, V, A, E, N, psi, kappa, theta, phi,
                            edge_L, edge_R, pad_to)
    L_tab = cols["t"].shape[0]
    return tube_from_columns(
        cols, n,
        _build_lookup_index(cols["t"], n, tab_len=L_tab, device=device),
        _build_lookup_index(cols["s"], n, tab_len=L_tab, device=device),
        device, dtype)


def tube_from_columns(cols, n_valid: int, t_idx: LookupIndex,
                      s_idx: LookupIndex, device, dtype) -> TrajectoryTube:
    """Assemble a tube from host columns and prebuilt lookup indices."""
    packed = np.stack([np.asarray(cols[k]) for k in _PACKED_FIELDS], axis=-1)
    as_t = lambda v: torch.as_tensor(np.asarray(v), dtype=dtype,
                                     device=device)
    return TrajectoryTube(n_valid=int(n_valid), t_idx=t_idx, s_idx=s_idx,
                          packed=as_t(packed),
                          **{k: as_t(cols[k]) for k in COLUMNS})


def _build_lookup_index(knots: np.ndarray, n_valid: int,
                        max_len: int = 8192, tab_len: int | None = None,
                        device=None) -> LookupIndex:
    """Host-side uniform acceleration index over the live knot range (the
    same construction as `pigeon_tpu.trajectory._build_lookup_index`)."""
    live = np.asarray(knots[:n_valid], np.float64)
    lo, hi = float(live[0]), float(live[-1])
    span = max(hi - lo, 1e-9)
    if tab_len is not None:
        L_tab = int(max(2, min(tab_len, max_len)))
    else:
        min_gap = float(np.min(np.diff(live))) if n_valid > 1 else span
        L_tab = int(min(max_len,
                        max(2, np.ceil(span / max(min_gap, 1e-9)))))
    h = span / L_tab
    grid = lo + h * np.arange(L_tab)
    table = np.clip(np.searchsorted(live, grid, side="right") - 1,
                    0, max(n_valid - 2, 0))
    ends = np.clip(np.searchsorted(live, grid + h, side="right") - 1,
                   0, max(n_valid - 2, 0))
    fixups = int(np.max(ends - table)) if n_valid > 1 else 0
    return LookupIndex(table=torch.as_tensor(table, dtype=torch.int64,
                                             device=device),
                       lo=lo, h=h, fixups=max(2, fixups))


def straight_trajectory(length: float, vel: float, pad_to: int | None = None,
                        device=None, dtype=torch.float32) -> TrajectoryTube:
    """Straight constant-speed trajectory along +N
    (reference `straight_trajectory`, `src/trajectories.jl:96-105`)."""
    return make_tube(t=[0.0, length / vel], s=[0.0, length], V=[vel, vel],
                     A=[0.0, 0.0], E=[0.0, 0.0], N=[0.0, length],
                     psi=[0.0, 0.0], kappa=[0.0, 0.0], pad_to=pad_to,
                     device=device, dtype=dtype)


def oval_columns(straight: float = 60.0, radius: float = 20.0,
                 speed: float = 8.0, spacing: float = 0.25) -> dict:
    """Numpy columns of one lap of a closed oval at constant speed: a
    straight along +N, a left semicircle, a straight back along -N and a
    second left semicircle (heading measured from N).  One lap only: a
    second lap would lie on the first, and path projection would put a
    vehicle on the wrong lap.  The in-repo stand-in for the recorded
    skidpad oval path (983 knots at the defaults)."""
    arc = math.pi * radius
    s = np.arange(0.0, 2.0 * (straight + arc) + 1e-9, spacing)
    E = np.empty_like(s)
    N = np.empty_like(s)
    psi = np.empty_like(s)
    kappa = np.zeros_like(s)
    seg1 = s < straight
    seg2 = (s >= straight) & (s < straight + arc)
    seg3 = (s >= straight + arc) & (s < 2 * straight + arc)
    seg4 = s >= 2 * straight + arc
    E[seg1], N[seg1], psi[seg1] = 0.0, s[seg1], 0.0
    th = (s[seg2] - straight) / radius
    E[seg2] = -radius + radius * np.cos(th)
    N[seg2] = straight + radius * np.sin(th)
    psi[seg2] = th
    kappa[seg2] = 1.0 / radius
    back = s[seg3] - straight - arc
    E[seg3], N[seg3], psi[seg3] = -2.0 * radius, straight - back, math.pi
    th = (s[seg4] - 2 * straight - arc) / radius
    E[seg4] = -radius - radius * np.cos(th)
    N[seg4] = -radius * np.sin(th)
    psi[seg4] = math.pi + th
    kappa[seg4] = 1.0 / radius
    n = s.shape[0]
    return dict(t=s / speed, s=s, V=np.full(n, speed), A=np.zeros(n), E=E,
                N=N, psi=psi, kappa=kappa)


# ---------------------------------------------------------------------------
# Lookup
# ---------------------------------------------------------------------------

def _segment_index(knots, x, n_valid: int, idx: LookupIndex):
    """Index i of the live segment [knots[i], knots[i+1]] containing x,
    clamped to the valid range: one table gather plus `idx.fixups`
    compare-and-advance steps."""
    cell = torch.nan_to_num((x - idx.lo) / idx.h, nan=0.0)
    j = torch.clamp(cell, 0, idx.table.shape[0] - 1).to(torch.int64)
    i = idx.table[j]
    for _ in range(idx.fixups):
        adv = (x >= knots[i + 1]).to(i.dtype)
        i = torch.clamp(i + adv, max=n_valid - 2)
    return i


def _packed_spatial(r0, r1, lam, fields):
    """Linear interp of the spatial columns from packed rows; lam is
    unclamped -> linear extrapolation past the ends."""
    vals = r0 + lam[..., None] * (r1 - r0)
    return {name: (vals[..., _PCOL[name]] if name in fields else None)
            for name in _SPATIAL_FIELDS}


def eval_time(tube: TrajectoryTube, t,
              fields=_SPATIAL_FIELDS) -> TrajectoryNode:
    """Sample the tube at time t: constant-accel interpolation between time
    knots, then spatial interp at the resulting arclength."""
    i = _segment_index(tube.t, t, tube.n_valid, tube.t_idx)
    r0, r1 = tube.packed[i], tube.packed[i + 1]
    t0, s0, V0 = r0[..., 0], r0[..., 1], r0[..., 2]
    t1, s1, V1 = r1[..., 0], r1[..., 1], r1[..., 2]
    A = (V1 - V0) / (t1 - t0)
    dt = t - t0
    s = s0 + V0 * dt + A * dt * dt / 2.0
    V = V0 + A * dt
    sp = _packed_spatial(r0, r1, (s - s0) / (s1 - s0), fields)
    return TrajectoryNode(t=t, s=s, V=V, A=A, **sp)


def eval_arclength(tube: TrajectoryTube, s,
                   fields=_SPATIAL_FIELDS) -> TrajectoryNode:
    """Sample the tube at arclength s."""
    i = _segment_index(tube.s, s, tube.n_valid, tube.s_idx)
    r0, r1 = tube.packed[i], tube.packed[i + 1]
    t0, s0, V0 = r0[..., 0], r0[..., 1], r0[..., 2]
    t1, s1, V1 = r1[..., 0], r1[..., 1], r1[..., 2]
    ds = s - s0
    A = (V1 - V0) / (t1 - t0)
    disc = torch.sqrt(torch.clamp(2.0 * A * ds + V0 * V0, min=0.0))
    s_end = tube.s[tube.n_valid - 1]
    use_linear = (torch.abs(A) < 1e-3) | (s > s_end)
    A_safe = torch.where(torch.abs(A) < 1e-3, torch.ones_like(A), A)
    dt = torch.where(use_linear, ds / V0, (disc - V0) / A_safe)
    sp = _packed_spatial(r0, r1, ds / (s1 - s0), fields)
    return TrajectoryNode(t=t0 + dt, s=s, V=V0 + A * dt, A=A, **sp)


def _time_from_arc(tube: TrajectoryTube, i, ds, s):
    """Invert the constant-accel arc s(t) on segment i for dt."""
    A = (tube.V[i + 1] - tube.V[i]) / (tube.t[i + 1] - tube.t[i])
    Vi = tube.V[i]
    disc = torch.sqrt(torch.clamp(2.0 * A * ds + Vi * Vi, min=0.0))
    s_end = tube.s[tube.n_valid - 1]
    use_linear = (torch.abs(A) < 1e-3) | (s > s_end)
    A_safe = torch.where(torch.abs(A) < 1e-3, torch.ones_like(A), A)
    dt = torch.where(use_linear, ds / Vi, (disc - Vi) / A_safe)
    return A, dt


def path_coordinates(tube: TrajectoryTube, x):
    """Project world positions x (..., 2) onto the path: returns (s, e, t)
    with signed lateral error e (left positive).  A masked argmin over
    every live segment; ties take the first minimum, as `jnp.argmin`."""
    pts = torch.stack([tube.E, tube.N], dim=-1)       # (L, 2)
    p0, p1 = pts[:-1], pts[1:]                        # (L-1, 2)
    d2, _ = segment_distance2(p0, p1, x[..., None, :])  # (..., L-1)
    live = torch.arange(p0.shape[0], device=x.device) < (tube.n_valid - 1)
    d2 = torch.where(live, d2, torch.full_like(d2, math.inf))
    i = torch.argmin(d2, dim=-1)
    d2min = torch.gather(d2, -1, i[..., None])[..., 0]
    v = p1[i] - p0[i]
    w = x - p0[i]
    ds = torch.sqrt(torch.clamp(torch.sum(w * w, dim=-1) - d2min, min=0.0))
    s = tube.s[i] + ds
    e = torch.sqrt(d2min) * torch.sign(cross2(v, w))
    _, dt = _time_from_arc(tube, i, ds, s)
    return s, e, tube.t[i] + dt


def end_time(tube: TrajectoryTube):
    """Final live time knot (the reference's `traj.t[end]`), a 0-d
    tensor."""
    return tube.t[tube.n_valid - 1]


# ---------------------------------------------------------------------------
# Loaders: the `.world` text, the path message and the VehicleTrajectory
# message (the reference's /des_path and /des_traj ingest,
# src/ros_integration.jl:13-20), with no YAML or ROS stack
# ---------------------------------------------------------------------------

def _time_from_speed(V, s) -> np.ndarray:
    """t = invcumtrapz(V, s) at float64 on the host: the time the
    reference reconstructs for a spatial path."""
    as64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    return invcumtrapz(as64(V), as64(s)).numpy()


def load_world_arrays(path: str) -> dict:
    """Parse a `.world` file of `key: comma-separated values` entries
    (keys per the reference's `test/path/world2pathmsg.py:5-16`) into
    numpy arrays; single values become floats, or stay strings."""
    out = {}
    with open(path) as f:
        text = f.read()
    for m in re.finditer(r"^(\w+):\s*(.*?)(?=^\w+:|\Z)", text,
                         re.MULTILINE | re.DOTALL):
        key, val = m.group(1), m.group(2).strip()
        if "," in val:
            out[key] = np.array([float(v) for v in val.split(",")])
        else:
            try:
                out[key] = float(val)
            except ValueError:
                out[key] = val
    return out


def tube_from_world(path: str, pad_to: int | None = None, device=None,
                    dtype=torch.float32) -> TrajectoryTube:
    """A recorded X1 `.world` path as a tube on `device` (None: the card),
    with its time reconstructed from speed over arclength."""
    w = load_world_arrays(path)
    s, V = w["s_m"], w["UxDes_mps"]
    return make_tube(
        t=_time_from_speed(V, s), s=s, V=V, A=w["AxDes_mps2"],
        E=w["posE_m"], N=w["posN_m"], psi=w["psi_rad"], kappa=w["k_1pm"],
        theta=w["grade_rad"], phi=None, edge_L=w.get("edgeL_m"),
        edge_R=w.get("edgeR_m"), pad_to=pad_to, device=device, dtype=dtype)


def _header_arrays(buf: bytes, what: str) -> list:
    """The 12 length-prefixed float64 arrays after a ROS1 std_msgs/Header
    (uint32 seq, uint32 secs, uint32 nsecs, length-prefixed frame_id)."""
    off = 12
    (flen,) = struct.unpack_from("<I", buf, off)
    off += 4 + flen
    arrays = []
    while off + 4 <= len(buf) and len(arrays) < 12:
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        if n * 8 > len(buf) - off:
            raise ValueError(f"corrupt {what}: array of {n} doubles past "
                             f"end of buffer")
        arrays.append(np.frombuffer(buf, "<f8", count=n, offset=off).copy())
        off += 8 * n
    if len(arrays) != 12:
        raise ValueError(f"{what}: expected 12 arrays, got {len(arrays)}")
    return arrays


def tube_from_pathmsg(path: str, pad_to: int | None = None, device=None,
                      dtype=torch.float32) -> TrajectoryTube:
    """A serialized ROS1 `safe_traffic_weaving/path` message file as a
    tube.  Its layout (little endian): the header, then 12 float64 arrays
    -- two unused, s, E, N, psi, kappa, grade, edge_L, edge_R, Ux, Ax --
    then isOpen.  Time is reconstructed from Ux over s, as for `.world`
    paths."""
    with open(path, "rb") as f:
        buf = f.read()
    (s, E, N, psi, kappa, grade, edge_L, edge_R, Ux,
     Ax) = _header_arrays(buf, f"path msg {path!r}")[2:]
    return make_tube(t=_time_from_speed(Ux, s), s=s, V=Ux, A=Ax, E=E, N=N,
                     psi=psi, kappa=kappa, theta=grade, phi=None,
                     edge_L=edge_L, edge_R=edge_R, pad_to=pad_to,
                     device=device, dtype=dtype)


def tube_from_trajmsg_bytes(buf: bytes, pad_to: int | None = None,
                            device=None, dtype=torch.float32
                            ) -> "tuple[TrajectoryTube, float]":
    """A serialized ROS1 `safe_traffic_weaving/VehicleTrajectory` message
    (the `/des_traj` topic): the header, then 12 float64 arrays t, s, V,
    A, E, N, heading, curvature, grade, bank, edge_L, edge_R.  Returns
    (tube, the header stamp in seconds): the controller's time offset."""
    (_, secs, nsecs) = struct.unpack_from("<III", buf, 0)
    (t, s, V, A, E, N, psi, kappa, grade, bank, edge_L,
     edge_R) = _header_arrays(buf, "VehicleTrajectory msg")
    tube = make_tube(t=t, s=s, V=V, A=A, E=E, N=N, psi=psi, kappa=kappa,
                     theta=grade, phi=bank, edge_L=edge_L, edge_R=edge_R,
                     pad_to=pad_to, device=device, dtype=dtype)
    return tube, secs + nsecs * 1e-9


def serialize_trajmsg(t, s, V, A, E, N, psi, kappa, grade, bank, edge_L,
                      edge_R, stamp: float = 0.0, seq: int = 0,
                      frame_id: str = "") -> bytes:
    """A VehicleTrajectory in the ROS1 wire format, the inverse of
    `tube_from_trajmsg_bytes` (for tests and in-process planner
    stand-ins)."""
    secs = int(stamp)
    nsecs = int(round((stamp - secs) * 1e9))
    fid = frame_id.encode()
    out = [struct.pack("<III", seq, secs, nsecs),
           struct.pack("<I", len(fid)), fid]
    for arr in (t, s, V, A, E, N, psi, kappa, grade, bank, edge_L,
                edge_R):
        a = np.asarray(arr, "<f8")
        out.append(struct.pack("<I", a.size))
        out.append(a.tobytes())
    return b"".join(out)
