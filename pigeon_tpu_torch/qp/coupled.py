"""Coupled lateral+longitudinal tracking QP: the stage data container and
the control normalization shared by its formulations.  Counterpart of the
part of `pigeon_tpu/qp/coupled.py` that the soft condensed QP uses."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pigeon_tpu_torch.config import VehicleParams


def u_normalization(veh: VehicleParams):
    """(delta, Fx) normalization to ~[-1, 1]
    (reference `src/coupled_lat_long.jl:199`)."""
    return np.array([veh.delta_max, max(-veh.Fx_min, veh.Fx_max)])


class CoupledStageData(NamedTuple):
    """Per-step assembly inputs, batched over a leading instance axis."""

    dt: torch.Tensor        # (B, T)
    qs: torch.Tensor        # (B, N, 6) linearization states
    us: torch.Tensor        # (B, N, 2) linearization controls (physical)
    ps: torch.Tensor        # (B, N, 4) trajectory params (V, kappa, 0, 0)
    hji_M: torch.Tensor     # (B, 2) constraint row on physical u
    hji_b: torch.Tensor     # (B,) offset
    edges: "torch.Tensor | None" = None   # (B, N, 2) [edge_L, edge_R]
