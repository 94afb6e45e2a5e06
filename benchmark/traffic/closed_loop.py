"""Closed-loop fleet traffic: the general generator that every traffic mix
file here names.

A fleet of `fleet` vehicles on the configuration's path, each with one
other car, stepped at `period_s`: one controller step for the whole fleet
and one plant step a period.  Every `episode_periods` periods the fleet
is drawn anew, on the device, from the seed's generator, as a study
resets its episodes: start knots uniform over `start_knots`, position
and heading jittered uniformly, longitudinal speed `speed_mps`, lateral
speed, yaw rate and the command in effect zero.  Without `other_car` the
other car waits far away; with it, it comes head-on `gap_m` ahead of each
vehicle, offset `lateral_m` to the side, heading opposite plus
`heading_offset_rad`, at a speed drawn from `speed_mps`, and drives on at
constant velocity (the constant-velocity prediction of Pigeon.jl's
dynamic-obstacle study).  Headings are measured from N.

The draw takes the same number of draws of each kind whatever the
values, so every seed gives the same sizes in another order.
"""

from __future__ import annotations

import math

import torch

FAR = 1.0e4


def _uniform(gen, B, lo, hi, like):
    return lo + (hi - lo) * torch.rand(B, generator=gen, **like)


def draw(mix: dict, world: dict, gen: torch.Generator) -> dict:
    """A fresh episode: q (B, 6) = (E, N, psi, Ux, Uy, r), u (B, 3), the
    other cars oc (B, 4) = (E, N, psi, V), and the times t (B,).  `world`
    holds the path's columns as float32 tensors on the device."""
    B = int(mix["fleet"])
    like = dict(dtype=torch.float32, device=world["E"].device)
    lo, hi = mix["start_knots"]
    k0 = torch.randint(int(lo), int(hi), (B,), generator=gen,
                       device=like["device"])
    jit = float(mix["position_jitter_m"])
    E = world["E"][k0] + _uniform(gen, B, -jit, jit, like)
    N = world["N"][k0] + _uniform(gen, B, -jit, jit, like)
    hj = float(mix["heading_jitter_rad"])
    psi = world["psi"][k0] + _uniform(gen, B, -hj, hj, like)
    zero = torch.zeros(B, **like)
    q = torch.stack([E, N, psi, torch.full((B,), float(mix["speed_mps"]),
                                           **like), zero, zero], dim=-1)
    other = mix.get("other_car")
    if other is None:
        oc = torch.tensor([FAR, FAR, 0.0, 0.0], **like).expand(B, 4)
    else:
        gap = _uniform(gen, B, *other["gap_m"], like)
        lat = _uniform(gen, B, *other["lateral_m"], like)
        turn = _uniform(gen, B, *other["heading_offset_rad"], like)
        V = _uniform(gen, B, *other["speed_mps"], like)
        s, c = torch.sin(psi), torch.cos(psi)
        oc = torch.stack([E - gap * s - lat * c, N + gap * c - lat * s,
                          psi + math.pi + turn, V], dim=-1)
    return dict(q=q, u=torch.zeros((B, 3), **like), oc=oc.contiguous(),
                t=world["t"][k0].clone())


def advance(oc: torch.Tensor, dt: float) -> torch.Tensor:
    """The other cars after dt at constant velocity."""
    psi, V = oc[:, 2], oc[:, 3]
    return torch.stack([oc[:, 0] - V * torch.sin(psi) * dt,
                        oc[:, 1] + V * torch.cos(psi) * dt, psi, V], dim=-1)
