"""Host-side real-time control loop: the functional analog of the
reference's ROS node (`src/ros_integration.jl`).  Counterpart of
`pigeon_tpu/runtime/loop.py`.

The reference's `/from_autobox` callback is the control loop: ingest the
state estimate, run the MPC, apply the HJI override and the NaN fallback,
publish `/to_autobox`.  Here the same semantics live in
`ControllerRuntime.on_state`, with the MPC step the port's `mpc.mpc_step`
on the card and every gating check (`pre_flag`, the trajectory's time
window, the low-speed pause, heartbeat tracking) on the host.

Transport is pluggable: in-process calls for simulation, or the native UDP
autobox link (`pigeon_tpu_torch.runtime.transport`).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Optional

import numpy as np
import torch

from pigeon_tpu_torch import hji as hji_mod
from pigeon_tpu_torch import mpc as mpc_mod
from pigeon_tpu_torch import resolve_device
from pigeon_tpu_torch import trajectory as trj

log = logging.getLogger("pigeon_tpu_torch.runtime")


@dataclasses.dataclass
class FromAutobox:
    """State-estimate message (reference `from_autobox` msg fields used at
    `src/ros_integration.jl:50-52,70,78,88`)."""

    seq: int
    stamp: float
    E_m: float
    N_m: float
    psi_rad: float
    ux_mps: float
    uy_mps: float
    r_radps: float
    pre_flag: int = 1


@dataclasses.dataclass
class ToAutobox:
    """Command message (reference `to_autobox` fill,
    `src/ros_integration.jl:126-133`)."""

    stamp: float
    post_flag: int
    heartbeat: int
    s_m: float
    e_m: float
    delta_cmd_rad: float
    fxf_cmd_N: float
    fxr_cmd_N: float


class ControllerRuntime:
    """Stateful host loop around the pure `mpc_step`, float32 on `device`
    (None: the card).

    Mirrors the reference's mutable node state: latest trajectory and
    tracking mode (`src/ros_integration.jl:28-41`), heartbeat
    (`:88-92,112`), other-car state (`:153-155`), HJI policy flag (`:47`).

    The runtime holds two controllers and selects one per control period
    by tracking mode: the decoupled (path) controller in "path" mode, the
    coupled (trajectory) controller in "traj" mode (reference
    `src/ros_integration.jl:48-49`, singletons `src/Pigeon.jl:34-35`).  The
    HJI override is gated on "traj" mode (reference `:115-116`).  A single
    `cfg` serves both modes.
    """

    def __init__(self, cfg: Optional[mpc_mod.MPCConfig] = None,
                 cache: Optional[hji_mod.HJICache] = None,
                 tube: Optional[trj.TrajectoryTube] = None,
                 use_hji_policy: bool = False,
                 pad_to: int = 1024,
                 cfg_path: Optional[mpc_mod.MPCConfig] = None,
                 cfg_traj: Optional[mpc_mod.MPCConfig] = None,
                 warmup: bool = True,
                 step_budget_s: float = 0.010,
                 device=None):
        self.device = resolve_device(device)
        if cfg is not None:
            cfg_path = cfg_path if cfg_path is not None else cfg
            cfg_traj = cfg_traj if cfg_traj is not None else cfg
        else:
            # the reference's module-load singletons X1DMPC / X1CMPC
            # (src/Pigeon.jl:34-35)
            cfg_path = (cfg_path if cfg_path is not None
                        else mpc_mod.x1_decoupled_config())
            cfg_traj = (cfg_traj if cfg_traj is not None
                        else mpc_mod.x1_coupled_config())
        if use_hji_policy and not cfg_traj.use_hji_policy:
            cfg_traj = dataclasses.replace(cfg_traj, use_hji_policy=True)
        # the HJI override only fires in "traj" mode (reference :115)
        if cfg_path.use_hji_policy:
            cfg_path = dataclasses.replace(cfg_path, use_hji_policy=False)
        self.cfgs = {"path": cfg_path, "traj": cfg_traj}
        self.cfg = cfg_traj
        self.cache = (cache if cache is not None
                      else hji_mod.inactive_cache(device=self.device))
        self.pad_to = pad_to
        # the default trajectory of the module-load singletons
        # (straight_trajectory(30, 5), reference src/Pigeon.jl:34-35)
        self.tube = tube if tube is not None else trj.straight_trajectory(
            30.0, 5.0, pad_to=pad_to, device=self.device)
        self.tracking_mode = "path"
        self.time_offset = math.nan
        self.use_hji_policy = use_hji_policy
        self.heartbeat = 0
        self.other_car = self._f32([1e4, 1e4, 0.0, 0.0])
        self.carries = {m: mpc_mod.init_carry(c, None, dtype=torch.float32,
                                              device=self.device)
                        for m, c in self.cfgs.items()}
        self.last_command = ToAutobox(0.0, 0, 0, 0.0, 0.0, 0.0, 0.0, 0.0)

        def make_step(c):
            return lambda tube, carry, q0, u0, oc, t: mpc_mod.mpc_step(
                c, tube, self.cache, carry, q0, u0, oc, t)
        self._steps = {m: make_step(c) for m, c in self.cfgs.items()}

        # per-step wall time against the real-time budget (reference
        # @elapsed and the >10 ms logwarn, src/ros_integration.jl:94,105-109)
        self.step_budget_s = step_budget_s
        self.budget_violations = 0
        self._step_times = []                  # rolling window (s)
        self._step_times_max = 1024

        if warmup:
            self.warmup()

    def _f32(self, values) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.float32, device=self.device)

    def warmup(self):
        """Dry runs of both controllers and the projection before the
        first control period, so that it does not pay for building the
        kernels and creating the cuBLAS / cuSOLVER handles (the reference
        warm-runs its pipeline for the same reason, src/Pigeon.jl:44-58).
        The steps' results are dropped: the carries stay as they were."""
        t0 = time.perf_counter()
        q0 = self._f32([float(self.tube.E[0]), float(self.tube.N[0]),
                        float(self.tube.psi[0]),
                        max(float(self.tube.V[0]), 2.0), 0.0, 0.0])
        u0 = self._f32([0.0, 0.0, 0.0])
        trj.path_coordinates(self.tube, q0[:2])
        for m, step in self._steps.items():
            step(self.tube, self.carries[m], q0, u0, self.other_car,
                 self._f32(0.0))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        log.info("warmup ran %d programs in %.1f s", len(self._steps) + 1,
                 time.perf_counter() - t0)

    @property
    def carry(self):
        """Carry of the currently selected controller."""
        return self.carries[self.tracking_mode]

    @carry.setter
    def carry(self, value):
        self.carries[self.tracking_mode] = value

    def _drop_warm_start(self, mode: str):
        self.carries[mode] = self.carries[mode]._replace(
            solved=torch.zeros((), dtype=torch.bool, device=self.device))

    # -- trajectory ingest (reference nominal_trajectory_callback,
    #    src/ros_integration.jl:30-41) ------------------------------------
    def set_path(self, tube: trj.TrajectoryTube):
        """Spatial path (`/des_path`): path-tracking mode, the time
        recovered by projection each step.  Drops the path controller's
        warm start (reference `src/ros_integration.jl:30-34`)."""
        self.tube = tube
        self.tracking_mode = "path"
        self.time_offset = math.nan
        self._drop_warm_start("path")

    def set_trajectory(self, tube: trj.TrajectoryTube, stamp: float):
        """Timed trajectory (`/des_traj`): planner time is meaningful.
        Drops the trajectory controller's warm start (reference `:36-41`)."""
        self.tube = tube
        self.tracking_mode = "traj"
        self.time_offset = float(stamp)
        self._drop_warm_start("traj")

    def set_trajectory_msg(self, buf: bytes):
        """Wire-level `/des_traj` ingest: a serialized ROS1
        VehicleTrajectory message, its header stamp the time offset
        (reference `src/ros_integration.jl:17-20,36-41`)."""
        tube, stamp = trj.tube_from_trajmsg_bytes(buf, pad_to=self.pad_to,
                                                  device=self.device)
        self.set_trajectory(tube, stamp)

    def latency_stats(self) -> dict:
        """The measured `on_state` MPC latency over the rolling window."""
        if not self._step_times:
            return {"n": 0}
        ts = np.asarray(self._step_times)
        return {
            "n": int(ts.size),
            "p50_ms": round(float(np.percentile(ts, 50)) * 1e3, 3),
            "p99_ms": round(float(np.percentile(ts, 99)) * 1e3, 3),
            "max_ms": round(float(ts.max()) * 1e3, 3),
            "budget_ms": self.step_budget_s * 1e3,
            "budget_violations": self.budget_violations,
        }

    def set_other_car(self, x: float, y: float, th: float, v: float):
        """Reference other_car_callback (src/ros_integration.jl:153-155),
        with its theta - pi/2 heading convention shift."""
        self.other_car = self._f32([x, y, th - math.pi / 2, v])

    # -- the control loop -------------------------------------------------
    def on_state(self, msg: FromAutobox) -> Optional[ToAutobox]:
        """One control period.  Returns the command, or None when the MPC
        is gated off (reference gating ladder,
        src/ros_integration.jl:70-92)."""
        q0 = self._f32([msg.E_m, msg.N_m, msg.psi_rad, msg.ux_mps,
                        msg.uy_mps, msg.r_radps])
        u0 = self._f32([self.last_command.delta_cmd_rad,
                        self.last_command.fxf_cmd_N,
                        self.last_command.fxr_cmd_N])

        if msg.pre_flag == 0:
            log.info("pre_flag == 0, MPC inactive")
            return None
        if math.isnan(self.time_offset):
            _, _, t = torch.stack(trj.path_coordinates(self.tube,
                                                       q0[:2])).tolist()
        else:
            t = msg.stamp - self.time_offset
            t_end = float(trj.end_time(self.tube))
            if t < 0 or t > t_end:
                log.info("time %.2f outside trajectory [0, %.2f]", t, t_end)
                return None
        if msg.ux_mps < 1.0:
            log.info("speed < 1 m/s, pausing MPC")
            return None
        missed = msg.seq - (self.heartbeat + 1)
        if missed != 0:
            log.warning("%d from_autobox messages lost", missed)
            self.heartbeat = msg.seq - 1

        t_mpc = time.perf_counter()
        mode = self.tracking_mode
        self.carries[mode], u3, diag = self._steps[mode](
            self.tube, self.carries[mode], q0, u0, self.other_car,
            self._f32(t))
        u3 = u3.cpu().numpy()                  # the device sync
        elapsed = time.perf_counter() - t_mpc
        self._step_times.append(elapsed)
        if len(self._step_times) > self._step_times_max:
            del self._step_times[:len(self._step_times)
                                 - self._step_times_max]
        if elapsed > self.step_budget_s:
            # reference: logwarn past the 10 ms budget with the heartbeat
            # (src/ros_integration.jl:105-109)
            self.budget_violations += 1
            log.warning("MPC step exceeded budget: %.1f ms > %.1f ms "
                        "(heartbeat %d)", elapsed * 1e3,
                        self.step_budget_s * 1e3, self.heartbeat)
        self.heartbeat += 1
        cmd = ToAutobox(
            stamp=msg.stamp, post_flag=1, heartbeat=self.heartbeat,
            s_m=float(diag.s), e_m=float(diag.e),
            delta_cmd_rad=float(u3[0]), fxf_cmd_N=float(u3[1]),
            fxr_cmd_N=float(u3[2]))
        self.last_command = cmd
        return cmd

    def diagnostics_row(self, diag) -> dict:
        """Structured per-step metrics (the reference's loginfo lines)."""
        return {
            "heartbeat": self.heartbeat,
            "s": float(diag.s), "e": float(diag.e),
            "V_hji": float(diag.V_hji),
            "iterations": int(diag.iterations),
            "prim_res": float(diag.prim_res),
            "dual_res": float(diag.dual_res),
            "converged": bool(diag.converged),
        }
