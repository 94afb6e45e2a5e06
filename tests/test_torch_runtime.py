"""pigeon_tpu_torch.runtime.ControllerRuntime against
pigeon_tpu.runtime.ControllerRuntime: both runtimes, each float32 (the
JAX package with 64-bit types off, as on a TPU), get the same message
sequences at horizon (2, 3) with `pad_to=32` (tests/test_runtime.py's
size): the basic step, pre_flag, the low-speed pause, the trajectory's
time window, the path -> traj dispatch with both controllers, heartbeat
recovery, the budget warning, the VehicleTrajectory ingest, and a start
from a mid-run JAX runtime through `convert.runtime_state_from_numpy`.

Every gating decision, heartbeat, mode, time offset and warm-start flag
must be equal, and so must each step's inputs (state, other car and
time; the command in effect is each runtime's own last command).

The commands are two float32 roundings of a solve at eps 1e-3, where a
weakly determined force moves with rounding by far more than
tests/test_torch_simulate_sparse.py's float64 bar (2e-4 rad, 2 N): on a
cold coupled step at horizon (2, 3) the float64 Fxr is 141.8 N in both
packages, the float32 one 294.7 N in JAX and 350.7 N in the port.  One
package's float32-to-float64 gap on a step does not bound the other's
(two independent roundings), and a period's command in effect carries
the last period's rounding into the next step, of either mode.  So the
rule is chip_smoke.py's for the hard QPs (REF_RULES' "fleet_wide"), with
a test's periods in place of a fleet: every pair of commands within the
bar plus twice the largest float32-to-float64 gap of either package over
the test's periods, and never more than 128 bars apart.  The float64
command is the port's `mpc_step` at float64 from the runtime's own
recorded carry and inputs (the tests named above hold it to the JAX
package's at float64), so the rule fails where the two runtimes' inputs
lead to float64 commands further apart than the bar."""

import dataclasses
import logging
import math

import jax
import numpy as np
import pytest
import torch

from torch_port_helpers import carry_arrays, tube_arrays
from pigeon_tpu import mpc as JM
from pigeon_tpu import trajectory as JT
from pigeon_tpu.config import HorizonParams as JHP
from pigeon_tpu.runtime import loop as JL
from pigeon_tpu_torch import convert
from pigeon_tpu_torch import mpc as TM
from pigeon_tpu_torch import trajectory as TT
from pigeon_tpu_torch.config import HorizonParams as THP
from pigeon_tpu_torch.runtime import loop as TL

BAR = np.array([2e-4, 2.0, 2.0])
CAP_BARS = 128.0
F64 = torch.float64
STRAIGHT = dict(t=[0.0, 12.0], s=[0.0, 60.0], V=[5.0, 5.0], A=[0.0, 0.0],
                E=[0.0, 0.0], N=[0.0, 60.0], psi=[0.0, 0.0],
                kappa=[0.0, 0.0])


def _cfgs():
    """Both packages' runtime controllers at horizon (2, 3): the two
    defaults, the sparse decoupled path controller and the sparse coupled
    trajectory one."""
    out = []
    for M, HP in ((JM, JHP), (TM, THP)):
        hz = HP(N_short=2, N_long=3)
        out.append(dict(cfg_path=M.x1_decoupled_config(hz=hz),
                        cfg_traj=M.x1_coupled_config(hz=hz)))
    return out


RUNTIME_KW = dict(pad_to=32, use_hji_policy=True, warmup=False)


@pytest.fixture(scope="module")
def jax_rt():
    """One JAX runtime for the module (each compiles its two steps on
    first use) and its state as built, to start each test from."""
    with jax.enable_x64(False):
        jr = JL.ControllerRuntime(**_cfgs()[0], **RUNTIME_KW)
    calls = []
    _record(jr, calls)
    return jr, dict(jr.__dict__, carries=dict(jr.carries)), calls


def _record(rt, calls):
    """Record each (mode, step arguments) of runtime `rt` in `calls`."""
    for mode, step in list(rt._steps.items()):
        def rec(*args, step=step, mode=mode):
            calls.append((mode, args))
            return step(*args)
        rt._steps[mode] = rec


def _as_torch64(x):
    x = torch.as_tensor(np.asarray(x))
    return x.to(F64) if x.is_floating_point() else x


class Pair:
    """The JAX runtime and a new port runtime on the CPU driven in
    lockstep, from the JAX runtime's state as built (`fresh`) or as it
    is.  The port's steps are recorded to replay each at float64."""

    def __init__(self, jax_rt, fresh=True, **kw):
        self.j, built, self.j_calls = jax_rt
        # the packages' wall times differ: a budget no step can meet, or
        # one every step meets, makes the violation counts comparable
        kw.setdefault("step_budget_s", 1e9)
        if fresh:
            self.j.__dict__.update(built, carries=dict(built["carries"]),
                                   _step_times=[])
            self.j_calls.clear()
        self.j.step_budget_s = kw["step_budget_s"]
        self.t = TL.ControllerRuntime(device="cpu", **_cfgs()[1],
                                      **RUNTIME_KW, **kw)
        self.tube64 = TT.straight_trajectory(30.0, 5.0, pad_to=32,
                                             device="cpu", dtype=F64)
        self.calls = []
        _record(self.t, self.calls)
        self.rows = []              # (mode, JAX and port float32 commands,
                                    # and each one's float64 gap)

    def set_path(self, cols):
        with jax.enable_x64(False):
            self.j.set_path(JT.make_tube(**cols, pad_to=32))
        self.t.set_path(TT.make_tube(**cols, pad_to=32, device="cpu"))
        self.tube64 = TT.make_tube(**cols, pad_to=32, device="cpu",
                                   dtype=F64)
        self.check_state()

    def set_trajectory(self, cols, stamp):
        with jax.enable_x64(False):
            self.j.set_trajectory(JT.make_tube(**cols, pad_to=32), stamp)
        self.t.set_trajectory(TT.make_tube(**cols, pad_to=32, device="cpu"),
                              stamp)
        self.tube64 = TT.make_tube(**cols, pad_to=32, device="cpu",
                                   dtype=F64)
        self.check_state()

    def set_trajectory_msg(self, buf):
        with jax.enable_x64(False):
            self.j.set_trajectory_msg(buf)
        self.t.set_trajectory_msg(buf)
        self.tube64, _ = TT.tube_from_trajmsg_bytes(buf, pad_to=32,
                                                    device="cpu", dtype=F64)
        self.check_state()

    def set_other_car(self, *xyzv):
        with jax.enable_x64(False):
            self.j.set_other_car(*xyzv)
        self.t.set_other_car(*xyzv)
        np.testing.assert_array_equal(self.t.other_car.numpy(),
                                      np.asarray(self.j.other_car))

    def check_state(self):
        j, t = self.j, self.t
        assert t.tracking_mode == j.tracking_mode
        assert (t.time_offset == j.time_offset
                or (math.isnan(t.time_offset) and math.isnan(j.time_offset)))
        assert t.heartbeat == j.heartbeat
        assert t.budget_violations == j.budget_violations
        for m in ("path", "traj"):
            assert bool(t.carries[m].solved) == bool(j.carries[m].solved), m
        assert t.tracking_mode == ("path" if math.isnan(t.time_offset)
                                   else "traj")

    def on_state(self, seq, stamp=0.0, E=0.2, N=5.0, psi=0.0, ux=5.0,
                 pre=1):
        fields = dict(seq=seq, stamp=stamp, E_m=E, N_m=N, psi_rad=psi,
                      ux_mps=ux, uy_mps=0.0, r_radps=0.0, pre_flag=pre)
        n_calls = len(self.calls)
        with jax.enable_x64(False):
            a = self.j.on_state(JL.FromAutobox(**fields))
        b = self.t.on_state(TL.FromAutobox(**fields))
        assert (a is None) == (b is None), (a, b)
        self.check_state()
        if b is None:
            assert len(self.calls) == n_calls
            return None
        assert (b.stamp, b.post_flag, b.heartbeat) == (
            a.stamp, a.post_flag, a.heartbeat)
        assert b.heartbeat == seq
        # the projection of one float32 state on one float32 tube
        np.testing.assert_allclose([b.s_m, b.e_m], [a.s_m, a.e_m],
                                   rtol=1e-6, atol=1e-6)
        mode, targs = self.calls[-1]
        jmode, jargs = self.j_calls[-1]
        assert mode == jmode == self.t.tracking_mode
        assert len(self.calls) == n_calls + 1
        # the step's inputs: the state and the other car as given, the
        # time of one float32 projection (path) or of one subtraction
        q0, u0, oc, t = targs[2:]
        np.testing.assert_array_equal(q0.numpy(), np.asarray(jargs[2]))
        np.testing.assert_array_equal(oc.numpy(), np.asarray(jargs[4]))
        np.testing.assert_allclose(t.numpy(), np.asarray(jargs[5]),
                                   rtol=1e-6)
        # u0 is the command in effect, the last one published
        np.testing.assert_array_equal(u0.numpy(), np.float32(
            [getattr(self.prev, k) for k in ("delta_cmd_rad", "fxf_cmd_N",
                                             "fxr_cmd_N")]))
        u32 = [np.array([c.delta_cmd_rad, c.fxf_cmd_N, c.fxr_cmd_N])
               for c in (a, b)]
        assert all(np.isfinite(u).all() for u in u32)
        gaps = [np.abs(u - self.replay64(mode, args).numpy())
                for u, args in zip(u32, (jargs, targs))]
        self.rows.append((mode, u32, gaps))
        self.prev = b
        return b

    def replay64(self, mode, args):
        """The port's `mpc_step` at float64 on a recorded step's carry and
        inputs (either package's)."""
        carry = TM.MPCCarry(*[_as_torch64(x) for x in args[1]])
        _, u64, _ = TM.mpc_step(self.t.cfgs[mode], self.tube64,
                                self.t.cache, carry,
                                *[_as_torch64(x) for x in args[2:]])
        return u64

    def check_commands(self):
        """The commands by the rule of the module docstring."""
        if not self.rows:
            return
        u32 = np.array([u for _, u, _ in self.rows])   # (period, pkg, 3)
        G = np.array([g for _, _, g in self.rows]).max(axis=(0, 1))
        allowed = np.minimum(BAR + 2.0 * G, CAP_BARS * BAR)
        diff = np.abs(u32[:, 0] - u32[:, 1])
        assert (diff <= allowed).all(), (diff, allowed)

    prev = TL.ToAutobox(0.0, 0, 0, 0.0, 0.0, 0.0, 0.0, 0.0)


def _msgs_ahead(pair, seqs, stamp0=0.0):
    """Periods of a vehicle moving up the straight path at 5 m/s, 0.2 m to
    its right of the path, drifting left."""
    return [pair.on_state(seq, stamp=stamp0 + 0.01 * seq,
                          E=0.2 - 0.01 * seq, N=5.0 + 0.05 * seq)
            for seq in seqs]


def test_basic_step_gating_and_heartbeat(jax_rt):
    p = Pair(jax_rt)
    p.set_path(STRAIGHT)
    cmds = _msgs_ahead(p, (1, 2))
    assert [c.heartbeat for c in cmds] == [1, 2]
    assert abs(cmds[0].e_m + 0.19) < 0.05
    # pre_flag 0 and the low-speed pause: no step, heartbeat kept
    assert p.on_state(3, pre=0) is None and p.t.heartbeat == 2
    assert p.on_state(4, ux=0.5) is None and p.t.heartbeat == 2
    # 4 messages lost: the heartbeat jumps to the sequence number
    cmd = p.on_state(9, stamp=0.09, E=0.15, N=5.45)
    assert cmd.heartbeat == 9
    _msgs_ahead(p, (10, 11))
    assert p.t.heartbeat == 11
    assert bool(p.t.carries["path"].solved)
    p.check_commands()


def test_time_window(jax_rt):
    p = Pair(jax_rt)
    p.set_trajectory(STRAIGHT, stamp=100.0)
    assert p.t.tracking_mode == "traj" and p.t.time_offset == 100.0
    assert p.on_state(1, stamp=99.0) is None            # before it
    assert p.on_state(2, stamp=120.0) is None           # past its 12 s
    assert p.on_state(3, stamp=112.0 + 1e-3) is None
    assert p.on_state(4, stamp=100.5, N=2.5).heartbeat == 4
    assert p.on_state(5, stamp=112.0, N=60.0) is not None  # at its end
    assert p.t.heartbeat == 5
    p.check_commands()


def test_path_to_traj_dispatch(jax_rt):
    """The decoupled controller serves "path" mode and the coupled one
    "traj" mode, the HJI override only the latter; each ingest drops its
    controller's warm start and only its own."""
    p = Pair(jax_rt)
    assert not p.t.cfgs["path"].use_hji_policy
    assert p.t.cfgs["traj"].use_hji_policy
    assert p.t.cfgs["path"].formulation == "decoupled"
    p.set_path(STRAIGHT)
    _msgs_ahead(p, (1, 2))
    assert bool(p.t.carries["path"].solved)
    assert not bool(p.t.carries["traj"].solved)
    p.set_trajectory(STRAIGHT, stamp=10.0)
    assert not bool(p.t.carries["traj"].solved)
    assert bool(p.t.carries["path"].solved)
    p.set_other_car(1.0, 40.0, -math.pi / 2, 5.0)
    _msgs_ahead(p, (3, 4, 5), stamp0=11.0)
    assert bool(p.t.carries["traj"].solved)
    # back to the path: its warm start dropped, the traj one kept
    p.set_path(STRAIGHT)
    assert not bool(p.t.carries["path"].solved)
    assert bool(p.t.carries["traj"].solved)
    _msgs_ahead(p, (6, 7))
    assert [c[0] for c in p.calls] == ["path"] * 2 + ["traj"] * 3 + [
        "path"] * 2
    p.check_commands()


@pytest.mark.parametrize("budget,violations", [(1e-9, 3), (1e9, 0)])
def test_budget_warning(jax_rt, caplog, budget, violations):
    """Every step past the budget is counted and logged with its
    heartbeat, in both packages."""
    p = Pair(jax_rt, step_budget_s=budget)
    p.set_path(STRAIGHT)
    with caplog.at_level(logging.WARNING):
        _msgs_ahead(p, (1, 2, 3))
    for pkg in ("pigeon_tpu.runtime", "pigeon_tpu_torch.runtime"):
        warned = [r.getMessage() for r in caplog.records
                  if r.name == pkg and "exceeded budget" in r.getMessage()]
        assert len(warned) == violations, (pkg, warned)
    stats = p.t.latency_stats()
    assert stats["n"] == 3 and stats["budget_violations"] == violations
    assert stats.keys() == p.j.latency_stats().keys()
    assert stats["p50_ms"] <= stats["p99_ms"] <= stats["max_ms"]
    p.check_commands()
    assert TL.ControllerRuntime(device="cpu", **RUNTIME_KW
                                ).latency_stats() == {"n": 0}


def test_trajmsg_ingest(jax_rt):
    n = 24
    t = np.linspace(0.0, 4.6, n)
    s = t * 6.0
    psi = np.linspace(0.0, 0.4, n)
    buf = TT.serialize_trajmsg(
        t, s, np.full(n, 6.0), np.zeros(n), -np.sin(psi) * s,
        np.cos(psi) * s, psi, np.full(n, 0.02), np.zeros(n), np.zeros(n),
        np.full(n, 3.5), np.full(n, -3.5), stamp=123.25, seq=7,
        frame_id="map")
    p = Pair(jax_rt)
    p.set_path(STRAIGHT)
    _msgs_ahead(p, (1,))
    p.set_trajectory_msg(buf)
    assert p.t.tracking_mode == "traj"
    assert p.t.time_offset == pytest.approx(123.25, abs=1e-6)
    assert p.t.tube.n_valid == int(p.j.tube.n_valid) == n
    for name in TT.COLUMNS:
        np.testing.assert_array_equal(getattr(p.t.tube, name).numpy(),
                                      np.asarray(getattr(p.j.tube, name)))
    assert not bool(p.t.carries["traj"].solved)
    assert p.on_state(2, stamp=123.25 + 0.5, E=-0.03, N=3.0,
                      psi=0.02) is not None
    assert p.on_state(3, stamp=123.25 + 4.7) is None     # past its end
    p.check_commands()


def _state_as_numpy(jr) -> dict:
    return dict(tube=tube_arrays(jr.tube),
                carries={m: carry_arrays(c) for m, c in jr.carries.items()},
                other_car=np.asarray(jr.other_car),
                tracking_mode=jr.tracking_mode, time_offset=jr.time_offset,
                heartbeat=jr.heartbeat,
                last_command=dataclasses.asdict(jr.last_command))


def test_start_from_mid_run_jax_state(jax_rt):
    """A JAX runtime runs a path, then a trajectory; its state carried
    over goes on as the JAX runtime does."""
    jr, built, calls = jax_rt
    jr.__dict__.update(built, carries=dict(built["carries"]),
                       _step_times=[], step_budget_s=1e9)
    calls.clear()
    with jax.enable_x64(False):
        jr.set_path(JT.make_tube(**STRAIGHT, pad_to=32))
        for seq in (1, 2):
            jr.on_state(JL.FromAutobox(seq, 0.01 * seq, 0.2, 5.0 + 0.05 * seq,
                                       0.0, 5.0, 0.0, 0.0))
        jr.set_trajectory(JT.make_tube(**STRAIGHT, pad_to=32), stamp=50.0)
        jr.set_other_car(0.5, 30.0, -math.pi / 2, 4.0)
        for seq in (3, 4):
            jr.on_state(JL.FromAutobox(seq, 51.0 + 0.01 * seq, 0.2,
                                       5.0 + 0.05 * seq, 0.0, 5.0, 0.0, 0.0))
    p = Pair(jax_rt, fresh=False)
    convert.runtime_state_from_numpy(p.t, _state_as_numpy(jr))
    p.tube64 = TT.make_tube(**STRAIGHT, pad_to=32, device="cpu", dtype=F64)
    p.prev = p.t.last_command
    p.check_state()
    assert p.t.tracking_mode == "traj" and p.t.heartbeat == 4
    assert p.t.carries["traj"].warm_x.dtype == torch.float32
    for m in ("path", "traj"):
        for name, v in carry_arrays(jr.carries[m]).items():
            np.testing.assert_array_equal(
                getattr(p.t.carries[m], name).numpy(), v, err_msg=name)
    _msgs_ahead(p, (5, 6), stamp0=51.0)
    p.set_path(STRAIGHT)
    _msgs_ahead(p, (7,))
    assert p.t.heartbeat == 7
    p.check_commands()


def test_warmup_and_device(monkeypatch):
    """Warm-up runs both controllers and leaves the carries as they were;
    the default device is the card, which raises without CUDA."""
    tkw = _cfgs()[1]
    rt = TL.ControllerRuntime(pad_to=32, device="cpu", **tkw)
    assert rt.device == torch.device("cpu")
    cold = {m: TM.init_carry(c, None, device="cpu")
            for m, c in rt.cfgs.items()}
    for m in ("path", "traj"):
        for a, b in zip(rt.carries[m], cold[m]):
            assert torch.equal(a, b)
    assert rt.tube.n_valid == 2 and float(TT.end_time(rt.tube)) == 6.0
    assert rt.other_car.tolist() == [1e4, 1e4, 0.0, 0.0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        TL.ControllerRuntime(pad_to=32, warmup=False, **tkw)


@pytest.mark.parametrize("given", ["one", "one_with_policy", "two"])
def test_controller_selection(given):
    """The controllers each mode gets, in both packages: a single `cfg`
    serves both, the path controller never carries the HJI override, and
    `use_hji_policy` turns it on for the trajectory controller."""
    out = []
    for M, HP, L, extra in ((JM, JHP, JL, {}), (TM, THP, TL,
                                                 dict(device="cpu"))):
        hz = HP(N_short=2, N_long=3)
        if given == "two":
            kw = _cfgs()[L is TL]
        else:
            kw = dict(cfg=M.x1_coupled_config(
                hz=hz, use_hji_policy=given == "one_with_policy"))
        with jax.enable_x64(False):
            rt = L.ControllerRuntime(pad_to=32, warmup=False, **kw, **extra)
        out.append({m: (c.formulation, c.soft, c.use_hji_policy, c.hz.N)
                    for m, c in rt.cfgs.items()})
        assert rt.cfg is rt.cfgs["traj"]
        assert not rt.cfgs["path"].use_hji_policy
        assert rt.tracking_mode == "path" and math.isnan(rt.time_offset)
    assert out[0] == out[1]
