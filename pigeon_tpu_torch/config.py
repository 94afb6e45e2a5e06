"""Typed configuration tree of the PyTorch port.

The same frozen dataclasses, fields and defaults as `pigeon_tpu/config.py`
(tests/test_torch_config.py holds them equal field by field).  The port
keeps its own copy so that it imports nothing from the JAX package.

Mirrors the reference's three config tiers (SURVEY.md §5 "Config / flag
system"): vehicle physical parameters (reference: `src/vehicles.jl:1-59`,
a Dict{Symbol,Float64}), controller gains (reference:
`src/decoupled_lat_long.jl:18-30`, `src/coupled_lat_long.jl:23-40`) and
horizon shape (reference: `src/model_predictive_control.jl:11-16`).

All configs here are frozen dataclasses of Python scalars: hashable, and
fixed for the life of a controller.  Options that select JAX or TPU code
paths (`backend`, `pallas_*`, `factor_method`, `tp_axis`, ...) are kept
for field-by-field parity; the port's step reads only the ones its lane
solver uses.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class VehicleParams:
    """Physical vehicle parameters (bicycle model + actuation + limits).

    Field-for-field covers the entries of the reference's vehicle Dict
    consumed by `BicycleModelParams`, `LongitudinalActuationParams` and
    `ControlLimits` (reference: `src/vehicle_dynamics.jl:7-29,272-292`).
    """

    # Dimensions
    L: float      # wheelbase (m)
    a: float      # distance from CG to front axle (m)
    b: float      # distance from CG to rear axle (m)
    h: float      # CG height (m)

    # Mass and yaw inertia
    G: float      # gravitational acceleration (m/s^2)
    m: float      # total vehicle mass (kg)
    Izz: float    # yaw moment of inertia (kg m^2)

    # Tire model
    mu: float     # friction coefficient
    Caf: float    # front tire (pair) cornering stiffness (N/rad)
    Car: float    # rear tire (pair) cornering stiffness (N/rad)

    # Longitudinal drag: Fx_drag = -(Cd0 + Cd1*Ux + Cd2*Ux^2)
    Cd0: float
    Cd1: float
    Cd2: float

    # Drive / brake force distribution (front/rear fractions)
    fwd_frac: float
    rwd_frac: float
    fwb_frac: float
    rwb_frac: float

    # Actuation limits
    Fx_max: float   # max positive longitudinal force (N)
    Fx_min: float   # max braking force (negative, N)
    Px_max: float   # max motor power (W)
    delta_max: float  # max steering angle (rad)
    kappa_max: float  # max curvature at low speed (1/m)

    # Geometry extras carried for completeness (collision footprint etc.)
    d: float = 0.0    # track width (m)
    w: float = 0.0    # physical width (m)
    ab: float = 0.0   # CG to front bumper (m)
    bb: float = 0.0   # CG to rear bumper (m)


def x1_params() -> VehicleParams:
    """Stanford X1 vehicle parameterization.

    Values and derived quantities mirror the reference's `X1()` constructor
    (reference: `src/vehicles.jl:1-59`).
    """
    G = 9.80665
    mfl, mfr, mrl, mrr = 484.0, 455.0, 521.0, 504.0
    m = mfl + mfr + mrl + mrr
    L = 2.87
    a = (mrl + mrr) / m * L
    b = (mfl + mfr) / m * L
    hf, hr, h1 = 0.1, 0.1, 0.37
    h = hf * b / L + hr * a / L + h1
    mu = 0.92
    fwd_frac = 0.0
    rwd_frac = 1.0 - fwd_frac
    fwb_frac = 0.6
    rwb_frac = 1.0 - fwb_frac
    # Brake force at which the first of the front/rear tires saturates
    # (reference: src/vehicles.jl:49-50).
    Fx_min = max(
        -m * G * a * mu / (L * rwb_frac + mu * h),
        -m * G * b * mu / (L * fwb_frac - mu * h),
    )
    delta_max = 18.0 * math.pi / 180.0
    return VehicleParams(
        L=L, a=a, b=b, h=h,
        G=G, m=m, Izz=2900.0,
        mu=mu, Caf=150e3, Car=220e3,
        Cd0=241.0, Cd1=25.1, Cd2=0.0,
        fwd_frac=fwd_frac, rwd_frac=rwd_frac,
        fwb_frac=fwb_frac, rwb_frac=rwb_frac,
        Fx_max=5600.0, Fx_min=Fx_min, Px_max=75e3,
        delta_max=delta_max, kappa_max=math.tan(delta_max) / L,
        d=1.63, w=1.87, ab=a + 0.4953, bb=b + 0.4318,
    )


@dataclasses.dataclass(frozen=True)
class HorizonParams:
    """Two-resolution MPC horizon (reference: `src/model_predictive_control.jl:1-30`).

    N_short steps at dt_short then N_long at dt_long, with an optional
    correction step aligning the long steps to the dt_long grid.
    """

    N_short: int = 10
    N_long: int = 20
    dt_short: float = 0.01
    dt_long: float = 0.2
    use_correction_step: bool = True

    @property
    def N(self) -> int:
        """Number of knots: 1 + N_short + N_long."""
        return 1 + self.N_short + self.N_long


@dataclasses.dataclass(frozen=True)
class DecoupledControlParams:
    """Lateral-only MPC gains (reference: `src/decoupled_lat_long.jl:1-30`)."""

    V_min: float = 1.0
    V_max: float = 15.0
    k_V: float = 10.0 / 4 / 100
    k_s: float = 10.0 / 4 / 10000
    delta_dot_max: float = 0.344
    Q_dpsi: float = 1.0 / (10 * math.pi / 180) ** 2
    Q_e: float = 1.0
    W_beta: float = 50.0 / (10 * math.pi / 180)
    W_r: float = 50.0
    R_delta: float = 0.0
    R_ddelta: float = 0.01 / (10 * math.pi / 180) ** 2


@dataclasses.dataclass(frozen=True)
class CoupledControlParams:
    """Coupled lat-long MPC gains (reference: `src/coupled_lat_long.jl:1-40`)."""

    V_min: float = 1.0
    V_max: float = 15.0
    k_V: float = 10.0 / 4 / 100
    k_s: float = 10.0 / 4 / 10000
    delta_dot_max: float = 0.344
    Q_ds: float = 1.0
    Q_dpsi: float = 1.0
    Q_e: float = 1.0
    W_beta: float = 50.0 / (10 * math.pi / 180)
    W_r: float = 50.0
    W_HJI: float = 500.0
    N_HJI: int = 3
    R_delta: float = 0.0
    R_ddelta: float = 0.1
    R_Fx: float = 0.0
    R_dFx: float = 0.5
    use_hji: bool = True
    # Wall / edge collision avoidance (the reference's `both_walls` branch
    # configuration; edge_L/edge_R fields exist in every trajectory,
    # reference src/trajectories.jl:19-20): soft bounds
    # edge_R + margin <= e_t <= edge_L - margin with slack weight W_wall.
    use_walls: bool = False
    W_wall: float = 500.0
    wall_margin: float = 1.0   # ~half the X1's 1.87 m width


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Batched OSQP-style ADMM solver options.

    Defaults mirror OSQP's (the reference's C solver, declared at
    the reference's `Project.toml:15`, configured
    `src/coupled_lat_long.jl:201-203`):
    sigma=1e-6, alpha=1.6, rho=0.1 with 1e3x stiffer rho on equality rows.
    `max_iter` is capped far below OSQP's 4000 because a warm-started MPC QP
    converges in tens of iterations and a fixed budget keeps latency
    deterministic on TPU.

    eps matches OSQP's 1e-3 default.  (During development a tighter 1e-4
    was needed to mask an instability that was actually caused by RK4
    linearization of the stiff tire modes over dt_long; with the exact expm
    discretization, 1e-3 tracks the X1 oval paths at |e| < 1e-3 m.)
    """

    rho: float = 0.1
    rho_eq_scale: float = 1e3
    sigma: float = 1e-6
    alpha: float = 1.6
    eps_abs: float = 1e-3
    eps_rel: float = 1e-3
    max_iter: int = 2000
    check_every: int = 25
    scaling_iters: int = 10   # Ruiz equilibration sweeps (0 disables)
    adaptive_rho: bool = True
    # Iteration backend: "xla" (portable) or "pallas" (TPU kernel holding
    # A / K^-1 in VMEM across iterations — the OSQP-hot-loop replacement).
    backend: str = "xla"
    # KKT factorization: "chol" (exact, slow batched Cholesky on TPU),
    # "ns" (Newton-Schulz inverse — square MXU matmuls only), or "banded"
    # (block-tridiagonal stage factorization; needs a banded_plan).
    factor_method: str = "chol"
    ns_iters: int = 30
    # bf16 bulk phase of the Newton-Schulz factor — measured NOT to
    # converge on the condensed KKT family (early NS progress per
    # iteration is below bf16 noise); keep 0
    ns_bf16_iters: int = 0
    # Pallas batched-path tuning: instances per VMEM tile (4 fits the
    # coupled QP's ~3 MB/instance working set in 16 MB VMEM with double
    # buffering; 8 overflows), and the bf16 bulk phase of the precision
    # ladder: that many one-pass-MXU bf16 iterations run before the fp32
    # polish segments (~6x cheaper per iteration; 0 disables).
    pallas_tile: int = 4
    bf16_bulk_iters: int = 0
    # Matmul precision for the in-kernel iteration matvecs (the iteration
    # is MXU-pass bound, so this is ~the segment latency):
    #   "highest": 6-pass fp32 everywhere (reference grade).
    #   "high":    3-pass bf16x3 everywhere — DIVERGES on this QP family
    #              (rho_eq rows amplify the noise; kept for experiments).
    #   "mixed":   equality-row A/A^T tiles at 6-pass fp32, inequality
    #              tiles and K^-1 at 3-pass bf16x3 (needs the layout's
    #              eq_rows, which mpc_step_batched passes; ~1.6x fewer MXU
    #              passes on the TPU, three FMAs for one on the H100).
    #   "mixedk6": like "mixed" but K^-1 also at 6-pass fp32.
    # The FACTORIZATION stays at HIGHEST regardless (solver/banded.py).
    pallas_precision: str = "highest"
    # In-kernel convergence-check period (iterations).  Pallas grid steps
    # run sequentially, so a tile that detects convergence stops early
    # and the batch pays the MEAN iteration count, not the fixed budget.
    # 0 disables (fixed-length segments, deterministic latency).
    pallas_check_inner: int = 10
    # Newton-Schulz polish steps after the lane-batched per-lane Cholesky
    # inverse ("lanes" backend): each squares the factorization residual
    # (fp32 substitution leaves ~eps*cond); 1 is plenty.
    lane_polish: int = 1
    # Tensor-parallel mesh axis name (shard_map) for the KKT factorization:
    # identity RHS columns of the banded solve are sharded across this
    # axis and re-assembled with all_gather.  None = no TP.
    tp_axis: "str | None" = None


@dataclasses.dataclass(frozen=True)
class SimOptions:
    """Closed-loop simulation options (reference `simulate`,
    `src/model_predictive_control.jl:80-100`)."""

    dt: float = 0.01
    substeps: int = 1   # RK4 substeps for the plant propagation
