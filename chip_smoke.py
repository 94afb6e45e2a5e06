"""Drive the PyTorch/CUDA port (`pigeon_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build the nine CUDA kernels (B8 in four builds, the pair build in the
   large build's source) from `pigeon_tpu_torch/csrc/` (one nvcc per
   source, in parallel) and print the build time and register use;
3. kernel checks: capture each kernel's inputs at the shapes its path
   gives it (float32) -- one cold step of the coupled and the decoupled
   fleet at B=8192 and of the sparse fleet at B=2048, one `mpc_step` of
   each soft formulation -- then hold the kernel against its plain PyTorch
   version on the card, with times for the kernel, the plain version and
   a PyTorch library call where one computes the same function; also on a
   ragged batch and on the inputs of a 12-stage horizon (the kernels'
   run-time-n build).  The dense exponential is also held on the stack of
   all 122,880 stage matrices of the coupled fleet, its exact builds
   (d = 19, 17) bit-equal to its run-time build on every call, and the
   run-time build swept over d (EXPM_SWEEP_D); it prints the chain's
   latency floor and the wrapper's host time a call.  The sparse path's
   kernels (ruiz, banded_chol, admm_dense) whose float32 results are
   rounding-limited by the stiff equality rows are also held against the
   float64 plain version: the kernel no further from it than twice the
   float32 plain version; the Ruiz kernel must also be bit-equal to its
   plain version on all three of its calls, and the structured
   exponential and the Cholesky inverse bit-equal on the ragged batch to
   the same instances of the full call.  Each check prints its
   kernel's ptxas registers (and static shared memory), and how many
   blocks, or clusters, the card holds at once at the path's shape, and
   the shared memory of a block (for the structured exponential and the
   Cholesky inverse the Python plan must match the kernel's own); the two
   ADMM kernels and the Ruiz kernel launch as thread block clusters.  The
   ADMM kernels' bounds count A's nonzeros, not m n.  The dense ADMM
   kernel has three builds, picked from A's widths and the mode
   (`pallas_admm.plan_build`): the narrow one (`admm_dense`, the sparse
   fleet's in "highest"), the wide one (`admm_wide`, the condensed QP's
   long rows and columns) and the large one (`admm_large`, the sparse
   fleet's in the split modes, one block filling an SM); each check of
   the dense ADMM kernel prints its pipe floor (`pipe_floor_ms`, worked
   out from the run's residency and executed iterations, not measured)
   on its own record, not in the kernels line.
   The wide build's dense-P mode and the Ruiz kernel are held the same
   way on the inputs of the hard condensed fleet (a cold and a warm
   segment, a ragged batch, horizon (4, 8)), with the split of its
   segment's time measured from variants of the call (`dense_p_split`);
   the wide build again at tile 1 on the calls of the unbatched condensed
   route (B=1, no check, identity scalings: the cold step's first segment
   and the second step's last, `check_admm_dense_tile1`, with its latency
   floor); the narrow build on the sparse fleet's as before; and the
   large build on the inputs of the sparse fleet in mode "mixedk6" (its
   cold and warm segment, a ragged batch, horizon (4, 8)), the statistics
   held against their own iterates'.  Its other precision modes
   ("mixed", "mixedk6", "high", "bf16"; `check_admm_dense_modes`) are
   held the same way on the cold and the warm segment of both hard fleets
   and on a ragged batch, in the build each mode takes (the sparse QP's
   large one, the condensed QP's wide one), against its own float32 and
   float64 plain versions (on the fixed iterations before the float32
   plain version leaves float64's tenth of a scale or goes non-finite,
   where it does; the statistics against the kernel's own iterates'),
   with each build's time, bound, registers and shared memory.  The
   large build is held the same way on the sparse decoupled fleet's cold
   and warm segments (B=2048, n=245, m=395, "highest"), a ragged batch
   and horizon (4, 8), and so is its pair form (`admm_pair`: an instance
   on two blocks, each holding half of K^-1's columns; no path runs it),
   also at tile 1 and bit-equal to the large build on the sparse coupled
   fleet's calls and on the decoupled fleet's cold, warm, ragged and tile
   1 calls; the Ruiz kernel on that fleet's A, and the dense exponential
   on its two stacks a step (20,480 matrices of 11 x 11, 40,960 of 17 x
   17).  The same checks on the wall fleets' calls (below): B1 on each,
   B9, B7 (block width 14, the padded build) and B8's narrow build (n =
   208, m = 335) on the sparse one, B9 and B8's wide build with its dense
   P (n = 118, m = 245) on the condensed one, B2 and B3 (m = 139) on the
   soft one;
4. path "fleet": the coupled soft MPC for a fleet of 8192 vehicles on an
   oval (x1_coupled_config(soft=True), N_short=5, N_long=10, the lane
   solver with bench.py's options), one cold step and 5 warm closed-loop
   steps with the RK4 plant, timed with CUDA events; the launch counters
   of vanloan, chol_inverse and admm_iterations must advance on every
   step and no other, commands must be finite and the converged fraction
   on the last step at least 0.99; then torch.profiler over one more warm
   step (device busy time, idle share, largest kernels);
5. path "fleet_decoupled": the same for x1_decoupled_config(soft=True)
   (N_short=10, N_long=20, QPs of n=30, m=180), 5 warm steps; its steps
   launch vanloan, rollout, chol_inverse and admm_iterations;
6. path "fleet_sparse": the sparse coupled MPC (x1_coupled_config() as
   it comes, N_short=5, N_long=10, QPs of n=193, m=290) for 2048 vehicles
   on the "pallas" solver with the banded factor, one cold and 5 warm
   steps; every step launches vanloan and ruiz once, and banded_chol and
   admm_dense 8 times (SPARSE_STEP_LAUNCHES);
   path "fleet_condensed": the hard condensed coupled MPC
   (x1_coupled_config(condensed=True), QPs of n=103, m=200, a dense P)
   for 2048 vehicles on the sparse fleet's solver options, whose banded
   factor falls through to the dense Cholesky for a dense P; one cold and
   5 warm steps, each launching vanloan and ruiz once and admm_wide
   (the dense ADMM kernel's wide build, dense-P mode) once per solver
   segment, and no launch of the narrow build;
   path "fleet_sparse_mixedk6": the sparse fleet in precision mode
   "mixedk6" (scripts/exp_conv.py's: the layout's 128 equality rows in
   float32, the other rows and the vectors in bf16 pairs, K^-1 in
   float32), one cold and 5 warm steps, each launching vanloan and ruiz
   once, banded_chol once per factorization and admm_large (the dense
   ADMM kernel's large build) once per segment, every launch its mixedk6
   instantiation (`_kernels.launches_by`), and no launch of the narrow
   build;
   path "fleet_decoupled_sparse": the sparse decoupled MPC
   (x1_decoupled_config() as it comes, N_short=10, N_long=20, QPs of
   n=245, m=395) for 2048 vehicles on the sparse fleet's solver options
   (no banded plan: the dense Cholesky), one cold and 5 warm steps, each
   launching expm_dense twice, ruiz once and admm_large (the large
   build, "highest") once per segment; its converged share on one more
   step held against the same step with B8's plain version on the card,
   every convergence it reports confirmed by the float64 residuals of
   its solution, and the plain version in float64 recorded beside them
   (`convergence_witness`; its float32 solve leaves about a fifth of the
   fleet unconverged at this budget, in the JAX package too);
   paths "fleet_sparse_walls", "fleet_condensed_walls" and "fleet_walls":
   the sparse, hard condensed (B = 2048, the hard fleets' options) and
   soft coupled fleets (B = 8192, bench.py's) with the wall rows (the
   reference's both_walls) on the oval with a 3.5 m lane (WALL_EDGES),
   one cold and 5 warm steps each, launching their base fleets' kernels;
   the cold step's shares outside the admissible band and with a live
   wall slack must be above zero; the sparse and soft ones' converged
   share is gated by `convergence_witness` (the sparse one's float32
   solve, the soft one's budget); then one cold step of the
   sparse wall fleet with lin_method "expm_split" (`run_expm_split`: its
   QP against the "expm" one, expm_dense twice, its two stacks held
   against plain);
7. path "simulate": `mpc.simulate` for one vehicle on the card, 5
   closed-loop steps per soft formulation -- the unbatched route, dense
   linearization and `solve_qp` -- which launches expm_dense once per
   step and no other kernel; then torch.profiler over 1 more step; and
   path "simulate_condensed": 5 steps of the hard condensed QP on
   backend "pallas", whose `solve_qp` runs each solver segment on the
   dense ADMM kernel's wide build at tile 1 (expm_dense once per step,
   admm_wide once per segment), profiled over 1 more; and 5 steps of
   the sparse decoupled QP (x1_decoupled_config() as it comes, the
   runtime's path controller: expm_dense twice a step, plain `solve_qp`),
   profiled over 1 more; and path "simulate_faithful": 2 steps of the
   parity harness's reference-faithful controller (`parity.faithful_config`
   at the oval's stable RK4 substep count, 4: the RK4 linearization,
   PARITY_SOLVER, the reference tire inverse, unclamped), which launches
   no kernel;
8. path "montecarlo": `montecarlo.run_dynamic_obstacle`, the HJI safety
   filter's Monte-Carlo study, at scripts/exp_safety_ab.py's
   hammer_eps1.5 arm (the soft coupled QP with the HJI row and its
   override, the lane solver in 12 segments of 50 iterations) with the
   mid value grid (`assets/hji_cache_mid.npz`, read by
   `hji_solve.load_cache`) for 8192 scenarios of its "avoidable" regime
   over 150 steps; every step launches vanloan, chol_inverse (once more
   per refactor) and admm_iterations (once per segment) and no other;
   commands finite, the filter active and the override applied on some
   steps; then `certify_avoidable` on the same scenarios, torch.profiler
   over one more step, and the Cholesky inverse and ADMM kernels held
   against their plain versions on the inputs of a step that refactors
   with active HJI rows (`run_montecarlo`);
   path "runtime": `runtime.ControllerRuntime` on the card with both
   default controllers at full width (the sparse decoupled path
   controller, n=245, m=395; the sparse coupled trajectory controller,
   n=193, m=290, with the HJI override), the mid grid, pad_to 1024,
   warmed up; 10 periods on the oval as a spatial path (`set_path`), then
   10 on the oval as a timed VehicleTrajectory from the wire
   (`set_trajectory_msg`) with the other car placed ahead each period;
   every state message through the native `StateRing`, the RK4 plant on
   the host; a pre_flag = 0 period, one at ux < 1 and (traj) one before
   the time window must return None and keep the heartbeat, every other
   period must return a finite command and launch expm_dense (twice a
   path period, once a traj period) and nothing else; each mode's
   `latency_stats()` against the 10 ms budget, one more period of each
   under torch.profiler, the count of periods with the HJI row active,
   and the dense exponential held against its plain version on the calls
   of a period of each mode (`run_runtime`, `check_runtime_expm`);
   path "hji_solve" (`run_hji_solve`): the HJI value-iteration solver,
   plain PyTorch operations and no kernel: the proto grid solved to its
   pseudo-time horizon in float32 and float64 (HJI_PROD.json's settings:
   450 sweeps), each held against `assets/hji_cache_proto.npz` by the
   mean and p99 |dV| and the activation agreement at eps 0.05, 0.3, 0.6
   within fixed bars, twice the larger of the JAX package's CPU float32
   gap and the card's recorded float32-to-float64 gap, which the solve
   stopped at half the horizon must fail, and the live float32-to-float64
   gap held to twice its recorded value; one sweep under torch.profiler;
   the card-solved cache against the asset at the Monte-Carlo rollout's
   states by the same rule; the production grid (128 x 32 x 9^5 points,
   stored reversed, slab by slab) for 3 sweeps in float32 and float64,
   the two step traces equal to float32 rounding and V within bars set
   from the recorded gap, which the float32 run one sweep short must
   fail, with ms a sweep and peak memory; the sharded solver on a
   one-card NCCL mesh bit-equal to the whole-grid sweep on the smooth
   pursuit game;
   paths "mesh_fleet", "mesh_sparse_tp", "mesh_montecarlo" (`run_mesh`,
   one one-rank NCCL world): `BatchedController(mesh=make_mesh())` on
   the coupled fleet (B=8192), a cold and 3 warm steps, bit-equal to the
   mesh-less controller; `make_sharded_step` on a (1, 1) mesh with the
   tp factor forced on the sparse fleet (B=2048), a cold and 2 warm
   closed-loop steps, bit-equal to `mpc_step_batched`, its FleetMetrics
   the step's own reductions, each step's launches SPARSE_STEP_LAUNCHES;
   `run_dynamic_obstacle(mesh=)` at B=8192 for 5 steps, its summary the
   mesh-less one's field for field; then `rollout_affine` at T = 64 and
   128 (the associative scan, no kernel) against the CPU float64
   unroll, and `viz.hji_slice` on the mid cache against the CPU float64
   slice; phase "profile_phases": `profiling.profile_step` on the coupled
   and the sparse fleet (each phase finite, the whole step within 0.5-2x
   the fleet phase's warm median) and `mfu_row` of the coupled fleet's
   warm step;
9. reference checks: for each formulation (coupled, decoupled, sparse,
   condensed, decoupled_sparse, and the three wall fleets) a 64-vehicle
   fleet stepped on the card,
   each step also run on the CPU (plain versions) from the card's state
   at float64 and float32, commands compared by each formulation's rule
   (REF_RULES, `reference_check`; the hard QPs' bars are fleet-wide,
   their float32 solves being rounding-determined, the condensed one's
   also covers the float64 path's own exit noise, and the sparse
   decoupled one's converged counts the float32 path's own), on three
   placements for the hard QPs (one for the wall fleets), which also
   record the card's QPs solved on the CPU; the card's `simulate`
   commands against the CPU `simulate` at float64 and float32
   (`simulate_reference_check`, both unbatched soft formulations, the
   condensed, the sparse decoupled and the faithful one); the coupled,
   the sparse and the condensed check
   once more with active HJI rows (the mid grid, the other car 3-15 m
   ahead); the sparse fleet in mode "mixedk6" by the sparse rule, with
   its controls; the precision ladder (`ladder_check`: 50 and 2 bf16
   iterations before the mixedk6 segments, three steps, the bulk's
   iterations and convergence accounted, every launch the large build's
   bf16 or mixedk6 instantiation);
   and the Monte-Carlo rollout's 8 scenarios of least start value, five
   steps (`reference_montecarlo`); the runtime's first three steps of
   each mode replayed on the CPU at float64 and float32 by
   `simulate_reference_check`'s rule (`reference_runtime`, run with the
   runtime phase);
10. B=1 latency: the coupled fleet path for one vehicle, 10 warm steps;
11. one JSON line listing the kernels, the nvidia-smi line, and the last
   line {"ok": true, "device": {...}}.

It exits non-zero without a result when CUDA is unavailable or when run
outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import subprocess
import sys
import time

import numpy as np

B_FLEET = 8192
B_SPARSE = 2048
# The wall fleets (the reference's both_walls configuration): each coupled
# fleet with the wall rows, on the oval with a 3.5 m lane whose centre
# lies 0.55 m right of the path; with the default wall_margin of 1.0 the
# admissible band is e in [-1.3, 0.2], so the fleet's +-0.5 m placement
# starts a share of it outside the band
WALL_EDGES = dict(edge_L=1.2, edge_R=-2.3)
WALL_FLEETS = {"sparse_walls": "sparse", "condensed_walls": "condensed",
               "coupled_walls": "coupled"}
# the kernel checks' records of the wall fleets' calls and of the
# "expm_split" step's two exponential stacks, by path (the kernels line's
# `other_shapes`)
WALL_CHECKS = ("sparse_walls", "condensed_walls", "coupled_walls",
               "expm_split_zoh", "expm_split_foh")
# The "expm_split" step (one cold step of the sparse wall fleet with each
# hold order's own exponential, 8 squarings, order 8): each field of its
# QP within this share of the field's scale of the "expm" QP (4 squarings,
# order 6) of the same state.  On the CPU over 64 vehicles the two
# differ by 1.0e-8 of A's scale in float64 (the methods) and by 1.2e-5
# in float32 (the roundings of the squarings); the bar is the dense
# exponential's own float64 bar (`expm_case`)
EXPM_SPLIT_QP_REL = 1e-4
# The reference-faithful closed loop (`parity.faithful_config` of the
# coupled singleton at the oval's stable substep count, on PARITY_SOLVER):
# steps on the card, all replayed on the CPU (2: cut from 10 to 4 when
# the HJI solver's phase joined the run, to 2 when the mesh phases did;
# each step is 10,000 iterations, ~6 s on the card's host and as much
# again on the CPU)
SIM_STEPS_FAITHFUL = 2
# warm steps of each fleet path (the six fleets without wall rows cut
# from 10 to 5 when the mesh phases joined the run)
WARM_STEPS = {"coupled": 5, "decoupled": 5, "sparse": 5,
              "condensed": 5, "sparse_mixedk6": 5, "decoupled_sparse": 5,
              "sparse_walls": 5, "condensed_walls": 5, "coupled_walls": 5}
B1_STEPS = 10   # cut from 20 when the mesh phases joined the run
# (5, the steps its reference check compares: cut from 20 to 10 when the
# wall and faithful phases joined the run, to 5 when the mesh phases did)
SIM_STEPS = 5
# the condensed QP's single-vehicle path: as many steps as its reference
# check compares; the sparse decoupled QP's, the runtime's path
# controller, too (cut from 30 to 10 when the HJI solver's phase joined
# the run, to 5 when the mesh phases did)
SIM_STEPS_CONDENSED = 5
SIM_STEPS_DECOUPLED_SPARSE = 5
SIM_REF_STEPS = 5   # steps of `simulate` also run on the CPU
# steps of each `simulate` profile (the profiler's own cost a step is most
# of these phases' time: 6-10 s a step on the H100's host)
SIM_PROFILE_STEPS = 1
B_REF = 64
B_RAGGED = 130   # kernel checks on a batch with a ragged last block
# and on the inputs of a 12-stage horizon (soft QP n = 2 T = 24), which
# runs the run-time-n build that every horizon but (5, 10) takes
HZ_SMALL = (4, 8)
B_SMALL = 1024
DT = 0.01
# ADMM outputs, kernel against plain (both float32, only the summation
# order differs): each within this share of its scale (`admm_errors`)
ADMM_REL = 1e-4
# The dense ADMM kernel's early exit (`held_segment`): at most this share
# of the tiles may stop at another check than the float32 plain version's
# (the sparse QP's stiff equality rows put exits at the tolerance's edge
# in rounding's hands; the lane kernel, on the soft QP, is held to 1%)
B8_EXITS_DIFFER_MAX = 0.1
# Reference check (`reference_check`): at most this share of the vehicles
# outside the test_soft.py bar on a step, and no command further than this
# many bars from the float64 one
REF_OUTSIDE_MAX = 0.1
REF_CAP_BARS = 128.0
# The CPU float64 path is also stepped from states moved by this relative
# amount (float32's rounding of them): at eps 1e-3 the solver's exit, and a
# weakly determined force, move with such a move by as much as float32
# moves them (`reference_check`'s exit-noise witness)
EXIT_NOISE = 1e-7
# The reference rule of each formulation (`reference_check`):
# - seeds: the fleet placements (make_setup's seed) it runs on; the
#   controls below run on the first, and only where `fleet_wide`;
# - fleet_wide: each command's allowance takes the step's largest CPU gap
#   over the fleet in place of the vehicle's own, and the iteration rule
#   compares fleet shares (the hard QPs, whose float32 solve is
#   rounding-determined);
# - exit_draws: states moved by EXIT_NOISE, each stepped on the CPU in
#   float64; the fleet-wide gap is then the largest of the float32 gap and
#   these float64 gaps (the hard condensed QP);
# - outside_from_cpu: where the share of vehicles outside the bare bar may
#   also reach twice the largest share of the CPU witnesses (the float32
#   path and the moved float64 states): "active" with an active HJI row,
#   "always" on every step;
# - segments: the fleet-wide iteration bar (the fleet means within one
#   segment) grows by the in-kernel check period for each segment one
#   run's batch went on with after the other's had stopped.  The rule
#   lets the converged counts differ by two, and one vehicle left
#   unconverged keeps every vehicle of its batch in the segment loop, at
#   least a check period more each segment (the mixedk6 sparse fleet:
#   63 of 64 converged on the card against 64 on the CPU gave means of
#   163.1 and 93.8 iterations on one step);
# - card_plain: the card's step with its ADMM kernel's float32 plain
#   version in place of the kernel (`plain_admm`), from the same state,
#   is one more witness: its gap to float64 joins the fleet-wide gap and
#   its share outside the bar the witnesses' shares;
# - conv_slack: how far the fleet-wide converged counts may differ (2
#   where not given).  The sparse decoupled fleet's float32 solve leaves
#   a fifth of its vehicles unconverged at the tolerance's edge, where
#   the exit is rounding-determined: on the H100 over placements 0-2,
#   three steps each, the card's counts and the CPU float32 path's
#   differed by 2 to 7 of 64 (commands within 0.31 bars of the float64
#   path's); its slack is twice the largest, 14.  Its controls are
#   rejected by the iteration means and the commands, each on every
#   step, and `convergence_witness` holds the fleet's share at B = 2048
#   to its plain version's within CONV_WITNESS_SLACK, each of its
#   convergences confirmed in float64.
REF_RULES = {
    "coupled": dict(seeds=(0,), fleet_wide=False, exit_draws=0,
                    outside_from_cpu="active"),
    "decoupled": dict(seeds=(0,), fleet_wide=False, exit_draws=0,
                      outside_from_cpu="never"),
    "sparse": dict(seeds=(0, 1, 2), fleet_wide=True, exit_draws=0,
                   outside_from_cpu="never"),
    "sparse_mixedk6": dict(seeds=(0, 1, 2), fleet_wide=True, exit_draws=0,
                           outside_from_cpu="never", segments=True),
    # the precision ladder (`ladder_check`, placement 0, no controls): its
    # bf16 bulk rounds the iterates at 2^-8, so the share outside the bar
    # may reach twice the CPU float32 path's
    "sparse_ladder": dict(seeds=(0,), fleet_wide=True, exit_draws=0,
                          outside_from_cpu="always", segments=True),
    "condensed": dict(seeds=(0, 1, 2), fleet_wide=True, exit_draws=3,
                      outside_from_cpu="always"),
    "decoupled_sparse": dict(seeds=(0, 1, 2), fleet_wide=True, exit_draws=0,
                             outside_from_cpu="never", segments=True,
                             conv_slack=14),
    # the wall fleets: each base fleet's rule, the sparse one with the
    # segments' allowance (its float32 solve leaves a share of the fleet
    # unconverged at the budget) and the card-plain witness: on placement
    # 2's third step the card's commands lie 7.59 bars from float64, the
    # CPU float32 path's 1.68, and the card's step with B8's float32 plain
    # version 6.69 (B8's plain version leaves that vehicle unconverged at
    # 400 iterations; its float64 version 0.14 bars), so the float32 spread
    # of the card's own QPs is as wide as the kernel's error; the soft one
    # with the share outside the bar scaled by the CPU float32 path's: its
    # unconverged vehicles at a wall are weakly determined (on the CPU the
    # float32 path put 6 of 64 commands outside the bar, up to 35 bars
    # from float64).  The sparse and soft ones hold on placements 0-2; the
    # condensed one on placement 0 only: on placement 1's third step one
    # tile's kernel exits at iteration 80 where its plain version, the CPU
    # float32 and the float64 paths exit at 100, its float64 residuals
    # within the tolerance, and that vehicle's force lies 3.10 bars from
    # float64 against the 2.98 the rule allows (ROADMAP C;
    # scripts/wall_rule_probe.py; PERF.md section 6)
    "sparse_walls": dict(seeds=(0, 1, 2), fleet_wide=True, exit_draws=0,
                         outside_from_cpu="never", segments=True,
                         card_plain=True),
    "condensed_walls": dict(seeds=(0,), fleet_wide=True, exit_draws=3,
                            outside_from_cpu="always"),
    "coupled_walls": dict(seeds=(0, 1, 2), fleet_wide=False,
                          exit_draws=0, outside_from_cpu="always"),
}
# The fleet-wide rules' controls: wrong solver options, each run on the
# card from the same state as the step it is compared with, and whether
# the rule must reject it on at least one step.  A control whose commands
# equal the card's bit for bit on every step is the same computation and
# is only recorded (the condensed fleet converges within 200 iterations on
# the steps checked, so max_iter 200 gives the bits of 400).  One segment
# fewer is only recorded: the vehicles the 400-iteration budget leaves
# unconverged stay unconverged at 350, so nothing the rule reads moves.
REF_CONTROLS = {"rho_eq_scale_1": (dict(rho_eq_scale=1.0), True),
                "eps_1e-2": (dict(eps_abs=1e-2, eps_rel=1e-2), True),
                "max_iter_200": (dict(max_iter=200), True),
                "alpha_1": (dict(alpha=1.0), True),
                "one_segment_fewer": (dict(max_iter=350), False)}
# Every step of the sparse fleet launches the kernels this often: one
# solve, the 8 segments of its 400-iteration budget (the vehicles that stay
# unconverged in float32 keep every step to the whole budget), one
# factorization each
SPARSE_STEP_LAUNCHES = {"vanloan": 1, "ruiz": 1, "banded_chol": 8,
                        "admm_dense": 8}
# The kernels every step of each main path must launch; it must launch no
# other ("faithful": none, the RK4 linearization and the plain solver)
PATH_KERNELS = {
    "coupled": {"vanloan", "chol_inverse", "admm_iterations"},
    "decoupled": {"vanloan", "rollout", "chol_inverse", "admm_iterations"},
    "sparse": {"vanloan", "ruiz", "banded_chol", "admm_dense"},
    "condensed": {"vanloan", "ruiz", "admm_wide"},
    "sparse_mixedk6": {"vanloan", "ruiz", "banded_chol", "admm_large"},
    "decoupled_sparse": {"expm_dense", "ruiz", "admm_large"},
    "sparse_walls": {"vanloan", "ruiz", "banded_chol", "admm_dense"},
    "condensed_walls": {"vanloan", "ruiz", "admm_wide"},
    "coupled_walls": {"vanloan", "chol_inverse", "admm_iterations"},
    "sparse_walls_expm_split": {"expm_dense", "ruiz", "banded_chol",
                                "admm_dense"},
    "simulate": {"expm_dense"},
    "simulate_faithful": set(),
    "simulate_condensed": {"expm_dense", "admm_wide"},
    "montecarlo": {"vanloan", "chol_inverse", "admm_iterations"},
    "runtime": {"expm_dense"},
}
# The dense ADMM kernel's build each hard path must launch, and no other:
# the narrow ("admm_dense"), the wide ("admm_wide", the condensed QP's
# widths), the large build ("admm_large", the sparse QP's split modes,
# `pallas_admm.plan_build`, and the sparse decoupled QP, whose K^-1 only
# its block holds, `EllPattern.for_mode`) or its pair build ("admm_pair":
# a K^-1 no one block holds; no path), and its mode
# (`_kernels.launches_by`: "_dense_P" added for the dense-P build)
B8_KERNELS = ("admm_dense", "admm_wide", "admm_large", "admm_pair")
B8_BUILD_OF = {"admm_dense": "narrow", "admm_wide": "wide",
               "admm_large": "large", "admm_pair": "pair"}
PATH_B8_BUILD = {"sparse": ("admm_dense", "highest"),
                 "condensed": ("admm_wide", "highest_dense_P"),
                 "sparse_walls": ("admm_dense", "highest"),
                 "condensed_walls": ("admm_wide", "highest_dense_P"),
                 "sparse_mixedk6": ("admm_large", "mixedk6"),
                 "decoupled_sparse": ("admm_large", "highest"),
                 "simulate_condensed": ("admm_wide", "highest")}
# Every step of the sparse decoupled fleet launches the dense exponential
# twice (the ZOH stages' 11 x 11 stack, then the FOH stages' 17 x 17) and
# the Ruiz kernel once
DECOUPLED_SPARSE_STEP_LAUNCHES = {"expm_dense": 2, "ruiz": 1}
# The sparse decoupled fleet's convergence gate.  At SPARSE_SOLVER's
# budget its float32 solve leaves 15-30% of the oval fleet unconverged on
# a step, in either package (its 155 stiff equality rows; at float64
# every vehicle converges: tests/test_torch_decoupled_sparse_f32.py), so
# the gate is the plain version's share on the same state
# (`convergence_witness`, two float32 roundings of one step): the
# kernel's share may fall short of it by at most this much
CONV_WITNESS_SLACK = 0.02
# A witness run's reported convergence holds when the float64 residuals of
# its solution are within this share above their tolerances
# (`verified_convergence`): float32 rounding of the statistics moves the
# ratio by far less
CONV_VERIFY_MARGIN = 0.1
# the fleets gated by `convergence_witness` in place of converged >= 0.99,
# each for its float32 solve at its budget: the sparse decoupled one; the
# sparse wall fleet (on the CPU at B = 128 after the cold and 5 warm
# steps: 0.992 in float64, 0.984 in float32); and the soft wall fleet,
# whose vehicles outside the band leave a share unconverged at its
# 150-iteration budget in float64 too (0.945 / 0.953)
WITNESS_FLEETS = ("decoupled_sparse", "sparse_walls", "coupled_walls")
# bench.py's lane-solver iteration budget per formulation
MAX_ITER = {"coupled": 150, "decoupled": 300}
# The dense ADMM kernel's other precision modes, held on the "highest"
# paths' captured segments (`check_admm_dense_modes`); where the float32
# plain version goes non-finite within a segment, or ends it further
# than MODE_DIVERGED of an output's scale from the float64 one, on the
# fixed iterations before that point: the largest of MODE_HORIZONS at
# which it is finite and within MODE_DIVERGED.  Past it the two float32
# runs (kernel and plain) have each decorrelated from float64 (the
# split's rounding on the stiff rows, or a diverging iteration), and the
# float64 bar would compare two draws of the same rounding noise
MODES_CHECKED = ("mixed", "mixedk6", "high", "bf16")
MODE_HORIZONS = (1, 2, 3, 5, 10, 15, 20, 30, 40)
MODE_DIVERGED = 0.1
# the sparse QP's solver: the JAX package's sparse-path options
# (scripts/exp_precision.py) with a budget of 400 iterations in segments
# of 50 in place of its 100, which leaves part of the oval fleet
# unconverged on warm steps
SPARSE_SOLVER = dict(max_iter=400, check_every=50, eps_abs=1e-3,
                     eps_rel=1e-3, backend="pallas", factor_method="banded",
                     scaling_iters=4, pallas_tile=4,
                     pallas_precision="highest", pallas_check_inner=10,
                     bf16_bulk_iters=0)
# The hard fleets' solver options: SPARSE_SOLVER, in mode "mixedk6" for
# scripts/exp_conv.py's sparse fleet (its pallas_precision and eq_rows,
# with this budget); the precision ladder (`ladder_check`) puts
# LADDER_BULKS bf16 iterations before the mixedk6 segments, for
# LADDER_STEPS steps (50 as the ladder's users would set it, and 2, the
# count at which tests/test_torch_mpc_sparse.py holds the ladder to the
# JAX package's: on the sparse QP the bf16 iteration diverges, so 50
# leave every solve non-finite, in the plain version too)
LADDER_BULKS = (50, 2)
LADDER_STEPS = 3
HARD_SOLVER = {
    "sparse": SPARSE_SOLVER, "condensed": SPARSE_SOLVER,
    "sparse_mixedk6": dict(SPARSE_SOLVER, pallas_precision="mixedk6"),
    "decoupled_sparse": SPARSE_SOLVER}
# The hard condensed QP's fleet takes SPARSE_SOLVER as it is: its dense P
# has no banded form, so "banded" falls through to the dense Cholesky, as
# a user who sets condensed=True gets.  Its single-vehicle route
# (`simulate`) takes the default SolverOptions on backend "pallas".
SIM_CONDENSED_SOLVER = dict(backend="pallas")
# the port's kernel functions (csrc/), whose device time the profiles
# report one by one
PORT_KERNEL_FUNCTIONS = {"vanloan_kernel", "chol_inverse_kernel",
                         "admm_kernel", "rollout_kernel",
                         "expm_dense_kernel", "ruiz_kernel",
                         "banded_chol_kernel", "admm_dense_kernel",
                         "admm_wide_kernel", "admm_large_kernel"}
# the pair build's instantiations of admm_large_kernel (<MODE, true>)
PAIR_KERNEL = re.compile(r"admm_large_kernel<\d+, true>")
# The dense exponential's run-time build is swept over these d against
# its plain version (the path's d, 19 and 17, take exact builds)
EXPM_SWEEP_D = (1, 2, 7, 16, 18, 20, 32)
# cycles from one fp32 FMA to the next that depends on it (Hopper), for
# the dense exponential's latency floor
FMA_LATENCY_CYCLES = 4
# cycles from a shared-memory load to its use, taken as ~30 for Hopper,
# for the latency floor of the dense ADMM kernel's wide build at tile 1
SMEM_LATENCY_CYCLES = 30
# H100 SXM data-sheet peaks (dense): HBM bandwidth and non-tensor fp32
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# bytes an SM's shared-memory pipe moves a clock (Hopper), for the dense
# ADMM kernel's pipe floor (`pipe_floor_ms`)
SMEM_BYTES_PER_CLOCK = 128
# The Monte-Carlo path: scripts/exp_safety_ab.py's hammer_eps1.5 arm
# (the soft coupled QP on the lane solver in 12 segments of 50
# iterations, the HJI row and its override) on the finest value grid in
# the repository, its "avoidable" scenarios at B = 8192
MC_CACHE = "assets/hji_cache_mid.npz"
B_MC = 8192
# run_dynamic_obstacle's default is 200: cut to 150 when the mesh phases
# joined the run
MC_STEPS = 150
MC_CERT_STEPS = 500     # certify_avoidable's default
MC_EPS = 1.5
MC_SOLVER = dict(max_iter=600, check_every=50, eps_abs=1e-3, eps_rel=1e-3,
                 backend="lanes", scaling_iters=2, pallas_check_inner=10)
MC_SCENARIOS = dict(seed=7, oncoming_gap=(12.0, 40.0),
                    oncoming_lateral=(-1.0, 1.0))
# `reference_montecarlo`: the scenarios of least start value, stepped on
# the card and on the CPU
MC_REF_B = 8
MC_REF_STEPS = 5
# The runtime phase (`run_runtime`): periods driven in each mode; each
# mode's gated periods (by index: pre_flag 0, ux below 1 m/s, a stamp
# before the trajectory's time window); the trajectory message's header
# stamp; the other car's start gap (m), lateral offset (m) and speed
# (m/s), oncoming; the steps of each mode replayed on the CPU
RT_PERIODS = 10
RT_GATED = {"path": {3: dict(pre_flag=0), 6: dict(ux_mps=0.5)},
            "traj": {2: dict(pre_flag=0), 5: dict(ux_mps=0.5),
                     8: dict(stamp_shift=-1e3)}}
RT_STAMP = 1000.0
RT_OTHER = (7.0, 1.0, 5.0)
RT_REF_PERIODS = 3
# every period of each runtime mode launches the dense exponential this
# often (the path controller's ZOH and FOH stacks, the trajectory
# controller's stage matrix) and nothing else
RUNTIME_PERIOD_LAUNCHES = {"path": {"expm_dense": 2},
                           "traj": {"expm_dense": 1}}
# at most this share of a step's vehicles may have an HJI flag that
# differs from the CPU float64 path's within float32 interpolation noise
# of the threshold (`hji_flags`)
FLAG_NEAR_MAX = 1 / 8
# the other car in the active-row reference checks: this far ahead of
# each vehicle (m), oncoming, offset laterally by up to 1 m, at 2-8 m/s
ACTIVE_GAP = (3.0, 15.0)
# The HJI value-iteration solver (`run_hji_solve`).  (a) The proto solve
# as scripts/hji_production.py's proto phase ran it (HJI_PROD.json:
# PROTO_SHAPE, horizon 3.0 s, chunks of 50 with the horizon break, 15 Fx
# samples, cfl 0.5, local LF, margin 3.0), in float32 and float64; it
# must return HJI_PROD.json's 450 sweeps, as the JAX package does on the
# CPU (scripts/jax_hji_proto_cpu.py: 450 sweeps, t 3.1102 s).
HJI_PROTO = dict(n_sweeps=1200, sweep_chunk=50, fx_samples=15, cfl=0.5,
                 lf="local", margin=3.0, horizon_s=3.0)
HJI_PROTO_SWEEPS = 450
HJI_PROTO_ASSET = "assets/hji_cache_proto.npz"
# scripts/jax_hji_proto_cpu.py: the JAX package's float32 proto solve on
# the CPU against the asset (mean and p99 |dV|, and the largest share of
# points whose activation V <= eps differs, over AGREEMENT_EPS)
JAX_CPU_PROTO_GAP = dict(mean=4.23125926772836e-4, p99=5.090484619140634e-3,
                         disagreement=1.6491445063e-6)
# the port's float32-to-float64 gap on the card (NVIDIA H100 80GB HBM3,
# 700.00 W; PERF.md, hji-proto), the same in every recorded run: on the
# proto grid, and at the Monte-Carlo rollout's 1,638,400 relative states
# of 200 steps (one activation of them differs; 1,228,800 since the
# rollout was cut to 150 steps)
CARD_PROTO_GAP = dict(mean=8.728837373004018e-05, p99=0.00122833251953125,
                      disagreement=0.0)
CARD_STATES_GAP = dict(mean=2.605514158229127e-06, p99=3.62396240234375e-05,
                       disagreement=6.103515625e-07)
# the bars on the proto solve against the asset, on the grid and at the
# states: HJI_BAR_FACTOR times the larger of the two recorded gaps; the
# control (the proto stopped at half the horizon) must fail them.  The
# live float32-to-float64 gap is held to HJI_BAR_FACTOR times its
# recorded value (mean, p99) and its disagreement to the asset bar (a
# flip is one point), so a fault of one dtype fails it and never widens
# the bars
HJI_BAR_FACTOR = 2.0
HJI_PROTO_BARS = {k: HJI_BAR_FACTOR * max(JAX_CPU_PROTO_GAP[k],
                                          CARD_PROTO_GAP[k])
                  for k in JAX_CPU_PROTO_GAP}
HJI_CONTROL = dict(horizon_s=1.5)
# (b) the production grid at full width in its storage order, slab by
# slab, with scripts/hji_production.py's step cap, V only, for a few
# sweeps in float32 and float64: the lagged CFL step (below the cap
# there) the same in both to float32 rounding, and the float32 V within
# HJI_PROD_BARS (max, mean |dV|) of the float64 V, which the float32 run
# one sweep short must fail.  On the card (NVIDIA H100 80GB HBM3,
# 700.00 W; PERF.md, hji-production-3) the float32 V lay 8.66e-4 (max)
# and 8.56e-7 (mean) from float64 after 3 sweeps, the same in every
# recorded run, and the control 0.1306 and 9.79e-3: the bars sit 4.6x
# and 11.7x above the one and 33x and 980x below the other
HJI_PROD_SWEEPS = 3
HJI_PROD = dict(slab_chunk=1, dt_fixed=0.0022, with_grad=False,
                fx_samples=15)
HJI_PROD_BARS = (4e-3, 1e-5)
# (c) the sharded solver at world size 1 over NCCL on the smooth pursuit
# game (speed 1, margin 1) on an (n, n + 1) grid over [-8, 8]^2
HJI_SMOOTH_N = 400
HJI_SMOOTH_SWEEPS = 60

# The mesh phase (`run_mesh`, one-rank NCCL world): warm steps after the
# cold one of the data-parallel controller (fleet-8192) and of the sharded
# sparse step with the tp factor forced (fleet-sparse-2048), and the
# Monte-Carlo steps at B_MC
MESH_FLEET_WARM = 3
MESH_SPARSE_WARM = 2
MESH_MC_STEPS = 5
# the rollout scan's horizons and its operands (the decoupled fleet's d
# and w), held to the CPU float64 unroll at check_rollout's relative bar
SCAN_T = (64, 128)
SCAN_SHAPE = dict(B=8192, d=4, w=31)
ROLLOUT_REL = 1e-5
# `viz.hji_slice` on the mid cache, on the card, against the CPU float64
# slice at the same float32 points: float32 rounding alone reaches 2.9
# float32 spacings of the grid's largest |V| on the CPU (100 slices of
# either cache), so the bar is twice that, in those spacings
HJI_SLICE_ULPS = 6
HJI_SLICE_RELS = ((0.0, 0.0, 3.1, 6.0, 0.0, 5.0, 0.0),
                  (0.0, 0.0, 2.5, 4.0, 0.3, 7.0, 0.2),
                  (5.0, -1.0, -3.0, 8.0, -0.5, 3.0, -0.4))
# the profiler's whole step against the fleet phase's own warm median
# (closed loop, CUDA events): a loose bar that only catches a mis-timed
# phase
PROFILE_FULL_STEP_RATIO = (0.5, 2.0)


def require(ok, message):
    """A check that stays under `python -O`."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {message}")


_T0 = time.perf_counter()


def log(**kw):
    """One JSON line, with the seconds since the script started."""
    print(json.dumps(dict(kw, t_s=time.perf_counter() - _T0)), flush=True)


def nvidia_smi(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Fleet set-up (bench.py's _fleet on the in-repo oval)
# ---------------------------------------------------------------------------

def fleet_config(formulation: str, hz=None):
    """x1_coupled_config or x1_decoupled_config, soft, on the lane solver
    with bench.py's options, or ("sparse") x1_coupled_config() as it comes
    on the pallas solver with SPARSE_SOLVER, or ("condensed")
    x1_coupled_config(condensed=True) with the same options, or
    ("sparse_mixedk6") the sparse QP in mode "mixedk6", or
    ("decoupled_sparse") x1_decoupled_config() as it comes with
    SPARSE_SOLVER, or (WALL_FLEETS) one of the coupled ones with the wall
    rows (`use_walls`); `hz` = (N_short, N_long) overrides the horizon."""
    from pigeon_tpu_torch import mpc
    from pigeon_tpu_torch.config import SolverOptions

    if formulation in WALL_FLEETS:
        cfg = fleet_config(WALL_FLEETS[formulation], hz)
        return dataclasses.replace(cfg, coupled=dataclasses.replace(
            cfg.coupled, use_walls=True))
    if formulation == "decoupled_sparse":
        cfg = mpc.x1_decoupled_config(
            solver=SolverOptions(**HARD_SOLVER[formulation]))
    elif formulation in HARD_SOLVER:
        cfg = mpc.x1_coupled_config(
            condensed=formulation == "condensed",
            solver=SolverOptions(**HARD_SOLVER[formulation]))
    else:
        make = {"coupled": mpc.x1_coupled_config,
                "decoupled": mpc.x1_decoupled_config}[formulation]
        cfg = make(soft=True)
    if hz is not None:
        cfg = dataclasses.replace(cfg, hz=dataclasses.replace(
            cfg.hz, N_short=hz[0], N_long=hz[1]))
    if formulation in HARD_SOLVER:
        return cfg
    n_it = MAX_ITER[formulation]
    return dataclasses.replace(cfg, solver=SolverOptions(
        max_iter=n_it, check_every=n_it, eps_abs=1e-3, eps_rel=1e-3,
        backend="lanes", scaling_iters=2, pallas_check_inner=10))


def oval_tube(torch, device, dtype, cfg=None):
    """The in-repo oval, padded to 1024 knots; with the lane of
    WALL_EDGES where `cfg` has wall rows."""
    from pigeon_tpu_torch import trajectory

    cols = trajectory.oval_columns()
    if cfg is not None and cfg.formulation == "coupled" \
            and cfg.coupled.use_walls:
        cols.update({k: np.full(len(cols["t"]), v)
                     for k, v in WALL_EDGES.items()})
    return trajectory.make_tube(**cols, pad_to=1024, device=device,
                                dtype=dtype)


def make_setup(torch, B: int, device, hz=None, formulation="coupled",
               seed=0, cache=None):
    """The fleet on the in-repo oval (bench.py's placement, from `seed`).
    Without `cache` the HJI cache is the inactive one and the other car
    far away; with one, the other car comes head-on ACTIVE_GAP ahead of
    each vehicle (drawn from the same generator), so the HJI row is
    active where the cache's V <= eps."""
    from pigeon_tpu_torch import hji, mpc, trajectory

    cols = trajectory.oval_columns()
    cfg = fleet_config(formulation, hz)
    tube = oval_tube(torch, device, torch.float32, cfg)
    rng = np.random.default_rng(seed)
    k0 = rng.integers(0, 900, B)
    E = cols["E"][k0] + rng.uniform(-0.5, 0.5, B)
    N = cols["N"][k0] + rng.uniform(-0.5, 0.5, B)
    psi = cols["psi"][k0] + rng.uniform(-0.05, 0.05, B)
    f32 = dict(dtype=torch.float32, device=device)
    q0 = torch.as_tensor(np.stack([E, N, psi, np.full(B, 6.0), np.zeros(B),
                                   np.zeros(B)], axis=1), **f32)
    t0 = torch.as_tensor(cols["t"][k0], **f32)
    u0 = torch.zeros((B, 3), **f32)
    if cache is None:
        cache = hji.inactive_cache(device=device)
        oc = torch.tensor([1e4, 1e4, 0.0, 0.0], **f32).expand(B, 4)
    else:
        gap = rng.uniform(*ACTIVE_GAP, B)
        lat = rng.uniform(-1.0, 1.0, B)
        # ahead along the heading (from N), offset along the left normal,
        # the heading turned by pi and a little more: exactly antiparallel
        # headings sit on the +-pi wrap of the grid's dpsi axis, where the
        # dtype's rounding picks the side
        oc = torch.as_tensor(np.stack([
            E - gap * np.sin(psi) - lat * np.cos(psi),
            N + gap * np.cos(psi) - lat * np.sin(psi),
            psi + np.pi + rng.uniform(-0.1, 0.1, B),
            rng.uniform(2.0, 8.0, B)], axis=1), **f32)
    oc = oc.contiguous()
    carry = mpc.init_carry(cfg, B, device=device)
    return dict(cfg=cfg, tube=tube, cache=cache, carry=carry, q=q0, u=u0,
                oc=oc, t=t0)


def closed_loop_step(torch, st, step=None):
    """One 100 Hz period: MPC step, then the plant advances with the new
    command (bench.py's one_step).  `step(carry, q, u, oc, t)` -> (carry,
    u3, diag) in place of `mpc.mpc_step_batched` on the set-up's tube and
    cache."""
    from pigeon_tpu_torch import discretize as dz
    from pigeon_tpu_torch import dynamics as dyn
    from pigeon_tpu_torch import mpc

    cfg = st["cfg"]
    if step is None:
        step = lambda *a: mpc.mpc_step_batched(cfg, st["tube"], st["cache"],
                                               *a)
    carry, u3, diag = step(st["carry"], st["q"], st["u"], st["oc"], st["t"])
    ur = torch.cat([u3[:, 0:1], u3[:, 1:2] + u3[:, 2:3],
                    torch.zeros_like(u3[:, :1]).expand(-1, 4)], dim=-1)
    f = lambda q, r: dyn.vehicle_ode(cfg.veh, "bicycle", q, r[..., :2],
                                     r[..., 2:])
    st.update(carry=carry, q=dz.propagate(f, st["q"], ur, DT), u=u3,
              t=st["t"] + DT)
    return u3, diag


# ---------------------------------------------------------------------------
# Kernel checks
# ---------------------------------------------------------------------------

def capture_kernel_inputs(step, last=False):
    """Record the first call (`last`: the last call) of each kernel
    wrapper during `step()`, and the last call of `expm_dense` also as
    "expm_dense_last"."""
    from pigeon_tpu_torch import discretize as dz
    from pigeon_tpu_torch.qp import decoupled as qd
    from pigeon_tpu_torch.solver import banded as bd
    from pigeon_tpu_torch.solver import lane_admm as la
    from pigeon_tpu_torch.solver import pallas_admm as pa
    from pigeon_tpu_torch.solver import pallas_ruiz as pr

    seen = {}
    # (module, function): the name the capture is recorded under
    originals = {(dz, "vanloan"): "vanloan", (dz, "expm_dense"): "expm_dense",
                 (qd, "rollout_affine"): "rollout_affine",
                 (la, "chol_inverse"): "chol_inverse",
                 (la, "admm_iterations"): "admm_iterations",
                 (pr, "ruiz_batched"): "ruiz",
                 (bd, "chol_factor"): "banded_chol",
                 (bd, "factor_inv_banded"): "factor_inv_banded",
                 (pa, "admm_iterations"): "admm_dense"}
    functions = {key: getattr(*key) for key in originals}

    def spy(name, fn):
        def inner(*args, **kw):
            if last or name not in seen:
                seen[name] = (args, kw)
            if name == "expm_dense":
                # the sparse decoupled step's second stack (FOH)
                seen["expm_dense_last"] = (args, kw)
            return fn(*args, **kw)
        return inner

    try:
        for (mod, attr), name in originals.items():
            setattr(mod, attr, spy(name, functions[(mod, attr)]))
        step()
    finally:
        for (mod, attr), fn in functions.items():
            setattr(mod, attr, fn)
    return seen


def cloned(torch, seen):
    """`capture_kernel_inputs`' record with every tensor in it cloned (a
    later step may reuse its storage)."""
    def clone(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            return type(v)(*[clone(t) for t in v])
        if isinstance(v, (tuple, list)):
            return type(v)(clone(t) for t in v)
        if isinstance(v, dict):
            return {k: clone(t) for k, t in v.items()}
        return v
    return clone(seen)


def cuda_ms(torch, fn, reps: int, sleep: bool = True) -> float:
    """Device time of one call of `fn`, over `reps` calls back to back: a
    sleep kernel holds the stream while the host queues them, so the
    wrapper's host time (some 20-50 us a call) does not stand in for a
    kernel that takes less.  Without the sleep: the time a call when the
    host queues them as they run, the larger of host and device time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if sleep:
        # clock cycles at up to 2 GHz
        torch.cuda._sleep(int(min(1.5 * reps * host_s, 2.0) * 2e9))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_moved: float, flops: float):
    tb = bytes_moved / PEAK_BYTES_PER_S * 1e3
    tf = flops / PEAK_FP32_FLOPS * 1e3
    return (max(tb, tf), "bytes" if tb >= tf else "operations")


def admm_flops(torch, nnz, executed, check, n, it_extra, st_extra):
    """Operations of an ADMM segment as this run's data needs them, per
    instance: each executed iteration A'w and A x (2 per nonzero of the
    instance's A each, `nnz`), the K^-1 product (2 n^2) and `it_extra`
    elementwise; each check A x and A'y again and `st_extra`."""
    executed = executed.double()
    nnz = nnz.double()
    checks = (torch.ceil(executed / check) if check > 0
              else torch.ones_like(executed))
    return float((executed * (4 * nnz + 2 * n * n + it_extra)
                  + checks * (4 * nnz + st_extra)).sum())


def dense_stage_matrices(torch, P0, Cu0, cc0, rr):
    """The (B T, n+2m+1, n+2m+1) dense Van Loan stage matrices of the
    structured exponential's inputs."""
    n, m = Cu0.shape[-2:]
    dim = n + 2 * m + 1
    Md = torch.zeros((rr.numel(), dim, dim), dtype=P0.dtype,
                     device=P0.device)
    Md[:, :n, :n] = P0.reshape(-1, n, n)
    Md[:, :n, n:n + m] = Cu0.reshape(-1, n, m)
    Md[:, :n, -1] = cc0.reshape(-1, n)
    Md[:, n:n + m, n + m:n + 2 * m] = (
        rr.reshape(-1, 1, 1) * torch.eye(m, device=P0.device))
    return Md


def check_vanloan(torch, args, kw, small=None):
    """`args`: the main-path call.  `small`: the 12-stage horizon's call,
    checked without timing (None: skip it)."""
    from pigeon_tpu_torch import discretize as dz

    P0, Cu0, cc0, rr, sq, order = args
    out_k = dz.vanloan(P0, Cu0, cc0, rr, sq, order)
    out_p = dz.vanloan_plain(P0, Cu0, cc0, rr, sq, order)
    torch.cuda.synchronize()
    # both float32; only the summation order differs, so each output
    # agrees to a few float32 ulps of its largest entry, amplified by
    # the 2^4 squarings
    err, rel = 0.0, 0.0
    for k, p in zip(out_k, out_p):
        d = float((k - p).abs().max())
        err = max(err, d)
        rel = max(rel, d / max(float(p.abs().max()), 1e-30))
    require(all(bool(torch.isfinite(k).all()) for k in out_k),
            "vanloan kernel output not finite")
    require(rel <= 1e-5, f"vanloan kernel vs plain: relative error {rel}")
    zoh = rr == 0
    require(bool(zoh.any()) and bool((out_k[2][zoh] == 0).all()),
            "ZOH stages need Phi_qv == 0")
    # a ragged last block (B_RAGGED instances x T stages is no multiple of
    # a block's stages), and the 12-stage horizon's inputs; the ragged
    # call bit-equal to the same instances of the full call
    sub = [a[:B_RAGGED].contiguous() if isinstance(a, torch.Tensor) else a
           for a in args]
    for a in (sub,) + (() if small is None else (small[0],)):
        out_s = dz.vanloan(*a)
        for k, p in zip(out_s, dz.vanloan_plain(*a)):
            d = float((k - p).abs().max())
            require(d <= 1e-5 * max(float(p.abs().max()), 1e-30),
                    f"vanloan kernel at {tuple(a[0].shape)}: {d}")
        if a is sub:
            require(all(bit_equal(torch, k, f[:B_RAGGED])
                        for k, f in zip(out_s, out_k)),
                    "vanloan: the ragged call differs from the full call")

    Bn, T, n, _ = P0.shape
    m = Cu0.shape[-1]
    from pigeon_tpu_torch import _kernels
    plan = dz.vanloan_plan(n, m)
    require(tuple(_kernels.occupancy("vanloan.cu", "vanloan_plan", n, f)
                  for f in range(3)) == plan,
            f"vanloan: the kernel's block plan is not {plan}")
    Md = dense_stage_matrices(torch, P0, Cu0, cc0, rr)
    ms = cuda_ms(torch, lambda: dz.vanloan(*args), 20)
    plain = cuda_ms(torch, lambda: dz.vanloan_plain(*args), 5)
    lib = cuda_ms(torch, lambda: torch.linalg.matrix_exp(Md), 5)
    mm = lambda r, k, c: 2 * r * k * c
    flops_stage = (order * (mm(n, n, n) + 3 * 2 * n * n)
                   + 2 * mm(n, n, m) + mm(n, n, 1) + n * m
                   + sq * (2 * mm(n, n, m) + mm(n, n, 1) + mm(n, n, n)
                           + 4 * n * m + n))
    b_ms, b_by = bound(nbytes(P0, Cu0, cc0, rr, *out_k),
                       flops_stage * Bn * T)
    return dict(err=err, rel=rel, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=b_ms, bound_by=b_by,
                blocks_per_sm=_kernels.occupancy(
                    "vanloan.cu", "vanloan_blocks_per_sm", n),
                stages_per_chunk=plan[0], threads_per_block=plan[1],
                smem_bytes=plan[2],
                shapes=[list(P0.shape), list(Cu0.shape)])


def check_chol_inverse(torch, args, kw, small=None):
    from pigeon_tpu_torch.solver import lane_admm as la

    K = args[0]
    polish = kw.get("polish", args[1] if len(args) > 1 else 1)
    Xk = la.chol_inverse(K, polish)
    Xp = la.chol_inverse_plain(K, polish)
    torch.cuda.synchronize()
    n = K.shape[-1]
    eye = torch.eye(n, device=K.device)
    # the Ruiz-scaled K carries sigma = 1e-6 on its diagonal: residual
    # bar 1e-3 on K K^-1 - I, and 1e-3 of each instance's largest entry
    # against the plain version
    resid = float((K @ Xk - eye).abs().amax())
    scale = Xp.abs().amax(dim=(1, 2))
    rel = float(((Xk - Xp).abs().amax(dim=(1, 2)) / scale).max())
    sym = float(((Xk - Xk.transpose(1, 2)).abs().amax(dim=(1, 2))
                 / scale).max())
    require(resid <= 1e-3, f"chol_inverse: |K K^-1 - I| = {resid}")
    require(rel <= 1e-3, f"chol_inverse kernel vs plain: relative {rel}")
    # ragged batches (B_RAGGED instances, and one fewer, which leaves the
    # last block of 2 warps half full) and the 12-stage horizon's K
    # (n = 24), each against the plain version with the same bar; a
    # ragged call bit-equal to the same instances of the full call
    ragged = [K[:b].contiguous() for b in (B_RAGGED, B_RAGGED - 1)]
    for Ks in ragged + ([] if small is None else [small[0][0]]):
        Xs = la.chol_inverse(Ks, polish)
        Ps = la.chol_inverse_plain(Ks, polish)
        r = float(((Xs - Ps).abs().amax(dim=(1, 2))
                   / Ps.abs().amax(dim=(1, 2))).max())
        require(r <= 1e-3, f"chol_inverse at {tuple(Ks.shape)}: relative {r}")
        if any(Ks is t for t in ragged):
            require(bit_equal(torch, Xs, Xk[:Ks.shape[0]]),
                    f"chol_inverse: the call on {Ks.shape[0]} instances "
                    f"differs from the full call")
    from pigeon_tpu_torch import _kernels
    plan = la.chol_inverse_plan(n)
    require(tuple(_kernels.occupancy("chol_inverse.cu", "chol_inverse_plan",
                                     f) for f in range(2)) == plan,
            f"chol_inverse: the kernel's block plan is not {plan}")
    ms = cuda_ms(torch, lambda: la.chol_inverse(K, polish), 20)
    plain = cuda_ms(torch, lambda: la.chol_inverse_plain(K, polish), 3)
    lib = cuda_ms(torch, lambda: torch.linalg.inv(K), 10)
    # the function's least work per instance: the Cholesky factor, the
    # triangular inverse W = L^-1 and the symmetric W'W, n^3/3 each, then
    # 4 n^3 per Newton-Schulz step (two n x n products)
    Bn = K.shape[0]
    flops = Bn * (n ** 3 + polish * 4 * n ** 3)
    b_ms, b_by = bound(nbytes(K, Xk), flops)
    return dict(err=float((Xk - Xp).abs().max()), rel=rel, resid=resid,
                asym=sym, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=b_ms, bound_by=b_by,
                blocks_per_sm=_kernels.occupancy(
                    "chol_inverse.cu", "chol_inverse_blocks_per_sm"),
                instances_per_block=plan[0], smem_bytes=plan[1],
                shapes=[list(K.shape)])


def admm_errors(torch, out_k, out_p, keep=None):
    """Largest difference of each ADMM output, kernel against plain, over
    the instances in `keep` (all if None), relative to its scale: x, z, y
    and the magnitude rows 2-5 of stats to their largest entry; the
    residual rows 0 (|Ax - z|) and 1 (|Px + q + A'y|) to the magnitudes
    they are differences of (rows 2-3, rows 4-5), the scale the
    convergence test holds them to."""
    if keep is not None:
        out_k = [o[..., keep] for o in out_k]
        out_p = [o[..., keep] for o in out_p]
    (xk, zk, yk, sk), (xp, zp, yp, sp) = out_k, out_p
    if xp.numel() == 0:
        return {}

    def rel(a, b, scale):
        return float((a - b).abs().max()) / max(float(scale), 1e-30)

    errs = {name: rel(k, p, p.abs().max())
            for name, k, p in (("x", xk, xp), ("z", zk, zp), ("y", yk, yp))}
    for r in range(2, 6):
        errs[f"stats{r}"] = rel(sk[r], sp[r], sp[r].abs().max())
    errs["stats0"] = rel(sk[0], sp[0], torch.maximum(sp[2], sp[3]).max())
    errs["stats1"] = rel(sk[1], sp[1], torch.maximum(sp[4], sp[5]).max())
    return errs


def require_admm_close(errs, what):
    bad = {k: v for k, v in errs.items() if not v <= ADMM_REL}
    require(not bad, f"admm_iterations {what} kernel vs plain: {bad}")


def check_admm(torch, args, kw, small=None):
    from pigeon_tpu_torch.solver import lane_admm as la

    ops = args[:14]
    n_iters, sigma, alpha = args[14:17]
    check = kw["check"]
    eps = dict(eps_abs=kw["eps_abs"], eps_rel=kw["eps_rel"])
    # fixed-length segment of 10 iterations: x, z, y and stats rows 0-5
    # within ADMM_REL of their scales
    xk = la.admm_iterations(*ops, 10, sigma, alpha, check=0, **eps)
    xp = la.admm_iterations_plain(*ops, 10, sigma, alpha, check=0, **eps)
    torch.cuda.synchronize()
    fixed_errs = admm_errors(torch, xk, xp)
    require_admm_close(fixed_errs, "(10 fixed)")
    scale = float(xp[0].abs().max())
    err = float((xk[0] - xp[0]).abs().max())
    # the main-path call: early exit per group; executed counts must agree
    # in at least 99% of the groups, and in the groups where they agree
    # every output within ADMM_REL as above
    ok_ = la.admm_iterations(*ops, n_iters, sigma, alpha, check=check, **eps)
    op_ = la.admm_iterations_plain(*ops, n_iters, sigma, alpha, check=check,
                                   **eps)
    torch.cuda.synchronize()
    sk, sp = ok_[3], op_[3]
    G = la.GROUP
    gk = sk[6][::G]
    gp = sp[6][::G]
    agree = float((gk == gp).float().mean())
    require(agree >= 0.99, f"admm executed counts agree in {agree} of groups")
    same = (sk[6] == sp[6]).nonzero().flatten()
    exit_errs = admm_errors(torch, ok_, op_, keep=same)
    require_admm_close(exit_errs, "(early exit, agreeing groups)")
    # the ragged last group (a full group and one of B_RAGGED - 128), and
    # the run-time-n build on the 12-stage horizon's operands (n = 24)
    sub = [o[..., :B_RAGGED].contiguous() for o in ops]
    other_errs = []
    for s_ops in (sub,) + (() if small is None else (small[0][:14],)):
        other_errs.append(admm_errors(
            torch,
            la.admm_iterations(*s_ops, 10, sigma, alpha, check=0, **eps),
            la.admm_iterations_plain(*s_ops, 10, sigma, alpha, check=0,
                                     **eps)))
        require_admm_close(other_errs[-1],
                           f"(10 fixed) at {tuple(s_ops[1].shape)}")
    ek = la.admm_iterations(*sub, n_iters, sigma, alpha, check=check,
                            **eps)[3][6]
    ep = la.admm_iterations_plain(*sub, n_iters, sigma, alpha, check=check,
                                  **eps)[3][6]
    # rounding may move a group's exit by one check period, no more
    require(float((ek - ep).abs().max()) <= check
            and bool((ek[:G] == ek[0]).all() and (ek[G:] == ek[-1]).all()),
            f"admm executed counts on a ragged batch: {ek} vs {ep}")
    ragged_exec = dict(kernel=[float(ek[0]), float(ek[-1])],
                       plain=[float(ep[0]), float(ep[-1])])
    # an instance with a NaN bound (the reference's envelope row is NaN at
    # some nodes, in the JAX package too): its statistics NaN and its
    # group kept to the budget, as in the plain version
    nan_ops = [o.clone() for o in sub]
    nan_ops[4][0, 0] = float("nan")
    sk_nan, sp_nan = (fn(*nan_ops, n_iters, sigma, alpha, check=check,
                         **eps)[3][:, 0]
                      for fn in (la.admm_iterations, la.admm_iterations_plain))
    nan_instance = dict(kernel=sk_nan.tolist(), plain=sp_nan.tolist())
    require(bool(torch.isnan(sk_nan[:6]).all())
            and bool(torch.isnan(sp_nan[:6]).all())
            and float(sk_nan[6]) == float(sp_nan[6]) == n_iters,
            f"admm with a NaN bound: {nan_instance}")
    ms = cuda_ms(torch, lambda: la.admm_iterations(
        *ops, n_iters, sigma, alpha, check=check, **eps), 10)
    plain = cuda_ms(torch, lambda: la.admm_iterations_plain(
        *ops, n_iters, sigma, alpha, check=check, **eps), 2)
    n, m = ops[2].shape[0], ops[3].shape[0]
    executed = sk[6].double()
    # P x (2 n^2) is part of each check
    flops = admm_flops(torch, (ops[1] != 0).sum(dim=(0, 1)), executed, check,
                       n, 4 * n + 14 * m, 2 * n * n + 8 * m + 8 * n)
    outs = la.admm_iterations(*ops, n_iters, sigma, alpha, check=check,
                              **eps)
    b_ms, b_by = bound(nbytes(*ops, *outs), flops)
    return dict(err=err, rel=err / max(scale, 1e-30), groups_agree=agree,
                fixed_errs=fixed_errs, exit_errs=exit_errs,
                ragged_errs=other_errs[0],
                small_horizon_errs=other_errs[1] if small else None,
                ragged_exec=ragged_exec, nan_instance=nan_instance,
                iters_mean=float(executed.mean()), ms=ms, plain_ms=plain,
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                a_nonzeros_mean=float((ops[1] != 0).sum(dim=(0, 1))
                                      .double().mean()),
                max_active_clusters=la.max_active_clusters(n, m),
                smem_bytes=la.plan_smem(n, m),
                shapes=[list(ops[1].shape)])


def check_rollout(torch, args, kw, small=None):
    from pigeon_tpu_torch.qp import condensed as qc

    A, E = args
    out_k = qc.rollout_affine(A, E)
    out_p = qc.rollout_affine_unroll(A, E)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(out_k).all()), "rollout output not finite")

    def rel_err(k, p):
        # both float32, the same recursion; only the order of the d-term
        # sums differs, carried through T stages: 1e-5 of the largest entry
        return float((k - p).abs().max()) / max(float(p.abs().max()), 1e-30)

    rel = rel_err(out_k, out_p)
    require(rel <= 1e-5, f"rollout kernel vs plain: relative error {rel}")
    # a ragged last block (B_RAGGED is no multiple of the 4 instances of a
    # block), a width over one warp and the coupled model's d = 6
    g = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *sh: torch.randn(sh, generator=g, device="cuda")
    for As, Es in ((A[:B_RAGGED].contiguous(), E[:B_RAGGED].contiguous()),
                   (0.4 * rnd(B_RAGGED, 15, 6, 6), rnd(B_RAGGED, 15, 6, 70))):
        r = rel_err(qc.rollout_affine(As, Es),
                    qc.rollout_affine_unroll(As, Es))
        require(r <= 1e-5, f"rollout at {tuple(Es.shape)}: relative {r}")
    # from the scan's horizon on the wrapper takes the associative scan,
    # not the kernel (`rollout_scan_check` holds it)
    from pigeon_tpu_torch import _kernels
    long_T = qc.ROLLOUT_SCAN_MIN_T
    before = _kernels.launches()["rollout"]
    qc.rollout_affine(0.4 * rnd(2, long_T, 4, 4), rnd(2, long_T, 4, 5))
    require(_kernels.launches()["rollout"] == before,
            f"rollout_affine at T={long_T} launched the kernel")
    ms = cuda_ms(torch, lambda: qc.rollout_affine(A, E), 20)
    plain = cuda_ms(torch, lambda: qc.rollout_affine_unroll(A, E), 5)
    Bn, T, d, w = E.shape
    b_ms, b_by = bound(nbytes(A, E, out_k), 2.0 * Bn * (T - 1) * d * d * w)
    return dict(err=float((out_k - out_p).abs().max()), rel=rel, ms=ms,
                plain_ms=plain, library_ms=None, bound_ms=b_ms,
                bound_by=b_by,
                blocks_per_sm=_kernels.occupancy(
                    "rollout.cu", "rollout_blocks_per_sm", T, d),
                smem_bytes=4 * T * d * d * 4,
                shapes=[list(A.shape), list(E.shape)])


def expm_launch(torch, M, sq, order, build):
    """`csrc/expm_dense.cu`'s `build` (0: d at run time) on M, whatever
    build `expm_build` would pick."""
    from pigeon_tpu_torch import _kernels

    d = M.shape[-1]
    out = torch.empty_like(M)
    _kernels.KERNELS["expm_dense"].launch(M, out, M.numel() // (d * d), d,
                                          sq, order, build)
    return out


def expm_case(torch, M, sq, order, reps):
    """Kernel against plain and against float64 on one stack, the exact
    build (where `expm_build` picks one) bit-equal to the run-time build,
    with times, the bound, and the chain's latency floor."""
    from pigeon_tpu_torch import _kernels
    from pigeon_tpu_torch import discretize as dz

    d = M.shape[-1]
    build = dz.expm_build(d)
    out_k = dz.expm_dense(M, sq, order)
    out_p = dz.expm_fixed(M, sq, order)
    out_r = expm_launch(torch, M, sq, order, 0)
    exact = torch.linalg.matrix_exp(M.double())
    torch.cuda.synchronize()
    require(bool(torch.isfinite(out_k).all()), "expm_dense not finite")
    # the build cannot change a result: every build runs the same sums
    require(bit_equal(torch, out_r, out_k),
            f"expm_dense: the run-time build differs from build {build} "
            f"at {tuple(M.shape)}")
    scale = max(float(out_p.abs().max()), 1e-30)
    # both float32, only the summation order differs: a few ulps of the
    # largest entry, amplified by the squarings (the vanloan bar)
    rel = float((out_k - out_p).abs().max()) / scale
    require(rel <= 1e-5, f"expm_dense kernel vs plain at "
                         f"{tuple(M.shape)}: relative error {rel}")
    # against the float64 exponential: the chain's truncation at this
    # order and squarings on the long stages, plus float32 rounding
    rel64 = float((out_k.double() - exact).abs().max()) / scale
    require(rel64 <= 1e-4, f"expm_dense vs float64 at {tuple(M.shape)}: "
                           f"relative error {rel64}")
    K = M.numel() // (d * d)
    b_ms, b_by = bound(nbytes(M, out_k),
                       2.0 * d ** 3 * (order - 1 + sq) * K)
    call = lambda: dz.expm_dense(M, sq, order)
    # the chain's floor: its products' d dependent FMAs each at the
    # highest SM clock, plus a call that runs no product (load, one
    # division, store: the launch and one device-memory round trip)
    empty_ms = cuda_ms(torch, lambda: dz.expm_dense(M, 0, 1), reps[0])
    chain_ms = ((order - 1 + sq) * d * FMA_LATENCY_CYCLES
                / (float(nvidia_smi("clocks.max.sm").split()[0]) * 1e3))
    occ = {f"build_{b}": dict(
        blocks_per_sm=_kernels.occupancy("expm_dense.cu",
                                         "expm_dense_occupancy", b, d, 0),
        registers=_kernels.occupancy("expm_dense.cu",
                                     "expm_dense_occupancy", b, d, 1))
        for b in dict.fromkeys((build, 0))}
    return dict(
        err=float((out_k - out_p).abs().max()), rel=rel, rel_vs_f64=rel64,
        ms=cuda_ms(torch, call, reps[0]),
        runtime_build_ms=cuda_ms(
            torch, lambda: expm_launch(torch, M, sq, order, 0), reps[0]),
        host_ms=cuda_ms(torch, call, reps[0], sleep=False),
        plain_ms=cuda_ms(torch, lambda: dz.expm_fixed(M, sq, order),
                         reps[1]),
        library_ms=cuda_ms(torch, lambda: torch.linalg.matrix_exp(M),
                           reps[1]),
        bound_ms=b_ms, bound_by=b_by, no_product_ms=empty_ms,
        chain_fma_ms=chain_ms, latency_floor_ms=chain_ms + empty_ms,
        build=build, **occ[f"build_{build}"],
        builds=occ, shapes=[list(M.shape)])


def check_expm_dense(torch, args, kw, extra):
    """`args`: the coupled `mpc_step`'s call (15 matrices of 19 x 19), the
    entry of the kernels line.  `extra`: the decoupled `mpc_step`'s call
    and the coupled fleet's structured-exponential inputs, from which the
    stack of all its 122,880 dense stage matrices is built; and
    ("decoupled_sparse") the sparse decoupled fleet's two calls of a step,
    its ZOH stages' stack of 11 x 11 matrices and its FOH stages' of 17 x
    17 (the run-time build and the exact build 17).  Every call also runs
    the run-time build, which must give the exact build's bits; the
    run-time build is also swept over d against plain."""
    from pigeon_tpu_torch import discretize as dz

    M, sq, order = args
    r = expm_case(torch, M, sq, order, (50, 20))
    Md, sq_d, order_d = extra["decoupled"][0]
    r["decoupled_step"] = expm_case(torch, Md, sq_d, order_d, (50, 20))
    stack = dense_stage_matrices(torch, *extra["fleet_vanloan"][:4])
    r["fleet_stack"] = expm_case(torch, stack, sq, order, (10, 3))
    for name, (a, kw) in zip(("zoh", "foh"), extra["decoupled_sparse"]):
        # linearize_affine_zoh / _foh call expm_dense(M) at its defaults
        ms = (a[0], kw.get("squarings", 8), kw.get("order", 8))
        r[f"decoupled_sparse_{name}"] = expm_case(torch, *ms, (10, 3))
    require([r[f"decoupled_sparse_{k}"]["shapes"][0][1:]
             for k in ("zoh", "foh")] == [[11, 11], [17, 17]],
            "expm_dense: the sparse decoupled fleet's stacks")
    require(r["build"] == 19 and r["decoupled_step"]["build"] == 17,
            "expm_dense: the path shapes take the exact builds")
    # a ragged count, and other orders and squarings (run-time arguments)
    sub = stack[:B_RAGGED].contiguous()
    for s_, o_ in ((0, 1), (2, 3), (8, 8)):
        k, p_ = dz.expm_dense(sub, s_, o_), dz.expm_fixed(sub, s_, o_)
        e = float((k - p_).abs().max()) / max(float(p_.abs().max()), 1e-30)
        require(e <= 1e-4, f"expm_dense at squarings={s_}, order={o_}: {e}")
        require(bit_equal(torch, expm_launch(torch, sub, s_, o_, 0), k),
                f"expm_dense: the run-time build differs at squarings="
                f"{s_}, order={o_}")
    # the run-time build over d, on matrices of the path's norm
    rng = np.random.default_rng(0)
    r["d_sweep"] = {}
    for d in EXPM_SWEEP_D:
        require(dz.expm_build(d) == 0, f"d={d} takes the run-time build")
        Ms = torch.as_tensor(rng.normal(size=(B_RAGGED, d, d))
                             * (1.5 / np.sqrt(d)), dtype=torch.float32,
                             device="cuda")
        k, p_ = dz.expm_dense(Ms, sq, order), dz.expm_fixed(Ms, sq, order)
        ex = torch.linalg.matrix_exp(Ms.double())
        scale = max(float(p_.abs().max()), 1e-30)
        e = float((k - p_).abs().max()) / scale
        e64 = float((k.double() - ex).abs().max()) / scale
        require(bool(torch.isfinite(k).all()) and e <= 1e-5 and e64 <= 1e-4,
                f"expm_dense's run-time build at d={d}: relative error "
                f"{e} against plain, {e64} against float64")
        r["d_sweep"][d] = dict(rel=e, rel_vs_f64=e64)
    return r


def diff_finite(k, p):
    """(largest difference, the same relative to the largest magnitude)
    over the finite entries of `p`; the non-finite entries must be
    equal."""
    fin = p.isfinite()
    require(bool((k.isfinite() == fin).all())
            and bool((k[~fin] == p[~fin]).all()),
            "non-finite entries differ")
    if not bool(fin.any()):
        return 0.0, 0.0
    d = float((k[fin] - p[fin]).abs().max())
    return d, d / max(float(p[fin].abs().max()), 1e-30)


def bit_equal(torch, k, p) -> bool:
    return (k.dtype == p.dtype == torch.float32 and k.shape == p.shape
            and torch.equal(k.view(torch.int32), p.view(torch.int32)))


def check_ruiz(torch, args, kw, small=None):
    """`args`: the sparse fleet's (P, q, A, l, u); `small`: the 12-stage
    horizon's call."""
    from pigeon_tpu_torch import _kernels
    from pigeon_tpu_torch.solver import admm as TA
    from pigeon_tpu_torch.solver import pallas_ruiz as pr

    iters = kw.get("iters", 4)

    def both(a):
        k = pr.ruiz_batched(*a, iters=iters)
        (Pb, qb, Ab, lb, ub), D, E, c = TA.ruiz(TA.QPData(*a), iters)
        torch.cuda.synchronize()
        return k, (Pb, qb, Ab, lb, ub, D, E, c)

    out_k, out_p = both(args)
    # both float32 with the same products, maxima and square roots; only
    # the cost scaling's mean sums in another order: 1e-5 of each output's
    # scale
    diffs = [diff_finite(k, p) for k, p in zip(out_k, out_p)]
    rel = max(r for _, r in diffs)
    require(rel <= 1e-5, f"ruiz kernel vs plain: relative error {rel}")
    bits = {"path": all(bit_equal(torch, k, p) for k, p in zip(out_k, out_p))}
    others = {"ragged": [a[:B_RAGGED].contiguous() for a in args]}
    if small is not None:
        others["small_horizon"] = list(small[0])
    for name, a in others.items():
        k_, p_ = both(a)
        r = max(diff_finite(k, p)[1] for k, p in zip(k_, p_))
        require(r <= 1e-5, f"ruiz at {tuple(a[2].shape)}: relative {r}")
        bits[name] = all(bit_equal(torch, k, p) for k, p in zip(k_, p_))
    # the mean's sum, the one difference, has given the plain version's
    # bits on these inputs in every run: required bit-equal on all three
    require(all(bits.values()), f"ruiz not bit-equal to the plain: {bits}")
    ms = cuda_ms(torch, lambda: pr.ruiz_batched(*args, iters=iters), 20)
    plain = cuda_ms(torch, lambda: TA.ruiz(TA.QPData(*args), iters), 5)
    Bn, m, n = args[2].shape
    # per sweep: two passes over |A| (a product and a max per nonzero), the
    # square roots and the cost scaling; then the scaled copy
    nnz = float((args[2] != 0).sum())
    flops = (iters * (4 * nnz + Bn * (4 * (m + n) + 8 * n))
             + 2 * nnz + Bn * (6 * n + 2 * m))
    b_ms, b_by = bound(nbytes(*args, *out_k), flops)
    cluster, smem = pr.plan_smem(n, m)
    # the kernel at each cluster size whose blocks hold their rows (the
    # plan takes pr.CLUSTER, the fastest of these on an H100)
    outs = [torch.empty_like(t) for t in out_k]
    cluster_ms = {
        cl: cuda_ms(torch, lambda: _kernels.KERNELS["ruiz"].launch(
            *args, *outs, Bn, n, m, iters, cl), 20)
        for cl in range(3, pr.CLUSTER_MAX + 1)
        if pr.smem_bytes(n, m, cl) <= pr.SMEM_MAX}
    return dict(err=max(d for d, _ in diffs), rel=rel, bit_equal=bits,
                ms=ms, plain_ms=plain, library_ms=None, cluster_ms=cluster_ms,
                bound_ms=b_ms, bound_by=b_by, cluster=cluster,
                smem_bytes=smem, max_active_clusters=pr.max_active_clusters(
                    n, m), shapes=[list(args[2].shape)])


def rel_per_instance(k, ref):
    dims = tuple(range(1, ref.dim()))
    scale = ref.abs().amax(dim=dims).clamp(min=1e-30)
    return float(((k - ref).abs().amax(dim=dims) / scale).max())


def check_banded_chol(torch, args, kw, extra):
    """`args`: the sparse fleet's stage blocks (K_diag, K_sub);
    `extra["small"]`: the 12-stage horizon's call; `extra["factor"]`: the
    fleet's `factor_inv_banded` call, for |K K^-1 - I| of the whole
    factor against the dense Cholesky inverse of the same K."""
    from pigeon_tpu_torch import _kernels
    from pigeon_tpu_torch.solver import banded as bd

    def held(Kd, Ks):
        """Kernel and plain (float32), each against the float64 plain
        version: the kernel no further from it than twice the float32
        plain version (K's stiff equality rows make the float32 factor
        rounding-limited; the bar scales with that limit)."""
        Lk, Sk = bd.chol_factor(Kd, Ks)
        Lp, Sp = bd.chol_factor_plain(Kd, Ks)
        L64, S64 = bd.chol_factor_plain(Kd.double(), Ks.double())
        torch.cuda.synchronize()
        out = {}
        for name, k, p, e in (("Linv", Lk, Lp, L64), ("S", Sk, Sp, S64)):
            d_k = rel_per_instance(k.double(), e)
            d_p = rel_per_instance(p.double(), e)
            out[name] = dict(vs_plain=rel_per_instance(k, p),
                             kernel_vs_f64=d_k, plain_vs_f64=d_p)
            require(bool(torch.isfinite(k).all()), f"banded_chol {name} "
                                                   f"not finite")
            require(d_k <= 2.0 * d_p + 1e-6,
                    f"banded_chol {name} at {tuple(Kd.shape)}: {out[name]}")
        return out

    Kd, Ks = args
    # the main-path call, a ragged batch and the 12-stage horizon's call
    path_errs = held(Kd, Ks)
    errs = held(Kd[:B_RAGGED].contiguous(), Ks[:B_RAGGED].contiguous())
    small_errs = held(*extra["small"][0])
    Lp, Sp = bd.chol_factor_plain(Kd, Ks)
    Lk, Sk = bd.chol_factor(Kd, Ks)
    torch.cuda.synchronize()
    rel = max(rel_per_instance(Lk, Lp), rel_per_instance(Sk, Sp))

    # the whole factor: |K K^-1 - I| of the banded K^-1 (kernel route)
    # and of the dense Cholesky inverse of the same float32 K, both
    # measured in float64
    Pb, Ab, rho, sigma = extra["factor"][0][:4]
    plan = extra["factor"][0][4:8]
    Kinv = bd.factor_inv_banded(Pb, Ab, rho, sigma, *plan)
    K32 = (Ab.transpose(-1, -2) * rho[:, None, :]) @ Ab
    K32 = K32 + torch.diag_embed(Pb + sigma)
    n = K32.shape[-1]
    eye = torch.eye(n, device=K32.device)

    def dense_inv():
        L, info = torch.linalg.cholesky_ex(K32)
        W = torch.linalg.solve_triangular(L, eye.expand_as(K32), upper=False)
        return W.transpose(-1, -2) @ W, info

    Kinv_d, info = dense_inv()
    K64 = K32.double()
    resid = lambda X: (K64 @ X.double() - eye.double()).abs().amax(dim=(1, 2))
    r_b, r_d = resid(Kinv), resid(Kinv_d)
    ok = info == 0
    require(bool(ok.any()), "dense Cholesky failed on every instance")
    r_b_max = float(r_b.max())
    r_d_max = float(r_d[ok].max())
    require(bool(torch.isfinite(Kinv).all())
            and float(r_b[ok].max()) <= 10.0 * r_d_max + 1e-3,
            f"banded K^-1 residual {r_b_max} vs dense {r_d_max}")

    ms = cuda_ms(torch, lambda: bd.chol_factor(Kd, Ks), 20)
    plain = cuda_ms(torch, lambda: bd.chol_factor_plain(Kd, Ks), 3)
    dense_ms = cuda_ms(torch, dense_inv, 5)
    Bn, nb, bw, _ = Kd.shape
    # the padded build (any bw <= 16) on the same blocks: its padding is
    # an exact fixed point, so it must give the exact build's bits
    Lq, Sq = torch.empty_like(Kd), torch.empty_like(Kd)

    def padded():
        _kernels.KERNELS["banded_chol"].launch(Kd, Ks, Lq, Sq, Bn, nb, bw,
                                               bd.BW_MAX)

    padded()
    torch.cuda.synchronize()
    require(bit_equal(torch, Lq, Lk) and bit_equal(torch, Sq, Sk),
            "banded_chol's padded build differs from the exact one")
    padded_ms = cuda_ms(torch, padded, 20)
    # per stage: S = K_sub Linv', D = K - S S' (2 bw^3 each), the
    # Cholesky and the triangular inverse (bw^3 / 3 each)
    flops = Bn * nb * (4 * bw ** 3 + 2 * bw ** 3 / 3)
    b_ms, b_by = bound(nbytes(Kd, Ks, Lk, Sk), flops)
    per_sm = bd.chol_blocks_per_sm(bw)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return dict(err=float(max((Lk - Lp).abs().max(), (Sk - Sp).abs().max())),
                build=bd.chol_build(bw), padded_build_ms=padded_ms,
                blocks_per_sm=per_sm,
                instances_resident=per_sm * sms * bd.CHOL_PER_BLOCK,
                rel=rel, path_errs=path_errs, ragged_errs=errs,
                small_horizon_errs=small_errs,
                kkt_resid_banded=r_b_max, kkt_resid_dense_chol=r_d_max,
                dense_chol_failed=int((~ok).sum()), ms=ms, plain_ms=plain,
                library_ms=None, dense_chol_inverse_ms=dense_ms,
                bound_ms=b_ms, bound_by=b_by, shapes=[list(Kd.shape)])


def dense_admm(torch, ops, kw, n_iters, check, plain=False, dtype=None):
    """One call of the dense ADMM kernel (or its plain version, in
    `dtype` if given) on the captured operands `ops` = (Kinv, A, q, l, u,
    rho, x, z, y) with the captured options `kw` (a dense P where
    `kw["dense_P"]`; the precision mode of `kw`'s precision, bf16 and
    m_eq, "highest" where it has none)."""
    from pigeon_tpu_torch.solver import pallas_admm as pa

    sigma, alpha = kw["sigma"], kw["alpha"]
    dense_P = kw.get("dense_P", False)
    # the wrapper's defaults where the caller gave none (the unbatched
    # route passes no scalings, tolerances, check or mode)
    eps = dict(eps_abs=kw.get("eps_abs", 1e-3), eps_rel=kw.get("eps_rel",
                                                                1e-3))
    mode = dict(precision=kw.get("precision", "highest"),
                bf16=kw.get("bf16", False), m_eq=kw.get("m_eq", 0))
    if not plain:
        # the pipeline's pattern and packed A where `kw` has them; without
        # a pattern the wrapper derives the batch's
        return pa.admm_iterations(*ops, n_iters, sigma, alpha,
                                  tile=kw["tile"],
                                  scalings=kw.get("scalings"),
                                  check=check, dense_P=dense_P,
                                  pattern=kw.get("pattern"),
                                  A_packed=kw.get("A_packed"), **eps,
                                  **mode)
    q, l = ops[2], ops[3]
    # identity scalings and no P term, as the wrapper takes them
    D, E, c, Pu, qu = kw.get("scalings") or (
        torch.ones_like(q), torch.ones_like(l), torch.ones_like(q[:, 0]),
        torch.zeros_like(q), q)
    cast = (lambda t: t) if dtype is None else (lambda t: t.to(dtype))
    PuD = D[:, :, None] * Pu if dense_P else Pu * D
    name = pa.mode_of(mode["precision"], mode["bf16"], mode["m_eq"],
                      ops[1].shape[1])
    return pa.admm_iterations_plain(
        *[cast(t) for t in ops], cast(E), cast(PuD), cast(qu),
        cast(1.0 / (D * c[:, None])), n_iters, sigma, alpha, kw["tile"],
        check, **eps, mode=name,
        m_eq=mode["m_eq"] if name in pa.MIXED_MODES else 0)


def held_vs_f64(torch, out_k, out_p, out_e, what, keep=None, truth=None):
    """Kernel and float32 plain outputs, each against the float64 plain
    version, over the instances in `keep` (all if None): for x, z, y and
    stats rows 0-5 (admm_errors' scales) the kernel's error is at most
    twice the float32 plain version's plus ADMM_REL.  With `truth` (an
    output -> the float64 statistics of its own x, z, y) the statistics
    are each held against their own iterates' instead: in the split
    modes the statistics' bf16 split of y is discontinuous in y, so two
    runs' statistics differ by the split itself wherever their iterates
    differ by rounding."""
    lane = lambda o: [t.double().T for t in o]
    e_l = lane(out_e)
    errs_k = admm_errors(torch, lane(out_k), e_l, keep)
    errs_p = admm_errors(torch, lane(out_p), e_l, keep)
    if truth is not None:
        for errs, o in ((errs_k, out_k), (errs_p, out_p)):
            own = admm_errors(torch, lane(o),
                              lane(list(o[:3]) + [truth(o)]), keep)
            errs.update({k: v for k, v in own.items()
                         if k.startswith("stats")})
    vs_plain = admm_errors(torch, lane(out_k), lane(out_p), keep)
    bad = {name: (errs_k[name], errs_p[name]) for name in errs_k
           if not errs_k[name] <= 2.0 * errs_p[name] + ADMM_REL}
    require(not bad, f"admm_dense {what} vs float64: {bad}")
    return dict(vs_plain=vs_plain, kernel_vs_f64=errs_k, plain_vs_f64=errs_p)


def three_ways(torch, ops, kw, n_iters, check):
    """The kernel, the float32 plain and the float64 plain version of one
    segment on the same operands."""
    k = dense_admm(torch, ops, kw, n_iters, check)
    p = dense_admm(torch, ops, kw, n_iters, check, plain=True)
    e = dense_admm(torch, ops, kw, n_iters, check, plain=True,
                   dtype=torch.float64)
    torch.cuda.synchronize()
    return k, p, e


def held_fixed(torch, ops, kw, n_iters, what, truth=None):
    """A fixed segment (no early exit), held by `held_vs_f64`."""
    return held_vs_f64(torch, *three_ways(torch, ops, kw, n_iters, 0), what,
                       truth=truth)


def exits_consistent(torch, stats, tile, n_iters, kw, what):
    """Every instance of a tile reports the same executed count, and a
    tile that stopped early has every instance converged by its own
    statistics."""
    ex = stats[:, 6]
    B = ex.shape[0]
    full = (B // tile) * tile
    require(bool((ex[:full].view(-1, tile) == ex[:full].view(-1, tile)[:, :1])
                 .all()) and bool((ex[full:] == ex[-1]).all()),
            f"admm_dense {what}: executed counts differ within a tile")
    eps_p = kw["eps_abs"] + kw["eps_rel"] * torch.maximum(stats[:, 2],
                                                          stats[:, 3])
    amax_qu = kw["scalings"][4].abs().amax(dim=-1)
    eps_d = kw["eps_abs"] + kw["eps_rel"] * torch.maximum(
        torch.maximum(stats[:, 4], stats[:, 5]), amax_qu)
    conv = (stats[:, 0] <= eps_p) & (stats[:, 1] <= eps_d)
    early = ex < n_iters
    require(bool(conv[early].all()),
            f"admm_dense {what}: a tile stopped before converging")


def held_segment(torch, ops, kw, n_iters, check, what, some_early=True,
                 truth=None):
    """A segment with the early exit per tile, kernel against the float32
    and the float64 plain versions.  Exits at the tolerance's edge are
    rounding-determined, so a tile's executed count may differ between
    the three; the kernel must:
    - report one count per tile, and stop a tile early only when all its
      instances have converged by its own statistics;
    - differ from the float32 plain version in at most
      B8_EXITS_DIFFER_MAX of the tiles;
    - differ from the float64 plain version's counts in at most twice the
      share of tiles the float32 plain version does, plus one tile, and
      in no tile by more than the float32 plain version's largest
      difference from them plus one check period;
    - on the tiles where all three counts agree, meet `held_vs_f64`.
    Returns the outputs and a record of the shares."""
    tile = kw["tile"]
    k, p, e = three_ways(torch, ops, kw, n_iters, check)
    exits_consistent(torch, k[3], tile, n_iters, kw, what)
    ek, ep, ee = (o[3][:, 6].double() for o in (k, p, e))
    tk, tp, te = ek[::tile], ep[::tile], ee[::tile]
    n_tiles = tk.numel()
    share = lambda a, b: float((a != b).double().mean())
    most = lambda a, b: float((a - b).abs().max())
    rec = dict(tiles=n_tiles, differ_vs_plain=share(tk, tp),
               differ_vs_f64=share(tk, te),
               plain_differ_vs_f64=share(tp, te),
               max_count_diff=most(tk, tp),
               max_count_diff_vs_f64=most(tk, te),
               plain_max_count_diff_vs_f64=most(tp, te),
               mean=[float(ek.mean()), float(ep.mean()), float(ee.mean())],
               last_tile=[float(ek[-1]), float(ep[-1]), float(ee[-1])])
    require(bool((ek < n_iters).any()) or not some_early,
            f"admm_dense {what}: no tile stopped early")
    require(rec["differ_vs_plain"] <= B8_EXITS_DIFFER_MAX
            and rec["differ_vs_f64"]
            <= 2.0 * rec["plain_differ_vs_f64"] + 1.0 / n_tiles
            and rec["max_count_diff_vs_f64"]
            <= rec["plain_max_count_diff_vs_f64"] + check,
            f"admm_dense {what}: executed counts {rec}")
    same = ((ek == ep) & (ek == ee)).nonzero().flatten()
    rec["agreeing_share"] = same.numel() / ek.numel()
    rec.update(held_vs_f64(torch, k, p, e, f"{what}, agreeing tiles",
                           keep=same, truth=truth))
    return k, p, rec


def dense_p_split(torch, ops, kw, n_iters, check):
    """Where the dense-P mode's time goes on the main-path call, in its
    pattern's build, from device times of variants of it on one wave of it (the first instances, as many as the card
    holds at once, so that a variant that fits more blocks on an SM does
    not run fewer waves; same operands unless named):
    - full: the call as the path makes it (`check`-iteration checks);
    - diagonal_P: the diagonal build, P's diagonal in place of P;
    - fixed: no check, one statistics pass at the end;
    - thin_A: fixed, A replaced by one entry a row (row width 1, column
      width 2), so A x and A'w cost next to nothing;
    - load: no iteration, the call's loads and one statistics pass.
    Differences: P x at the checks (full - diagonal_P; in the wide build
    PuD read from device memory), the checks' statistics (full - fixed),
    the A products (fixed - thin_A), the rest of the iterations (thin_A -
    load)."""
    from pigeon_tpu_torch.solver import pallas_admm as pa

    tile = kw["tile"]
    pattern = kw.get("pattern") or pa.pattern_from(ops[1])
    build = pattern.build
    wave = pa.max_active_clusters(pattern, tile, True) * tile
    cut = lambda t: t[:wave].contiguous()
    ops = [cut(t) for t in ops]
    D, E, c, Pu, qu = (cut(t) for t in kw["scalings"])
    kw = dict(kw, scalings=(D, E, c, Pu, qu), pattern=pattern,
              A_packed=pa.pack(ops[1], pattern))
    diag = dict(kw, dense_P=False, scalings=(
        D, E, c, torch.diagonal(Pu, dim1=1, dim2=2).contiguous(), qu))
    B, m, n = ops[1].shape
    thin = torch.zeros_like(ops[1])
    rows = torch.arange(m, device=thin.device)
    thin[:, rows, rows % n] = 1.0
    thin_pattern = pa.pattern_from(thin).as_build(build)
    thin_ops = list(ops[:1]) + [thin] + list(ops[2:])
    thin_kw = dict(kw, pattern=thin_pattern,
                   A_packed=pa.pack(thin, thin_pattern))
    t = lambda o, k, it, ch: cuda_ms(
        torch, lambda: dense_admm(torch, o, k, it, ch), 10)
    ms = dict(full=t(ops, kw, n_iters, check),
              diagonal_P=t(ops, diag, n_iters, check),
              fixed=t(ops, kw, n_iters, 0),
              thin_A=t(thin_ops, thin_kw, n_iters, 0),
              load=t(ops, kw, 0, 0))
    return dict(build=build, wave=wave, ms=ms,
                thin_widths=[thin_pattern.row_width, thin_pattern.col_width],
                thin_max_active_clusters=pa.max_active_clusters(
                    thin_pattern, tile, True),
                P_x=ms["full"] - ms["diagonal_P"],
                statistics=ms["full"] - ms["fixed"],
                A_products=ms["fixed"] - ms["thin_A"],
                rest_of_iterations=ms["thin_A"] - ms["load"])


def a_bytes(pattern, B: int) -> int:
    """A's bytes as the bound counts them, whichever build's storage: each
    static nonzero's value once an instance (float32), and the pattern
    once: a column index a nonzero (int16) and the row starts (int32)."""
    return 4 * B * pattern.nnz + 2 * pattern.nnz + 4 * (pattern.m + 1)


def residency(torch, pattern, B, tile, dense_P, mode="highest") -> dict:
    """A build's shared bytes a block, registers, resident clusters (of a
    tile: `tile` blocks, 2 `tile` in the pair build) and waves for B
    instances."""
    from pigeon_tpu_torch.solver import pallas_admm as pa

    clusters = pa.max_active_clusters(pattern, tile, dense_P, mode)
    return dict(build=pattern.build,
                smem_bytes=pa.block_smem(pattern, dense_P, mode),
                registers=pa.registers(mode, dense_P, pattern.build),
                max_active_clusters=clusters,
                waves=-(-B // (clusters * tile)))


def pipe_floor_ms(torch, pattern, res, tile, iterations,
                  mode="highest", all_rows=False) -> float:
    """A dense ADMM segment's shared-memory pipe floor: every iteration of
    every block reads the K^-1 words it keeps in shared memory once (rows
    at the build's row stride: n in the narrow build, `kld(n)` in the
    wide and large ones, a half's columns at `pair_ld(n)` in each block
    of a pair; in the large and pair builds only the rows past each K^-1
    lane's `large_kreg(mode)` register rows, `large_stored_rows`) through
    its SM's pipe at SMEM_BYTES_PER_CLOCK, the SM's resident blocks one
    after another and the waves (`residency`) one after another, at the
    highest SM clock; `iterations` the segment's mean executed count.
    `all_rows`: count all n rows, as before the register rows were left
    out of the count."""
    from pigeon_tpu_torch.solver import pallas_admm as pa

    n = pattern.n
    ld = {"narrow": n, "pair": pa.pair_ld(n)}.get(pattern.build, pa.kld(n))
    rows = (pa.large_stored_rows(n, pa.large_kreg(mode))
            if pattern.build in pa.LARGE_FORMS and not all_rows else n)
    pairs = 2 if pattern.build == "pair" else 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm = -(-res["max_active_clusters"] * tile * pairs // sms)
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    return (res["waves"] * per_sm * iterations * 4 * rows * ld
            / SMEM_BYTES_PER_CLOCK / clock_hz * 1e3)


def b8_mode(kw, m) -> str:
    """The dense ADMM kernel's mode of a captured call's options."""
    from pigeon_tpu_torch.solver import pallas_admm as pa

    return pa.mode_of(kw.get("precision", "highest"), kw.get("bf16", False),
                      kw.get("m_eq", 0), m)


def check_admm_dense(torch, args, kw, extra):
    """`args`: a hard fleet's first segment of its cold step (Kinv, A, q,
    l, u, rho, x, z, y, n_iters, sigma, alpha), the sparse fleet's
    (diagonal P, the narrow build), the condensed fleet's
    (`kw["dense_P"]`, the wide build), the sparse fleet's in mode
    "mixedk6" (the large build) or the sparse decoupled fleet's (the large
    build, or the pair build where `kw["pattern"]` is in it);
    `extra["warm"]`: the first segment of a warm step, `extra["small"]`:
    the 12-stage horizon's call, held in the main call's build whichever
    the plan gives its widths.

    On the cold step no tile converges within the segment, so the early
    exit per tile is held on the warm step's segment too, where most
    tiles stop at a check before the segment's end.  In a split mode, and
    in the large and pair builds, the statistics are held against their
    own iterates' (`stats_of_iterates`, as `held_mode` holds them): the
    sparse decoupled QP's 155 stiff equality rows make |Ax - z| a
    cancellation that follows each run's own rounding of x (on a warm
    segment's 130-instance cut the pair's came 4.2e-4 of its scale from
    float64's against the float32 plain version's 8.2e-5, and 1.3e-5
    against 2.2e-5 on another step).  The pair build is also held
    bit-equal to the large build on the sparse coupled fleet's calls
    (`extra["large_calls"]`, `pair_vs_large`) and on its own: the cold
    and the warm segment, the warm segment's ragged cut and the warm
    segment at tile 1 (`large_vs_pair`), which both builds take."""
    from pigeon_tpu_torch.solver import pallas_admm as pa

    ops, (n_iters, sigma, alpha) = args[:9], args[9:12]
    kw = dict(kw, sigma=sigma, alpha=alpha)
    check = kw["check"]
    n, m = ops[0].shape[-1], ops[1].shape[1]
    mode = b8_mode(kw, m)
    # the pipeline passes its layout's pattern and packed A on the card
    dense_P = kw.get("dense_P", False)
    pattern = kw.get("pattern") or pa.pattern_from(
        ops[1], mode, kw.get("m_eq", 0), dense_P)
    build = pattern.build
    truth_of = ((lambda o, k: None)
                if mode == "highest" and build not in pa.LARGE_FORMS
                else (lambda o, k: stats_of_iterates(torch, o, k)))
    truth = truth_of(ops, kw)
    kw.setdefault("A_packed", pa.pack(ops[1], pattern))
    k10, p10, e10 = three_ways(torch, ops, kw, 10, 0)
    fixed = held_vs_f64(torch, k10, p10, e10, "(10 fixed)", truth=truth)
    # without a pattern the wrapper derives the union pattern of the batch
    # (one host read).  The narrow build skips only exact zeros, in the
    # same order, whichever pattern: the same bits as the layout's.  The
    # wide and large builds' order follows the pattern's lane plan, so the
    # two patterns' calls differ by rounding: each is held to float64, and
    # they to each other within the bar a kernel keeps from float64
    derived = dense_admm(torch, ops, dict(kw, pattern=None, A_packed=None),
                         10, 0)
    union = pa.pattern_from(ops[1], mode, kw.get("m_eq", 0), dense_P)
    union_errs = None
    if build != "narrow":
        union_errs = held_vs_f64(torch, derived, p10, e10,
                                 "(10 fixed, the batch's union pattern)",
                                 truth=truth)
        lane = lambda o: [t.double().T for t in o]
        vs_layout = admm_errors(torch, lane(derived), lane(k10))
        bar = fixed["plain_vs_f64"]
        # in a split mode each call's statistics are held to its own
        # iterates' above (the split of y is discontinuous in y)
        bad = {k: (v, bar[k]) for k, v in vs_layout.items()
               if not v <= 2.0 * bar[k] + ADMM_REL
               and (truth is None or not k.startswith("stats"))}
        require(not bad, f"admm_dense (10 fixed) with the batch's union "
                f"pattern vs the layout's: {bad}")
        union_errs["vs_layout"] = vs_layout
    else:
        require(all(torch.equal(a, b) for a, b in zip(derived, k10)),
                "admm_dense with the batch's union pattern vs the layout's")
    # the main-path call (its executed counts give the bound's work)
    ok_, op_, cold_exits = held_segment(torch, ops, kw, n_iters, check,
                                        "(cold segment)", some_early=False,
                                        truth=truth)
    w_args, w_kw = extra["warm"]
    w_ops, w_kw = w_args[:9], dict(w_kw, sigma=sigma, alpha=alpha)
    warm_exits = held_segment(torch, w_ops, w_kw, n_iters, check,
                              "(warm segment)",
                              truth=truth_of(w_ops, w_kw))[2]
    # the ragged last tile (B_RAGGED = 32 tiles of 4 and one of 2), and
    # the run-time n, m build on the 12-stage horizon's operands
    cut = lambda ops_, kw_: (
        [o[:B_RAGGED].contiguous() for o in ops_],
        dict(kw_, A_packed=None,
             scalings=tuple(t[:B_RAGGED].contiguous()
                            for t in kw_["scalings"])))
    r_ops, r_kw = cut(ops, kw)
    ragged = held_fixed(torch, r_ops, r_kw, 10, "(10 fixed, ragged)",
                        truth=truth_of(r_ops, r_kw))
    r_ops, r_kw = cut(w_ops, w_kw)
    ragged_exits = held_segment(torch, r_ops, r_kw, n_iters, check,
                                "(warm segment, ragged)", some_early=False,
                                truth=truth_of(r_ops, r_kw))[2]
    # the pair build at tile 1, a cluster of one pair: each instance of
    # the warm segment exits on its own
    tile1_exits = None
    if build == "pair":
        tile1_exits = held_segment(torch, w_ops, dict(w_kw, tile=1),
                                   n_iters, check, "(warm segment, tile 1)",
                                   truth=truth_of(w_ops, w_kw))[2]
    s_args, s_kw = extra["small"]
    s_pattern = (s_kw.get("pattern") or pa.pattern_from(
        s_args[1], mode, s_kw.get("m_eq", 0), dense_P))
    s_kw = dict(s_kw, sigma=s_args[10], alpha=s_args[11],
                pattern=s_pattern.as_build(build, s_pattern.m_split),
                A_packed=None)
    small_errs = held_fixed(torch, s_args[:9], s_kw, 10,
                            f"(10 fixed) at {tuple(s_args[1].shape)}",
                            truth=truth_of(s_args[:9], s_kw))
    small_errs["plan_build"] = s_pattern.build
    ms = cuda_ms(torch, lambda: dense_admm(torch, ops, kw, n_iters, check), 5)
    warm_ms = cuda_ms(torch, lambda: dense_admm(torch, w_ops, w_kw, n_iters,
                                                check), 5)
    pack_ms = cuda_ms(torch, lambda: pa.pack(ops[1], pattern), 20)
    # the pack runs once per solve, outside the kernel
    log(phase="admm_dense_pack", build=build, ms=pack_ms,
        shape=list(kw["A_packed"].shape),
        bytes=nbytes(ops[1], kw["A_packed"]))
    plain = cuda_ms(torch, lambda: dense_admm(torch, ops, kw, n_iters, check,
                                              plain=True), 2)
    executed = ok_[3][:, 6].double()
    # a check's statistics: with a dense P, P x is 2 n^2 more; a split
    # mode's terms as `mode_flops` counts them
    flops = mode_flops(torch, ops[1], kw.get("m_eq", 0), mode, executed,
                       check, n, dense_P)
    # the kernel's inputs, A as its static nonzeros (`a_bytes`)
    b_ms, b_by = bound(nbytes(ops[0], *ops[2:], *kw["scalings"], *ok_)
                       + a_bytes(pattern, ops[1].shape[0]), flops)
    res = residency(torch, pattern, ops[1].shape[0], kw["tile"], dense_P,
                    mode)
    rec = dict(err=float((ok_[0] - op_[0]).abs().max()), mode=mode,
               rel=fixed["vs_plain"]["x"], fixed_errs=fixed,
               union_errs=union_errs,
               cold_exits=cold_exits, warm_exits=warm_exits,
               ragged_errs=ragged, ragged_exits=ragged_exits,
               tile1_exits=tile1_exits, small_horizon_errs=small_errs,
               iters_mean=float(executed.mean()), ms=ms, plain_ms=plain,
               library_ms=None, bound_ms=b_ms, bound_by=b_by,
               warm_ms=warm_ms,
               warm_iters_mean=warm_exits["mean"][0], pack_ms=pack_ms,
               pattern=dict(nonzeros=pattern.nnz,
                            widths=[pattern.row_width, pattern.col_width],
                            union_nonzeros=union.nnz,
                            a_nonzeros_mean=float((ops[1] != 0).sum(
                                dim=(1, 2)).double().mean())),
               **res, pipe_floor_ms=pipe_floor_ms(
                   torch, pattern, res, kw["tile"], float(executed.mean()),
                   mode),
               pipe_floor_all_rows_ms=pipe_floor_ms(
                   torch, pattern, res, kw["tile"], float(executed.mean()),
                   mode, all_rows=True),
               dense_P=dense_P,
               shapes=[list(ops[0].shape), list(ops[1].shape)])
    if build != "narrow":
        rec["lane_warps"] = list(pattern.lane_warps)
        rec["slots"] = list(pattern.slots)
    if dense_P:
        rec["dense_p_split"] = dense_p_split(torch, ops, kw, n_iters, check)
    if build == "pair":
        rec["pair_vs_large"] = {
            name: pair_vs_large(torch, *call)
            for name, call in extra["large_calls"].items()}
        sched = [n_iters, sigma, alpha]
        r_ops, r_kw = cut(w_ops, w_kw)
        rec["large_vs_pair"] = {
            name: pair_vs_large(torch, list(o) + sched, k)
            for name, (o, k) in dict(
                cold=(ops, kw), warm=(w_ops, w_kw), ragged=(r_ops, r_kw),
                tile1=(w_ops, dict(w_kw, tile=1))).items()}
    return rec


def pair_vs_large(torch, args, kw):
    """A call the large build takes (the sparse coupled fleet's first
    segment, n = 193, or the sparse decoupled fleet's, n = 245) run in the
    large build and in its pair form on the same operands: the pair's
    blocks compute each column of xt with the large build's sums, so the
    outputs must be the same bits.  Also each build's time (3 calls), its
    residency and pipe floor."""
    from pigeon_tpu_torch.solver import pallas_admm as pa

    ops, (n_iters, sigma, alpha) = args[:9], args[9:12]
    m_split = kw.get("m_eq", 0) if b8_mode(kw, ops[1].shape[1]) in \
        pa.MIXED_MODES else 0
    outs, ms, res = {}, {}, {}
    mode = b8_mode(kw, ops[1].shape[1])
    for build in ("large", "pair"):
        pattern = kw["pattern"].as_build(build, m_split)
        kb = dict(kw, sigma=sigma, alpha=alpha, pattern=pattern,
                  A_packed=pa.pack(ops[1], pattern))
        outs[build] = dense_admm(torch, ops, kb, n_iters, kw["check"])
        ms[build] = cuda_ms(torch, lambda: dense_admm(
            torch, ops, kb, n_iters, kw["check"]), 3)
        res[build] = residency(torch, pattern, ops[1].shape[0], kb["tile"],
                               False, mode)
        iters = float(outs[build][3][:, 6].double().mean())
        res[build]["pipe_floor_ms"] = pipe_floor_ms(
            torch, pattern, res[build], kb["tile"], iters, mode)
        res[build]["pipe_floor_all_rows_ms"] = pipe_floor_ms(
            torch, pattern, res[build], kb["tile"], iters, mode,
            all_rows=True)
    same = all(torch.equal(a, b) for a, b in zip(outs["large"],
                                                 outs["pair"]))
    diffs = [float((a - b).abs().max())
             for a, b in zip(outs["large"], outs["pair"])]
    require(same, f"admm_pair differs from admm_large at "
                  f"{tuple(ops[1].shape)}: {diffs}")
    return dict(bit_equal=same, ms=ms, mode=mode, tile=kw["tile"],
                residency=res, shapes=[list(ops[1].shape)])


def wide_chain_links(pattern) -> int:
    """The wide build's dependent links an iteration: in each A product the
    longest lane run and its group tree's steps, and in the K^-1 product
    a part's run of rows and its two butterfly steps."""
    links = 0
    for desc, runs in ((pattern.row_lanes, pattern.row_runs),
                       (pattern.col_lanes, pattern.col_runs)):
        size = (desc.astype(np.int64) >> 21) & 63
        links += int((runs >> 16).max()) + int(np.ceil(np.log2(size.max())))
    return links + ((-(-pattern.n // 4)) | 1) + 2


def check_admm_dense_tile1(torch, captures):
    """The unbatched route's calls of the dense ADMM kernel (`mpc.simulate`
    on the condensed QP, backend "pallas": `solve_qp`'s segment of
    `check_every` iterations at B = 1, tile 1, no check, identity
    scalings, A packed once per solve): the first segment of the cold
    step and the last of the second step, each kernel against the float32
    and the float64 plain version (`held_fixed`) at the path's iteration
    count.  Times the first call and the wide build's latency floor: its
    dependent links an iteration (`wide_chain_links`) at
    SMEM_LATENCY_CYCLES each and the highest SM clock, plus a call that
    runs no iteration (the launch, one device-memory round trip, the
    statistics)."""
    recs = []
    for args, kw in captures:
        ops, (n_iters, sigma, alpha) = args[:9], args[9:12]
        require(kw.get("tile") == 1 and not kw.get("check")
                and kw.get("scalings") is None and ops[0].shape[0] == 1
                and kw.get("A_packed") is not None,
                f"the unbatched route's call: {sorted(kw)}")
        kw = dict(kw, sigma=sigma, alpha=alpha)
        fixed = held_fixed(torch, ops, kw, n_iters,
                           f"(tile 1, {n_iters} fixed)")
        k = dense_admm(torch, ops, kw, n_iters, 0)
        p = dense_admm(torch, ops, kw, n_iters, 0, plain=True)
        torch.cuda.synchronize()
        recs.append(dict(fixed_errs=fixed, n_iters=n_iters,
                         err=float((k[0] - p[0]).abs().max())))
    (args, kw), first = captures[0], recs[0]
    ops, n_iters = args[:9], args[9]
    kw = dict(kw, sigma=args[10], alpha=args[11])
    ms = cuda_ms(torch, lambda: dense_admm(torch, ops, kw, n_iters, 0), 20)
    plain = cuda_ms(torch, lambda: dense_admm(torch, ops, kw, n_iters, 0,
                                              plain=True), 5)
    n, m = ops[0].shape[-1], ops[1].shape[1]
    pattern = kw["pattern"]
    flops = admm_flops(torch, (ops[1] != 0).sum(dim=(1, 2)),
                       torch.full((1,), float(n_iters), device=ops[1].device),
                       0, n,
                       10 * m + 5 * n, 10 * m + 12 * n)
    b_ms, b_by = bound(nbytes(ops[0], *ops[2:], *ops[6:], torch.empty(8))
                       + a_bytes(pattern, 1), flops)
    rec = dict(err=max(r["err"] for r in recs),
               rel=first["fixed_errs"]["vs_plain"]["x"], calls=recs,
               ms=ms, plain_ms=plain, library_ms=None, bound_ms=b_ms,
               bound_by=b_by, tile=1,
               **residency(torch, pattern, 1, 1, False),
               shapes=[list(ops[0].shape), list(ops[1].shape)])
    if pattern.build == "wide":
        empty_ms = cuda_ms(torch, lambda: dense_admm(torch, ops, kw, 0, 0),
                           20)
        links = wide_chain_links(pattern)
        chain_ms = (n_iters * links * SMEM_LATENCY_CYCLES
                    / (float(nvidia_smi("clocks.max.sm").split()[0]) * 1e3))
        rec.update(chain_links=links, chain_ms=chain_ms,
                   no_iteration_ms=empty_ms,
                   latency_floor_ms=chain_ms + empty_ms)
    return rec


def tracks_f64(p, e):
    """Whether float32 outputs `p` (x, z, y first) are finite and each
    within MODE_DIVERGED of its scale from the float64 outputs `e`."""
    return all(bool(a.isfinite().all())
               and float((a.double() - b).abs().max())
               <= MODE_DIVERGED * float(b.abs().max())
               for a, b in zip(p[:3], e[:3]))


def plain_horizon(torch, ops, kw, n_iters):
    """How far the float32 plain version of `kw`'s mode stays a reference
    on these operands: the largest count in MODE_HORIZONS (up to n_iters)
    after which it `tracks_f64` (fixed iterations, chained from one count
    to the next).  Returns (count, the first count that fails or None)."""
    p, e = list(ops), [t.double() for t in ops]
    done, last = 0, 0
    for count in [c for c in MODE_HORIZONS if c <= n_iters] + [n_iters]:
        if count <= done:
            continue
        step = count - done
        p = list(p[:6]) + list(dense_admm(torch, p, kw, step, 0,
                                          plain=True)[:3])
        e = list(e[:6]) + list(dense_admm(torch, e, kw, step, 0, plain=True,
                                          dtype=torch.float64)[:3])
        done = count
        if not tracks_f64(p[6:], e[6:]):
            return last, count
        last = count
    return last, None


def stats_of_iterates(torch, ops, kw):
    """output -> the float64 statistics of its own x, z, y, through the
    mode's products of `kw` (`pallas_admm.products`, the bf16 roundings
    of the float32 iterates' splits kept)."""
    from pigeon_tpu_torch.solver import pallas_admm as pa

    d = lambda t: t.double()
    D, E, c, Pu, qu = (d(t) for t in kw["scalings"])
    m_eq = kw.get("m_eq", 0)
    mode = pa.mode_of(kw.get("precision", "highest"), kw.get("bf16", False),
                      m_eq, ops[1].shape[1])
    matA, matAT, _ = pa.products(d(ops[0]), d(ops[1]), mode,
                                 m_eq if mode in pa.MIXED_MODES else 0)
    PuD = D[:, :, None] * Pu if kw.get("dense_P", False) else Pu * D
    invDc = 1.0 / (D * c[:, None])
    return lambda o: pa._stats(matA, matAT, d(o[0]), d(o[1]), d(o[2]),
                               1.0 / E, PuD, qu, invDc, kw["eps_abs"],
                               kw["eps_rel"])[0]


def held_mode(torch, ops, kw, n_iters, check, what, some_early=False):
    """One segment in `kw`'s mode, held as the "highest" segments are
    (`held_segment`: exits per tile and the float64 bar; the statistics
    against their own iterates', `stats_of_iterates`) where the float32
    plain version `tracks_f64` over it, else on the fixed iterations
    before the point where it stops (`plain_horizon`, `held_fixed`)."""
    truth = stats_of_iterates(torch, ops, kw)
    if tracks_f64(dense_admm(torch, ops, kw, n_iters, check, plain=True),
                  dense_admm(torch, ops, kw, n_iters, check, plain=True,
                             dtype=torch.float64)):
        rec = held_segment(torch, ops, kw, n_iters, check, what,
                           some_early, truth)[2]
        return dict(rec, held="segment", iterations=n_iters)
    horizon, fails = plain_horizon(torch, ops, kw, n_iters)
    # a plain version already MODE_DIVERGED from float64 after one
    # iteration (the bf16 roundings of rhs and xt, times the stiff rows'
    # rho) is held on that one: the kernel and the float32 plain version
    # start from the same w
    horizon = max(horizon, 1)
    rec = held_fixed(torch, ops, kw, horizon,
                     f"{what}, {horizon} fixed before the plain version "
                     f"diverges", truth)
    return dict(rec, held=f"{horizon} fixed iterations: the float32 plain "
                          f"version is non-finite or more than "
                          f"{MODE_DIVERGED} of a scale from float64 "
                          f"after {fails}", iterations=horizon)


def mode_flops(torch, A, m_eq, mode, executed, check, n, dense_P):
    """`admm_flops` of a dense ADMM segment in `mode`: a split nonzero of
    A costs three FMAs a product where an unsplit one costs one (it
    counts three times), a split K^-1 three times 2 n^2, and each vector
    split or rounded for a product 6 operations an entry (w and xt, and
    rhs where K^-1 is split or rounded; x and y at each check)."""
    from pigeon_tpu_torch.solver import pallas_admm as pa

    m = A.shape[1]
    nz = A != 0
    split = torch.zeros(m, dtype=torch.bool, device=A.device)
    if mode == "high":
        split[:] = True
    elif mode in pa.MIXED_MODES:
        split[m_eq:] = True
    nnz = nz.sum(dim=(1, 2)) + 2 * nz[:, split].sum(dim=(1, 2))
    plain = mode == "highest"
    vec = 0 if plain else 6 * (n + m + (0 if mode == "mixedk6" else n))
    return admm_flops(
        torch, nnz, executed, check, n,
        10 * m + 5 * n + (4 * n * n if mode in ("mixed", "high") else 0)
        + vec,
        10 * m + 12 * n + (2 * n * n if dense_P else 0)
        + (0 if plain else 6 * (n + m)))


def check_admm_dense_modes(torch, forms):
    """The dense ADMM kernel's other modes ("mixed", "mixedk6", "high",
    "bf16") on the "highest" paths' captures, `forms` = {name: (cold
    segment, warm segment, m_eq)} for the sparse fleet (diagonal P) and
    the condensed fleet (dense P): each mode's build held on the cold
    and the warm segment and on a ragged batch (B_RAGGED instances of
    the warm one) against its float32 and float64 plain versions
    (`held_mode`), with its cold segment's time, plain time and bound
    (`mode_flops`), pipe floor, registers, shared bytes, resident clusters
    and waves in the build the pattern's widths and the mode give
    (`EllPattern.for_mode`: the sparse QP's large build, the condensed
    QP's wide)."""
    from pigeon_tpu_torch.solver import pallas_admm as pa

    out = {}
    for form, ((c_args, c_kw), (w_args, w_kw), m_eq) in forms.items():
        ops, (n_iters, sigma, alpha) = c_args[:9], c_args[9:12]
        w_ops = w_args[:9]
        dense_P = c_kw.get("dense_P", False)
        layout = c_kw.get("pattern") or pa.pattern_from(ops[1])
        n, m = ops[0].shape[-1], ops[1].shape[1]
        for mode in MODES_CHECKED:
            mkw = (dict(bf16=True) if mode == "bf16"
                   else dict(precision=mode))
            pattern = layout.for_mode(mode, m_eq, dense_P)
            kw = dict(c_kw, sigma=sigma, alpha=alpha, m_eq=m_eq, **mkw,
                      pattern=pattern, A_packed=pa.pack(ops[1], pattern))
            wkw = dict(w_kw, sigma=sigma, alpha=alpha, m_eq=m_eq, **mkw,
                       pattern=pattern, A_packed=None)
            check = kw["check"]
            what = f"{mode}, {form}"
            cold = held_mode(torch, ops, kw, n_iters, check,
                             f"{what} (cold segment)")
            warm = held_mode(torch, w_ops, wkw, n_iters, check,
                             f"{what} (warm segment)")
            cut = [o[:B_RAGGED].contiguous() for o in w_ops]
            rkw = dict(wkw, A_packed=None, scalings=tuple(
                t[:B_RAGGED].contiguous() for t in wkw["scalings"]))
            ragged = held_mode(torch, cut, rkw, n_iters, check,
                               f"{what} (warm segment, ragged)")
            k = dense_admm(torch, ops, kw, n_iters, check)
            torch.cuda.synchronize()
            ms = cuda_ms(torch, lambda: dense_admm(torch, ops, kw, n_iters,
                                                   check), 5)
            plain = cuda_ms(torch, lambda: dense_admm(
                torch, ops, kw, n_iters, check, plain=True), 2)
            flops = mode_flops(torch, ops[1], m_eq, mode, k[3][:, 6], check,
                               n, dense_P)
            b_ms, b_by = bound(nbytes(ops[0], *ops[2:], *kw["scalings"], *k)
                               + a_bytes(pattern, ops[1].shape[0]), flops)
            res = residency(torch, pattern, ops[1].shape[0], kw["tile"],
                            dense_P, mode)
            iters = float(k[3][:, 6].mean())
            rec = dict(mode=mode, form=form, dense_P=dense_P, ms=ms,
                       plain_ms=plain, library_ms=None, bound_ms=b_ms,
                       bound_by=b_by, iters_mean=iters,
                       finite=bool(torch.isfinite(k[0]).all()), **res,
                       pipe_floor_ms=pipe_floor_ms(torch, pattern, res,
                                                   kw["tile"], iters, mode),
                       pipe_floor_all_rows_ms=pipe_floor_ms(
                           torch, pattern, res, kw["tile"], iters, mode,
                           all_rows=True),
                       cold=cold, warm=warm, ragged=ragged,
                       shapes=[list(ops[0].shape), list(ops[1].shape)])
            # x's largest difference from the float32 plain version,
            # relative to its scale, on the cold segment's held part
            rec["err"] = cold["vs_plain"].get("x", 0.0)
            log(phase="kernel_check_mode", name="admm_dense", **rec)
            out[f"{mode}_{form}"] = rec
    return out


KERNEL_META = {
    "vanloan": ("pigeon_tpu_torch/csrc/vanloan.cu",
                "pigeon_tpu/discretize.py:563", check_vanloan),
    "chol_inverse": ("pigeon_tpu_torch/csrc/chol_inverse.cu",
                     "pigeon_tpu/solver/lane_admm.py:63",
                     check_chol_inverse),
    "admm_iterations": ("pigeon_tpu_torch/csrc/admm_iterations.cu",
                        "pigeon_tpu/solver/lane_admm.py:145", check_admm),
    "rollout": ("pigeon_tpu_torch/csrc/rollout.cu",
                "pigeon_tpu/qp/condensed.py:461", check_rollout),
    "expm_dense": ("pigeon_tpu_torch/csrc/expm_dense.cu",
                   "pigeon_tpu/discretize.py:341 and "
                   "pigeon_tpu/discretize.py:285", check_expm_dense),
    "ruiz": ("pigeon_tpu_torch/csrc/ruiz.cu",
             "pigeon_tpu/solver/pallas_ruiz.py:37", check_ruiz),
    "banded_chol": ("pigeon_tpu_torch/csrc/banded_chol.cu",
                    "pigeon_tpu/solver/banded.py:132", check_banded_chol),
    "admm_dense": ("pigeon_tpu_torch/csrc/admm_dense.cu",
                   "pigeon_tpu/solver/pallas_admm.py:38", check_admm_dense),
    "admm_wide": ("pigeon_tpu_torch/csrc/admm_wide.cu",
                  "pigeon_tpu/solver/pallas_admm.py:38", check_admm_dense),
    "admm_large": ("pigeon_tpu_torch/csrc/admm_large.cu",
                   "pigeon_tpu/solver/pallas_admm.py:38", check_admm_dense),
    "admm_pair": ("pigeon_tpu_torch/csrc/admm_large.cu",
                  "pigeon_tpu/solver/pallas_admm.py:38", check_admm_dense),
}


# ---------------------------------------------------------------------------

def wall_shares(torch, st, diag) -> dict:
    """A wall fleet's shares: its vehicles whose projection at the step's
    start lies outside the admissible band [edge_R + margin, edge_L -
    margin], and those whose plan after the step leans on a wall slack
    (the hard QPs' sw above 1e-3 at some stage; the soft QP's planned e
    outside the band by more than 1e-3)."""
    from pigeon_tpu_torch import mpc

    cfg = st["cfg"]
    lo = WALL_EDGES["edge_R"] + cfg.coupled.wall_margin
    hi = WALL_EDGES["edge_L"] - cfg.coupled.wall_margin
    outside = (diag.e < lo) | (diag.e > hi)
    if cfg.soft:
        plan = st["carry"].q_prev[:, 1:, 5]
        live = ((plan < lo - 1e-3) | (plan > hi + 1e-3)).any(dim=-1)
    else:
        live = (st["carry"].warm_x[:, mpc._layout(cfg).sw] > 1e-3).any(
            dim=-1)
    return dict(outside_band=float(outside.float().mean()),
                wall_slack_live=float(live.float().mean()))


def run_fleet(torch, B: int, steps: int, kernels, formulation="coupled"):
    """One cold and `steps` warm steps; every step must launch each kernel
    of its path (PATH_KERNELS) and no other.  A wall fleet's cold step
    records `wall_shares`, each of which must be above zero.  Returns
    per-step records and the final state."""
    st = make_setup(torch, B, "cuda", formulation=formulation)
    expect = PATH_KERNELS[formulation]
    recs = []
    for i in range(steps + 1):
        before = kernels.launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        u3, diag = closed_loop_step(torch, st)
        end.record()
        end.synchronize()
        after = kernels.launches()
        grew = {k: after[k] - before[k] for k in after}
        require(all((v > 0) == (k in expect) for k, v in grew.items()),
                f"step {i}: launches {grew}, expected exactly {expect}")
        require(u3.device.type == "cuda"
                and diag.converged.device.type == "cuda"
                and st["carry"].warm_x.device.type == "cuda",
                f"step {i}: an output left the card")
        require(bool(torch.isfinite(u3).all()), f"step {i}: non-finite")
        recs.append(dict(step=i, ms=start.elapsed_time(end),
                         conv=float(diag.converged.float().mean()),
                         iters=float(diag.iterations.float().mean()),
                         launches={k: v for k, v in grew.items() if v}))
        if i == 0 and formulation in WALL_FLEETS:
            recs[0].update(wall_shares(torch, st, diag))
            require(recs[0]["outside_band"] > 0.0
                    and recs[0]["wall_slack_live"] > 0.0,
                    f"{formulation}: no wall binds on the cold step "
                    f"{recs[0]}")
    return recs, st


def run_expm_split(torch, kernels):
    """One cold step of the sparse wall fleet (B_SPARSE) with lin_method
    "expm_split": each hold order's own exponential on the dense expm
    kernel, a (B 5, 13, 13) stack for the ZOH stages and a (B 10, 19, 19)
    one for the FOH stages, in place of the structured one.  Its QP is
    held against the "expm" QP of the same state, each field within
    EXPM_SPLIT_QP_REL of that field's scale; the step must launch the
    kernels of PATH_KERNELS["sparse_walls_expm_split"] (expm_dense twice)
    and no other, B8 in its narrow build.  Returns the record (with the
    step's launches and B8 builds) and the step's two expm_dense calls,
    ZOH then FOH."""
    from pigeon_tpu_torch import mpc

    st = make_setup(torch, B_SPARSE, "cuda", formulation="sparse_walls")
    split = dataclasses.replace(st["cfg"], lin_method="expm_split")
    qp = {cfg.lin_method: mpc._pre_solve(
        cfg, st["tube"], st["cache"], st["carry"], st["q"], st["u"],
        st["oc"], st["t"])[0] for cfg in (st["cfg"], split)}
    rel = {}
    for field in qp["expm"]._fields:
        a, b = getattr(qp["expm"], field), getattr(qp["expm_split"], field)
        finite = torch.isfinite(a)
        require(torch.equal(finite, torch.isfinite(b)),
                f"expm_split: the QPs' infinite bounds differ ({field})")
        rel[field] = float((a[finite] - b[finite]).abs().max()
                           / a[finite].abs().max().clamp(min=1e-30))
    require(max(rel.values()) <= EXPM_SPLIT_QP_REL,
            f"expm_split: QP against expm {rel}")
    del qp
    st["cfg"] = split
    kernels.reset_launches()
    out = {}
    calls = capture_kernel_inputs(
        lambda: out.update(diag=closed_loop_step(torch, st)[1]))
    torch.cuda.synchronize()
    counts = kernels.launches()
    launched = {k: v for k, v in counts.items() if v}
    b8 = {k: kernels.launches_by(k) for k in B8_KERNELS}
    require(set(launched) == PATH_KERNELS["sparse_walls_expm_split"]
            and launched["expm_dense"] == 2
            and b8 == b8_builds("admm_dense", "highest",
                                launched["admm_dense"]),
            f"expm_split step launches {launched}, builds {b8}")
    zoh, foh = calls["expm_dense"], calls["expm_dense_last"]
    require(zoh[0][0].shape == (B_SPARSE * 5, 13, 13)
            and foh[0][0].shape == (B_SPARSE * 10, 19, 19),
            "expm_split: the stacks' shapes")
    return dict(batch=B_SPARSE, qp_rel=rel, qp_rel_bar=EXPM_SPLIT_QP_REL,
                converged=float(out["diag"].converged.float().mean()),
                launches=counts, b8_builds=b8), (zoh, foh)


def plain_b8(torch, *args, pattern=None, A_packed=None, dtype=None, **kw):
    """`pallas_admm.admm_iterations` as its plain version computes it, on
    the tensors' own device (the card's here): the same arguments, the
    pattern and packed A unused; in `dtype` if given, the iterates and
    statistics then rounded back to the arguments' dtype."""
    n_iters, sigma, alpha = args[9:12]
    opts = dict(kw, sigma=sigma, alpha=alpha, tile=kw.get("tile", 1))
    out = dense_admm(torch, args[:9], opts, n_iters, kw.get("check", 0),
                     plain=True, dtype=dtype)
    return tuple(t.to(args[2].dtype) for t in out)


def lane_plain_in(torch, dtype):
    """`lane_admm.admm_iterations_plain` in `dtype`, its iterates and
    statistics rounded back to the arguments' dtype."""
    from pigeon_tpu_torch.solver import lane_admm as la

    def run(*args, **kw):
        up = lambda t: (t.to(dtype) if torch.is_tensor(t)
                        and t.is_floating_point() else t)
        out = la.admm_iterations_plain(*[up(a) for a in args], **kw)
        return tuple(t.to(args[2].dtype) for t in out)
    return run


def verified_convergence(torch, qp, sol, opts):
    """A batched solve's reported converged share, and the share whose
    report the float64 residuals of the returned solution confirm: the
    OSQP residuals |A x - z| and |P x + q + A'y| and their tolerances
    recomputed from the QP as the solver's statistics define them,
    within CONV_VERIFY_MARGIN of the tolerance; and the largest ratio of
    residual to tolerance among the instances reported converged."""
    P, q, A = (t.to(torch.float64) for t in qp[:3])
    x, y, z = (t.to(torch.float64) for t in (sol.x, sol.y, sol.z))
    Ax = torch.einsum("bmn,bn->bm", A, x)
    Aty = torch.einsum("bmn,bm->bn", A, y)
    Px = torch.einsum("bij,bj->bi", P, x) if P.dim() == 3 else P * x
    amax = lambda v: v.abs().amax(dim=-1)
    eps_p = opts.eps_abs + opts.eps_rel * torch.maximum(amax(Ax), amax(z))
    eps_d = opts.eps_abs + opts.eps_rel * torch.maximum(
        torch.maximum(amax(Px), amax(Aty)), amax(q))
    ratio = torch.maximum(amax(Ax - z) / eps_p, amax(Px + q + Aty) / eps_d)
    reported = sol.converged
    verified = reported & (ratio <= 1.0 + CONV_VERIFY_MARGIN)
    share = lambda t: float(t.float().mean())
    return dict(reported=share(reported), verified=share(verified),
                worst_ratio=float(ratio[reported].max())
                if bool(reported.any()) else 0.0,
                iters=float(sol.iterations.float().mean()))


def plain_admm(torch, cfg):
    """The ADMM kernel wrapper of `cfg`'s solver (the dense one on a
    "pallas" fleet, the lane one on a "lanes" fleet): (its module, its
    plain version, that plain version in float64)."""
    from pigeon_tpu_torch.solver import lane_admm as la
    from pigeon_tpu_torch.solver import pallas_admm as pa

    if cfg.solver.backend == "lanes":
        return (la, la.admm_iterations_plain,
                lane_plain_in(torch, torch.float64))
    return (pa, lambda *a, **kw: plain_b8(torch, *a, **kw),
            lambda *a, **kw: plain_b8(torch, *a, dtype=torch.float64, **kw))


def step_with_admm(torch, st, fn=None):
    """`closed_loop_step` of `st` with the ADMM kernel wrapper replaced by
    `fn` (None: the kernel); returns (u3, diag, the batched solve's (qp,
    solution, options))."""
    from pigeon_tpu_torch import mpc

    mod = plain_admm(torch, st["cfg"])[0]
    solve, kernel = mpc.solve_qp_batched, mod.admm_iterations
    seen = {}

    def recorded(qp, warm, opts, **kw):
        sol = solve(qp, warm, opts, **kw)
        seen.update(qp=qp, sol=sol, opts=opts)
        return sol
    mpc.solve_qp_batched, mod.admm_iterations = recorded, fn or kernel
    try:
        u3, diag = closed_loop_step(torch, st)
    finally:
        mpc.solve_qp_batched, mod.admm_iterations = solve, kernel
    return u3, diag, (seen["qp"], seen["sol"], seen["opts"])


def convergence_witness(torch, st):
    """One more closed-loop step of a fleet from its state `st` (left as
    it is), three times on the card: on the path (the kernels); with its
    ADMM kernel's plain version in its place (`plain_admm`: the same QPs,
    the same scaling and factor); and with that plain version in float64
    (its arguments raised to float64 at each call, its outputs rounded
    back).  Each run's `verified_convergence` of its solve."""
    device = st["q"].device
    _, plain, plain64 = plain_admm(torch, st["cfg"])
    out = {}
    for name, fn in (("kernel", None), ("plain", plain),
                     ("plain64", plain64)):
        solve = step_with_admm(torch, copy_state(torch, st, device,
                                                 torch.float32), fn)[2]
        out[name] = verified_convergence(torch, *solve)
    return out


def cache_to(cache, device):
    """An HJI cache on another device."""
    from pigeon_tpu_torch.hji import HJICache

    return HJICache(knots=tuple(k.to(device) for k in cache.knots),
                    V=cache.V.to(device),
                    gradV=None if cache.gradV is None
                    else cache.gradV.to(device),
                    dims=cache.dims, strides=cache.strides)


def copy_state(torch, st, device, dtype, cfg=None, cache=None):
    """The same fleet state on another device / in another dtype (with
    another configuration if `cfg` is given); `cache` is the HJI cache
    there (None: the inactive cache)."""
    from pigeon_tpu_torch import hji, mpc

    conv = lambda x: x.to(device=device, dtype=dtype) \
        if x.is_floating_point() else x.to(device)
    cfg = cfg or st["cfg"]
    return dict(
        cfg=cfg,
        cache=cache if cache is not None else hji.inactive_cache(
            device=device),
        tube=oval_tube(torch, device, dtype, cfg),
        carry=mpc.MPCCarry(*[conv(x) for x in st["carry"]]),
        **{k: conv(st[k]) for k in ("q", "u", "oc", "t")})


def profile_call(torch, fn, steps: int = 1):
    """torch.profiler over `fn()`, which runs `steps` control steps:
    per step, the wall time, the device busy time (the sum of device
    events on the one stream), the device events and the largest kernels;
    and the idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    port = {}
    for name, us in by_name.items():
        fn = re.search(r"::(\w+)[<(]", name)
        if fn and fn.group(1) in PORT_KERNEL_FUNCTIONS:
            key = ("admm_pair (admm_large_kernel)" if PAIR_KERNEL.search(name)
                   else fn.group(1))
            port[key] = port.get(key, 0.0) + us / 1e3 / steps
    return dict(wall_ms=wall_us / 1e3 / steps,
                device_busy_ms=busy_us / 1e3 / steps,
                idle_share=1.0 - busy_us / wall_us,
                device_events=round(len(dev) / steps),
                port_kernels_ms=port,
                top_ms=[[name[:70], us / 1e3 / steps] for name, us in top])


def profile_step(torch, st):
    """`profile_call` over one warm closed-loop fleet step."""
    return profile_call(torch, lambda: closed_loop_step(torch, st))


def reference_verdict(torch, fleet_wide, check, card, c32, u64, exit64=(),
                      outside_from_cpu=False, inner=0, conv_slack=2,
                      card_plain=None):
    """One step of `reference_check`'s rule: `card` and `c32` are the
    (commands, diagnostics) of the card and of the CPU float32 path, `u64`
    the CPU float64 commands, `exit64` the CPU float64 commands from the
    states moved by EXIT_NOISE.  `fleet_wide` and `outside_from_cpu` as
    in REF_RULES; `inner` (REF_RULES' "segments"): the in-kernel check
    period, by which the fleet-wide iteration bar grows for each segment
    one run's batch went on with after the other's stopped; `conv_slack`:
    how far the fleet-wide converged counts may differ (REF_RULES);
    `card_plain`: the commands of the card's step with its ADMM kernel's
    float32 plain version in its place (REF_RULES' "card_plain"), a
    witness like the moved float64 states.
    Returns the record and the rules broken."""
    (ug, dg_), (u32, d32) = card, c32
    bar = torch.tensor([2e-4, 2.0, 2.0], dtype=torch.float64)
    dg = (ug.cpu().double() - u64).abs()
    gap = (u32.double() - u64).abs()
    scale = gap.amax(dim=0) if fleet_wide else gap
    outside_of = lambda d: float((d > bar).any(dim=-1).double().mean())
    extra, witness_outside = {}, [outside_of(gap)]
    if len(exit64):
        exit_gaps = [(u - u64).abs() for u in exit64]
        exit_gap = torch.stack([e.amax(dim=0) for e in exit_gaps]).amax(0)
        scale = torch.maximum(scale, exit_gap)
        witness_outside += [outside_of(e) for e in exit_gaps]
        extra = dict(exit_gap_bars=[float((e / bar).max())
                                    for e in exit_gaps],
                     exit_gap_abs=exit_gap.tolist(),
                     exit_outside_bar=witness_outside[1:])
    if card_plain is not None:
        plain_gap = (card_plain - u64).abs()
        scale = torch.maximum(scale, plain_gap.amax(dim=0) if fleet_wide
                              else plain_gap)
        witness_outside.append(outside_of(plain_gap))
        extra.update(card_plain_gap_bars=float((plain_gap / bar).max()),
                     card_plain_gap_abs=plain_gap.amax(dim=0).tolist(),
                     card_plain_outside_bar=witness_outside[-1])
    allowed = torch.minimum(bar + 2.0 * scale, REF_CAP_BARS * bar)
    it_g = dg_.iterations.cpu().double()
    it_c = d32.iterations.double()
    conv_g, conv_c = dg_.converged.cpu(), d32.converged
    rec = dict(err_bars=float((dg / bar).max()),
               err_abs=dg.amax(dim=0).tolist(),
               gap32_bars=float((gap / bar).max()),
               gap32_abs=gap.amax(dim=0).tolist(),
               max_excess=float((dg - allowed).max()),
               outside_bar=outside_of(dg), outside_bar32=witness_outside[0],
               iters_diff=int((it_g - it_c).abs().max()),
               iters_mean=[float(it_g.mean()), float(it_c.mean())],
               converged=[float(conv_g.double().mean()),
                          float(conv_c.double().mean())], **extra)
    if fleet_wide:
        # each run's segments: its slowest vehicle's count in segments
        segs = lambda it: math.ceil(float(it.max()) / check)
        rec["iters_allowed"] = check + inner * abs(segs(it_g) - segs(it_c))
        rec["conv_allowed"] = conv_slack
        same = (abs(int(conv_g.sum()) - int(conv_c.sum())) <= conv_slack
                and abs(float(it_g.mean() - it_c.mean()))
                <= rec["iters_allowed"])
    else:
        same = (bool((conv_g == conv_c).all())
                and rec["iters_diff"] <= check)
    broken = [name for name, ok in (
        ("commands", rec["max_excess"] <= 0.0),
        ("outside_bar", rec["outside_bar"] <= max(
            REF_OUTSIDE_MAX,
            2.0 * max(witness_outside) if outside_from_cpu else 0.0)),
        ("iterations", same)) if not ok]
    return rec, broken


def cpu_solve_step(torch, st):
    """`closed_loop_step` on the card with only the QP solve moved to the
    CPU's plain float32 pipeline: the card's own QP data, solved by the
    plain versions of the kernels."""
    from pigeon_tpu_torch import mpc
    from pigeon_tpu_torch.solver import admm

    def solve(qp, warm, opts, **kw):
        cpu = lambda t: t if t is None else t.cpu()
        sol = admm.solve_qp_batched(
            type(qp)(*map(cpu, qp)), type(warm)(*map(cpu, warm)), opts,
            **{k: cpu(v) if isinstance(v, torch.Tensor) else v
               for k, v in kw.items()})
        return type(sol)(*[t.to(qp.q.device) for t in sol])

    original = mpc.solve_qp_batched
    mpc.solve_qp_batched = solve
    try:
        return closed_loop_step(torch, st)
    finally:
        mpc.solve_qp_batched = original


def moved_state(torch, st, gen, cache=None):
    """The fleet state on the CPU in float64, moved by EXIT_NOISE
    (relative, uniform, from `gen`)."""
    c = copy_state(torch, st, "cpu", torch.float64, cache=cache)
    c["q"] = c["q"] * (1.0 + EXIT_NOISE * (
        2.0 * torch.rand(c["q"].shape, generator=gen, dtype=torch.float64)
        - 1.0))
    return c


def hji_flags(torch, eps, dg, d32, d64):
    """The card's HJI flags (diagnostics `dg`) against the CPU float64
    path's (`d64`).  Both packages interpolate V in float32 whatever the
    state's dtype, so a flag may differ where V lies at eps within that
    rounding: where |V64 - eps| <= 2 |V32 - V64|, V32 the CPU float32
    path's value.  Such vehicles, at most FLAG_NEAR_MAX of the batch,
    are left out of the command rule; a flag that differs elsewhere fails.
    Returns (the mask of the vehicles kept, a record)."""
    fg, f64 = dg.hji_active.cpu(), d64.hji_active
    V64, V32 = d64.V_hji.double(), d32.V_hji.double()
    differ = fg != f64
    near = (V64 - eps).abs() <= 2.0 * (V32 - V64).abs()
    rec = dict(active_card=int(fg.sum()), active_cpu64=int(f64.sum()),
               flags_near_eps=int((differ & near).sum()))
    require(not bool((differ & ~near).any()),
            f"HJI flags of the card and the CPU differ away from eps: {rec}")
    require(rec["flags_near_eps"] <= FLAG_NEAR_MAX * fg.numel(),
            f"too many HJI flags differ near eps: {rec}")
    return ~differ, rec


def take(pair, keep):
    """(commands, diagnostics) of the vehicles in the CPU mask `keep`."""
    u, d = pair
    k = lambda x: x[keep.to(x.device)]
    return k(u), type(d)(*[k(x) for x in d])


def reference_check(torch, formulation="coupled", device="cuda",
                    cache=None):
    """A B_REF-vehicle fleet stepped on the card; each step is also run on
    the CPU (plain versions) from the card's state, at float64 (the path
    the CPU tests hold against the JAX package) and at float32.

    At the solver's eps of 1e-3 some commands are weakly determined:
    float32 rounding of the QP data alone moves them by many times the
    test_soft.py bar (2e-4 rad, 2 N).  `gap32_bars` prints that CPU
    float32-to-float64 gap per step, in bars.  Per step, the card must
    meet all of (`reference_verdict`):
    - every command within the bar plus twice that vehicle's CPU gap of
      the float64 command, and never more than REF_CAP_BARS bars from it;
    - at most REF_OUTSIDE_MAX of the vehicles outside the bare bar;
    - converged flags equal to the CPU float32 path's and executed
      iterations within one check period of them (the bar
      tests/test_torch_mpc.py and tests/test_torch_mpc_decoupled.py hold
      the port to against the JAX package).

    The hard QPs' stiff equality rows (rho_eq = 1e3 rho) make their
    float32 solve rounding-determined: the card and the CPU float32 path
    are two independent roundings, each its own distance from float64, so
    a vehicle's CPU gap does not bound that vehicle's card error, and
    exits at the tolerance's edge move by segments
    (tests/test_torch_mpc_sparse.py finds the same between the JAX
    package's float32 pipeline and the port's).  REF_RULES says how each
    formulation's rule departs from the above: the fleet-wide gap and
    iteration shares, the float64 exit-noise witnesses, the share outside
    the bar scaled by the CPU witnesses', and the placements.  On the
    first placement a fleet-wide rule must reject the REF_CONTROLS so
    marked.  Two records test the rule itself and gate nothing: whether
    the per-vehicle rule would hold too (`per_vehicle_rule_broken`), and
    the card's own QPs solved on the CPU in float32 (`cpu_solve_step`):
    their gap to float64 (`card_qp_gap_bars`) against the card's, and the
    card's distance from them (`card_vs_card_qp_bars`).

    With `cache` (an HJI cache on `device`), the active-row check: the
    other car comes head-on ACTIVE_GAP ahead of each vehicle
    (`make_setup`), on the first placement only and without controls;
    the CPU paths step with the same cache, and a vehicle whose HJI flag
    differs from the CPU float64 path's is left out of the rule where
    `hji_flags` allows it."""
    rule = REF_RULES[formulation]
    fleet_wide = rule["fleet_wide"]
    active = cache is not None
    outside = (rule["outside_from_cpu"] == "always"
               or (active and rule["outside_from_cpu"] == "active"))
    cpu_cache = cache_to(cache, "cpu") if active else None
    bar = torch.tensor([2e-4, 2.0, 2.0], dtype=torch.float64)
    seeds = []
    for seed in rule["seeds"][:1 if active else None]:
        gpu = make_setup(torch, B_REF, device, formulation=formulation,
                         seed=seed, cache=cache)
        if active and not fleet_wide:
            # bench.py's single 150-iteration segment leaves the active
            # rows' QPs unconverged: the Monte-Carlo path's solver
            gpu["cfg"] = dataclasses.replace(
                gpu["cfg"], solver=montecarlo_config().solver)
        solver = gpu["cfg"].solver
        check = (solver.check_every if fleet_wide or solver.max_iter
                 > solver.check_every else solver.pallas_check_inner)
        controls = {
            name: dataclasses.replace(gpu["cfg"], solver=dataclasses.replace(
                solver, **change))
            for name, (change, _) in REF_CONTROLS.items()
            if fleet_wide and not active and seed == rule["seeds"][0]}
        rejected = {name: [] for name in controls}
        same_bits = dict.fromkeys(controls, True)
        gen = torch.Generator().manual_seed(seed)
        steps = []
        for i in range(3):
            c32 = copy_state(torch, gpu, "cpu", torch.float32,
                             cache=cpu_cache)
            c64 = copy_state(torch, gpu, "cpu", torch.float64,
                             cache=cpu_cache)
            moved = [moved_state(torch, gpu, gen, cpu_cache)
                     for _ in range(rule["exit_draws"])]
            ctl = {name: copy_state(torch, gpu, device, torch.float32, cfg)
                   for name, cfg in controls.items()}
            on_cpu = (copy_state(torch, gpu, device, torch.float32,
                                 cache=cache) if fleet_wide else None)
            plain_st = (copy_state(torch, gpu, device, torch.float32,
                                   cache=cache)
                        if rule.get("card_plain") else None)
            card = closed_loop_step(torch, gpu)
            u_cp = (None if plain_st is None else step_with_admm(
                torch, plain_st, plain_admm(torch, gpu["cfg"])[1])[0]
                .cpu().double())
            cpu32 = closed_loop_step(torch, c32)
            u64, d64 = closed_loop_step(torch, c64)
            exit64 = [closed_loop_step(torch, st)[0] for st in moved]
            conv_slack = rule.get("conv_slack", 2)
            u_cq = (None if on_cpu is None
                    else cpu_solve_step(torch, on_cpu)[0].cpu().double())
            flags, ug = {}, card[0]
            if active:
                keep, flags = hji_flags(torch, gpu["cfg"].hji_eps, card[1],
                                        cpu32[1], d64)
                require(i > 0 or flags["active_cpu64"] > 0,
                        f"no active HJI row ({formulation}): {flags}")
                card, cpu32, u64 = (take(card, keep), take(cpu32, keep),
                                    u64[keep])
                exit64 = [u[keep] for u in exit64]
                u_cq = None if u_cq is None else u_cq[keep]
                u_cp = None if u_cp is None else u_cp[keep]
            inner = solver.pallas_check_inner if rule.get("segments") else 0
            rec, broken = reference_verdict(torch, fleet_wide, check, card,
                                            cpu32, u64, exit64, outside,
                                            inner, conv_slack, u_cp)
            rec.update(flags)
            if fleet_wide:
                rec["per_vehicle_rule_broken"] = reference_verdict(
                    torch, False, check, card, cpu32, u64)[1]
            if u_cq is not None:
                rec.update(
                    card_qp_gap_bars=float(((u_cq - u64).abs() / bar).max()),
                    card_qp_gap_abs=(u_cq - u64).abs().amax(dim=0).tolist(),
                    card_vs_card_qp_bars=float(
                        ((card[0].cpu().double() - u_cq).abs() / bar).max()))
            require(not broken, f"card vs CPU ({formulation}, seed {seed}, "
                                f"step {i}): {broken} {rec}")
            for name, st in ctl.items():
                u_c, d_c = closed_loop_step(torch, st)
                same_bits[name] &= bool(torch.equal(u_c, ug))
                crec, cbroken = reference_verdict(
                    torch, fleet_wide, check, (u_c, d_c), cpu32, u64, exit64,
                    outside, inner, conv_slack, u_cp)
                rec[f"control_{name}"] = dict(
                    broken=cbroken, err_bars=crec["err_bars"],
                    max_excess=crec["max_excess"],
                    iters_mean=crec["iters_mean"][0],
                    converged=crec["converged"][0])
                if cbroken:
                    rejected[name].append(i)
            steps.append(dict(step=i, **rec))
        for name, at in rejected.items():
            require(at or not REF_CONTROLS[name][1] or same_bits[name],
                    f"the {formulation} reference rule took control {name}")
        seeds.append(dict(seed=seed, steps=steps, controls_rejected=rejected,
                          controls_same_bits=same_bits))
    return dict(rule=rule, seeds=seeds)


def ladder_check(torch, kernels, bulk, device="cuda", seed=0,
                 b8="admm_large"):
    """The precision ladder on the sparse step (`bulk` iterations in mode
    "bf16", then the "mixedk6" segments) for B_REF vehicles over
    LADDER_STEPS steps, each also run on the CPU at float32 and float64
    from the card's state and compared by REF_RULES["sparse_ladder"]
    (`reference_verdict`), on the placement `seed`.  On each card step:
    - the dense ADMM kernel runs first the bulk (bf16, `bulk` iterations,
      the bf16 instantiation of the build `b8`, the large one on the
      path), then only mixedk6 segments (its mixedk6 one), and launches
      no other build;
    - each vehicle's iterations are `bulk` plus its executed segment
      iterations;
    - its converged flag is the last segment's convergence test, whatever
      the bulk's statistics say (the bulk sets no convergence; the share
      they would have called converged is recorded);
    - the vehicles whose solve fell back (non-finite) are those of the
      CPU float64 step, within two."""
    from pigeon_tpu_torch.solver import pallas_admm as pa

    rule = REF_RULES["sparse_ladder"]
    gpu = make_setup(torch, B_REF, device, formulation="sparse_mixedk6",
                     seed=seed)
    opts = dataclasses.replace(gpu["cfg"].solver, bf16_bulk_iters=bulk)
    gpu["cfg"] = dataclasses.replace(gpu["cfg"], solver=opts)
    conv_of = lambda st, qu: (
        (st[:, 0] <= opts.eps_abs + opts.eps_rel * torch.maximum(st[:, 2],
                                                                  st[:, 3]))
        & (st[:, 1] <= opts.eps_abs + opts.eps_rel * torch.maximum(
            torch.maximum(st[:, 4], st[:, 5]), qu.abs().amax(dim=-1))))
    steps = []
    for i in range(LADDER_STEPS):
        c32 = copy_state(torch, gpu, "cpu", torch.float32)
        c64 = copy_state(torch, gpu, "cpu", torch.float64)
        calls, original = [], pa.admm_iterations

        def spy(*args, **kw):
            out = original(*args, **kw)
            calls.append((kw.get("bf16", False), kw.get("precision"),
                          args[9], out[3], kw["scalings"][4]))
            return out

        before = {k: kernels.launches_by(k) for k in B8_KERNELS}
        pa.admm_iterations = spy
        try:
            card = closed_loop_step(torch, gpu)
        finally:
            pa.admm_iterations = original
        after = {k: kernels.launches_by(k) for k in B8_KERNELS}
        grew = {(b, k): v - before[b].get(k, 0) for b in B8_KERNELS
                for k, v in after[b].items() if v != before[b].get(k, 0)}
        fb_card = gpu["carry"].nan_fallback.cpu()
        cpu32 = closed_loop_step(torch, c32)
        u64, d64 = closed_loop_step(torch, c64)
        fb64 = c64["carry"].nan_fallback
        first, segs = calls[0], calls[1:]
        require(first[0] and first[2] == bulk and segs
                and all(not c[0] and c[1] == "mixedk6"
                        and c[2] == opts.check_every for c in segs)
                and grew == {(b8, "bf16"): 1, (b8, "mixedk6"): len(segs)},
                f"ladder step {i}: calls "
                f"{[(c[0], c[1], c[2]) for c in calls]}, builds {grew}")
        executed = bulk + sum(c[3][:, 6] for c in segs)
        dg = card[1]
        require(torch.equal(dg.iterations.double(), executed.double()),
                f"ladder step {i}: iterations are not the bulk's plus the "
                f"segments'")
        last_conv = conv_of(segs[-1][3], segs[-1][4])
        require(torch.equal(dg.converged, last_conv),
                f"ladder step {i}: converged is not the last segment's")
        rec, broken = reference_verdict(
            torch, rule["fleet_wide"], opts.check_every, card, cpu32, u64,
            outside_from_cpu=rule["outside_from_cpu"] == "always",
            inner=opts.pallas_check_inner if rule["segments"] else 0)
        rec.update(
            segments=len(segs),
            bulk_would_converge=float(conv_of(first[3], first[4])
                                      .double().mean()),
            bulk_finite=float(torch.isfinite(first[3][:, :6]).all(dim=1)
                              .double().mean()),
            bulk_r_prim_median=float(first[3][:, 0].median()),
            fallback=[float(fb_card.double().mean()),
                      float(c32["carry"].nan_fallback.double().mean()),
                      float(fb64.double().mean())])
        require(not broken and int((fb_card != fb64).sum()) <= 2,
                f"ladder card vs CPU, step {i}: {broken} {rec}")
        steps.append(dict(step=i, **rec))
    return dict(bulk=bulk, batch=B_REF, seed=seed, steps=steps)


# ---------------------------------------------------------------------------
# The unbatched route: mpc.simulate
# ---------------------------------------------------------------------------

def simulate_setup(torch, formulation: str, device, dtype):
    """`mpc.simulate`'s arguments for one vehicle near the oval's start,
    with the formulation's default solver options (the soft ones, and
    "decoupled_sparse": `x1_decoupled_config()` as it comes), or
    ("condensed") the hard condensed QP on SIM_CONDENSED_SOLVER, or
    ("faithful") `parity.faithful_config` of `x1_coupled_config()` at the
    oval's stable RK4 substep count (`parity.stable_substeps`: 4)."""
    from pigeon_tpu_torch import hji, mpc, parity, trajectory
    from pigeon_tpu_torch.config import SolverOptions

    cols = trajectory.oval_columns()
    tube = trajectory.make_tube(**cols, pad_to=1024, device=device,
                                dtype=dtype)
    if formulation == "faithful":
        base = mpc.x1_coupled_config()
        cfg = parity.faithful_config(base, parity.stable_substeps(base.veh,
                                                                  tube))
    elif formulation == "condensed":
        cfg = mpc.x1_coupled_config(
            condensed=True, solver=SolverOptions(**SIM_CONDENSED_SOLVER))
    elif formulation == "decoupled_sparse":
        cfg = mpc.x1_decoupled_config()
    else:
        cfg = {"coupled": mpc.x1_coupled_config,
               "decoupled": mpc.x1_decoupled_config}[formulation](soft=True)
    q0 = torch.tensor([cols["E"][0] + 0.3, cols["N"][0] + 0.5,
                       cols["psi"][0] + 0.03, 6.0, 0.0, 0.0], dtype=dtype,
                      device=device)
    return cfg, tube, hji.inactive_cache(device=device), q0


def b8_builds(kernel: str, tag: str, count: int) -> dict:
    """`_kernels.launches_by` of both B8 builds when `count` launches all
    went to `kernel`'s build `tag`."""
    return {k: ({tag: count} if k == kernel and count else {})
            for k in B8_KERNELS}


def run_simulate(torch, kernels, formulation: str, steps: int = SIM_STEPS,
                 profile_steps: int = SIM_PROFILE_STEPS):
    """`steps` closed-loop steps of one vehicle on the card through
    `mpc.simulate`.  The route must launch expm_dense once per step (twice
    for "decoupled_sparse": its ZOH and its FOH stack; never for
    "faithful", whose RK4 linearization and plain solver launch nothing)
    and no other kernel but, for "condensed", the dense ADMM kernel's wide
    build once per solver segment (the log's iterations over
    `check_every`).  The last step must converge, but for "faithful":
    PARITY_SOLVER's eps of 1e-6 is beyond a float32 solve, which runs its
    10,000 iterations on every step (on the CPU too; float64 converges
    within 100-650).  Returns the record, the log, and torch.profiler's
    per-step reading of `profile_steps` more steps from the same start
    (None for 0)."""
    from pigeon_tpu_torch import mpc

    cfg, tube, cache, q0 = simulate_setup(torch, formulation, "cuda",
                                          torch.float32)
    if formulation != "faithful":
        # warm-up (the faithful route builds and launches no kernel)
        mpc.simulate(cfg, tube, cache, q0, n_steps=2)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    log = mpc.simulate(cfg, tube, cache, q0, n_steps=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = kernels.launches()
    expect = dict.fromkeys(launched, 0)
    expect["expm_dense"] = steps * {"decoupled_sparse": 2,
                                    "faithful": 0}.get(formulation, 1)
    builds = {k: kernels.launches_by(k) for k in B8_KERNELS}
    if formulation == "condensed":
        b8, tag = PATH_B8_BUILD["simulate_condensed"]
        expect[b8] = (int(log.diag.iterations.sum())
                      // cfg.solver.check_every)
        require(builds == b8_builds(b8, tag, expect[b8]),
                f"simulate ({formulation}): B8 builds {builds}")
    require(launched == expect,
            f"simulate ({formulation}): launches {launched}, expected "
            f"{expect}")
    require(log.q.device.type == "cuda" and log.u.device.type == "cuda",
            "simulate: the log left the card")
    require(log.q.shape == (steps, 6) and log.u.shape == (steps, 3)
            and bool(torch.isfinite(log.q).all())
            and bool(torch.isfinite(log.u).all()),
            f"simulate ({formulation}): log not finite or misshapen")
    conv = log.diag.converged
    require(bool(conv[-1]) or formulation == "faithful",
            f"simulate ({formulation}): last step did not converge")
    rec = dict(formulation=formulation, steps=steps,
               step_ms=wall / steps * 1e3,
               converged_share=float(conv.float().mean()),
               iters_mean=float(log.diag.iterations.float().mean()),
               e_last=float(log.diag.e[-1]), launches=launched,
               b8_builds=builds)
    prof = None
    if profile_steps:
        prof = profile_call(
            torch, lambda: mpc.simulate(cfg, tube, cache, q0,
                                        n_steps=profile_steps),
            profile_steps)
    return rec, log, prof


def simulate_reference_check(torch, formulation: str, log):
    """The card's `simulate` commands over the first SIM_REF_STEPS steps
    (all of a shorter log) against the same closed loop on the CPU at
    float64, by the rule of
    `reference_check`: every command within the bar (2e-4 rad, 2 N) plus
    twice the CPU float32-to-float64 gap at that step, and never more
    than REF_CAP_BARS bars away; converged flags equal to the CPU
    float32 loop's."""
    from pigeon_tpu_torch import mpc

    steps = min(SIM_REF_STEPS, log.u.shape[0])
    logs = {}
    for dtype in (torch.float64, torch.float32):
        cfg, tube, cache, q0 = simulate_setup(torch, formulation, "cpu",
                                              dtype)
        logs[dtype] = mpc.simulate(cfg, tube, cache, q0, n_steps=steps,
                                   device="cpu")
    u64 = logs[torch.float64].u
    ug = log.u[:steps].cpu().double()
    bar = torch.tensor([2e-4, 2.0, 2.0], dtype=torch.float64)
    dg = (ug - u64).abs()
    gap = (logs[torch.float32].u.double() - u64).abs()
    allowed = torch.minimum(bar + 2.0 * gap, REF_CAP_BARS * bar)
    rec = dict(formulation=formulation, steps=steps,
               err_bars=float((dg / bar).max()),
               gap32_bars=float((gap / bar).max()),
               max_excess=float((dg - allowed).max()),
               state_err=float((log.q[:steps].cpu().double()
                                - logs[torch.float64].q).abs().max()))
    require(rec["max_excess"] <= 0.0,
            f"card simulate commands vs CPU float64: {rec}")
    require(bool((log.diag.converged[:steps].cpu()
                  == logs[torch.float32].diag.converged).all()),
            f"card simulate converged flags vs CPU float32: {rec}")
    return rec


# ---------------------------------------------------------------------------
# The Monte-Carlo safety study: montecarlo.run_dynamic_obstacle
# ---------------------------------------------------------------------------

def montecarlo_config():
    """scripts/exp_safety_ab.py's hammer_eps1.5 arm: the soft coupled QP
    with the HJI row (use_hji, the default) and its override, on the lane
    solver with that script's options."""
    from pigeon_tpu_torch import mpc
    from pigeon_tpu_torch.config import SolverOptions

    return mpc.x1_coupled_config(soft=True, use_hji_policy=True,
                                 hji_eps=MC_EPS,
                                 solver=SolverOptions(**MC_SOLVER))


def run_montecarlo(torch, kernels, device="cuda"):
    """`montecarlo.run_dynamic_obstacle` on the card: B_MC scenarios of
    MC_SCENARIOS for MC_STEPS steps with the mid cache, read through
    `hji_solve.load_cache`.  The launch counters are set to 0 just before
    the run and read just after: every step must launch the kernels of
    PATH_KERNELS["montecarlo"] (vanloan once, chol_inverse once and once
    more per refactor, admm_iterations once per segment) and no other.
    The run must keep every command finite, find the filter active on
    some steps and apply the override there (the steering at its limit).
    A recording controller keeps each step's launches and, for the
    kernel checks, the inputs of the first step that refactors with an
    active row (the last chol_inverse and admm_iterations calls of that
    step).  Then `certify_avoidable` on the same scenarios, timed, and
    torch.profiler over one more step.  Returns (record, context)."""
    from pigeon_tpu_torch import hji, hji_solve
    from pigeon_tpu_torch import montecarlo as mc
    from pigeon_tpu_torch import trajectory

    t0 = time.perf_counter()
    cache = hji_solve.load_cache(MC_CACHE, device=device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    tube = trajectory.make_tube(**trajectory.oval_columns(), pad_to=1024,
                                device=device)
    cfg = montecarlo_config()
    scen = mc.sample_scenarios(tube, B_MC, **MC_SCENARIOS)
    V0, _ = hji.interpolate(cache, hji.relative_state(scen.q0, scen.other0))

    base = mc.BatchedController
    per_step, rollouts, capture = [], [], {}

    class Recording(base):
        def step(self, state, other_car=None, t=0.0):
            before = kernels.launches()
            out = []
            run = lambda: out.append(base.step(self, state, other_car, t))
            if capture:
                run()
            else:
                seen = capture_kernel_inputs(run, last=True)
            grew = {k: v - before[k] for k, v in kernels.launches().items()}
            per_step.append(grew)
            if (not capture and grew["chol_inverse"] > 1
                    and bool(out[0][1].hji_active.any())):
                capture.update(seen, step=len(per_step) - 1)
            return out[0]

        def rollout(self, *a, **kw):
            out = base.rollout(self, *a, **kw)
            rollouts.append(out)
            return out

    mc.BatchedController = Recording
    try:
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary, per = mc.run_dynamic_obstacle(cfg, tube, cache, scen,
                                               n_steps=MC_STEPS,
                                               per_scenario=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = kernels.launches()
    finally:
        mc.BatchedController = base

    expect = PATH_KERNELS["montecarlo"]
    require(all((v > 0) == (k in expect) for k, v in launched.items())
            and all(all((g[k] > 0) == (k in expect) for k in g)
                    for g in per_step)
            and launched["vanloan"] == MC_STEPS,
            f"montecarlo launches {launched}, expected exactly {expect} "
            f"on each of {MC_STEPS} steps")
    state, (q_log, u_log, oc_log, diag) = rollouts[0]
    require(all(x.device == cache.V.device
                for x in (u_log, diag.V_hji, state.carry.warm_x)),
            "montecarlo: an output left the card")
    require(summary.controls_finite, "montecarlo: a command is not finite")
    require(summary.hji_active_frac > 0.0,
            "montecarlo: the HJI filter was never active")
    act = diag.hji_active
    overridden = int(act.sum())
    require(overridden > 0 and bool(
        (u_log[..., 0][act].abs() == cfg.veh.delta_max).all()),
        f"montecarlo: {overridden} active steps, the override not applied")
    require("chol_inverse" in capture,
            "montecarlo: no step refactored with an active HJI row")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cert, best = mc.certify_avoidable(cfg.veh, scen, n_steps=MC_CERT_STEPS)
    cert_frac = float(cert.float().mean())
    cert_s = time.perf_counter() - t0
    collided = per.collided
    share = lambda m: (float(collided[m].float().mean()) if bool(m.any())
                       else None)
    fin = torch.isfinite(V0)
    V0f = V0[fin].double().cpu().numpy()
    segs = np.array([g["admm_iterations"] for g in per_step])
    facs = np.array([g["chol_inverse"] for g in per_step])
    rec = dict(
        batch=B_MC, steps=MC_STEPS, cache=MC_CACHE,
        cache_dims=list(cache.dims), cache_load_s=load_s,
        cache_mb=dict(V=cache.V.numel() * 4 / 1e6,
                      gradV=cache.gradV.numel() * 4 / 1e6),
        hji_eps=MC_EPS, scenarios=MC_SCENARIOS,
        V_start=dict(in_grid=float(fin.float().mean()),
                     at_most_eps=float((V0 <= MC_EPS).float().mean()),
                     p10_p50_p90=np.percentile(V0f, [10, 50, 90]).tolist()),
        summary=summary._asdict(),
        collision_frac_certified=share(cert),
        collision_frac_uncertified=share(~cert),
        certified_frac=cert_frac, certify_s=cert_s,
        certify_steps=MC_CERT_STEPS,
        overrides=overridden, override_share=overridden / act.numel(),
        wall_s=wall, wall_ms_step=wall / MC_STEPS * 1e3,
        segments_per_step=dict(mean=float(segs.mean()), max=int(segs.max())),
        chol_inverse_per_step=dict(mean=float(facs.mean()),
                                   max=int(facs.max()),
                                   steps_refactoring=int((facs > 1).sum())),
        iters_mean=float(diag.iterations.float().mean()),
        capture_step=capture.pop("step"), launches=launched)
    # one more step from where the rollout ended
    ctrl = base(cfg, tube, cache)
    oc, t_next = ctrl.advance_other(oc_log[-1]), scen.t0 + MC_STEPS * DT
    prof = profile_call(torch, lambda: ctrl.step(state, oc, t_next))
    return rec, dict(cfg=cfg, tube=tube, cache=cache, scen=scen, V0=V0,
                     capture=capture, profile=prof,
                     x_rel=hji.relative_state(q_log, oc_log))


def reference_montecarlo(torch, ctx):
    """The card's Monte-Carlo rollout against the CPU, by the rule of
    `reference_check`: the MC_REF_B scenarios of least start value (the
    rule fixed before any rollout), MC_REF_STEPS steps of the card's
    controller; each step is also run on the CPU from the card's state
    (the same cache copied there) at float64 and float32.  Per step:
    `hji_flags` (a vehicle whose flag differs within float32
    interpolation noise of eps is left out of the rest), then
    `reference_verdict` with executed iterations within one segment
    (twelve segments with adaptive-rho refactors move a float32 exit by
    more than one inner check), and every command the override made on
    both the card and the CPU float64 path equal to the latter's to 1e-5
    relative."""
    from pigeon_tpu_torch import montecarlo as mc
    from pigeon_tpu_torch import trajectory
    from pigeon_tpu_torch.parallel.mesh import BatchState

    cfg, scen = ctx["cfg"], ctx["scen"]
    idx = torch.argsort(ctx["V0"])[:MC_REF_B]
    sub = mc.ScenarioSet(*[t[idx] for t in scen])
    card = mc.BatchedController(cfg, ctx["tube"], ctx["cache"])
    cpu_cache = cache_to(ctx["cache"], "cpu")
    cpu = {dt: mc.BatchedController(
        cfg, trajectory.make_tube(**trajectory.oval_columns(), pad_to=1024,
                                  device="cpu", dtype=dt), cpu_cache)
        for dt in (torch.float32, torch.float64)}
    conv = lambda x, dt: (x.to(device="cpu", dtype=dt)
                          if x.is_floating_point() else x.cpu())

    def on_cpu(st, dt):
        return BatchState(carry=type(st.carry)(*[conv(x, dt)
                                                 for x in st.carry]),
                          q=conv(st.q, dt), u=conv(st.u, dt))

    state = card.init_state(sub.q0)
    oc, t = sub.other0, sub.t0
    steps = []
    for i in range(MC_REF_STEPS):
        outs = {dt: c.step(on_cpu(state, dt), conv(oc, dt), conv(t, dt))
                for dt, c in cpu.items()}
        state, dg = card.step(state, oc, t)
        (s32, d32), (s64, d64) = (outs[torch.float32],
                                  outs[torch.float64])
        keep, flags = hji_flags(torch, cfg.hji_eps, dg, d32, d64)
        both = keep & d64.hji_active
        dev = (state.u.cpu().double() - s64.u)[both].abs()
        over_rel = float((dev / s64.u[both].abs().clamp(min=1e-30))
                         .max()) if bool(both.any()) else 0.0
        require(bool((dev <= 1e-5 * s64.u[both].abs()).all()),
                f"montecarlo step {i}: an overridden command differs from "
                f"the CPU float64 one by {over_rel} relative")
        rec, broken = reference_verdict(
            torch, False, MC_SOLVER["check_every"],
            take((state.u, dg), keep), take((s32.u, d32), keep),
            s64.u[keep], outside_from_cpu=True)
        require(not broken, f"montecarlo card vs CPU, step {i}: {broken} "
                            f"{rec}")
        steps.append(dict(step=i, overridden_rel=over_rel, **flags, **rec))
        oc, t = card.advance_other(oc), t + DT
    return dict(batch=MC_REF_B, V_start=ctx["V0"][idx].tolist(),
                steps=steps)


# ---------------------------------------------------------------------------
# The real-time controller runtime: runtime.ControllerRuntime
# ---------------------------------------------------------------------------

def runtime_msg(q, seq: int, stamp: float, **override):
    """The state message of plant state `q` (CPU, (6,)), with fields of
    `override` in place of the plant's (pre_flag, ux_mps)."""
    from pigeon_tpu_torch.runtime import FromAutobox

    E, N, psi, ux, uy, r = (float(v) for v in q)
    fields = dict(seq=seq, stamp=stamp, E_m=E, N_m=N, psi_rad=psi,
                  ux_mps=ux, uy_mps=uy, r_radps=r, pre_flag=1)
    return FromAutobox(**dict(fields, **override))


def other_car_ahead(q, gap: float, lateral: float, speed: float):
    """`set_other_car`'s arguments for a car `gap` m ahead of plant state
    `q` along its heading and `lateral` m to its left, oncoming at
    `speed` (the reference's heading convention: theta = psi + pi/2)."""
    E, N, psi = (float(v) for v in q[:3])
    fwd, left = (-math.sin(psi), math.cos(psi)), (-math.cos(psi),
                                                  -math.sin(psi))
    return (E + gap * fwd[0] + lateral * left[0],
            N + gap * fwd[1] + lateral * left[1],
            psi + math.pi + math.pi / 2, speed)


def run_runtime(torch, kernels, cache, device="cuda"):
    """The runtime on the card as a user deploys it: `ControllerRuntime`
    with both default controllers at full width (the sparse decoupled
    path controller, the sparse coupled trajectory controller with the
    HJI override), `cache` (the mid grid), pad_to 1024, warmed up.
    "path": `set_path` on the oval, RT_PERIODS periods; "traj":
    `set_trajectory_msg` of the oval as a timed VehicleTrajectory (edges,
    a stamp), RT_PERIODS periods, each placing the other car ahead
    (`set_other_car`).  Every state message goes through the native
    `StateRing` (push, pop, `on_state`); the plant (`dz.propagate`, RK4,
    float64 on the host) advances by the command in effect.  Each mode
    has one pre_flag = 0 period and one at ux < 1, and "traj" one before
    its time window: those return None, launch nothing and keep the
    heartbeat; every other period returns a finite command with the
    message's sequence number as heartbeat and launches expm_dense as
    RUNTIME_PERIOD_LAUNCHES says and nothing else.  The counters are set
    to 0 before the first period and read after the last.  Then one more
    period of each mode under torch.profiler.  Returns (record, context:
    each mode's recorded steps for `reference_runtime`, the captured
    expm_dense calls)."""
    from pigeon_tpu_torch import discretize as dz
    from pigeon_tpu_torch import dynamics as dyn
    from pigeon_tpu_torch import trajectory
    from pigeon_tpu_torch.runtime import ControllerRuntime, transport

    sync = lambda: torch.cuda.synchronize() if device != "cpu" else None
    t0 = time.perf_counter()
    rt = ControllerRuntime(cache=cache, use_hji_policy=True, pad_to=1024,
                           warmup=True, device=device)
    setup_s = time.perf_counter() - t0
    shapes = {m: (c.formulation, c.soft, c.hz.N_short, c.hz.N_long)
              for m, c in rt.cfgs.items()}
    require(shapes == {"path": ("decoupled", False, 10, 20),
                       "traj": ("coupled", False, 5, 10)}
            and rt.cfgs["traj"].use_hji_policy
            and not rt.cfgs["path"].use_hji_policy,
            f"runtime: the default controllers {shapes}")
    steps = {"path": [], "traj": []}
    for mode, step in list(rt._steps.items()):
        def recorded(*args, step=step, mode=mode):
            out = step(*args)
            steps[mode].append(dict(args=args, out=out))
            return out
        rt._steps[mode] = recorded

    cols = trajectory.oval_columns()
    veh = rt.cfgs["path"].veh
    ode = lambda q, ur: dyn.vehicle_ode(veh, "bicycle", q, ur[..., :2],
                                        ur[..., 2:])
    f64 = dict(dtype=torch.float64)
    ring = transport.StateRing(64)
    plant = dict(q=torch.tensor([cols["E"][0] + 0.3, cols["N"][0] + 0.5,
                                 cols["psi"][0] + 0.03, 6.0, 0.0, 0.0],
                                **f64),
                 u=torch.zeros(3, **f64), seq=0)
    periods, captures = [], {}

    def period(mode, stamp, gated=False, capture=None, **override):
        plant["seq"] += 1
        msg = runtime_msg(plant["q"], plant["seq"], stamp, **override)
        require(ring.push(msg), "runtime: the state ring is full")
        got = ring.pop()
        require(got == msg and ring.pop() is None,
                f"runtime: the ring gave {got} for {msg}")
        hb, before = rt.heartbeat, kernels.launches()
        run = lambda: rt.on_state(got)
        if capture:
            seen = capture_kernel_inputs(lambda: captures.update(cmd=run()))
            cmd = captures.pop("cmd")
            captures[capture] = cloned(torch, seen)
        else:
            cmd = run()
        grew = {k: v - before[k] for k, v in kernels.launches().items()
                if v != before[k]}
        if gated:
            require(cmd is None and rt.heartbeat == hb and not grew,
                    f"runtime {mode}: the gated period {override} gave "
                    f"{cmd}, heartbeat {rt.heartbeat} (was {hb}), "
                    f"launches {grew}")
        else:
            u = [cmd.delta_cmd_rad, cmd.fxf_cmd_N, cmd.fxr_cmd_N]
            require(cmd.heartbeat == rt.heartbeat == got.seq
                    and cmd.post_flag == 1 and cmd.stamp == stamp
                    and all(math.isfinite(v) for v in u + [cmd.s_m, cmd.e_m])
                    and grew == RUNTIME_PERIOD_LAUNCHES[mode],
                    f"runtime {mode}: period {got.seq} gave {cmd}, "
                    f"launches {grew}")
        periods.append(dict(mode=mode, seq=got.seq, stamp=stamp,
                            gated=gated, ran=cmd is not None,
                            heartbeat=rt.heartbeat, launches=grew))
        # the plant runs on under the command in effect, then adopts the
        # new one (`mpc.simulate`'s order)
        u = plant["u"]
        plant["q"] = dz.propagate(ode, plant["q"], torch.cat(
            [u[0:1], u[1:2] + u[2:3], torch.zeros(4, **f64)]), DT)
        if cmd is not None:
            plant["u"] = torch.tensor([cmd.delta_cmd_rad, cmd.fxf_cmd_N,
                                       cmd.fxr_cmd_N], **f64)

    def drive(mode, stamp_of, place=lambda: None):
        """RT_PERIODS periods (RT_GATED's gated), the mode's latency
        statistics, then one more period under the profiler."""
        # each mode's statistics start from an empty window
        rt._step_times.clear()
        rt.budget_violations = 0
        for k in range(RT_PERIODS):
            place()
            override = dict(RT_GATED[mode].get(k, {}))
            stamp = stamp_of(k) + override.pop("stamp_shift", 0.0)
            period(mode, stamp, gated=k in RT_GATED[mode],
                   capture=mode if k == 0 else None, **override)
        stats = rt.latency_stats()
        place()
        prof = profile_call(torch, lambda: period(mode,
                                                  stamp_of(RT_PERIODS)))
        return stats, prof

    # ---- path mode: the oval as a spatial path ----------------------------
    kernels.reset_launches()
    rt.set_path(trajectory.make_tube(**cols, pad_to=1024, device=device))
    stats, prof = {}, {}
    stats["path"], prof["path"] = drive("path", lambda k: k * DT)
    # ---- traj mode: the oval as a timed trajectory from the wire ----------
    n = cols["s"].shape[0]
    buf = trajectory.serialize_trajmsg(
        cols["t"], cols["s"], cols["V"], cols["A"], cols["E"], cols["N"],
        cols["psi"], cols["kappa"], np.zeros(n), np.zeros(n),
        np.full(n, 3.5), np.full(n, -3.5), stamp=RT_STAMP, seq=1,
        frame_id="map")
    rt.set_trajectory_msg(buf)
    require(rt.tracking_mode == "traj" and rt.time_offset == RT_STAMP
            and not bool(rt.carries["traj"].solved)
            and rt.tube.n_valid == n,
            "runtime: the trajectory message's ingest")
    # the trajectory's time where the vehicle is
    cpu_tube = trajectory.make_tube(**cols, pad_to=1024, device="cpu",
                                    dtype=torch.float64)
    t_on = float(trajectory.path_coordinates(cpu_tube, plant["q"][:2])[2])
    gap = dict(g=RT_OTHER[0])

    def place():
        rt.set_other_car(*other_car_ahead(plant["q"], gap["g"],
                                          *RT_OTHER[1:]))
        gap["g"] -= (float(plant["q"][3]) + RT_OTHER[2]) * DT

    stats["traj"], prof["traj"] = drive(
        "traj", lambda k: RT_STAMP + t_on + k * DT, place)
    sync()
    launched = kernels.launches()
    ring.destroy()
    require({k for k, v in launched.items() if v}
            == PATH_KERNELS["runtime"],
            f"runtime: launches {launched}")
    diag = lambda mode: [s["out"][2] for s in steps[mode]]
    rec = dict(
        setup_s=setup_s, periods=len(periods),
        latency=stats, budget_ms=rt.step_budget_s * 1e3,
        hji_active_periods=sum(bool(d.hji_active) for d in diag("traj")),
        V_hji_min=min(float(d.V_hji) for d in diag("traj")),
        iterations={m: [int(d.iterations) for d in diag(m)] for m in steps},
        converged={m: sum(bool(d.converged) for d in diag(m))
                   for m in steps},
        e_last={m: float(diag(m)[-1].e) for m in steps},
        launches=launched, profile=prof, trace=periods)
    return rec, dict(steps=steps, captures=captures, rt=rt, cols=cols,
                     traj_msg=buf)


def reference_runtime(torch, ctx, cache):
    """The card's runtime commands against the CPU, by
    `simulate_reference_check`'s rule: each mode's first RT_REF_PERIODS
    steps replayed through `mpc.mpc_step` on the CPU from the card's
    recorded inputs (the state, the command in effect, the time, the
    other car) and from the carry the card's first step of the mode
    started from, at float64 and float32, each chaining its own carry.
    Every card command within the bar (2e-4 rad, 2 N) plus twice the CPU
    float32-to-float64 gap of its step, never more than REF_CAP_BARS bars
    away, and its converged flag the CPU float32 step's.  The HJI flag
    must be the CPU float64 step's but where V lies at eps within float32
    interpolation noise (`hji_flags`' test); such a step is left out of
    the command rule."""
    from pigeon_tpu_torch import mpc, trajectory

    cpu_cache = cache_to(cache, "cpu")
    rt = ctx["rt"]
    bar = torch.tensor([2e-4, 2.0, 2.0], dtype=torch.float64)
    out = {}
    for mode, recs in ctx["steps"].items():
        cfg = rt.cfgs[mode]
        recs = recs[:RT_REF_PERIODS]
        conv = lambda x, dt: (x.to(device="cpu", dtype=dt)
                              if x.is_floating_point() else x.cpu())
        runs = {}
        for dt in (torch.float64, torch.float32):
            tube = trajectory.make_tube(**ctx["cols"], pad_to=1024,
                                        device="cpu", dtype=dt)
            if mode == "traj":
                tube = trajectory.tube_from_trajmsg_bytes(
                    ctx["traj_msg"], pad_to=1024, device="cpu",
                    dtype=dt)[0]
            carry = mpc.MPCCarry(*[conv(x, dt) for x in recs[0]["args"][1]])
            runs[dt] = []
            for r in recs:
                q0, u0, oc, t = (conv(x, dt) for x in r["args"][2:])
                carry, u3, d = mpc.mpc_step(cfg, tube, cpu_cache, carry, q0,
                                            u0, oc, t)
                runs[dt].append((u3, d))
        steps = []
        for i, r in enumerate(recs):
            _, ug, dg = r["out"]
            (u64, d64), (u32, d32) = runs[torch.float64][i], runs[
                torch.float32][i]
            V64, V32 = float(d64.V_hji), float(d32.V_hji)
            differ = bool(dg.hji_active) != bool(d64.hji_active)
            near = abs(V64 - cfg.hji_eps) <= 2.0 * abs(V32 - V64)
            require(not differ or near,
                    f"runtime {mode} step {i}: HJI flag {bool(dg.hji_active)}"
                    f" on the card, V = {V64} on the CPU")
            dg_ = (ug.cpu().double() - u64).abs()
            gap = (u32.double() - u64).abs()
            allowed = torch.minimum(bar + 2.0 * gap, REF_CAP_BARS * bar)
            row = dict(step=i, err_bars=float((dg_ / bar).max()),
                       gap32_bars=float((gap / bar).max()),
                       max_excess=float((dg_ - allowed).max()),
                       converged=[bool(dg.converged), bool(d32.converged)],
                       iterations=[int(dg.iterations), int(d32.iterations),
                                   int(d64.iterations)],
                       hji_active=bool(dg.hji_active), V_hji=V64,
                       flag_near_eps=differ)
            if not differ:
                require(row["max_excess"] <= 0.0,
                        f"runtime {mode} step {i}: card vs CPU float64 "
                        f"{row}")
            require(bool(dg.converged.cpu() == d32.converged),
                    f"runtime {mode} step {i}: converged vs CPU float32 "
                    f"{row}")
            steps.append(row)
        out[mode] = steps
    return out


def check_runtime_expm(torch, captures):
    """The dense exponential on the calls captured from the first period
    of each runtime mode: the path controller's ZOH and FOH stacks, the
    trajectory controller's stage matrix (`expm_case`)."""
    out = {}
    for mode, seen in captures.items():
        calls = {"zoh": seen["expm_dense"], "foh": seen["expm_dense_last"]}
        if mode == "traj":
            calls = {"stages": seen["expm_dense"]}
        for name, (args, kw) in calls.items():
            M = args[0]
            sq = args[1] if len(args) > 1 else kw.get("squarings", 8)
            order = args[2] if len(args) > 2 else kw.get("order", 8)
            out[f"runtime_{mode}_{name}"] = expm_case(torch, M, sq, order,
                                                      (20, 5))
    return out


def hji_gap(rec) -> dict:
    """A `value_agreement` record as the three numbers the HJI bars hold:
    mean and p99 |dV| and the largest share of points whose activation
    differs over AGREEMENT_EPS."""
    from pigeon_tpu_torch.hji_solve import AGREEMENT_EPS

    return dict(mean=rec["V_mean_abs_delta"], p99=rec["V_p99_abs_delta"],
                disagreement=max(1.0 - rec[f"eps_{e}"]["activation_agreement"]
                                 for e in AGREEMENT_EPS))


def within(gap: dict, bars: dict) -> bool:
    return all(gap[k] <= bars[k] for k in bars)


def timed_hji_solve(torch, dtype, **kw):
    """`hji_solve.solve_hji` on the card, timed by the host clock around
    the whole call (the grid's set-up and the cache's assembly included),
    with the device's peak memory.  Returns (cache, deltas, times,
    record)."""
    from pigeon_tpu_torch import hji_solve
    from pigeon_tpu_torch.config import x1_params

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cache, deltas, times = hji_solve.solve_hji(x1_params(), dtype=dtype,
                                               **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    require(np.isfinite(deltas).all() and bool(torch.isfinite(cache.V).all()),
            f"hji_solve {dtype}: a value is not finite")
    return cache, deltas, times, dict(
        dtype=str(dtype).split(".")[-1], seconds=seconds,
        sweeps=int(len(deltas)), t_reached_s=float(times[-1]),
        ms_per_sweep=seconds / len(deltas) * 1e3,
        delta_first=float(deltas[0]), delta_last=float(deltas[-1]),
        peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def device_agreement(torch, V, V_ref) -> dict:
    """`value_agreement`'s largest and mean |dV| and activation shares,
    computed on the device (for grids too large to compare on the
    host)."""
    from pigeon_tpu_torch.hji_solve import AGREEMENT_EPS

    dV = (V - V_ref).abs()
    rec = dict(points=V.numel(), V_max_abs_delta=float(dV.max()),
               V_mean_abs_delta=float(dV.double().mean()))
    for e in AGREEMENT_EPS:
        act, act_ref = V <= e, V_ref <= e
        rec[f"eps_{e}"] = dict(
            active_frac=float(act.double().mean()),
            active_frac_ref=float(act_ref.double().mean()),
            activation_agreement=float((act == act_ref).double().mean()))
    return rec


@contextlib.contextmanager
def world_of_one(device="cuda"):
    """A one-rank torch.distributed world over a free localhost port
    (NCCL on the card, gloo on the CPU), torn down on the way out."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def sharded_world_of_one(torch, device="cuda"):
    """`solve_hji_vi_sharded` on a one-rank NCCL group (a device mesh of
    one card, dimension "dp"; gloo on the CPU) against `solve_hji_vi` on
    the smooth flow: the halo rows are the rank's own edge rows and the
    reductions are over one rank, so the two must be bit-equal."""
    from torch.distributed.device_mesh import init_device_mesh

    from pigeon_tpu_torch import hji_solve

    l, hs = hji_solve.pursuit_target((HJI_SMOOTH_N, HJI_SMOOTH_N + 1))
    l = torch.as_tensor(l, dtype=torch.float32, device=device)
    flow = hji_solve.pursuit_flow(1.0)
    with world_of_one(device):
        mesh = init_device_mesh(device, (1,), mesh_dim_names=("dp",))
        t0 = time.perf_counter()
        V_s, d_s, t_s = hji_solve.solve_hji_vi_sharded(
            l, hs, flow, HJI_SMOOTH_SWEEPS, mesh)
        torch.cuda.synchronize()
        sharded_s = time.perf_counter() - t0
    V_u, d_u, t_u = hji_solve.solve_hji_vi(l, hs, flow, HJI_SMOOTH_SWEEPS)
    rec = dict(grid=list(l.shape), sweeps=HJI_SMOOTH_SWEEPS,
               seconds=sharded_s,
               V_max_abs_diff=float((V_s - V_u).abs().max()),
               times_equal=bool(torch.equal(t_s, t_u)),
               deltas_equal=bool(torch.equal(d_s, d_u)))
    require(torch.equal(V_s, V_u) and rec["times_equal"]
            and rec["deltas_equal"],
            f"hji_solve sharded at world size 1 differs: {rec}")
    return rec


def states_agreement(torch, cache, ref, x_rel, chunk: int = 1 << 18):
    """`value_agreement` of two caches interpolated at the states x_rel
    (..., 7), at AGREEMENT_EPS and MC_EPS."""
    from pigeon_tpu_torch import hji
    from pigeon_tpu_torch.hji_solve import AGREEMENT_EPS, value_agreement

    x = x_rel.reshape(-1, 7)
    V = [torch.cat([hji.interpolate(c, x[i:i + chunk])[0]
                    for i in range(0, len(x), chunk)]).cpu().numpy()
         for c in (cache, ref)]
    return value_agreement(*V, eps=AGREEMENT_EPS + (MC_EPS,))


def card_gap_bars(card: dict) -> dict:
    """The bars of a live float32-to-float64 gap: HJI_BAR_FACTOR times the
    recorded gap `card` in mean and p99 |dV|, the activation disagreement
    at the asset bar."""
    return dict(mean=HJI_BAR_FACTOR * card["mean"],
                p99=HJI_BAR_FACTOR * card["p99"],
                disagreement=HJI_PROTO_BARS["disagreement"])


def hji_proto(torch, x_rel, device="cuda"):
    """(a) of `run_hji_solve`: the proto solve to its horizon in float32
    and float64 against the asset, the control, one profiled sweep, and
    the float32 cache against the asset at the states x_rel."""
    from pigeon_tpu_torch import hji_solve
    from pigeon_tpu_torch.config import x1_params

    asset = np.load(HJI_PROTO_ASSET)["V"]
    proto, caches = {}, {}
    for dtype in (torch.float32, torch.float64):
        cache, deltas, times, r = timed_hji_solve(
            torch, dtype, shape=hji_solve.PROTO_SHAPE, device=device,
            **HJI_PROTO)
        proto[r["dtype"]] = r
        caches[r["dtype"]] = cache
        require(r["sweeps"] == HJI_PROTO_SWEEPS
                and r["t_reached_s"] >= HJI_PROTO["horizon_s"]
                and deltas[-1] == 0.0,
                f"hji_solve proto {r}: expected {HJI_PROTO_SWEEPS} sweeps "
                f"to the horizon, frozen")
    caches["control"], _, _, r_c = timed_hji_solve(
        torch, torch.float32, shape=hji_solve.PROTO_SHAPE, device=device,
        **dict(HJI_PROTO, **HJI_CONTROL))
    vals = {k: c.V.cpu().numpy().reshape(c.dims) for k, c in caches.items()}
    card = hji_solve.value_agreement(vals["float32"], vals["float64"])
    card_bars = card_gap_bars(CARD_PROTO_GAP)
    against = {k: hji_solve.value_agreement(v, asset) for k, v in vals.items()}
    gaps = {k: hji_gap(a) for k, a in against.items()}
    rec = dict(runs=proto, control=dict(HJI_CONTROL, **r_c),
               float32_vs_float64=card, float32_vs_float64_bars=card_bars,
               bars=HJI_PROTO_BARS, against_asset=against)
    require(within(hji_gap(card), card_bars),
            f"hji_solve proto float32 against float64: {hji_gap(card)} "
            f"outside {card_bars}")
    require(within(gaps["float32"], HJI_PROTO_BARS)
            and within(gaps["float64"], HJI_PROTO_BARS),
            f"hji_solve proto against the asset: {gaps} outside "
            f"{HJI_PROTO_BARS}")
    require(not within(gaps["control"], HJI_PROTO_BARS),
            f"hji_solve proto: the control {HJI_CONTROL} passes the bars")
    l, hs, flow, _ = hji_solve.vehicle_problem(
        x1_params(), shape=hji_solve.PROTO_SHAPE,
        fx_samples=HJI_PROTO["fx_samples"], device=device)
    hs_t, lo, cfl_t, _ = hji_solve._constants(l, hs, HJI_PROTO["cfl"], -3.0,
                                              None)
    zero = torch.zeros((), device=device)
    rec["profile_sweep"] = profile_call(
        torch, lambda: hji_solve._sweep_body(l, l, hs_t, flow, cfl_t, lo,
                                             "local", 3.0, zero))
    # the card-solved float32 cache against the asset at the rollout's
    # states, by the same rule
    ref = hji_solve.load_cache(HJI_PROTO_ASSET, device=device)
    at = dict(float32_vs_float64=states_agreement(
        torch, caches["float32"], caches["float64"], x_rel),
        against_asset=states_agreement(torch, caches["float32"], ref, x_rel),
        float32_vs_float64_bars=card_gap_bars(CARD_STATES_GAP),
        bars=HJI_PROTO_BARS)
    rec["at_montecarlo_states"] = dict(states=int(x_rel.numel() // 7), **at)
    require(within(hji_gap(at["float32_vs_float64"]),
                   at["float32_vs_float64_bars"])
            and within(hji_gap(at["against_asset"]), HJI_PROTO_BARS),
            f"hji_solve proto at the Monte-Carlo states: {at}")
    return rec


def hji_production(torch, device="cuda"):
    """(b) of `run_hji_solve`: the production grid at full width for
    HJI_PROD_SWEEPS sweeps in float32 and float64 and, as the control,
    one sweep fewer in float32; the float32 V held to the float64 V on
    the card within HJI_PROD_BARS, which the control must fail; one
    alpha pass under torch.profiler."""
    from pigeon_tpu_torch import hji_solve
    from pigeon_tpu_torch.config import x1_params

    shape = hji_solve.DEFAULT_SHAPE
    order = hji_solve.PROD_AXIS_ORDER
    prod, caches, traces = {}, {}, {}
    for name, dtype, sweeps in (("float32", torch.float32, HJI_PROD_SWEEPS),
                                ("float64", torch.float64, HJI_PROD_SWEEPS),
                                ("control", torch.float32,
                                 HJI_PROD_SWEEPS - 1)):
        cache, deltas, times, r = timed_hji_solve(
            torch, dtype, shape=shape, axis_order=order, device=device,
            n_sweeps=sweeps, **HJI_PROD)
        r["steps"] = np.diff(times, prepend=0.0).tolist()
        prod[name], caches[name], traces[name] = r, cache.V, times
        del cache
    gap = device_agreement(torch, caches["float32"], caches["float64"])
    control = device_agreement(torch, caches["control"], caches["float64"])
    del caches
    rec = dict(shape=list(shape), axis_order=list(order),
               grid_points=int(np.prod(shape)), runs=prod,
               float32_vs_float64=gap, control_vs_float64=control,
               bars=dict(zip(("max", "mean"), HJI_PROD_BARS)))

    def inside(g):
        return (g["V_max_abs_delta"] <= HJI_PROD_BARS[0]
                and g["V_mean_abs_delta"] <= HJI_PROD_BARS[1])
    require(np.allclose(traces["float32"], traces["float64"],
                        rtol=4 * np.finfo(np.float32).eps, atol=0)
            and len(traces["float32"]) == HJI_PROD_SWEEPS,
            f"hji_solve production: the step traces differ {traces}")
    require(inside(gap),
            f"hji_solve production float32 against float64: {gap} outside "
            f"{HJI_PROD_BARS}")
    require(not inside(control),
            f"hji_solve production: the float32 run one sweep short passes "
            f"the bars {HJI_PROD_BARS}: {control}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    l, hs, flow, _ = hji_solve.vehicle_problem(
        x1_params(), shape=shape, axis_order=order,
        fx_samples=HJI_PROD["fx_samples"], device=device)
    hs_t, lo, _, _ = hji_solve._constants(l, hs, 0.5, -3.0, None)
    zero = torch.zeros((), device=device)
    rec["alpha_pass"] = dict(profile=profile_call(
        torch, lambda: hji_solve._slab_pass(l, l, hs_t, flow, lo, "local",
                                            None, zero, zero, 1)),
        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del l, flow
    torch.cuda.empty_cache()
    return rec


def run_hji_solve(torch, x_rel, device="cuda"):
    """The HJI value-iteration solver on the card (`hji_solve`), with no
    kernel of its own: (a) the proto solve to its horizon in float32 and
    float64, each held against `assets/hji_cache_proto.npz` within
    HJI_PROTO_BARS, the control (HJI_CONTROL) failing them, the live
    float32-to-float64 gap within its recorded value's bars; one sweep
    under torch.profiler; the card-solved float32 proto cache against
    the asset at the Monte-Carlo rollout's relative states x_rel by the
    same rule (`hji_proto`); (b) the production grid (DEFAULT_SHAPE in
    PROD_AXIS_ORDER, slab by slab) at full width for HJI_PROD_SWEEPS
    sweeps in float32 and float64, the step traces equal to float32
    rounding, V within HJI_PROD_BARS (compared on the card), which the
    float32 run one sweep short fails, with one alpha pass (one sweep's
    work) under torch.profiler (`hji_production`); (c) the sharded
    solver at world size 1 over NCCL.  Returns the phase's record."""
    return dict(proto=hji_proto(torch, x_rel, device),
                production=hji_production(torch, device),
                sharded_world_1=sharded_world_of_one(torch, device))


def tree_bits_equal(torch, a, b) -> bool:
    """Every tensor of two trees of the same structure equal to the bit
    (floats compared as integers, so NaN matches NaN)."""
    from pigeon_tpu_torch.parallel.mesh import tree_map

    xs, ys = [], []
    tree_map(xs.append, a)
    tree_map(ys.append, b)
    as_bits = {torch.float32: torch.int32, torch.float64: torch.int64}
    return len(xs) == len(ys) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(
            x.view(as_bits.get(x.dtype, x.dtype)),
            y.view(as_bits.get(y.dtype, y.dtype)))
        for x, y in zip(xs, ys))


def grown(kernels, before) -> dict:
    return {k: v - before[k] for k, v in kernels.launches().items()}


def timed_steps(torch, n, step):
    """`step(i)` for i < n, each timed with CUDA events: [ms]."""
    out = []
    for i in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(i)
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def mesh_fleet(torch, kernels):
    """`BatchedController(mesh=make_mesh())` on fleet-8192 (the soft coupled
    QP on the lane solver: B1-B3), a cold and MESH_FLEET_WARM warm steps,
    against the mesh-less controller on the same inputs: a world of one
    reduces nothing, so states and diagnostics must be bit-equal; every
    mesh step launches exactly the fleet path's kernels."""
    from pigeon_tpu_torch.parallel import mesh as pm

    st = make_setup(torch, B_FLEET, "cuda")
    n = MESH_FLEET_WARM + 1
    mesh = pm.make_mesh()
    runs, launched = {}, {}
    for name, ctrl_mesh in (("plain", None), ("mesh", mesh)):
        ctrl = pm.BatchedController(st["cfg"], st["tube"], st["cache"],
                                    mesh=ctrl_mesh)
        out = dict(state=ctrl.init_state(st["q"]), per_step=[])
        before = kernels.launches()

        def step(i, ctrl=ctrl, out=out):
            b = kernels.launches()
            out["state"], out["diag"] = ctrl.step(out["state"], st["oc"],
                                                  st["t"] + i * DT)
            out["per_step"].append(grown(kernels, b))
        out["ms"] = timed_steps(torch, n, step)
        launched[name] = grown(kernels, before)
        runs[name] = out
    expect = PATH_KERNELS["coupled"]
    require(all(all((v > 0) == (k in expect) for k, v in g.items())
                for g in runs["mesh"]["per_step"]),
            f"mesh_fleet launches {runs['mesh']['per_step']}")
    mesh_out, plain = runs["mesh"], runs["plain"]
    require(tree_bits_equal(torch, (mesh_out["state"], mesh_out["diag"]),
                            (plain["state"], plain["diag"])),
            "mesh_fleet: the world-of-one controller differs from the "
            "mesh-less one")
    gathered = pm.gather_batch(mesh_out["state"].q, mesh)
    require(torch.equal(gathered, plain["state"].q), "gather_batch")
    return dict(batch=B_FLEET, steps=n, mesh_ms=mesh_out["ms"],
                plain_ms=plain["ms"], bit_equal=True,
                gather_batch_shape=list(gathered.shape),
                converged_last=float(mesh_out["diag"].converged
                                     .float().mean())), launched["mesh"]


def mesh_sparse_tp(torch, kernels):
    """`make_sharded_step(..., make_mesh_2d(tp=1), use_tp_factor=True)` on
    fleet-sparse-2048 ("pallas", "banded", "highest": B1, B9, B7, B8), a
    cold and MESH_SPARSE_WARM warm closed-loop steps with the plant, so
    the tp factor's all_gather route runs on NCCL over a group of one.
    Commands, carries and diagnostics bit-equal to `mpc_step_batched`'s
    (the gathered W is the same GEMM operand, the blocks re-assembled
    whole), the FleetMetrics equal to the step's own reductions, each
    step's launches SPARSE_STEP_LAUNCHES."""
    from pigeon_tpu_torch.parallel import shard

    plain = make_setup(torch, B_SPARSE, "cuda", formulation="sparse")
    st = make_setup(torch, B_SPARSE, "cuda", formulation="sparse")
    mesh = shard.make_mesh_2d(tp=1)
    sharded = shard.make_sharded_step(st["cfg"], st["tube"], st["cache"],
                                      mesh, use_tp_factor=True)
    require(st["cfg"].solver.tp_axis is None, "the caller's cfg changed")
    metrics, per_step, ms, plain_ms = [], [], [], []

    def step(*args):
        c, u3, diag, m = sharded(*shard.shard_batch_dp(args, mesh))
        metrics.append(m)
        return c, u3, diag

    launched = dict.fromkeys(kernels.launches(), 0)
    for i in range(MESH_SPARSE_WARM + 1):
        plain_ms += timed_steps(torch, 1, lambda _: plain.update(
            out=closed_loop_step(torch, plain)))
        b = kernels.launches()
        ms += timed_steps(torch, 1, lambda _: st.update(
            out=closed_loop_step(torch, st, step)))
        g = grown(kernels, b)
        launched = {k: launched[k] + v for k, v in g.items()}
        per_step.append({k: v for k, v in g.items() if v})
        require(per_step[-1] == SPARSE_STEP_LAUNCHES,
                f"mesh_sparse_tp step {i} launches {per_step[-1]}")
        require(tree_bits_equal(
            torch, (st["carry"], st["q"], st["out"]),
            (plain["carry"], plain["q"], plain["out"])),
            f"mesh_sparse_tp step {i}: the sharded step with the tp factor "
            f"differs from mpc_step_batched")
        u3, diag = st["out"]
        f32 = lambda v: v.to(torch.float32)
        own = (f32(torch.ones_like(st["t"])).sum(),
               f32(diag.converged).sum(), f32(diag.hji_active).sum(),
               f32(diag.e.abs()).amax(), f32(diag.prim_res).amax(),
               f32(torch.isfinite(u3).all()))
        require(all(torch.equal(a, b) for a, b in zip(metrics[-1], own)),
                f"mesh_sparse_tp step {i}: FleetMetrics {metrics[-1]} "
                f"against the step's own {own}")
    m = metrics[-1]
    return dict(batch=B_SPARSE, steps=len(ms), mesh_ms=ms, plain_ms=plain_ms,
                bit_equal=True, launches_per_step=per_step,
                metrics_last={k: float(v) for k, v in m._asdict().items()}
                ), launched


def mesh_montecarlo(torch, kernels, cache):
    """`run_dynamic_obstacle(mesh=make_mesh())` at B_MC for MESH_MC_STEPS
    steps (the Monte-Carlo path's configuration and scenarios) against the
    mesh-less call: the summary equal field for field, the steps
    launching the path's kernels."""
    from pigeon_tpu_torch import montecarlo as mc
    from pigeon_tpu_torch import trajectory
    from pigeon_tpu_torch.parallel import mesh as pm

    tube = trajectory.make_tube(**trajectory.oval_columns(), pad_to=1024,
                                device="cuda")
    cfg = montecarlo_config()
    scen = mc.sample_scenarios(tube, B_MC, **MC_SCENARIOS)
    secs, out, launched = {}, {}, {}
    for name, mesh in (("plain", None), ("mesh", pm.make_mesh())):
        before = kernels.launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = mc.run_dynamic_obstacle(cfg, tube, cache, scen,
                                            n_steps=MESH_MC_STEPS, mesh=mesh)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        launched[name] = grown(kernels, before)
    expect = PATH_KERNELS["montecarlo"]
    require(all((v > 0) == (k in expect)
                for k, v in launched["mesh"].items())
            and launched["mesh"]["vanloan"] == MESH_MC_STEPS,
            f"mesh_montecarlo launches {launched['mesh']}")
    require(out["mesh"] == out["plain"],
            f"mesh_montecarlo summary {out['mesh']} against the mesh-less "
            f"{out['plain']}")
    return dict(batch=B_MC, steps=MESH_MC_STEPS,
                wall_ms_step=secs["mesh"] / MESH_MC_STEPS * 1e3,
                plain_wall_ms_step=secs["plain"] / MESH_MC_STEPS * 1e3,
                summary=out["mesh"]._asdict()), launched["mesh"]


def rollout_scan_check(torch, kernels, device="cuda"):
    """`rollout_affine` at T in SCAN_T on the card (the associative scan,
    no kernel launch) against the CPU float64 unroll, within ROLLOUT_REL
    of the largest entry; its ms beside the unroll's on the card."""
    from pigeon_tpu_torch.qp import condensed as qc

    B, d, w = SCAN_SHAPE["B"], SCAN_SHAPE["d"], SCAN_SHAPE["w"]
    g = torch.Generator(device=device).manual_seed(0)
    recs = {}
    for T in SCAN_T:
        A = 0.25 * torch.randn((B, T, d, d), generator=g, device=device)
        E = torch.randn((B, T, d, w), generator=g, device=device)
        before = kernels.launches()
        out = qc.rollout_affine(A, E)
        torch.cuda.synchronize()
        require(kernels.launches() == before,
                f"rollout_affine at T={T} launched a kernel")
        ref = qc.rollout_affine_unroll(A.double().cpu(), E.double().cpu())
        err = float((out.double().cpu() - ref).abs().max())
        rel = err / float(ref.abs().max())
        require(rel <= ROLLOUT_REL,
                f"rollout scan at T={T}: relative {rel} against float64")
        recs[f"T{T}"] = dict(
            shapes=[list(A.shape), list(E.shape)], rounds=math.ceil(
                math.log2(T)), max_abs_err=err, rel=rel,
            ms=cuda_ms(torch, lambda: qc.rollout_affine(A, E), 5),
            unroll_ms=cuda_ms(torch, lambda: qc.rollout_affine_unroll(A, E),
                              3))
        del A, E, out, ref
    return recs


def hji_slice_check(torch, cache):
    """`viz.hji_slice` on the card's cache at HJI_SLICE_RELS against the
    CPU float64 interpolation at the same float32 points, within
    HJI_SLICE_ULPS float32 spacings of the grid's largest |V| (the CPU
    float32 slice's distance logged beside it)."""
    from pigeon_tpu_torch import hji, viz

    cpu = lambda dt: cache._replace(
        V=cache.V.cpu().to(dt), gradV=None,
        knots=tuple(k.cpu().to(dt) for k in cache.knots))
    c64, c32 = cpu(torch.float64), cpu(torch.float32)
    ulp = float(np.spacing(np.float32(cache.V.abs().max().item())))
    worst = {"f64": 0.0, "f32": 0.0}
    for rel in HJI_SLICE_RELS:
        dE, dN, V = viz.hji_slice(cache, rel)
        x = np.broadcast_to(np.asarray(rel), (dE.size, dN.size, 7)).copy()
        x[..., 0], x[..., 1] = dE[:, None], dN[None, :]
        x32 = torch.as_tensor(x, dtype=torch.float32)
        for name, c in (("f64", c64), ("f32", c32)):
            ref = hji.interpolate(c, x32.to(c.V.dtype))[0].numpy()
            fin = np.isfinite(ref)
            require(bool((np.isfinite(V) == fin).all()) and fin.any(),
                    f"hji_slice at {rel}: +inf pattern")
            worst[name] = max(worst[name],
                              float(np.abs(V[fin] - ref[fin]).max()))
    require(worst["f64"] <= HJI_SLICE_ULPS * ulp,
            f"hji_slice: {worst['f64'] / ulp} float32 spacings from the CPU "
            f"float64 slice")
    return dict(points=[41, 41], rels=len(HJI_SLICE_RELS), ulp=ulp,
                max_abs_vs_cpu_f64=worst["f64"],
                ulps_vs_cpu_f64=worst["f64"] / ulp,
                max_abs_vs_cpu_f32=worst["f32"],
                ulps_vs_cpu_f32=worst["f32"] / ulp)


def run_mesh(torch, kernels, cache):
    """The scale-out paths in one one-rank NCCL world (`world_of_one`):
    the data-parallel controller on fleet-8192 (`mesh_fleet`), the
    sharded sparse step with the tp factor forced (`mesh_sparse_tp`), the
    mesh Monte-Carlo (`mesh_montecarlo`, the mid cache `cache`); then the
    long-horizon rollout scan and `viz.hji_slice` on the card.  Returns
    (record, launches by path)."""
    rec, launched = {}, {}
    with world_of_one("cuda"):
        for name, fn, args in (("mesh_fleet", mesh_fleet, ()),
                               ("mesh_sparse_tp", mesh_sparse_tp, ()),
                               ("mesh_montecarlo", mesh_montecarlo,
                                (cache,))):
            t0 = time.perf_counter()
            rec[name], launched[name] = fn(torch, kernels, *args)
            rec[name]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["rollout_scan"] = rollout_scan_check(torch, kernels)
    rec["hji_slice"] = hji_slice_check(torch, cache)
    rec["scan_and_slice_seconds"] = time.perf_counter() - t0
    return rec, launched


def run_profile_phases(torch, fleet_warm_ms):
    """`profiling.profile_step` on fleet-8192 and fleet-sparse-2048 after
    a cold step (a warm carry), every phase's time finite and positive
    and the whole step within PROFILE_FULL_STEP_RATIO of the fleet
    phase's own warm median `fleet_warm_ms` (a loose bar: it only catches
    a mis-timed phase); and `mfu_row` of fleet-8192's warm step."""
    from pigeon_tpu_torch import profiling
    from pigeon_tpu_torch.qp.condensed import get_soft_layout

    rec = {}
    for formulation, B, phase in (("coupled", B_FLEET, "fleet"),
                                  ("sparse", B_SPARSE, "fleet_sparse")):
        st = make_setup(torch, B, "cuda", formulation=formulation)
        closed_loop_step(torch, st)
        row = profiling.profile_step(
            st["cfg"], st["tube"], st["cache"], st["carry"], st["q"],
            st["u"], st["oc"], st["t"], iters=5, warmup=1,
            keep_outputs=phase == "fleet")
        outputs = row.pop("outputs", None)
        ph = row["phase_ms"]
        ratio = ph["full_step"] / fleet_warm_ms[phase]
        require(all(math.isfinite(v) and v > 0 for v in ph.values())
                and PROFILE_FULL_STEP_RATIO[0] <= ratio
                <= PROFILE_FULL_STEP_RATIO[1],
                f"profile {phase}: {ph}, full step {ratio} of the fleet's")
        rec[phase] = dict(row, fleet_warm_ms=fleet_warm_ms[phase],
                          full_step_over_fleet=ratio)
        if outputs is not None:
            cfg = st["cfg"]
            L = get_soft_layout(cfg.hz, cfg.coupled.use_walls)
            iters = float(outputs["full_step"][2].iterations.float().mean())
            mfu = profiling.mfu_row(B, ph["full_step"] / 1e3,
                                    profiling.soft_step_flops(
                                        cfg.hz, L.n, L.m, iters,
                                        cfg.solver.pallas_check_inner))
            rec["mfu_fleet"] = dict(mfu, iters_mean=iters,
                                    step_ms=ph["full_step"])
        del st, outputs
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from pigeon_tpu_torch import _kernels as kernels
    from pigeon_tpu_torch import mpc

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(phase="device", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, name=kind,
        count=torch.cuda.device_count(),
        sms=torch.cuda.get_device_properties(0).multi_processor_count)

    t0 = time.perf_counter()
    build_out = kernels.build_all()
    build_s = time.perf_counter() - t0
    regs = {src: [ln.strip() for ln in out.splitlines()
                  if "registers" in ln or "spill" in ln]
            for src, out in build_out.items()}
    log(phase="build", seconds=build_s, ptxas=regs)

    # ---- kernel checks at the main paths' shapes ---------------------------
    def capture_fleet(formulation, B=B_FLEET, hz=None):
        st = make_setup(torch, B, "cuda", hz=hz, formulation=formulation)
        return capture_kernel_inputs(lambda: closed_loop_step(torch, st))

    def capture_step(formulation, n_steps=1, last=False):
        from pigeon_tpu_torch import mpc
        cfg, tube, cache, q0 = simulate_setup(torch, formulation, "cuda",
                                              torch.float32)
        return capture_kernel_inputs(lambda: mpc.simulate(
            cfg, tube, cache, q0, n_steps=n_steps), last)

    def capture_cold_warm(formulation):
        """The hard fleet's first (cold) step, its inputs cloned, and its
        second (warm) step, for B8's early exit."""
        st = make_setup(torch, B_SPARSE, "cuda", formulation=formulation)
        cold = cloned(torch, capture_kernel_inputs(
            lambda: closed_loop_step(torch, st)))
        return cold, capture_kernel_inputs(lambda: closed_loop_step(torch,
                                                                    st))

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        log(phase="capture", name=name, seconds=time.perf_counter() - t)
        return out

    cap = timed("coupled", capture_fleet, "coupled")
    cap_dec = timed("decoupled", capture_fleet, "decoupled")
    small = timed("coupled_small", capture_fleet, "coupled", B_SMALL,
                  HZ_SMALL)
    cap_sp, warm_sp = timed("sparse_cold_warm", capture_cold_warm, "sparse")
    small_sp = timed("sparse_small", capture_fleet, "sparse", B_SMALL,
                     HZ_SMALL)
    # the sparse fleet in mode "mixedk6": the large build's path
    cap_mk, warm_mk = timed("sparse_mixedk6_cold_warm", capture_cold_warm,
                            "sparse_mixedk6")
    small_mk = timed("sparse_mixedk6_small", capture_fleet,
                     "sparse_mixedk6", B_SMALL, HZ_SMALL)
    cap_cd, warm_cd = timed("condensed_cold_warm", capture_cold_warm,
                            "condensed")
    small_cd = timed("condensed_small", capture_fleet, "condensed", B_SMALL,
                     HZ_SMALL)
    # the sparse decoupled fleet: B8's large build, and the two
    # exponential stacks of a step (its first call the ZOH stages', its
    # last the FOH stages')
    cap_ds, warm_ds = timed("decoupled_sparse_cold_warm", capture_cold_warm,
                            "decoupled_sparse")
    small_ds = timed("decoupled_sparse_small", capture_fleet,
                     "decoupled_sparse", B_SMALL, HZ_SMALL)
    require(cap_ds["admm_dense"][0][1].shape == (B_SPARSE, 395, 245)
            and cap_ds["admm_dense"][1]["pattern"].build == "large"
            and cap_ds["admm_dense"][1]["tile"] == 4
            and not {"vanloan", "banded_chol"} & set(cap_ds)
            and cap_ds["expm_dense"][0][0].shape == (B_SPARSE * 10, 11, 11)
            and cap_ds["expm_dense_last"][0][0].shape
            == (B_SPARSE * 20, 17, 17)
            and small_ds["admm_dense"][0][1].shape == (B_SMALL, 161, 101),
            "the sparse decoupled fleet's QP sizes, stacks and B8 build")
    # the unbatched condensed route's calls: the cold step's first
    # segment, the second step's last
    sim_cd = timed("simulate_condensed", lambda: [
        capture_step("condensed")["admm_dense"],
        capture_step("condensed", 2, last=True)["admm_dense"]])
    require(cap_cd["admm_dense"][0][1].shape == (B_SPARSE, 200, 103)
            and cap_cd["admm_dense"][1]["dense_P"]
            and cap_cd["admm_dense"][1]["scalings"][3].shape
            == (B_SPARSE, 103, 103)
            and "banded_chol" not in cap_cd
            and small_cd["admm_dense"][0][1].shape[1:] == (162, 84),
            "the condensed fleet's QP sizes and its dense P")
    require(cap_sp["admm_dense"][0][1].shape == (B_SPARSE, 290, 193)
            and cap_sp["banded_chol"][0][0].shape == (B_SPARSE, 16, 13, 13)
            and small_sp["admm_dense"][0][1].shape == (B_SMALL, 234, 156)
            and small_sp["banded_chol"][0][0].shape[1] == 13,
            "the sparse fleet's QP and block sizes")
    require(cap_mk["admm_dense"][1]["pattern"].build == "large"
            and cap_mk["admm_dense"][1]["m_eq"] == 128
            and small_mk["admm_dense"][0][1].shape == (B_SMALL, 234, 156)
            and cap_sp["admm_dense"][1]["pattern"].build == "narrow",
            "the sparse fleets' B8 builds: large in mixedk6, narrow in "
            "highest")
    require(small["admm_iterations"][0][2].shape[0] == 2 * sum(HZ_SMALL),
            "the 12-stage horizon's QP size")
    require(cap_dec["admm_iterations"][0][1].shape[:2] == (180, 30)
            and cap_dec["vanloan"][0][0].shape[1:] == (30, 4, 4),
            "the decoupled fleet's QP and stage sizes")
    cap["rollout"] = cap_dec["rollout_affine"]
    cap["expm_dense"] = capture_step("coupled")["expm_dense"]

    def as_pair(call):
        """A captured call with its pattern in the pair build (the pack is
        the large build's, which the pair shares, so the call packs
        anew)."""
        args, kw = call
        kw = {k: v for k, v in kw.items() if k != "A_packed"}
        return args, dict(kw, pattern=kw["pattern"].as_build("pair"))

    extra = {"rollout": None,
             "expm_dense": dict(
                 decoupled=capture_step("decoupled")["expm_dense"],
                 fleet_vanloan=cap["vanloan"][0],
                 decoupled_sparse=(cap_ds["expm_dense"],
                                   cap_ds["expm_dense_last"])),
             "ruiz": small_sp["ruiz"],
             "admm_dense": dict(small=small_sp["admm_dense"],
                                warm=warm_sp["admm_dense"]),
             "admm_wide": dict(small=small_cd["admm_dense"],
                               warm=warm_cd["admm_dense"]),
             "admm_large": dict(small=small_mk["admm_dense"],
                                warm=warm_mk["admm_dense"]),
             "admm_pair": dict(small=small_ds["admm_dense"],
                               warm=as_pair(warm_ds["admm_dense"]),
                               large_calls=dict(
                                   sparse=cap_sp["admm_dense"],
                                   sparse_mixedk6=cap_mk["admm_dense"])),
             "banded_chol": dict(small=small_sp["banded_chol"],
                                 factor=cap_sp["factor_inv_banded"])}
    for kname in ("ruiz", "banded_chol", "admm_dense"):
        cap[kname] = cap_sp[kname]
    # the dense ADMM kernel's wide build at the condensed fleet's shapes
    cap["admm_wide"] = cap_cd["admm_dense"]
    # its large build at the mixedk6 sparse fleet's (and, below, the sparse
    # decoupled fleet's), and its pair build at the sparse decoupled
    # fleet's, which no path runs now that the large block holds it
    cap["admm_large"] = cap_mk["admm_dense"]
    cap["admm_pair"] = as_pair(cap_ds["admm_dense"])
    require(cap["expm_dense"][0][0].shape == (1, 15, 19, 19)
            and extra["expm_dense"]["decoupled"][0][0].shape
            == (1, 30, 17, 17), "the unbatched route's dense stacks")

    def log_check(kname, r, **more):
        shown = ("err", "ms", "plain_ms", "library_ms", "bound_ms")
        log(phase="kernel_check", name=kname,
            tpu_kernel=KERNEL_META[kname][1],
            ptxas=regs.get(KERNEL_META[kname][0].rsplit("/", 1)[-1]),
            max_abs_err=r["err"],
            kernel_ms=r["ms"], plain_ms=r["plain_ms"],
            library_ms=r["library_ms"], bound_ms=r["bound_ms"], **more,
            **{k: v for k, v in r.items() if k not in shown})

    results, second = {}, {}
    for kname, (src, tpu, fn) in KERNEL_META.items():
        args, kw = cap[kname]
        results[kname] = fn(torch, args, kw, extra.get(kname, small.get(kname)))
        log_check(kname, results[kname])
        if kname in cap_dec:
            # the same kernel at the decoupled fleet's shapes: vanloan at
            # n=4, T=30; the solver kernels at n=30, m=180
            second[kname] = fn(torch, *cap_dec[kname])
            log_check(kname, second[kname], path="fleet_decoupled")
        if kname == "vanloan":
            # the structured exponential at the sparse fleet's shapes
            second["vanloan_sparse"] = fn(torch, *cap_sp["vanloan"])
            log_check(kname, second["vanloan_sparse"], path="fleet_sparse")
    # the Ruiz kernel (its diagonal input the row maxima of |P|) at the
    # condensed fleet's shapes
    second["ruiz_condensed"] = check_ruiz(torch, *cap_cd["ruiz"],
                                          small_cd["ruiz"])
    log_check("ruiz", second["ruiz_condensed"], path="fleet_condensed")
    # and at the sparse decoupled fleet's, A (2048, 395, 245)
    second["ruiz_decoupled_sparse"] = check_ruiz(torch, *cap_ds["ruiz"],
                                                 small_ds["ruiz"])
    log_check("ruiz", second["ruiz_decoupled_sparse"],
              path="fleet_decoupled_sparse")
    # the dense ADMM kernel's large build on the sparse decoupled fleet's
    # segments, its path's build (n = 245, "highest")
    second["admm_large_decoupled_sparse"] = check_admm_dense(
        torch, *cap_ds["admm_dense"], dict(small=small_ds["admm_dense"],
                                           warm=warm_ds["admm_dense"]))
    log_check("admm_large", second["admm_large_decoupled_sparse"],
              path="fleet_decoupled_sparse")
    # the wide build at tile 1, B = 1, as the unbatched condensed route
    # launches it
    second["admm_wide_simulate_condensed"] = check_admm_dense_tile1(
        torch, sim_cd)
    log_check("admm_wide", second["admm_wide_simulate_condensed"],
              path="simulate_condensed")
    # the dense ADMM kernel's other modes, on both hard fleets' segments
    m_eq = {f: int(np.asarray(mpc._eq_rows_for(fleet_config(f))).size)
            for f in ("sparse", "condensed")}
    require(m_eq == {"sparse": 128, "condensed": 38},
            f"the layouts' leading equality rows {m_eq}")
    modes = check_admm_dense_modes(torch, {
        "sparse": (cap_sp["admm_dense"], warm_sp["admm_dense"],
                   m_eq["sparse"]),
        "condensed": (cap_cd["admm_dense"], warm_cd["admm_dense"],
                      m_eq["condensed"])})
    del cap, cap_dec, small, extra, cap_sp, small_sp, warm_sp
    del cap_cd, small_cd, warm_cd, sim_cd, cap_mk, small_mk, warm_mk
    del cap_ds, warm_ds, small_ds

    # ---- kernel checks at the wall fleets' shapes -------------------------
    # their cold and warm steps' calls (B8 narrow at n = 208, m = 335 and
    # B7 at block width 14 on the sparse QP, B8 wide at n = 118, m = 245
    # with its dense P on the condensed QP, B2 and B3 at m = 139 on the
    # soft QP, B1 and B9 on each) and the 12-stage horizon's
    cap_sw, warm_sw = timed("sparse_walls_cold_warm", capture_cold_warm,
                            "sparse_walls")
    small_sw = timed("sparse_walls_small", capture_fleet, "sparse_walls",
                     B_SMALL, HZ_SMALL)
    cap_cw, warm_cw = timed("condensed_walls_cold_warm", capture_cold_warm,
                            "condensed_walls")
    small_cw = timed("condensed_walls_small", capture_fleet,
                     "condensed_walls", B_SMALL, HZ_SMALL)
    cap_fw = timed("coupled_walls", capture_fleet, "coupled_walls")
    require(cap_sw["admm_dense"][0][1].shape == (B_SPARSE, 335, 208)
            and cap_sw["admm_dense"][1]["pattern"].build == "narrow"
            and cap_sw["banded_chol"][0][0].shape == (B_SPARSE, 16, 14, 14)
            and cap_cw["admm_dense"][0][1].shape == (B_SPARSE, 245, 118)
            and cap_cw["admm_dense"][1]["dense_P"]
            and cap_cw["admm_dense"][1]["pattern"].build == "wide"
            and cap_fw["admm_iterations"][0][1].shape[:2] == (139, 30)
            and cap_fw["vanloan"][0][0].shape[:2] == (B_FLEET, 15),
            "the wall fleets' QP sizes, stage blocks and B8 builds")
    wall_checks = [
        ("vanloan", name, lambda c=c: check_vanloan(torch, *c["vanloan"]))
        for name, c in (("sparse_walls", cap_sw),
                        ("condensed_walls", cap_cw),
                        ("coupled_walls", cap_fw))] + [
        ("chol_inverse", "coupled_walls",
         lambda: check_chol_inverse(torch, *cap_fw["chol_inverse"])),
        ("admm_iterations", "coupled_walls",
         lambda: check_admm(torch, *cap_fw["admm_iterations"])),
        ("ruiz", "sparse_walls",
         lambda: check_ruiz(torch, *cap_sw["ruiz"], small_sw["ruiz"])),
        ("ruiz", "condensed_walls",
         lambda: check_ruiz(torch, *cap_cw["ruiz"], small_cw["ruiz"])),
        ("banded_chol", "sparse_walls",
         lambda: check_banded_chol(torch, *cap_sw["banded_chol"], dict(
             small=small_sw["banded_chol"],
             factor=cap_sw["factor_inv_banded"]))),
        ("admm_dense", "sparse_walls",
         lambda: check_admm_dense(torch, *cap_sw["admm_dense"], dict(
             small=small_sw["admm_dense"], warm=warm_sw["admm_dense"]))),
        ("admm_wide", "condensed_walls",
         lambda: check_admm_dense(torch, *cap_cw["admm_dense"], dict(
             small=small_cw["admm_dense"], warm=warm_cw["admm_dense"])))]
    for kname, name, check in wall_checks:
        second[f"{kname}_{name}"] = check()
        log_check(kname, second[f"{kname}_{name}"], path=f"fleet_{name}")
    del cap_sw, warm_sw, small_sw, cap_cw, warm_cw, small_cw, cap_fw
    del wall_checks

    # ---- path: the coupled fleet ------------------------------------------
    launches, builds, fleet_warm_ms = {}, {}, {}

    def fleet_phase(formulation, phase, B=B_FLEET):
        kernels.reset_launches()
        recs, st = run_fleet(torch, B, WARM_STEPS[formulation], kernels,
                             formulation)
        launches[phase] = kernels.launches()
        builds[phase] = {k: kernels.launches_by(k) for k in B8_KERNELS}
        warm_ms = [r["ms"] for r in recs[1:]]
        fleet_warm_ms[phase] = float(np.median(warm_ms))
        last = recs[-1]
        witness = None
        if formulation in WITNESS_FLEETS:
            witness = convergence_witness(torch, st)
        log(phase=phase, batch=B, cold_ms=recs[0]["ms"],
            warm_ms_median=float(np.median(warm_ms)),
            solves_per_s=B / (float(np.median(warm_ms)) / 1e3),
            iters_mean_last=last["iters"], converged_last=last["conv"],
            launches=launches[phase], b8_builds=builds[phase],
            convergence_witness=witness, steps=recs)
        if witness is None:
            require(last["conv"] >= 0.99,
                    f"converged fraction {last['conv']}")
        else:
            # every convergence the kernel reports holds in float64, and
            # its share is no lower than its plain version's
            kern = witness["kernel"]
            require(kern["verified"] == kern["reported"]
                    and kern["verified"] >= witness["plain"]["verified"]
                    - CONV_WITNESS_SLACK and last["conv"] > 0.0,
                    f"{phase}: converged {witness}, last step "
                    f"{last['conv']}")
        if formulation in PATH_B8_BUILD:
            # every launch of the dense ADMM kernel was the path's build
            b8, tag = PATH_B8_BUILD[formulation]
            require(builds[phase] == b8_builds(b8, tag,
                                               launches[phase][b8]),
                    f"{phase}: B8 builds {builds[phase]}")
        if formulation == "sparse":
            require(all(r["launches"] == SPARSE_STEP_LAUNCHES for r in recs),
                    f"sparse step launches {[r['launches'] for r in recs]}")
        if formulation == "decoupled_sparse":
            # the two exponential stacks and Ruiz once, B8's large build
            # once per segment of the budget (fewer only on a step where
            # every vehicle converged)
            n_seg = SPARSE_SOLVER["max_iter"] // SPARSE_SOLVER["check_every"]
            require(all({k: r["launches"].get(k) for k in
                         DECOUPLED_SPARSE_STEP_LAUNCHES}
                        == DECOUPLED_SPARSE_STEP_LAUNCHES
                        and 1 <= r["launches"]["admm_large"] <= n_seg
                        and (r["launches"]["admm_large"] == n_seg
                             or r["conv"] == 1) for r in recs),
                    f"{phase} step launches {[r['launches'] for r in recs]}")
        if formulation in ("condensed", "sparse_mixedk6", "sparse_walls",
                           "condensed_walls"):
            # vanloan and ruiz once, B8 once per segment of the
            # budget: fewer only on a step where every vehicle converged;
            # the sparse QP's banded factor once per factorization (the
            # first and each refactor before a segment)
            n_seg = SPARSE_SOLVER["max_iter"] // SPARSE_SOLVER["check_every"]
            segs = [r["launches"].get(PATH_B8_BUILD[formulation][0], 0)
                    for r in recs]
            chol = [r["launches"].get("banded_chol", 0) for r in recs]
            sparse = not formulation.startswith("condensed")
            require(all(r["launches"].get("vanloan") == 1
                        and r["launches"].get("ruiz") == 1
                        and 1 <= k <= n_seg and (k == n_seg or r["conv"] == 1)
                        and (1 <= f <= k if sparse else f == 0)
                        for r, k, f in zip(recs, segs, chol)),
                    f"{phase} step launches {[r['launches'] for r in recs]}")
        log(phase="profile", path=phase, batch=B, **profile_step(torch, st))

    fleet_phase("coupled", "fleet")
    # ---- path: the decoupled fleet ----------------------------------------
    fleet_phase("decoupled", "fleet_decoupled")
    # ---- path: the sparse coupled fleet -----------------------------------
    fleet_phase("sparse", "fleet_sparse", B_SPARSE)
    # ---- path: the sparse fleet in mode "mixedk6" -------------------------
    fleet_phase("sparse_mixedk6", "fleet_sparse_mixedk6", B_SPARSE)
    # ---- path: the hard condensed coupled fleet ---------------------------
    fleet_phase("condensed", "fleet_condensed", B_SPARSE)
    # ---- path: the sparse decoupled fleet ---------------------------------
    fleet_phase("decoupled_sparse", "fleet_decoupled_sparse", B_SPARSE)
    # ---- paths: the wall fleets (the reference's both_walls) --------------
    fleet_phase("sparse_walls", "fleet_sparse_walls", B_SPARSE)
    fleet_phase("condensed_walls", "fleet_condensed_walls", B_SPARSE)
    fleet_phase("coupled_walls", "fleet_walls")
    # ---- path: the sparse wall fleet's step with "expm_split" -------------
    rec, split_calls = run_expm_split(torch, kernels)
    launches["fleet_sparse_walls_expm_split"] = rec.pop("launches")
    builds["fleet_sparse_walls_expm_split"] = rec.pop("b8_builds")
    log(phase="fleet_sparse_walls_expm_split", **rec)
    for name, (a, kw) in zip(("zoh", "foh"), split_calls):
        # linearize_affine_zoh / _foh call expm_dense(M) at its defaults
        second[f"expm_dense_expm_split_{name}"] = expm_case(
            torch, a[0], kw.get("squarings", 8), kw.get("order", 8), (10, 3))
        log_check("expm_dense", second[f"expm_dense_expm_split_{name}"],
                  path=f"expm_split_{name}")
    del split_calls

    # ---- path: the unbatched closed loop ----------------------------------
    sim_logs = {}
    launches["simulate"] = dict.fromkeys(KERNEL_META, 0)
    for formulation in ("coupled", "decoupled"):
        rec, sim_logs[formulation], prof = run_simulate(torch, kernels,
                                                        formulation)
        for k, v in rec["launches"].items():
            launches["simulate"][k] += v
        log(phase="simulate", **rec)
        log(phase="profile", path="simulate", formulation=formulation,
            batch=1, **prof)
    # the hard condensed QP's unbatched route: the dense ADMM kernel at
    # tile 1, once per solver segment
    rec, sim_logs["condensed"], prof = run_simulate(
        torch, kernels, "condensed", SIM_STEPS_CONDENSED)
    launches["simulate_condensed"] = rec["launches"]
    builds["simulate_condensed"] = rec["b8_builds"]
    log(phase="simulate", **rec)
    log(phase="profile", path="simulate", formulation="condensed", batch=1,
        **prof)
    # the sparse decoupled QP's unbatched route (the runtime's path
    # controller): the default solver in plain PyTorch, both exponential
    # stacks of a step on the dense expm kernel
    rec, sim_logs["decoupled_sparse"], prof = run_simulate(
        torch, kernels, "decoupled_sparse", SIM_STEPS_DECOUPLED_SPARSE)
    launches["simulate_decoupled_sparse"] = rec["launches"]
    log(phase="simulate", **rec)
    log(phase="profile", path="simulate", formulation="decoupled_sparse",
        batch=1, **prof)
    # the reference-faithful closed loop (the parity harness's faithful
    # controller): the RK4 linearization and the plain solver, no kernel;
    # not profiled (its 10,000-iteration solves)
    rec, sim_logs["faithful"], _ = run_simulate(
        torch, kernels, "faithful", SIM_STEPS_FAITHFUL, profile_steps=0)
    launches["simulate_faithful"] = rec["launches"]
    log(phase="simulate", **rec)

    # ---- path: the Monte-Carlo safety study ------------------------------
    mc_rec, mc_ctx = run_montecarlo(torch, kernels)
    launches["montecarlo"] = mc_rec.pop("launches")
    log(phase="montecarlo", **mc_rec)
    log(phase="profile", path="montecarlo", batch=B_MC, **mc_ctx["profile"])
    # the Cholesky inverse after a refactor, and the last ADMM segment, of
    # a Monte-Carlo step with active HJI rows
    for kname in ("chol_inverse", "admm_iterations"):
        args, kw = mc_ctx["capture"][kname]
        second[f"{kname}_montecarlo"] = KERNEL_META[kname][2](torch, args,
                                                              kw)
        log_check(kname, second[f"{kname}_montecarlo"], path="montecarlo",
                  step=mc_rec["capture_step"])
    del mc_ctx["capture"]

    # ---- path: the real-time controller runtime --------------------------
    t0 = time.perf_counter()
    rt_rec, rt_ctx = run_runtime(torch, kernels, mc_ctx["cache"])
    launches["runtime"] = rt_rec.pop("launches")
    rt_prof = rt_rec.pop("profile")
    log(phase="runtime", seconds=time.perf_counter() - t0, nvidia_smi=smi,
        **rt_rec)
    for mode, prof in rt_prof.items():
        log(phase="profile", path="runtime", mode=mode, batch=1, **prof)
    # the dense exponential on the calls of a period of each mode
    for call, r in check_runtime_expm(torch, rt_ctx.pop("captures")).items():
        second[f"expm_dense_{call}"] = r
        log_check("expm_dense", r, path=call)
    t0 = time.perf_counter()
    rec = reference_runtime(torch, rt_ctx, mc_ctx["cache"])
    log(phase="reference_runtime", seconds=time.perf_counter() - t0, **rec)
    del rt_ctx

    # ---- the HJI value-iteration solver ----------------------------------
    before = kernels.launches()
    t0 = time.perf_counter()
    rec = run_hji_solve(torch, mc_ctx["x_rel"])
    require(kernels.launches() == before,
            "hji_solve launched a kernel of another path")
    log(phase="hji_solve", seconds=time.perf_counter() - t0, nvidia_smi=smi,
        **rec)

    # ---- the scale-out paths (one-rank NCCL world), the rollout scan and
    # the HJI slice; then the profiler's phase split -----------------------
    t0 = time.perf_counter()
    rec, mesh_launches = run_mesh(torch, kernels, mc_ctx["cache"])
    launches.update(mesh_launches)
    log(phase="mesh", seconds=time.perf_counter() - t0, nvidia_smi=smi,
        launches=mesh_launches, **rec)
    t0 = time.perf_counter()
    rec = run_profile_phases(torch, fleet_warm_ms)
    log(phase="profile_phases", seconds=time.perf_counter() - t0,
        nvidia_smi=smi, **rec)

    main_launches = {k: sum(per[k] for per in launches.values())
                     for k in KERNEL_META}
    # every kernel of a path (the pair build is on none: its kernel check
    # above drives it)
    require(all(main_launches[k] > 0
                for k in set().union(*PATH_KERNELS.values())),
            main_launches)

    # ---- reference checks -------------------------------------------------
    for formulation in ("coupled", "decoupled", "sparse", "condensed",
                        "sparse_mixedk6", "decoupled_sparse",
                        "sparse_walls", "condensed_walls", "coupled_walls"):
        t0 = time.perf_counter()
        rec = reference_check(torch, formulation)
        log(phase="reference", formulation=formulation, batch=B_REF,
            seconds=time.perf_counter() - t0, **rec)
    for bulk in LADDER_BULKS:
        t0 = time.perf_counter()
        rec = ladder_check(torch, kernels, bulk)
        log(phase="reference_ladder", seconds=time.perf_counter() - t0,
            **rec)
    for formulation, sim_log in sim_logs.items():
        log(phase="reference_simulate",
            **simulate_reference_check(torch, formulation, sim_log))
    # active HJI rows on the coupled steps, and the Monte-Carlo rollout
    for formulation in ("coupled", "sparse", "condensed"):
        t0 = time.perf_counter()
        rec = reference_check(torch, formulation, cache=mc_ctx["cache"])
        log(phase="reference_active", formulation=formulation, batch=B_REF,
            cache=MC_CACHE, seconds=time.perf_counter() - t0, **rec)
    t0 = time.perf_counter()
    rec = reference_montecarlo(torch, mc_ctx)
    log(phase="reference_montecarlo", seconds=time.perf_counter() - t0,
        **rec)
    del mc_ctx

    # ---- B=1 latency ------------------------------------------------------
    recs1, st1 = run_fleet(torch, 1, B1_STEPS, kernels)
    log(phase="latency_b1", cold_ms=recs1[0]["ms"],
        warm_ms_median=float(np.median([r["ms"] for r in recs1[1:]])),
        converged_last=recs1[-1]["conv"])
    log(phase="profile", path="latency_b1", batch=1,
        **profile_step(torch, st1))

    def entry(k):
        r = results[k]
        out = dict(name=k, route="cuda", source=KERNEL_META[k][0],
                   replaces=KERNEL_META[k][1], launches=main_launches[k],
                   max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
                   bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                   library_ms=r["library_ms"], shapes=r["shapes"],
                   launches_by_path={ph: per[k]
                                     for ph, per in launches.items()})
        others = dict(fleet_decoupled=second.get(k),
                      fleet_sparse=second.get(f"{k}_sparse"),
                      fleet_condensed=second.get(f"{k}_condensed"),
                      fleet_decoupled_sparse=second.get(
                          f"{k}_decoupled_sparse"),
                      decoupled_sparse_zoh=r.get("decoupled_sparse_zoh"),
                      decoupled_sparse_foh=r.get("decoupled_sparse_foh"),
                      simulate_condensed=second.get(
                          f"{k}_simulate_condensed"),
                      montecarlo=second.get(f"{k}_montecarlo"),
                      **{name[len(k) + 1:]: o for name, o in second.items()
                         if name.startswith(f"{k}_runtime_")},
                      decoupled_step=r.get("decoupled_step"),
                      fleet_stack=r.get("fleet_stack"),
                      **{f"fleet_{w}" if "walls" in w else w:
                         second.get(f"{k}_{w}") for w in WALL_CHECKS})
        keys = ("shapes", "err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
        out["other_shapes"] = {name: {q: o[q] for q in keys}
                               for name, o in others.items() if o}
        if k in B8_KERNELS:
            out["launches_by_build"] = {ph: b[k] for ph, b in builds.items()}
            out["modes"] = {name: {q: o[q] for q in keys + (
                "registers", "smem_bytes", "iters_mean", "waves")}
                for name, o in modes.items()
                if o["build"] == B8_BUILD_OF[k]}
        return out

    print(json.dumps({"kernels": [entry(k) for k in KERNEL_META]}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
