#!/usr/bin/env python3
"""Chip check of the PyTorch + CUDA port: the scale solve on one GPU.

    python3 chip_smoke.py [--profile-refinement]

Phases (any failed check exits non-zero, before the result line):
  1. card and build: the card's name and power limit (nvidia-smi), then the
     CUDA kernels built from csrc/ with nvcc (sm_90a);
  2. each kernel (K3 camera gather, K2 fused assembly, K1 Schur matvec)
     against its plain PyTorch version at the main-path shapes (100,352
     points incl. padding, 500 images, 12 views, G = 10): K3 exactly, K1
     and K2 within a scaled error of 2e-4 (the reference's f32 kernel
     tolerance), K2 also through finish_reduction; 50 repeat runs of K1 and
     5 of K2 must give identical bits (deterministic reductions, and every
     barrier of the shared-memory ring in place); each kernel's time is
     the device time of its launches under torch.profiler
     (measure.device_ms: no launch gap, no host; K1 and K2 also kernel by
     kernel; each profile held to the launches it must hold, the
     wrappers' launch counts or a stated count per call, and raising after
     3 short ones), K1 and K3 also with the L2 flushed before each launch,
     beside the time per call between CUDA events around back-to-back
     calls (for K3 that reads the host: the kernel is shorter than its
     wrapper); for K3 the device time of the one PyTorch call for the same
     gather; the SHA-256 digest of the synthetic problem
     (`synthetic.digest`), so that two runs can be compared;
  3. the LM phase (parallel/lm.py) from synthetic.build_problem(seed=0),
     entirely through the kernels: launch counters reset before and read
     after, each must be > 0; Omega must drop and sigma0 = sqrt(Omega/dof)
     must land within 1% of the injected 5e-4 (on failure the same phase
     runs through the plain path to tell kernel from slice);
  4. the steady-state fixed-CG step (8 CG iterations, tol 0) through the
     kernels and through the plain path, timed in turns; then three steps
     under torch.profiler (device busy and idle share, launches, the
     largest kernels); with --profile-refinement the undamped refinement
     of phase 5 runs once more under the profiler, likewise (seconds of
     profiler bookkeeping for its ~36,000 launches, so not by default);
  5. convergence: from phase 3's end state, mixed-precision refinement
     (parallel/refine.py `converge`: cg_tol 1e-12, cg_maxiter 800,
     stall_limit 300, at most 15 steps) through K1-K3, the f64 gradient in
     plain PyTorch on the GPU, run twice: with the bench's damping 1e-7,
     recorded over its first 5 steps, and undamped, which must reach
     max|dx| <= 1e-6 (at this
     size the bench's damping limits the contraction to ~2/3 per step, see
     refine.py).  For each run the launch counters are reset before and
     read after, each > 0; the f64 Omega of the refinement's own objective
     (the f32-rounded observations) at the refined state must be <= its
     value at phase 3's state x (1 + 1e-9) and sigma0 within 1% of 5e-4.
     time_to_converged_s = phase 3's seconds + the undamped refinement's
     (a run that fails a check runs again through the plain path);
  6. the matvec roofline (measure.py) on the lean rows at phase 3's state:
     K4 (read floor) against its plain version, each entry within 1e-6 of
     the sum of |values| it folds, and the device time of the one PyTorch
     call for the same fold (a sum over the zero-padded prefix); each cut K1 stage within a scaled error
     of 2e-4, the full stage equal to K1 bit for bit; then with the
     counters reset, K4, every stage and K1 timed over 20 warm runs (CUDA
     events; then once more for their device time), GB/s
     on the rows read and on the padded count, and matvec_vs_read_floor;
     the floor must not be slower than K1;
  7. covariance (parallel/cov_direct.py `cov_all`: linearise at damping 0,
     dense reduced system, Cholesky inverse, every point's 3x3 block) on
     the point-major problem at phase 3's end state.  The f64 run is the
     gate: the Cholesky succeeds; S agrees with a second assembly route
     (per-image sums and the Schur correction as dense products of
     per-point coupling columns, built from the Jacobian rows with none
     of cov_direct's helpers) within a Jacobi-scaled 1e-9; the
     Jacobi-scaled residual max|D^-1 S Q D - I| <= 1e-8 (D = sqrt(diag
     S)); the camera blocks equal Q's 6x6 diagonal blocks; 8 points (6
     random free, one datum, one padded dummy) from the all-points run
     and selected (block gathers) agree within 1e-6 of each block's
     largest entry with an LU route (C_p from the same coupling columns,
     X = solve(S, C_p), Qpp = Hpp^-1 + C_p^T X); the block-gather
     recovery of all points agrees with the dense panels likewise, and
     cov_all's cold and warm calls with the staged run; every free
     point's diagonal is finite and > 0.
     The f32 run checks K3 on the point-major layout exactly against its
     plain gather, then goes through K3 (launches > 0) and is recorded:
     its Cholesky status, where f32 loses S (the Jacobi-scaled assembly
     error and smallest eigenvalue of the f32 S; the Cholesky of the f64 S
     rounded to f32) and, if it factorises, the relative error of the free
     points' diagonal entries against f64.  Times: cov_all_points_s is the
     mean of 3 warm `cov_all` calls after a cold one, each between CUDA
     events; the stage split (linearise / assemble base / corrections /
     inverse / recovery) comes from 3 stage-by-stage runs, and both
     recoveries of all points (block gathers, cov_all's; dense panels,
     the reference) are timed apart.
  8. the free network (parallel/freenet.py, solver.py, refine.py with
     extras) at the same size: phase 2's problem re-dressed by
     synthetic.free_network (every coordinate of the 100,000 true points
     free, 8 scale bars of weight 1e6 at the true distance + N(0, 5e-7^2),
     the six-defect inner-constraint datum over all true points).  First
     one LM step at the start state (damping 1e-2, cg_tol 1e-7), f32
     through K3 / K2 / K1 against the plain path on the card and both
     against the plain f64 step on the f32-rounded problem: an f32 step
     lies ~1e-3 (scaled) from the f64 step, its rounding amplified by the
     solve, so dxp, dxc, dxg of the kernels must lie within that distance
     of the plain f32 step's (or within 2e-4, the kernels' own tolerance,
     if that is larger), and no further than twice that distance from the
     f64 step; run twice: equal bits.  The same
     for a second problem with a 30-row populated direct group and
     diagonal dp / de / dg observations on the fixed-coordinate datum
     (d = 0).  Then, with the counters reset, `solver.solve` (f32,
     damping 1e-2, through the kernels by default; its tolerance is the
     f32 floor 1e-3, since the dtype-scaled default 3.45e-4 lies under the
     floor of an f32 step here) and `refine.converge` with extras, undamped
     (the gate: max|dx| <= 1e-6) and with the Refiner's default damping
     1e-8 (recorded); the solve's preconditioner per step (the coupled one
     where its global Schur complement is definite, else block Jacobi) is
     printed, here and in phases 10, 11 and 15.  Gates: K1, K2 and K3
     launched; sigma0 =
     sqrt(Omega / dof) within 1% of 5e-4 with dof = 2 N_true - (3 P_true +
     6 M + G) + d + bars; the f64 Omega at the refined state not above the
     f32 phase's end; every bar's refined length within 5 sigma (2.5e-6)
     of its observed length; one more f32 step at the f32 phase's end:
     max|B dxp| <= 1e-6 max|dxp| (the sums in f64).  Recorded: steps,
     accepted / rejected, CG iterations per step, seconds of both parts,
     the set-up time of the extras per step (prepare_extras +
     wrap_precond, CUDA events), and the launches and device time of one
     CG iteration with and without the extras (torch.profiler, 16 against
     8 iterations).
  9. the reference API in float64 (no launch of K1 to K4: they take f32;
     the scale class's per-image sums go through the image-sum kernel):
     testing.make_synthetic_scene(1000 points, 200 images, noise = sigma =
     5e-4, perturb 0.01, seed 0) with its distortion model and one scale
     bar, through `BundleAdjustment` on its default device (CUDA) in
     REDUCED, FULL and PRE_ELIMINATION (two runs each from the same start)
     and `ScaleBundleAdjustment` (once).  Gates: ERROR_FREE_ESTIMATION;
     sigma0 a-posteriori / a-priori within 1% of 1; REDUCED and
     PRE_ELIMINATION against FULL on coordinates (rtol 1e-5, atol 1e-9)
     and on the points' cofactor blocks (rtol 2e-4, atol 1e-9 of max|Q|);
     the scale class against the dense REDUCED estimate (coordinates rtol
     1e-8 / atol 1e-10, Omega and sigma0^2 rtol 1e-8, Q rtol 1e-4 / atol
     1e-6 of max|Q|); the same code on the CPU and on the card for the
     scene cut to 100 points / 20 images within 1e-9 (relative sigma0,
     coordinates of the field size); no kernel launched.  Printed: n, u,
     d, dof, iterations, sigma0, the seconds of each estimate_model (CUDA
     events), compile_problem's host seconds, peak memory, and the
     per-iteration split at the estimate (assembly, LU solve, EO
     reduction, reduced and full inverse; CUDA events, 3 warm calls).
  10. the multi-camera rig: synthetic.build_problem(100,000, 500, 12,
     num_cameras=4) (image m on camera m % 4; G = 40), the compact layout
     on the plain path (K1 to K4 take one camera: none launched, and the
     image-sum kernel launched, gated).  (i) the image-sum kernel at the
     rig's product call (16 f64 rows of N on the rig's layout) against its
     plain model bit for bit and twice, and against the stack path it
     replaced within 1e-12 of the largest sum (gated); printed: its device
     time and time per call between CUDA events, its byte bound
     (measure.image_sum_work) and share, the plain model's and the stack
     path's (library_ms) times between CUDA events; the phase's launch
     counts start after (i).  (a) one f64 `lm_step`
     (damping 1e-4, cg_tol 1e-13) with the compact rows against the same
     step on the masked rows of `materialize_global_rows` through the
     single-camera code path, rtol
     3e-4 / atol 1e-6 of max (tests/test_multi_camera.py's), and the f32
     compact step twice, bit for bit; (b) `solver.solve` (f32, plain,
     tolerance 1e-3, at most 30 steps), the definiteness of the coupled
     preconditioner's global Schur complement there, then
     `refine.converge` undamped with the Refiner's own route
     (``use_kernels=None``: the plain compact rows), with block Jacobi (at
     most 15 steps: the rig's route, gated) and with the default coupled
     preconditioner (at most 5 steps, recorded), each followed by one f64
     Gauss-Newton step that shows how far its end lies from the optimum:
     the f32 inner solve does not hold the rig's weakest mode, so the
     Refiner runs a rig's inner solve in f64; the block-Jacobi run must
     converge with at least one f64 step, and a run that reports
     convergence must lie within 1e-5 of the optimum (gated); its
     cross-check is `solver.solve` in f64 from
     the f32 end (Gauss-Newton, cg_tol 1e-10) to max|dx| <= 1e-6, sigma0
     within 1% of 5e-4, the f64 Omega not above the f32 end's, each
     camera's principal distance closest to its own true value, and the
     refined state within 1e-5 of its end (gated; on the refinement's
     f32-rounded observations); time_to_converged_s =
     the f32 solve's and the block-Jacobi refinement's seconds; one f64
     step's device-idle share; (c) `cov_all` in
     f64 (u = 3,040): S against the second assembly route within a
     Jacobi-scaled 1e-9, residual <= 1e-8; (d) `parallel/covariance.py`'s
     point, pair and camera blocks (4 each, f64, PCG tol 1e-10, the
     preconditioner that `covariance.prepare` picks) against cov_all /
     Qred within 1e-5 of each block's largest entry, with PCG iterations
     and seconds, and the point blocks once more with the coupled
     preconditioner (recorded); (e) `ScaleBundleAdjustment` against the dense
     `BundleAdjustment` (MatrixInversion.NONE) on a two-camera scene of
     BASELINE config 3's size (make_synthetic_scene(5000, 50) with its odd
     images on a second camera), coordinates within 1e-10 of the field,
     and the scale class on the CPU against the card at 300 / 10.
  11. the file-driven scale path: phase 2's network without its 352 dummy
     points written as the generic flat files (`synthetic.write_flat`, 17
     significant digits; 1,200,000 image rows); the image file parsed by
     the native loader (built with g++ into .kernels_build/) and by
     `parse_table_py`, gated equal (floats, keys, column counts), both
     host times printed; `io.columnar.build_rcs_problem` (f32, on the
     card, the true distortion) gated equal bit for bit, field by field
     and in the state, to the in-memory problem without the pads and with
     r0 = 0 (`synthetic.as_read_from_files`); `solver.solve` (f32, damping
     1e-2, tolerance 1e-3) on both: equal bits of the end state and the
     same steps, K1 / K2 / K3 launched during the file route's solve; a
     solve of 2 iterations with checkpoint_every = 2 leaves a checkpoint
     equal to its returned state bit for bit (100,000 points: no dummy
     points); `refine.converge` undamped from the file route's end:
     max|dx| <= 1e-6, the f64 Omega not above the f32 end's, sigma0 within
     1% of 5e-4 (r0 = 0 reparametrises the radial terms, the fit is
     phase 5's); one solve step under `tracing.device_trace`, whose Chrome
     trace must name matvec_kernel, prepare_kernel and cam_gather_kernel.
  12. the CLI and initialisation at the reference-API size: phase 9's
     scene (points renamed to at most 3 characters, so the CLI's datum is
     phase 9's: every point) written as AICON .obc/.scale/.ior/.eor/.phc
     (the .ior adds A3, free) and as an AICON plain-text report
     (`io.scene_files`); `python -m bundle_adjustment_tpu_torch flat|report
     ... --inversion reduced --export --export-mat` as subprocesses on the
     card: exit 0, the printed n, u, d, dof equal to an in-process
     `estimate_model` of the same files on the card, sigma0 within 1e-10
     relative, the .mat coordinates and cofactor diagonal within 1e-9 of
     the field / of the largest variance, and the cofactor diagonal equal
     bit for bit (the dense f64 assembly sums in a fixed order: two
     assemblies of one state in this process are gated equal too), .info
     and .cxx equal to the .mat to their printed digits;
     `flat --cpu` against the card within 1e-9; DLT `adjust` on 20
     noise-free images (card against CPU within 1e-9, the projection
     centre and principal point within 1e-6 and |c| within 1e-6 relative
     of the truth, tests/test_dlt.py's); `transformation.transform` of 20
     points through a reference image with the card's FULL Qxx against
     the same call on the CPU within 1e-9; no kernel launch (float64).
  13. the sharded paths (parallel/spmd_fm.py, tp.py, spmd.py on
     torch.distributed, plain path, float64) on phase 2's network at
     phase 3's start state, in spawned rank processes (multihost.run_ranks:
     a file:// store in .chipwork/, process groups with a 120 s limit, a
     rank that fails or a launch that does not end in 600 s fails the
     script): first world size 1 on NCCL, then 2 ranks sharing the card
     over gloo (NCCL takes one card per rank; gloo takes CUDA tensors for
     all_reduce and broadcast, so the communicator forms its gather and
     scatter from all_reduce).  (a) / (b) `spmd_fm` replicated and
     cam_shard, 3 steps each (damping 1e-4, cg_tol 1e-12), against
     `engine.lm_step` on the card (3 steps, in the world-size-1 process):
     the first step's CG count equal, omega0 rtol 1e-10, max_dx rtol 1e-7
     (tests/test_spmd.py:77-83); the state (points and eo within rtol
     1e-9 / atol 1e-11, io rtol 1e-9 / atol 1e-12, as that test) is held
     on one more step of each at cg_tol 1e-14 against the engine's step
     at 1e-14 (at 1e-12 the CG truncation at this size is of the state
     gates' own size; its ratio is recorded); equal bits to the engine at
     world size 1 are recorded; the ranks' replicated results equal bit
     for bit; omega
     falls over the 3 steps.  (c) `tp` on the damped reduced system of
     that network (u = 3,010, padded to 3,072, block 64): the factor
     against `torch.linalg.cholesky` of S on the CPU (LAPACK) within 1e-12
     Jacobi-scaled (rows over sqrt(diag S); against cuSOLVER's factor
     recorded: the two libraries' factors differ by ~1.2e-12 themselves),
     its backward error max|L L^T - S| Jacobi-scaled <= 1e-13, the
     solve against `rcs.pcg` at tol 1e-14 within 1e-7 of its largest
     entry, 8 cofactor columns against `torch.cholesky_inverse`
     within 1e-8 of their largest entry, every rank's S the same bits;
     times of the assembly, the factorisation (against
     `torch.linalg.cholesky`), the solve and the columns.  (d) `spmd`
     (observation-sharded Gauss-Newton on the block-layout engine, cg_tol
     1e-13) on the point-major rows against the engine's Gauss-Newton
     step: points and eo within 1e-9, max_dx rtol 1e-8, omega0 rtol 1e-10
     (tests/test_spmd.py:44-49).  (e) the same step on phase 15's network
     in file order (N = 1,252,000 rows, each rank's contiguous shard, no
     padding beyond a multiple of the ranks; built once and handed to the
     ranks as an .npz in .chipwork/) against `rcs.lm_step` on the card,
     with (d)'s gates; rows per rank, peak memory per rank and the bytes
     all-reduced per matvec printed; at world size 1 one f32 step through
     K3 (`use_kernels` None) equal bit for bit to the same step on the
     plain gather, K3 launched and K1 / K2 not (its K3 launches join the
     kernels line).  Wall time per step for each world size; no kernel
     launch in any rank but (e)'s f32 step through K3 (gated).
  14. the scenario fleets (parallel/scenario.py, JAX's route: the
     block-layout `rcs.lm_step` vmapped): synthetic.scenario_batch of 16
     networks of 5,000 points / 50 images / 12 views sharing one index
     structure (BASELINE config 3's network as config 5's fleet), and the
     file-order fleet of `synthetic.thin_scenarios`: 16 networks of 5,000
     points in all 50 images cut so that every 10th point keeps its 50
     views and the rest 12 (N = 79,000 rows against 250,000 padded; the
     layout rule must pick "file"); each in float64, one
     `scenario_lm_step` (damping 1e-4, cg_tol 1e-14) against `rcs.lm_step`
     on each network in turn: per scenario the state, max_dx and omega0
     within 1e-12 relative and the CG count within 3 of its own step's
     (the batched reductions sum in another order on the card, and a CG
     count near the floor follows the last bits; the equal counts are
     printed, and recorded: the same comparison at cg_tol 1e-12, and the
     gaps between the vmapped and the unbatched rg, block-Jacobi blocks
     and matvec of scenario 0); two batched runs equal bit for bit; no
     `torch.func.vmap` fallback warning ("batching rule"); the batched
     step's time against the 16 sequential steps' (each run twice, the
     first recorded apart); no kernel launch.
  15. a network of uneven visibility (the block-layout engine of
     parallel/rcs.py): `synthetic.thin_views` of build_problem(100,000,
     500, 64, seed=0): every 100th point keeps its 64 views, every other
     point its first 12 (N = 1,252,000 rows in file order, grouped by
     image; 6,400,000 padded point-major); the layout rule must pick
     "file"; the byte reckoning of 1,000 targets in all 500 images is
     printed, not run.  (a) f64 `solve` (cg_tol 1e-10) to its default
     tolerance on the file order (block-layout engine) and on the padded
     layout (`rcs.to_point_major`, feature-major engine): sigma0 within 1%
     of 5e-4, Omega rtol 1e-8 and coordinates within 1e-7 of the field
     across the two; rows, peak memory, s and CG per step, steps printed.
     (b) K3 on the file order equal to its plain version bit for bit; f32
     `solve` through K3 (damping 1e-2) to max|dx| <= 1e-3, K3 launched and
     K1 / K2 not; then f64 `solve` from its end within (a)'s gates.  (c)
     one f32 step five times: equal bits.  (d) 4 point and 2 camera
     covariance blocks on demand on the file order against the padded
     feature-major route within 1e-6 of each block's largest entry.  (e)
     the network written as flat files and read back by
     `build_rcs_problem` (layout None: must pick "file"), every field
     equal to the in-memory control bit for bit, and its f32 `solve`
     equal to the control's.  K3's launches of (b) and (e) join the
     kernels line.
  16. BASELINE config 5 on the card, nothing cut (bench.py's
     run_suite(1_000_000, 5_000, 12)): synthetic.build_problem(1,000,000,
     5,000, 12, seed=0), 1,000,448 points with the dummy points, N =
     12,005,376, G = 10, u = 30,010; the host seconds to build it and to
     reach the card (problem_to_torch, fm_problem, to_view_major).  K3,
     K2, K1 and K4 against their plain versions at these shapes with
     phase 2's gates (K3 exact; K1, K2 and K2 through finish_reduction
     within 2e-4 scaled; K4 within 1e-6 of the sum of |values|; 10 runs of
     K1 and 2 of K2 equal bit for bit), each kernel's and each plain
     version's ms per call between CUDA events (back to back).
     The LM phase through the kernels (sigma0 within 1% of 5e-4, launches
     > 0), the fixed-cg8 step through the kernels and the plain path in
     turns, the undamped refinement through the kernels (max|dx| <= 1e-6,
     the f64 Omega of its objective not above the LM phase's end) and
     time_to_converged_s.  Then `cov_direct.cov_all` in f64 at the
     refined state, a cold and a warm call, and the stage split of
     `cov_staged` with `torch.cuda.max_memory_allocated` after each stage.
     Gates: the Cholesky succeeds (`reduced_inverse` raises otherwise);
     the Jacobi-scaled residual max|D^-1 (S S^-1 - I)[:, cols] D| <= 1e-8
     on 512 sampled columns; 16 point blocks (the datum point 1, a free
     point that sees an image twice, a dummy, 13 free) from cov_all and
     selected within 1e-6 of each block's largest entry of the LU route;
     64 pair blocks among them within 1e-6 of the LU route (relative to
     the larger point block), and the 16 (p, p) pairs plus Hpp^-1 within
     1e-10 of the point blocks (a consistency check: both sides share
     `cov_direct`'s block gathers); the block-gather
     recovery and cov_all's blocks
     within 1e-10 of the dense panels on 4,096 sampled points (16 chunks
     of the dense chunk), whose times are extrapolated to all points; 6
     camera blocks equal Q's diagonal blocks; every free point's block
     symmetric and positive definite (a Cholesky of each on the card; the
     smallest eigenvalue in closed form, printed); cov_all cold and warm
     within 1e-6 of the staged run.  The problem's digest is printed, and
     each kernel's device time under the profiler beside its CUDA-event
     time (or the message where `measure.device_ms` raised on profiles
     short of launches).  The phase prints its seconds and fails
     above its stated budget (150 s); its launches join the kernels line, and each kernel
     entry gains a ``config5`` entry (events_ms and plain_events_ms: the
     times per call between CUDA events; device_ms; bound, share of the
     bound by the events time, launches).
  17. the port's example as a user runs it: `python
     examples/example_scale_torch.py 20000 100 8` as a process on the card
     (f32 `solve`, `refine.converge`, f64 `cov_all`; then the file-order
     network of `synthetic.thin_views` through the f32 and f64 `solve`
     and blocks on demand): exit 0, both parts at max|dx| <= 1e-6 with
     sigma0 within 1% of 5e-4.
Then one JSON line with the kernels (``launches`` summed over the runs of
phases 3, 5, 6, 7, 8, 11, 13 (e), 15 and 16, each between a reset and a
read of the counters; for the image-sum kernel, which is timed at the
rig's product call in phase 10 (i), over every phase's counts in
``launches_by_phase``, which leave out the check (i) itself;
``ms`` the device time, ``events_ms`` the time per call between CUDA events;
``bound_ms`` the least time an H100 SXM could take for the bytes and
operations of the call, measure.py, and ``share_of_bound`` = bound_ms / ms;
``library_ms`` where one PyTorch call computes the same function), and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

NUM_POINTS, NUM_IMAGES, VIEWS = 100_000, 500, 12
SIGMA = 5e-4
TOL_SCALED = 2e-4       # kernel vs plain, f32 (tests/test_pallas_prepare.py)
TOL_FLOOR = 1e-6        # K4 vs plain, per entry, of the sum of |values|
K1_REPEATS = 50         # repeat runs of K1 that must give the same bits
K2_REPEATS = 5          # and of K2
REFINE_TOL = 1e-6       # max|dx| the refinement must reach (bench.py)
BENCH_DAMPING = 1e-7    # the bench's refinement damping (bench.py:657)
TPU_SITES = {  # pallas_call of the TPU kernel each CUDA kernel replaces
    "cam_gather": "bundle_adjustment_tpu/parallel/kernels.py:312",
    "prepare_reduction": "bundle_adjustment_tpu/parallel/kernels.py:761",
    "schur_matvec": "bundle_adjustment_tpu/parallel/kernels.py:467",
    "read_floor": "bundle_adjustment_tpu/parallel/kernels.py:550",
    "matvec_stage": "tools/exp_tpu1.py:168, tools/exp_tpu2.py:158, "
                    "tools/exp_tpu2.py:238, tools/exp_tpu3.py:137, "
                    "tools/exp_tpu4.py:116",
    "image_sum": "none: XLA fuses the sum "
                 "(bundle_adjustment_tpu/parallel/engine.py:300)",
}
SOURCES = {
    "cam_gather": "bundle_adjustment_tpu_torch/csrc/cam_gather.cu",
    "prepare_reduction": "bundle_adjustment_tpu_torch/csrc/prepare_reduction.cu",
    "schur_matvec": "bundle_adjustment_tpu_torch/csrc/schur_matvec.cu",
    "read_floor": "bundle_adjustment_tpu_torch/csrc/read_floor.cu",
    "matvec_stage": "bundle_adjustment_tpu_torch/csrc/schur_matvec.cu",
    "image_sum": "bundle_adjustment_tpu_torch/csrc/image_sum.cu",
}
SOLVE_KERNELS = ("cam_gather", "prepare_reduction", "schur_matvec")
COV_S_TOL = 1e-9         # Jacobi-scaled max|S - S_ref|, f64 (two assemblies)
COV_RESIDUAL_TOL = 1e-8  # Jacobi-scaled max|D^-1 S Q D - I|, f64
COV_BLOCK_TOL = 1e-6     # point block vs another route, of its largest entry
COV_REPS = 3             # warm covariance calls timed after a cold one
PROFILE_REFINEMENT = "--profile-refinement"
BENCH_DAMPED_STEPS = 5   # steps of the recorded bench-damped refinement
FREE_BARS = 8            # scale bars of phase 8's free network
BAR_SIGMA = 5e-7         # their noise: SIGMA / sqrt(weight 1e6)
FREE_DEFECTS = 6         # its datum defect: 3 translations, 3 rotations
GROUP_ROWS = 30          # rows of the populated group of the second problem
F32_STOP = 1e-3          # max|dx| at which the f32 `solve` hands over
BDX_TOL = 1e-6           # max|B dxp| of an f32 step, of max|dxp|
# refinement damping of the free network: the gate, and the one recorded
FREE_REFINE_DAMPING = {"undamped": 0.0, "refiner_default": 1e-8}
FREE_REFINE_GATE = "undamped"
# phase 9: the reference API (scene model, dense f64 BundleAdjustment,
# ScaleBundleAdjustment) on testing.make_synthetic_scene
API_POINTS, API_IMAGES = 1000, 200
API_CUT = (100, 20)      # the scene of the CPU-against-card check
API_SIGMA0_TOL = 0.01    # sigma0 a-posteriori / a-priori within 1 % of 1
# tests/test_solver_synthetic.py::test_schur_modes_match_full (np.allclose);
# its absolute atol 1e-9 on Q is taken relative to max|Q| here: the LU and
# the Schur routes differ at the conditioning level, which grows with u
API_MODE_XYZ = dict(rtol=1e-5, atol=1e-9)
API_MODE_Q_RTOL, API_MODE_Q_ATOL = 2e-4, 1e-9   # atol of max|Q|
# tests/test_scale_driver.py::test_estimate_matches_dense
API_SCALE_XYZ = dict(rtol=1e-8, atol=1e-10)
API_SCALE_RTOL = 1e-8    # Omega and sigma0^2
API_SCALE_Q_RTOL, API_SCALE_Q_ATOL = 1e-4, 1e-6  # atol of max|Q|
API_CPU_TOL = 1e-9       # CPU against card: sigma0 and coordinates / field
API_TIMED = 3            # repeats of each stage of the per-iteration split
# phase 10: the multi-camera rig (the compact layout) at 100k / 500 / 12
RIG_CAMERAS = 4
RIG_DAMPING = 1e-4       # (a)'s step: tests/test_multi_camera.py's damping
RIG_CG_TOL = 1e-13       # (a)'s f64 steps, as that test
RIG_CG_MAXITER = 3000
# tests/test_multi_camera.py::test_compact_step_matches_rcs_16cam_rig
RIG_STEP_RTOL, RIG_STEP_ATOL = 3e-4, 1e-6      # atol of max|reference|
RIG_GN_CG_TOL = 1e-10    # CG of the f64 Gauss-Newton steps of (b)
RIG_REFINE_STEPS = 15    # steps of the rig's refinement (block Jacobi)
RIG_COUPLED_STEPS = 5    # steps of the recorded coupled refinement
RIG_FALSE_END = 10 * REFINE_TOL  # a converged refinement's f64 step, at most
RIG_COV_TOL = 1e-5       # on-demand blocks vs cov_all / Qred, of each max
RIG_COV_PCG_TOL = 1e-10
RIG_COV_K = 4            # points, pairs and images of the on-demand blocks
RIG_API = (5000, 50)     # BASELINE config 3: 5k points / 50 images
RIG_API_CUT = (300, 10)  # its cut for the CPU-against-card check
RIG_API_XYZ = 1e-10      # scale class vs dense, of the field's extent
RIG_IMAGE_SUM_F = 16     # the rows of the rig's product call: 6 + Gp
RIG_IMAGE_SUM_TOL = 1e-12  # image-sum kernel vs the stack path, f64
# phases 11-12: the file-driven entry points
ROOT = Path(__file__).resolve().parent
WORK = ROOT / ".chipwork"  # listed in .gitignore
CHECKPOINT_EVERY = 2       # iterations of the checkpointed solve
TRACE_KERNELS = ("matvec_kernel", "prepare_kernel", "cam_gather_kernel")
CLI_SIGMA0_RTOL = 1e-10    # CLI against the in-process estimate
CLI_RTOL = 1e-9            # .mat against in-process; --cpu against the card
DLT_IMAGES = 20
DLT_CPU_TOL = 1e-9         # DLT / transform on the card against the CPU
DLT_EO_ATOL = 1e-6         # tests/test_dlt.py: projection centre, x0, y0
DLT_C_RTOL = 1e-6          # and |c|
# phases 13-14: the sharded and scenario-batched paths (f64, plain path)
SHARD_DAMPING = 1e-4
SHARD_CG_TOL = 1e-12       # the steps whose CG counts, omega0, max_dx gate
# the step whose state is gated: at 100k the CG truncation at 1e-12 (times
# the conditioning) is already of the state gates' size, so the state is
# held at a CG converged well below them
SHARD_STATE_CG_TOL = 1e-14
SHARD_CG_MAXITER = 1000
SHARD_STEPS = 3            # steps of each sharded run (they must compose)
SHARD_MODES = ("replicated", "cam_shard")
SHARD_TIMEOUT = 120        # s, the process groups' limit per collective
SHARD_WAIT = 600           # s, the wait for all ranks of one launch
SHARD_THREADS = 4          # host threads per rank
# world size 1 on NCCL, then 2 ranks sharing the card over gloo (NCCL
# takes one card per rank)
SHARD_LAUNCHES = ((1, "cuda", "nccl"), (2, "cuda:0", "gloo"))
# tests/test_spmd.py:77-83: points and eo rtol 1e-9 / atol 1e-11, io rtol
# 1e-9 / atol 1e-12, omega0 rtol 1e-10, max_dx rtol 1e-7
SHARD_STATE_TOL = dict(points=dict(rtol=1e-9, atol=1e-11),
                       eo=dict(rtol=1e-9, atol=1e-11),
                       io=dict(rtol=1e-9, atol=1e-12))
SHARD_OMEGA_RTOL = 1e-10
SHARD_MAXDX_RTOL = 1e-7
TP_BLOCK = 64              # rows per block of the block-cyclic Cholesky
# the factor against torch.linalg.cholesky on the CPU (LAPACK) within 1e-12
# Jacobi-scaled (rows over sqrt(diag S)); against cuSOLVER's factor it is
# recorded (LAPACK and cuSOLVER differ by ~1.2e-12 themselves at u =
# 3,010, the rounding of two backward-stable factorisations times
# sqrt(cond)); the backward error max|L L^T - S| (Jacobi-scaled) <= 1e-13
TP_FACTOR_TOL = 1e-12
TP_BACKWARD_TOL = 1e-13
TP_PCG_TOL = 1e-14         # the PCG solve the direct solve is held to
TP_PCG_MAXITER = 3000
TP_SOLVE_TOL = 1e-7        # of the PCG solution's largest entry
TP_COLUMNS = 8             # cofactor columns vs torch.cholesky_inverse
TP_COLUMN_TOL = 1e-8       # of their largest entry
SPMD_CG_TOL = 1e-13        # tests/test_spmd.py:17-49: Gauss-Newton,
SPMD_ATOL = 1e-9           # points / eo atol 1e-9, max_dx rtol 1e-8
SPMD_MAXDX_RTOL = 1e-8
SPMD_F32 = dict(cg_tol=1e-6, cg_maxiter=100)  # (e)'s f32 step through K3
FLEET = (16, 5000, 50, 12)  # BASELINE config 3's network as config 5's fleet
# the file-order fleet: 5,000 points in all 50 images, cut so that every
# THIN_FLEET_EVERY-th point keeps its 50 views and the rest THIN_FLEET_KEEP
# (N = 79,000 against 250,000 padded)
THIN_FLEET = (16, 5000, 50, 50)
THIN_FLEET_KEEP = 12
THIN_FLEET_EVERY = 10
FLEET_CG_TOL = 1e-14
FLEET_CG_MAXITER = 1000
FLEET_TOL = 1e-12          # state, max_dx, omega0 against each own step
# CG iterations a scenario may differ by from its own engine step: the
# batched reductions (bmm for mm, other reduction orders) differ in the
# last bits, and the count of a CG run near its floor follows them
FLEET_CG_SLACK = 3
# phase 15: a network of uneven visibility at 100k / 500, cut from
# build_problem(100k, 500, 64): every UNEVEN_EVERY-th point keeps its 64
# views, every other point its first 12 (N = 1,252,000)
UNEVEN_VIEWS = 64
UNEVEN_KEEP = 12
UNEVEN_EVERY = 100
UNEVEN_REPEATS = 5         # f32 steps that must give the same bits
UNEVEN_OMEGA_RTOL = 1e-8   # tests/test_torch_solver.py: Omega rtol 1e-8,
UNEVEN_XYZ_TOL = 1e-7      # coordinates within 1e-7 of the field
UNEVEN_COV_POINTS = (0, 100, 1, 54321)  # two seen 64 times, two 12 times
UNEVEN_COV_IMAGES = (0, 250)
K2_ROW_BYTES = 312         # K2 reads 78 f32 rows per observation
# the f64 solves of (a) and (b) to `solve`'s default tolerance, with a CG
# that resolves the weakly determined directions: at the default cg_tol
# 1e-6 two starts end 5e-8 apart in Omega (the 2,000-point rehearsal)
UNEVEN_F64 = dict(cg_tol=1e-10, cg_maxiter=500)
# phase 16: BASELINE config 5 (bench.py's run_suite(1_000_000, 5_000, 12))
# on one card, nothing cut: 1,000,448 points with the dummy points
C5_SHAPE = (1_000_000, 5_000)
C5_BUDGET_S = 150          # the phase's stated time budget (gated)
C5_K1_REPEATS = 10         # repeat runs of K1 and K2 that must give the
C5_K2_REPEATS = 2          # same bits at these shapes
C5_FIXED_REPS = 3          # fixed-cg8 steps per timed turn
C5_RESID_COLS = 512        # sampled columns of the residual S S^-1 - I
C5_POOL = 16               # points of the LU route (datum, dummy, a point
C5_PAIRS = 64              # that sees an image twice, the rest free); pairs
C5_SELF_PAIRS = 16         # among them, of which (p, p)
C5_CAMERAS = 6
C5_SAMPLE = 4096           # points of the block gather against dense panels
C5_GATHER_TOL = 1e-10      # of each block's largest entry
C5_SELF_TOL = 1e-10        # (p, p) pair + Hpp^-1 against the point's block
# phase 17: the port's example as a user runs it
EXAMPLE = ROOT / "examples" / "example_scale_torch.py"
EXAMPLE_SHAPE = (20_000, 100, 8)
EXAMPLE_TIMEOUT = 600      # s


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def by_kernel(ms_by_name) -> str:
    """`measure.device_ms`'s second result on one line, in us."""
    def short(name):
        m = re.match(r"(?:void )?([\w:]+(?:<[^>]*>)?)",
                     name.replace("(anonymous namespace)::", ""))
        return m.group(1) if m else name

    return ", ".join(f"{short(n)} {t * 1e3:.1f} us"
                     for n, t in ms_by_name.items())


def preconds(history) -> str:
    """The preconditioner of each `solve` step, run-length coded
    ("coupled x2, block_jacobi x5"): the point-major route keeps the
    coupled one where it is definite (`rcs.definite_coupling`)."""
    runs = []
    for h in history:
        if runs and runs[-1][0] == h["precond"]:
            runs[-1][1] += 1
        else:
            runs.append([h["precond"], 1])
    return ", ".join(f"{p} x{n}" for p, n in runs)


def scaled_err(a, b) -> float:
    """max|a - b| / max|b|."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def inverse_err(inv_k, inv_p) -> float:
    """Inverse blocks: max over blocks of (relative Frobenius difference) /
    cond_F(block).  An inverse amplifies a relative input difference by up
    to its condition number, so the input tolerance applies to this
    ratio."""
    import torch

    a, b = inv_k.double(), inv_p.double()
    if b.dim() == 2:
        a, b = a[None], b[None]
    rel = (a - b).flatten(1).norm(dim=1) / b.flatten(1).norm(dim=1)
    return float((rel / torch.linalg.cond(b, "fro")).max())


COV_STAGES = ("linearise", "assemble_base", "corrections", "inverse",
              "recovery")


def time_cov_all(fmp, state, spec, cam_gather=None):
    """`cov_direct.cov_all` itself, COV_REPS calls, each between two CUDA
    events.  Returns (mean ms, the last call's blocks)."""
    import torch

    from bundle_adjustment_tpu_torch.parallel import cov_direct

    ms = []
    for _ in range(COV_REPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = cov_direct.cov_all(fmp, state, spec, cam_gather=cam_gather)
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    return sum(ms) / len(ms), out


def cov_staged(fmp, state, spec, cam_gather=None):
    """The stage split of `cov_direct.cov_all`: the calls it makes (its
    assembly as `assemble_reduced_base` and `assemble_reduced_corrections`,
    which `assemble_reduced_dense` runs in turn), a CUDA event after each.
    A diagnostic: the caller holds its blocks against `cov_all`'s.
    Returns (blocks, FMBlocks, S, Q, {stage: ms}, {stage: GB}), the last
    `torch.cuda.max_memory_allocated` after each stage (the caller resets
    the peak where it wants it to start)."""
    import torch

    from bundle_adjustment_tpu_torch.parallel import cov_direct, engine

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    peak = []

    def stage_end(i):
        ev[i].record()
        peak.append(torch.cuda.max_memory_allocated() / 1e9)

    ev[0].record()
    b = engine.linearize(fmp, state, spec, 0.0, cam_gather=cam_gather)
    stage_end(1)
    S0 = cov_direct.assemble_reduced_base(fmp, b)
    stage_end(2)
    S = cov_direct.assemble_reduced_corrections(fmp, b, S0)
    stage_end(3)
    Q = cov_direct.reduced_inverse(S)
    stage_end(4)
    blocks = cov_direct.point_covariance_dense(fmp, b, Q)
    stage_end(5)
    torch.cuda.synchronize()
    ms = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(COV_STAGES)}
    return blocks, b, S, Q, ms, dict(zip(COV_STAGES, peak))


def mean_stage_ms(runs):
    return {n: sum(r[n] for r in runs) / len(runs) for n in COV_STAGES}


def sym3_eigmin(A):
    """The smallest eigenvalue of each symmetric 3x3 block of A [k, 3, 3],
    in closed form (the trigonometric roots of the characteristic
    cubic)."""
    import torch

    dg = A.diagonal(dim1=1, dim2=2)
    q = dg.sum(dim=1) / 3
    off = A[:, 0, 1] ** 2 + A[:, 0, 2] ** 2 + A[:, 1, 2] ** 2
    p = torch.sqrt((((dg - q[:, None]) ** 2).sum(dim=1) + 2 * off) / 6)
    ps = torch.where(p > 0, p, torch.ones_like(p))
    B = (A - q[:, None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
         ) / ps[:, None, None]
    det = (B[:, 0, 0] * (B[:, 1, 1] * B[:, 2, 2] - B[:, 1, 2] ** 2)
           - B[:, 0, 1] * (B[:, 0, 1] * B[:, 2, 2] - B[:, 1, 2] * B[:, 0, 2])
           + B[:, 0, 2] * (B[:, 0, 1] * B[:, 1, 2] - B[:, 1, 1] * B[:, 0, 2]))
    phi = torch.acos((det / 2).clamp(-1.0, 1.0)) / 3
    return torch.where(p > 0, q + 2 * p * torch.cos(phi + 2 * math.pi / 3), q)


def block_err(x, ref):
    """max over blocks of max|x - ref| / max|ref| (each block's own
    largest entry)."""
    return float(((x - ref).flatten(1).abs().max(dim=1).values
                  / ref.flatten(1).abs().max(dim=1).values.clamp_min(1e-300)
                  ).max())


def jacobian_rows(b):
    """The Jacobian rows of an FMBlocks stacked: Jp, PJp [6, N], Jc, PJc
    [12, N], Jg, PJg [2G, N] (x rows first, then y rows)."""
    import torch

    return {n: torch.stack(getattr(b, n))
            for n in ("Jp", "PJp", "Jc", "PJc", "Jg", "PJg")}


def coupling_by_sums(fmp, R, ids):
    """Hpp^-1 [c, 3, 3] and the coupling columns Hxp = [Jc; Jg]^T P Jp
    [c, u, 3] of the points ``ids``, summed densely over each point's
    observations from the Jacobian rows ``R`` (`jacobian_rows`), with
    none of cov_direct's helpers."""
    import torch

    V, K = fmp.views, 6 * fmp.num_images
    G = R["Jg"].shape[0] // 2
    dev, c = ids.device, ids.shape[0]
    obs = (ids[:, None] * V + torch.arange(V, device=dev)).reshape(-1)
    Jp, PJp, Jc, Jg = (R[n][:, obs].reshape(-1, c, V)
                       for n in ("Jp", "PJp", "Jc", "Jg"))
    Hpp = torch.einsum("apv,bpv->pab", Jp[:3], PJp[:3]) \
        + torch.einsum("apv,bpv->pab", Jp[3:], PJp[3:]) \
        + torch.diag_embed(1.0 - fmp.free_point[:, ids].T)
    hcp = torch.einsum("epv,apv->pvea", Jc[:6], PJp[:3]) \
        + torch.einsum("epv,apv->pvea", Jc[6:], PJp[3:])     # [c, V, 6, 3]
    Hxp = Jp.new_zeros((c, K + G, 3))
    rows = 6 * fmp.obs_image[obs].long().reshape(c, V, 1) \
        + torch.arange(6, device=dev)
    pidx = torch.arange(c, device=dev)[:, None, None].expand(c, V, 6)
    Hxp.index_put_((pidx, rows), hcp, accumulate=True)
    Hxp[:, K:] = torch.einsum("gpv,apv->pga", Jg[:G], PJp[:3]) \
        + torch.einsum("gpv,apv->pga", Jg[G:], PJp[3:])
    return torch.linalg.inv(Hpp), Hxp


def reduced_system_by_sums(fmp, R, chunk=4096):
    """The reduced system at damping 0 by a second route: the per-image
    Hcc / Hcg blocks index-added from per-observation products, Hgg, and
    the Schur correction sum_p Hxp Hpp^-1 Hxp^T as dense [u, 3c] products
    of `coupling_by_sums` per chunk of points."""
    import torch

    M, P = fmp.num_images, fmp.num_points
    K, G = 6 * M, R["Jg"].shape[0] // 2
    u = K + G
    img = fmp.obs_image.long()
    Jc, PJc, Jg, PJg = (R[n] for n in ("Jc", "PJc", "Jg", "PJg"))
    hcc = torch.einsum("en,fn->nef", Jc[:6], PJc[:6]) \
        + torch.einsum("en,fn->nef", Jc[6:], PJc[6:])
    Hcc = hcc.new_zeros((M, 6, 6)).index_add_(0, img, hcc) \
        + torch.diag_embed(1.0 - fmp.free_eo)
    del hcc
    hcg = torch.einsum("en,gn->neg", Jc[:6], PJg[:G]) \
        + torch.einsum("en,gn->neg", Jc[6:], PJg[G:])
    Hcg = hcg.new_zeros((M, 6, G)).index_add_(0, img, hcg).reshape(K, G)
    del hcg
    S = Jc.new_zeros((u, u))
    S[:K, :K] = torch.block_diag(*Hcc.unbind(0))
    S[:K, K:] = Hcg
    S[K:, :K] = Hcg.T
    S[K:, K:] = Jg[:G] @ PJg[:G].T + Jg[G:] @ PJg[G:].T \
        + torch.diag(1.0 - fmp.free_global)
    for c0 in range(0, P, chunk):
        ids = torch.arange(c0, min(c0 + chunk, P), device=S.device)
        hinv, Hxp = coupling_by_sums(fmp, R, ids)
        C = Hxp @ hinv
        S -= Hxp.permute(1, 0, 2).reshape(u, -1) \
            @ C.permute(1, 0, 2).reshape(u, -1).T
    return S


def solve_scaled(S, B):
    """X = S^-1 B by LU (not the Cholesky factor) on the Jacobi-scaled
    system D^-1 S D^-1 (D = sqrt(diag S)): partial pivoting on the raw S,
    whose rows span many orders of magnitude, loses digits that the
    scaled system keeps."""
    import torch

    d = S.diagonal().sqrt()
    return torch.linalg.solve(S / d[:, None] / d[None, :],
                              B / d[:, None]) / d[:, None]


def point_blocks_by_solve(fmp, R, S, ids):
    """Qpp of the points ``ids`` [c, 3, 3] by an LU route: C_p = Hxp
    Hpp^-1 from `coupling_by_sums`, X = S^-1 C_p (`solve_scaled`), Qpp =
    Hpp^-1 + C_p^T X."""
    hinv, Hxp = coupling_by_sums(fmp, R, ids)
    c, u = Hxp.shape[:2]
    C = Hxp @ hinv                                            # [c, u, 3]
    X = solve_scaled(S, C.permute(1, 0, 2).reshape(u, 3 * c))
    return hinv + C.mT @ X.reshape(u, c, 3).permute(1, 0, 2)


def scaled_condition(S, Q, iters=100):
    """The condition number of the Jacobi-scaled S as the product of the
    largest eigenvalues of D^-1 S D^-1 and of its inverse D Q D, each by
    ``iters`` power iterations (a lower bound)."""
    import torch

    d = S.diagonal().sqrt()

    def top(mv):
        v = torch.ones_like(d)
        lam = 0.0
        for _ in range(iters):
            w = mv(v)
            lam = float(w.norm() / v.norm())
            v = w / w.norm()
        return lam

    return top(lambda v: S @ (v / d) / d) * top(lambda v: Q @ (v * d) * d)


def covariance_phase(prob, st, spec, dev):
    """Phase 7 (see the module docstring).  Returns (summary dict, K3
    launches during the f32 run)."""
    import numpy as np
    import torch

    from bundle_adjustment_tpu_torch import measure
    from bundle_adjustment_tpu_torch.parallel import (cov_direct, engine,
                                                      kernels, refine)

    fmp64 = engine.fm_problem(refine.upcast_problem(prob))
    st64 = type(st)(*(a.double() for a in st))
    P, M, V = fmp64.num_points, fmp64.num_images, fmp64.views
    K = 6 * M
    free = fmp64.free_point.sum(dim=0) > 0
    log(f"covariance: P={P} M={M} V={V} u={K + 3 + spec.num_coefficients} "
        f"N={P * V}")

    # ---- f64, the gate ----------------------------------------------------
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    cold = cov_direct.cov_all(fmp64, st64, spec)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 - base_gb
    ms_all64, warm = time_cov_all(fmp64, st64, spec)
    tot64 = ms_all64 / 1e3
    runs = [cov_staged(fmp64, st64, spec) for _ in range(COV_REPS)]
    Qall, b, S, Q = runs[-1][:4]
    ms64 = mean_stage_ms([r[4] for r in runs])
    # cov_all, cold and warm, against its stage-by-stage run (the
    # pair-block corrections add with atomics: not bit for bit)
    repeat_err = max(block_err(cold, Qall), block_err(warm, Qall))
    u = S.shape[0]
    info = int(torch.linalg.cholesky_ex(S).info)
    d = S.diagonal().sqrt()
    resid = float(((S @ Q) * d[None, :] / d[:, None]
                   - torch.eye(u, dtype=S.dtype, device=dev)).abs().max())
    R = jacobian_rows(b)
    S_ref = reduced_system_by_sums(fmp64, R)
    s_err = float(((S - S_ref) / d[:, None] / d[None, :]).abs().max())
    cams = cov_direct.camera_covariance_dense(Q, torch.arange(M, device=dev))
    cams_ref = Q[:K, :K].reshape(M, 6, M, 6).diagonal(dim1=0, dim2=2)
    cams_same = bool(torch.equal(cams, cams_ref.permute(2, 0, 1)))
    rng = np.random.default_rng(7)
    free_ids = np.flatnonzero(free.cpu().numpy())
    ids = torch.as_tensor(np.concatenate([
        rng.choice(free_ids, 6, replace=False), [1],
        [NUM_POINTS + int(rng.integers(P - NUM_POINTS))]]), device=dev)
    sel = cov_direct.point_covariance_dense(fmp64, b, Q, point_ids=ids)
    ref = point_blocks_by_solve(fmp64, R, S, ids)
    err_dense, err_sel = block_err(Qall[ids], ref), block_err(sel, ref)
    # the same LU route on the second assembly: cond(S) ~ 1e8 amplifies
    # the two assemblies' rounding, so this one is recorded, not gated
    err_indep = block_err(Qall[ids], point_blocks_by_solve(fmp64, R, S_ref,
                                                           ids))
    del R, S_ref
    diag64 = Qall.diagonal(dim1=1, dim2=2)[free]              # [Pfree, 3]
    diag_ok = bool(torch.isfinite(diag64).all() and (diag64 > 0).all())
    eig64 = torch.linalg.eigvalsh(S / d[:, None] / d[None, :])
    all_ids = torch.arange(P, device=dev)
    gather_err = block_err(cov_direct.point_covariance_dense(
        fmp64, b, Q, point_ids=all_ids), cov_direct.point_covariance_panels(
            fmp64, b, Q))
    gather_ms = measure.time_ms(lambda: cov_direct.point_covariance_dense(
        fmp64, b, Q, point_ids=all_ids), reps=COV_REPS, warm=0)
    dense_ms = measure.time_ms(lambda: cov_direct.point_covariance_panels(
        fmp64, b, Q), reps=COV_REPS, warm=0)
    log(f"f64 S, Jacobi-scaled: eigenvalues {float(eig64[0]):.3e} .. "
        f"{float(eig64[-1]):.3e}; recovery of all points by block gathers "
        f"{gather_ms:.3f} ms, by dense panels {dense_ms:.3f} ms, block "
        f"error {gather_err:.3e}")
    log(f"f64: Cholesky info {info}; Jacobi-scaled max|S - S_ref| (second "
        f"assembly route) {s_err:.3e}; Jacobi-scaled residual "
        f"max|D^-1 S Q D - I| {resid:.3e}; camera blocks equal Q's diagonal "
        f"blocks: {cams_same}; points {ids.tolist()}: block error vs the LU "
        f"route, all-points path {err_dense:.3e}, selected {err_sel:.3e} "
        f"(LU on S_ref, recorded: {err_indep:.3e}); free diagonals finite "
        f"and > 0: {diag_ok}; cov_all (cold, warm) vs the staged run, block "
        f"error {repeat_err:.3e}")
    log(f"f64 cov_all: cold {cold_s:.3f} s, peak device memory "
        f"{peak_gb:.2f} GB above the {base_gb:.2f} GB held before; warm "
        f"{tot64:.4f} s ({P / tot64:.1f} point blocks/s); stages "
        + ", ".join(f"{n} {v:.3f}" for n, v in ms64.items())
        + f" ms (sum {sum(ms64.values()):.3f})")
    problems = []
    if info != 0:
        problems.append(f"f64 Cholesky failed (info {info})")
    if not s_err <= COV_S_TOL:
        problems.append(f"S differs from the second assembly route by "
                        f"{s_err:.3e} > {COV_S_TOL} (Jacobi-scaled)")
    if not resid <= COV_RESIDUAL_TOL:
        problems.append(f"Jacobi-scaled residual {resid:.3e} > "
                        f"{COV_RESIDUAL_TOL}")
    if not cams_same:
        problems.append("camera blocks differ from Q's diagonal blocks")
    if not (err_dense <= COV_BLOCK_TOL and err_sel <= COV_BLOCK_TOL):
        problems.append(f"point blocks disagree with the LU route "
                        f"(all points {err_dense:.3e}, selected "
                        f"{err_sel:.3e})")
    if not gather_err <= COV_BLOCK_TOL:
        problems.append(f"the block-gather recovery of all points differs "
                        f"from the dense one ({gather_err:.3e})")
    if not repeat_err <= COV_BLOCK_TOL:
        problems.append(f"cov_all differs from its staged run "
                        f"({repeat_err:.3e})")
    if not diag_ok:
        problems.append("a free point's diagonal is not finite and > 0")
    if problems:
        fail("covariance (f64): " + "; ".join(problems))
    del runs, b, Q, cold, warm, sel

    # ---- f32 through K3, recorded ------------------------------------------
    fmp32 = engine.fm_problem(prob)
    cg = kernels.make_cam_gather(fmp32)
    # K3 on the point-major layout against its plain gather, exactly (before
    # the counters are reset: this launch is a comparison)
    if not torch.equal(cg(st.eo), kernels.cam_gather_plain(
            st.eo, fmp32.obs_image)):
        fail("K3 on the point-major problem differs from its plain version")
    kernels.reset_launch_counts()
    b32 = engine.linearize(fmp32, st, spec, 0.0, cam_gather=cg)
    S32 = cov_direct.assemble_reduced_dense(fmp32, b32).double()
    info32 = int(torch.linalg.cholesky_ex(S32.float()).info)
    del b32
    # where f32 loses S: its assembly (S32 vs S) or its factorisation
    # (S rounded to f32), both in the Jacobi scale of the f64 S
    asm_err = float(((S32 - S) / d[:, None] / d[None, :]).abs().max())
    eig32 = torch.linalg.eigvalsh(S32 / d[:, None] / d[None, :])
    info_rounded = int(torch.linalg.cholesky_ex(S.float()).info)
    out32 = dict(cholesky_info=info32, scaled_assembly_err=asm_err,
                 scaled_eig_min=float(eig32[0]),
                 rounded_f64_cholesky_info=info_rounded)
    log(f"f32 S (K3): Cholesky info {info32}; Jacobi-scaled (f64 S's "
        f"diagonal) max|S32 - S64| {asm_err:.3e}, eigenvalues of S32 "
        f"{float(eig32[0]):.3e} .. {float(eig32[-1]):.3e}; the f64 S rounded "
        f"to f32: Cholesky info {info_rounded}")
    del S, S32
    if info32 != 0:
        log(f"f32: the Cholesky of S fails (info {info32}): no f32 "
            "covariance, no f32 timing")
    else:
        cold32 = cov_direct.cov_all(fmp32, st, spec, cam_gather=cg)
        ms_all32, _ = time_cov_all(fmp32, st, spec, cam_gather=cg)
        ms32 = mean_stage_ms([cov_staged(fmp32, st, spec, cam_gather=cg)[4]
                              for _ in range(COV_REPS)])
        diag32 = cold32.double().diagonal(dim1=1, dim2=2)[free]
        rel = ((diag32 - diag64) / diag64).abs()
        tot32 = ms_all32 / 1e3
        out32.update(
            cov_all_points_s=tot32, cov_point_blocks_per_s=P / tot32,
            stage_ms=ms32, diag_rel_err_max=float(rel.max()),
            diag_rel_err_median=float(rel.median()))
        log(f"f32 (K3): Cholesky info {info32}; free points' diagonal vs "
            f"f64: max relative error {out32['diag_rel_err_max']:.3e}, "
            f"median {out32['diag_rel_err_median']:.3e}")
        log(f"f32 cov_all: warm {tot32:.4f} s ({P / tot32:.1f} point "
            f"blocks/s); stages " + ", ".join(
                f"{n} {v:.3f}" for n, v in ms32.items()) + " ms")
        del cold32
    torch.cuda.synchronize()
    k3 = kernels.launch_counts()["cam_gather"]
    log(f"K3 launches during the f32 covariance: {k3}")
    if k3 <= 0:
        fail("the f32 covariance never launched K3")
    return dict(cov_all_points_s=tot64, cov_point_blocks_per_s=P / tot64,
                cov_stage_ms=ms64, cov_cold_s=cold_s, cov_peak_gb=peak_gb,
                cov_block_gather_recovery_ms=gather_ms,
                cov_dense_recovery_ms=dense_ms,
                cov_scaled_eig=[float(eig64[0]), float(eig64[-1])],
                cov_scaled_s_err=s_err, cov_scaled_residual=resid,
                cov_block_err=max(err_dense, err_sel),
                cov_block_err_s_ref=err_indep,
                cov_repeat_err=repeat_err, cov_f32=out32), k3


def free_network_phase(prob_h, state_h, spec, dev):
    """Phase 8 (see the module docstring).  Returns (summary dict, the
    launch counts of `solve` + the gated refinement)."""
    import numpy as np
    import torch

    from bundle_adjustment_tpu_torch import convert, measure, synthetic
    from bundle_adjustment_tpu_torch.parallel import (engine, freenet, hilo,
                                                      kernels, lm, rcs,
                                                      refine, solver)

    f32 = torch.float32
    state0 = convert.state_to_torch(state_h, dev, f32)
    state0_64 = type(state0)(*(a.double() for a in state0))

    def layouts(prob):
        fmp = engine.fm_problem(prob)
        return fmp, kernels.kernel_layout(fmp)

    def one_step(label, net_h):
        """One LM step at the start state: f32 kernels against f32 plain,
        and both against the plain f64 step on the same (f32-rounded)
        problem."""
        prob = convert.problem_to_torch(net_h, dev, f32)
        fmp, fv = layouts(prob)
        kw = dict(cg_tol=1e-7, cg_maxiter=200, stall_limit=50)
        k = engine.lm_step_full(fv, prob, state0, spec, 1e-2,
                                use_kernels=True, **kw)
        again = engine.lm_step_full(fv, prob, state0, spec, 1e-2,
                                    use_kernels=True, **kw)
        same = all(torch.equal(a, c) for a, c in zip(k[:3], again[:3]))
        del again
        pl = engine.lm_step_full(fmp, prob, state0, spec, 1e-2, **kw)
        prob64 = refine.upcast_problem(prob)
        r = engine.lm_step_full(engine.fm_problem(prob64), prob64, state0_64,
                                spec, 1e-2, cg_tol=1e-12, cg_maxiter=400)
        names = ("dxp", "dxc", "dxg")
        e_kp = {n: scaled_err(a, c) for n, a, c in zip(names, k, pl)}
        e_k64 = {n: scaled_err(a.double(), c) for n, a, c in zip(names, k, r)}
        e_p64 = {n: scaled_err(a.double(), c) for n, a, c in zip(names, pl, r)}
        log(f"{label}: one step at the start (damping 1e-2), CG iterations "
            f"kernels {k[4]}, plain {pl[4]}, f64 {r[4]}; scaled errors "
            "kernels vs plain " + ", ".join(
                f"{n} {e:.2e}" for n, e in e_kp.items())
            + "; kernels vs f64 " + ", ".join(
                f"{n} {e:.2e}" for n, e in e_k64.items())
            + "; plain f32 vs f64 " + ", ".join(
                f"{n} {e:.2e}" for n, e in e_p64.items())
            + f"; two kernel runs bit-identical: {same}")
        if not same:
            fail(f"{label}: two runs of one step through the kernels differ")
        bad = [n for n in names if not e_kp[n] <= max(e_p64[n], TOL_SCALED)]
        bad += [n + " (vs f64)" for n in names
                if not e_k64[n] <= max(2.0 * e_p64[n], TOL_SCALED)]
        if bad:
            fail(f"{label}: the step through the kernels disagrees: {bad}")
        return dict(kernels_vs_plain=e_kp, kernels_vs_f64=e_k64,
                    plain_vs_f64=e_p64, cg_iterations=[k[4], pl[4], r[4]])

    truth = synthetic.true_points(NUM_POINTS, seed=0)
    net_h = synthetic.free_network(prob_h, state_h, bars=FREE_BARS, seed=8,
                                   truth=truth)
    steps_a = one_step("free network (8 bars, datum)", net_h)
    steps_b = one_step(
        f"direct observations ({GROUP_ROWS}-row group, dp / de / dg)",
        synthetic.free_network(
            prob_h, state_h, bars=0, datum=False, seed=9,
            direct=dict(group=GROUP_ROWS, dp=1000, de=50, dg=True)))

    # ---- solve (f32) + refinement with extras ------------------------------
    prob = convert.problem_to_torch(net_h, dev, f32)
    n_true = 2 * int((prob.obs_weight[:, 0, 0] > 0).sum())
    u = int(prob.free_point.sum() + prob.free_eo.sum()
            + prob.free_global.sum())
    dof = n_true - u + FREE_DEFECTS + FREE_BARS
    log(f"free network: dof = 2 N_true {n_true} - u {u} (3 P_true + 6 M + G) "
        f"+ d {FREE_DEFECTS} + bars {FREE_BARS} = {dof}")
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = solver.solve(prob, state0, spec, damping=1e-2, max_iterations=30,
                       tolerance=F32_STOP)
    torch.cuda.synchronize()
    t_f32 = time.perf_counter() - t
    launches_solve = kernels.launch_counts()
    hist = res.history
    accepted = sum(h["accepted"] for h in hist)
    log(f"solve (f32, kernels): {res.status.name} after {res.iterations} "
        f"steps in {t_f32:.3f} s ({accepted} accepted, "
        f"{len(hist) - accepted} rejected); max|dx| " + ", ".join(
            f"{h['max_dx']:.3e}" for h in hist) + "; CG iterations "
        f"{[h['cg_it'] for h in hist]}; damping "
        f"{[h['damping'] for h in hist]}; preconditioner {preconds(hist)}")
    log(f"  launches during solve: {launches_solve}")
    st = res.state

    refiner = refine.Refiner(prob, spec, use_kernels=True)
    fv = refiner.fmp32
    st64 = type(st)(*(a.double() for a in st))
    om_f32 = float(refiner.gradient64(refiner.fmp64, st64)[3])
    phase = lm.LMPhase(steps=res.iterations, max_dx=res.max_abs_dx,
                       cg_iterations=[h["cg_it"] for h in hist],
                       seconds=t_f32)
    sb_a, sb_b = prob.sb_a.long(), prob.sb_b.long()
    runs = {}
    for label, damping in FREE_REFINE_DAMPING.items():
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        s_ref, rec = refine.converge(refiner, (st, phase),
                                     tolerance=REFINE_TOL, damping=damping)
        counts = kernels.launch_counts()
        full = hilo.to_f64(s_ref)
        om = float(refiner.gradient64(refiner.fmp64, full)[3])
        length = (full.points[sb_b] - full.points[sb_a]).norm(dim=1)
        bar_err = float((length - prob.sb_length.double()).abs().max())
        runs[label] = dict(
            damping=damping, steps=rec.refine_steps,
            seconds=rec.refine_seconds, max_dx=rec.max_dx,
            cg_iterations=rec.cg_iterations, omega=om,
            sigma0=(om / dof) ** 0.5, bar_err=bar_err, launches=counts)
        log(f"refinement with extras, damping {damping:g}: "
            f"{rec.refine_steps} steps in {rec.refine_seconds:.3f} s; "
            "max|dx| " + ", ".join(f"{x:.3e}" for x in rec.max_dx)
            + f"; CG iterations {rec.cg_iterations}; f64 Omega "
            f"{om_f32:.10e} -> {om:.10e}; sigma0 {runs[label]['sigma0']:.6e};"
            f" max |bar length - observed| {bar_err:.3e}; launches {counts}")
    gate = runs[FREE_REFINE_GATE]
    launches = {k: launches_solve[k] + gate["launches"][k]
                for k in launches_solve}
    problems = []
    if min(launches_solve[k] for k in SOLVE_KERNELS) <= 0 \
            or min(gate["launches"][k] for k in SOLVE_KERNELS) <= 0:
        problems.append(f"a kernel was never launched: solve "
                        f"{launches_solve}, refinement {gate['launches']}")
    if not gate["max_dx"][-1] <= REFINE_TOL:
        problems.append(f"the {FREE_REFINE_GATE} refinement did not reach "
                        f"max|dx| <= {REFINE_TOL}")
    if not abs(gate["sigma0"] / SIGMA - 1.0) < 0.01:
        problems.append(f"sigma0 {gate['sigma0']:.6e} is not within 1% of "
                        f"{SIGMA}")
    if not gate["omega"] <= om_f32 * (1.0 + 1e-9):
        problems.append("the refinement raised Omega above the f32 phase's")
    if not gate["bar_err"] <= 5 * BAR_SIGMA:
        problems.append(f"a bar is {gate['bar_err']:.3e} from its observed "
                        f"length (limit {5 * BAR_SIGMA:.1e})")

    # ---- one more f32 step at the f32 phase's end: B dx = 0 ----------------
    dxp, _, _, _, it_last, ext = engine.lm_step_full(
        fv, prob, st, spec, 0.0, cg_tol=1e-6, cg_maxiter=100,
        use_kernels=True)
    bdx = float(torch.einsum("kpa,pa->k", ext.Brows.double(),
                             dxp.double()).abs().max())
    mdxp = float(dxp.abs().max())
    log(f"f32 step at the f32 phase's end ({it_last} CG iterations): "
        f"max|B dxp| {bdx:.3e}, max|dxp| {mdxp:.3e}, ratio "
        f"{bdx / mdxp:.3e}")
    if not bdx <= BDX_TOL * mdxp:
        problems.append(f"max|B dxp| {bdx:.3e} > {BDX_TOL} x max|dxp|")
    if problems:
        fail("free network: " + "; ".join(problems))
    del dxp, ext

    # ---- what the extras cost: set-up per step, launches per iteration -----
    cgf = kernels.make_cam_gather(fv)
    b, rc, rg, Minv, pp = kernels.prepare_kernels(fv, st, spec, 0.0,
                                                  cam_gather=cgf)
    ops = engine.point_ops(fv, b, cam_gather=cgf)
    bp3 = torch.stack(b.bp, dim=1)
    apply_M = rcs.make_apply_M(Minv)

    def setup():
        e = freenet.prepare_extras(prob, st, bp3, rc, rg, ops, b.omega0)
        return e, freenet.wrap_precond(apply_M, e)

    setup_ms = measure.time_ms(setup, reps=3, warm=1)
    setup_prof = measure.device_profile(setup)
    ext, apply_full = setup()
    base = kernels.make_matvec(pp, b.extra_c, b.extra_g)
    wrapped = freenet.wrap_matvec(base, ext)

    def per_iteration(M, mv):
        """(launches, device ms) of one CG iteration: 16 iterations against
        8 under the profiler."""
        p8, p16 = (measure.device_profile(lambda n=n: rcs.pcg(
            ext.rc, ext.rg, M, mv, tol=0.0, maxiter=n, stall_limit=n + 1))
            for n in (8, 16))
        return ((p16["launches"] - p8["launches"]) / 8,
                (p16["busy_ms"] - p8["busy_ms"]) / 8)

    rcs.pcg(ext.rc, ext.rg, apply_full, wrapped, tol=0.0, maxiter=2)
    it_with = per_iteration(apply_full, wrapped)
    it_without = per_iteration(Minv, base)
    log(f"extras: set-up per step (prepare_extras + wrap_precond, Q + d = "
        f"{ext.W.shape[0]} rows) {setup_ms:.3f} ms between CUDA events, "
        f"{setup_prof['busy_ms']:.3f} ms of device time in "
        f"{setup_prof['launches']} launches; one CG iteration with extras "
        f"{it_with[0]:.1f} launches, {it_with[1]:.4f} ms of device time; "
        f"without {it_without[0]:.1f} launches, {it_without[1]:.4f} ms")
    return dict(
        free_dof=dof, free_solve_steps=res.iterations,
        free_solve_accepted=accepted, free_solve_s=t_f32,
        free_solve_cg_iterations=phase.cg_iterations,
        free_solve_precond=preconds(hist),
        free_solve_max_dx=[h["max_dx"] for h in hist],
        free_refine=runs, free_omega_f32_end=om_f32,
        free_time_to_converged_s=t_f32 + gate["seconds"],
        free_bdx_over_dxp=bdx / mdxp,
        free_one_step=steps_a, direct_one_step=steps_b,
        extras_setup_ms=setup_ms,
        extras_setup_device_ms=setup_prof["busy_ms"],
        extras_setup_launches=setup_prof["launches"],
        cg_iteration_launches=dict(with_extras=it_with[0],
                                   without=it_without[0]),
        cg_iteration_device_ms=dict(with_extras=it_with[1],
                                    without=it_without[1])), launches


def reference_api_phase(dev):
    """Phase 9 (see the module docstring).  Returns (summary dict, the
    launch counts of the phase: none, every run is float64)."""
    import numpy as np
    import torch

    import bundle_adjustment_tpu_torch as T
    from bundle_adjustment_tpu_torch.models.problem import compile_problem
    from bundle_adjustment_tpu_torch.ops.assembly import make_assembler
    from bundle_adjustment_tpu_torch.ops.schur import (reduce_eo,
                                                       retained_columns)
    from bundle_adjustment_tpu_torch.parallel import kernels
    from bundle_adjustment_tpu_torch.testing import make_synthetic_scene

    MI, OK = T.MatrixInversion, T.EstimationState.ERROR_FREE_ESTIMATION

    def scene(points, images):
        t0 = time.time()
        cams, bars, truth = make_synthetic_scene(
            num_points=points, num_images=images, noise=SIGMA, sigma=SIGMA,
            perturb=0.01, seed=0)
        params = [q for oc in truth["coords"] for q in oc.params]
        for cam in cams:
            params += list(cam.io.params)
            params += [q for h in cam.distortion_models.values() for q in h]
            params += [q for img in cam for q in img.eo.params]
        start = [q.value for q in params]

        def restore():
            """The start values, and every free column unassigned again (an
            estimate numbers the columns once per scene, as the
            reference's does)."""
            for q, v in zip(params, start):
                q.value = v
                q.fixed = q.fixed
        return cams, bars, truth, restore, time.time() - t0

    def events_s(fn):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        return out, e0.elapsed_time(e1) / 1e3

    kernels.reset_launch_counts()
    cams, bars, truth, restore, scene_s = scene(API_POINTS, API_IMAGES)
    t0 = time.time()
    bp = compile_problem(cams, bars, []).problem
    compile_s = time.time() - t0
    n, u, d = bp.num_observation_rows, bp.num_unknowns, bp.defect
    log(f"reference API scene: {API_POINTS} points, {API_IMAGES} images, "
        f"{bp.num_image_obs} image points (the |xy| <= 50 cut), 1 bar; "
        f"n={n} u={u} d={d} dof={bp.dof}; dense N {(u + d) ** 2 * 8 / 1e9:.3f}"
        f" GB in f64; scene built in {scene_s:.2f} s, compile_problem "
        f"{compile_s:.2f} s on the host")

    def estimate(cls, mode, reps):
        """`reps` runs of estimate_model on CUDA (the default device) from
        the same start; the last one is kept."""
        secs = []
        for _ in range(reps):
            restore()
            adj = cls()
            adj.add(*cams, *bars)
            adj.set_invert_normal_equation(mode)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            status, sec = events_s(adj.estimate_model)
            secs.append(sec)
            if status != OK or adj.device.type != "cuda":
                fail(f"{cls.__name__} {mode.name}: status {status!r} on "
                     f"{adj.device}")
        ratio = float(np.sqrt(adj.get_variance_factor_aposteriori()
                              / adj.get_variance_factor_apriori()))
        if abs(ratio - 1.0) > API_SIGMA0_TOL:
            fail(f"{cls.__name__} {mode.name}: sigma0 a-posteriori / "
                 f"a-priori {ratio:.6f}, not within 1 % of 1")
        r = dict(adj=adj, seconds=secs, iterations=adj.iteration_step,
                 sigma0_ratio=ratio,
                 peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        log(f"{cls.__name__} {mode.name}: {r['iterations']} iterations, "
            f"sigma0 {np.sqrt(adj.get_variance_factor_aposteriori()):.6e} "
            f"(a-posteriori / a-priori {ratio:.6f}), estimate_model "
            + ", ".join(f"{x:.3f}" for x in secs) + " s (CUDA events; the "
            f"first cold), peak {r['peak_gb']:.2f} GB")
        return r

    runs = {m: estimate(T.BundleAdjustment, getattr(MI, m), 2)
            for m in ("REDUCED", "FULL", "PRE_ELIMINATION")}
    runs["scale"] = estimate(T.ScaleBundleAdjustment, MI.REDUCED, 1)

    # the three modes agree (coordinates, the points' cofactor blocks)
    full = runs["FULL"]["adj"]
    col_eo = torch.as_tensor(bp.col_eo.astype(np.int64), device=dev)
    R = retained_columns(col_eo, bp.total_size)
    kept = R[R >= d]    # the retained unknowns: points, IO, distortion
    for m in ("REDUCED", "PRE_ELIMINATION"):
        a = runs[m]["adj"]
        if not torch.allclose(a.state.points, full.state.points,
                              **API_MODE_XYZ):
            fail(f"{m} coordinates differ from FULL's by "
                 f"{float((a.state.points - full.state.points).abs().max())}")
        qa, qf = a.Qxx[kept][:, kept], full.Qxx[kept][:, kept]
        q_max = float(qf.abs().max())
        q_err = float((qa - qf).abs().max())
        log(f"{m} against FULL: max|dxyz| "
            f"{float((a.state.points - full.state.points).abs().max()):.3e},"
            f" point cofactor blocks max|dQ| {q_err:.3e} of max|Q| "
            f"{q_max:.3e}")
        if not torch.allclose(qa, qf, rtol=API_MODE_Q_RTOL,
                              atol=API_MODE_Q_ATOL * q_max):
            fail(f"{m} point cofactor blocks differ from FULL's: "
                 f"{q_err} of {q_max}")
    # the scale class against the dense REDUCED estimate
    sa, ra = runs["scale"]["adj"], runs["REDUCED"]["adj"]
    q_atol = API_SCALE_Q_ATOL * float(ra.Qxx.abs().max())
    scale_ok = (
        torch.allclose(sa.state.points, ra.state.points, **API_SCALE_XYZ)
        and abs(sa.omega / ra.omega - 1.0) <= API_SCALE_RTOL
        and abs(sa.get_variance_factor_aposteriori()
                / ra.get_variance_factor_aposteriori() - 1.0) <= API_SCALE_RTOL
        and torch.allclose(sa.Qxx, ra.Qxx, rtol=API_SCALE_Q_RTOL,
                           atol=q_atol))
    xyz_dev = float((sa.state.points - ra.state.points).abs().max())
    log(f"ScaleBundleAdjustment against the dense REDUCED estimate: "
        f"max|dxyz| {xyz_dev:.3e}, Omega ratio {sa.omega / ra.omega:.12f}")
    if not scale_ok:
        fail("ScaleBundleAdjustment differs from the dense estimate beyond "
             "tests/test_scale_driver.py's tolerances")

    # the per-iteration split at the REDUCED estimate (CUDA events, mean
    # of API_TIMED after one untimed call each)
    st = ra.state
    assemble = make_assembler(bp, dev)

    def timed(fn):
        out = fn()
        sec = [events_s(fn)[1] for _ in range(API_TIMED)]
        return out, 1e3 * sum(sec) / len(sec)

    (N, nv, V), asm_ms = timed(lambda: assemble(st, 0.0))
    Np, npre = V[:, None] * N * V[None, :], V * nv
    _, solve_ms = timed(lambda: torch.linalg.solve_ex(Np, npre))
    f, reduce_ms = timed(lambda: reduce_eo(Np, npre, col_eo, R))
    _, inv_red_ms = timed(lambda: torch.linalg.inv_ex(f.S))
    _, inv_full_ms = timed(lambda: torch.linalg.inv_ex(Np))
    split = dict(assembly_ms=asm_ms, lu_solve_ms=solve_ms,
                 eo_reduction_ms=reduce_ms, reduced_inverse_ms=inv_red_ms,
                 full_inverse_ms=inv_full_ms)
    log("per-iteration split at the estimate (ms, CUDA events): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))

    # the same code on the CPU and on the card, on the cut scene
    out = {}
    for where in ("cpu", "cuda"):
        c2, b2, t2, _, _ = scene(*API_CUT)
        adj = T.BundleAdjustment(device=where)
        adj.add(*c2, *b2)
        adj.set_invert_normal_equation(MI.REDUCED)
        if adj.estimate_model() != OK:
            fail(f"the {API_CUT} scene on {where}: status {adj.status!r}")
        out[where] = (np.sqrt(adj.get_variance_factor_aposteriori()),
                      np.array([[o.x.value, o.y.value, o.z.value]
                                for o in t2["coords"]]))
    s_rel = abs(out["cuda"][0] / out["cpu"][0] - 1.0)
    x_rel = (np.abs(out["cuda"][1] - out["cpu"][1]).max()
             / np.abs(out["cpu"][1]).max())
    log(f"CPU against card at {API_CUT[0]} points / {API_CUT[1]} images: "
        f"sigma0 {s_rel:.2e} relative, coordinates {x_rel:.2e} of the field")
    if s_rel > API_CPU_TOL or x_rel > API_CPU_TOL:
        fail("the reference API on the card differs from the CPU's by "
             f"{max(s_rel, x_rel):.2e} (> {API_CPU_TOL})")
    launches = kernels.launch_counts()
    if any(solve_kernel_launches(launches).values()):
        fail(f"the float64 reference API launched K1 to K4: {launches}")
    summary = dict(
        api_n=n, api_u=u, api_d=d, api_dof=bp.dof,
        api_image_points=bp.num_image_obs, api_scene_s=scene_s,
        api_compile_problem_s=compile_s,
        api_cpu_vs_card=dict(sigma0_rel=s_rel, xyz_rel=x_rel),
        api_split_ms=split, api_scale_vs_dense_xyz=xyz_dev)
    for k, r in runs.items():
        summary[f"api_{k.lower()}"] = dict(
            iterations=r["iterations"], seconds=r["seconds"],
            sigma0_ratio=r["sigma0_ratio"], peak_gb=r["peak_gb"])
    return summary, launches


def two_camera_scene(points, images, seed=0):
    """`testing.make_synthetic_scene(points, images, noise = sigma = 5e-4,
    perturb 0.01)` as a two-camera network: even images on camera 1, odd
    images on camera 2, each camera with its own IO and distortion
    parameters started at the scene's values (one scale bar, inner
    constraints).  Returns (cameras, bars, truth)."""
    import bundle_adjustment_tpu_torch as T
    from bundle_adjustment_tpu_torch.testing import make_synthetic_scene

    (src,), bars, truth = make_synthetic_scene(
        num_points=points, num_images=images, noise=SIGMA, sigma=SIGMA,
        perturb=0.01, seed=seed)
    cams = []
    for cid in (1, 2):
        cam = T.Camera(cid, r0=src.r0,
                       distortion_types=tuple(src.distortion_models))
        for a in ("x0", "y0", "c"):
            p, q = getattr(src.io, a), getattr(cam.io, a)
            q.value, q.fixed = p.value, p.fixed
        for kind, handle in src.distortion_models.items():
            dst = cam.distortion(kind)
            have = {k for k, _ in dst.coefficients}
            for key, p in handle.coefficients:
                q = dst.get(key) if key in have else dst.add(key)
                q.value, q.fixed = p.value, p.fixed
        for img in list(src)[cid - 1::2]:
            oi = cam.add_image(img.id)
            for a in ("x0", "y0", "z0", "omega", "phi", "kappa"):
                p, q = getattr(img.eo, a), getattr(oi.eo, a)
                q.value, q.fixed = p.value, p.fixed
            for ic in img:
                o = oi.add(ic.object_coordinate, ic.x, ic.y, 1.0, 1.0, ic.rho)
                o.var_x, o.var_y = ic.var_x, ic.var_y
        cams.append(cam)
    return cams, bars, truth


def solve_kernel_launches(launches) -> dict:
    """``launches`` (a `kernels.launch_counts`) without the image-sum
    kernel, which the plain path's per-image sums take on the card: the
    launches of K1-K4 and the stage probes."""
    return {k: v for k, v in launches.items() if k != "image_sum"}


def rig_image_sum(fmp64, dev):
    """The image-sum kernel at the rig's product call (F = 16 f64 rows of
    N on the rig's point-major layout): the plain model's bits, the stack
    path within `RIG_IMAGE_SUM_TOL`, and the times (ms): the kernel's
    device time and per call between CUDA events, its byte bound, the
    plain model's and the stack path's (``library_ms``) per call between
    CUDA events; ``check_launches`` the kernel's launches here (checks
    and timing)."""
    import torch

    from bundle_adjustment_tpu_torch import measure
    from bundle_adjustment_tpu_torch.parallel import engine, kernels

    F, N = RIG_IMAGE_SUM_F, fmp64.obs_x.shape[0]
    gen = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn((F, N), generator=gen, dtype=torch.float64, device=dev)
    rows = list(x.unbind(0))
    before = kernels.image_sum_rows.launches
    out = kernels.image_sum_rows(fmp64, rows)
    model = kernels.image_sum_sorted_plain(fmp64, x.T)
    same = same_bits(out, model) \
        and same_bits(out, kernels.image_sum_rows(fmp64, rows))
    err = scaled_err(out, engine._image_sum_plain(fmp64, rows))
    M = fmp64.num_images
    bound, _ = measure.bound_ms(measure.image_sum_work(
        N, M, F, x.element_size()))
    res = dict(shape=dict(F=F, N=N, M=M, dtype="float64"), same_bits=same,
               max_abs_err=float((out - model).abs().max()), stack_err=err,
               bound_ms=bound)
    res["ms"] = measure.device_ms(
        lambda: kernels.image_sum_rows(fmp64, rows), reps=20)[0]
    res["events_ms"] = measure.time_ms(
        lambda: kernels.image_sum_rows(fmp64, rows), reps=50)
    res["share_of_bound"] = bound / res["ms"]
    res["plain_ms"] = measure.time_ms(
        lambda: kernels.image_sum_sorted_plain(fmp64, x.T), reps=3, warm=1)
    res["library_ms"] = measure.time_ms(
        lambda: engine._image_sum_plain(fmp64, rows), reps=20)
    res["check_launches"] = kernels.image_sum_rows.launches - before
    log(f"(i) image-sum kernel at the rig's product call (F={F} f64, "
        f"N={N}): {res['ms']:.4f} ms device [{res['events_ms']:.4f} ms "
        f"events], bound {bound:.4f} ms (share {res['share_of_bound']:.2f});"
        f" plain model {res['plain_ms']:.3f} ms, the stack path (library_ms)"
        f" {res['library_ms']:.4f} ms; the plain model's bits {same}, the "
        f"stack path within {err:.2e}")
    if not same:
        fail("rig (i): the image-sum kernel differs from its plain model or "
             "from itself")
    if not err <= RIG_IMAGE_SUM_TOL:
        fail(f"rig (i): the image-sum kernel differs from the stack path by "
             f"{err:.3e} > {RIG_IMAGE_SUM_TOL}")
    return res


def multi_camera_phase(dev):
    """Phase 10 (see the module docstring).  Returns (summary dict, the
    launch counts of the phase: no K1 to K4, the compact rows run the
    plain path; their per-image sums go through the image-sum kernel)."""
    import numpy as np
    import torch

    import bundle_adjustment_tpu_torch as T
    from bundle_adjustment_tpu_torch import convert, measure, synthetic
    from bundle_adjustment_tpu_torch.parallel import (cov_direct, covariance,
                                                      engine, hilo, kernels,
                                                      lm, rcs, refine, solver)

    C = RIG_CAMERAS
    kernels.reset_launch_counts()
    t_phase = time.time()
    prob_h, state_h, spec = synthetic.build_problem(
        NUM_POINTS, NUM_IMAGES, VIEWS, seed=0, num_cameras=C)
    f64, f32 = torch.float64, torch.float32
    prob64 = convert.problem_to_torch(prob_h, dev, f64)
    st64 = convert.state_to_torch(state_h, dev, f64)
    fmp64 = engine.fm_problem(prob64)
    Gp = 3 + spec.num_coefficients
    G = C * Gp
    log(f"rig: C={C}, P={fmp64.num_points} M={fmp64.num_images} "
        f"V={fmp64.views} G={G}; built in {time.time() - t_phase:.1f} s; "
        f"route: plain (the kernels take one camera)")
    image_sum = rig_image_sum(fmp64, dev)
    kernels.reset_launch_counts()  # from here the phase's own launches

    def events(fn):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        return out, e0.elapsed_time(e1) / 1e3

    # ---- (a) compact against materialized; equal bits on repeat ----------
    def compact_step():
        return engine.lm_step(fmp64, st64, spec, RIG_DAMPING,
                              cg_tol=RIG_CG_TOL, cg_maxiter=RIG_CG_MAXITER)

    def materialized_step():
        """The same step on the masked global rows through the
        single-camera code path of the engine."""
        b = engine.materialize_global_rows(
            fmp64, engine.linearize(fmp64, st64, spec, RIG_DAMPING))._replace(
            Jg_loc=None, PJg_loc=None, cam_obs=None)
        b, rc, rg, Minv = engine.reduce_blocks(fmp64, b, st64, RIG_DAMPING,
                                               couple_global=True)
        xc, xg, it = rcs.pcg(rc, rg, Minv,
                             lambda c, g: engine.schur_matvec(fmp64, b, c, g),
                             tol=RIG_CG_TOL, maxiter=RIG_CG_MAXITER)
        return engine.back_substitute_points(fmp64, b, xc, xg), xc, xg, b, it

    (cp, s_cp) = events(compact_step)
    (mt, s_mt) = events(materialized_step)
    if cp[3].Jg is not None:
        fail("rig: the step did not run the compact rows")
    errs = {}
    for n, a, r in zip(("dxp", "dxc", "dxg"), cp[:3], mt[:3]):
        errs[n] = float((a - r).abs().max())
        if not torch.allclose(a, r, rtol=RIG_STEP_RTOL,
                              atol=RIG_STEP_ATOL * float(r.abs().max())):
            fail(f"rig (a): the compact {n} differs from the materialized "
                 f"rows' by {errs[n]:.3e} (max {float(r.abs().max()):.3e})")
    fixed_slots = float(cp[2].reshape(C, Gp).abs().max())
    log(f"(a) f64 step, damping {RIG_DAMPING:g}, cg_tol {RIG_CG_TOL:g}: "
        f"compact {cp[4]} CG iterations in {s_cp:.3f} s, materialized "
        f"{mt[4]} in {s_mt:.3f} s; max|compact - materialized| "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()))
    cg_a = [int(cp[4]), int(mt[4])]
    if max(cg_a) >= RIG_CG_MAXITER:
        fail(f"rig (a): an f64 PCG did not reach {RIG_CG_TOL:g}")
    del mt
    prob32 = convert.problem_to_torch(prob_h, dev, f32)
    st32 = convert.state_to_torch(state_h, dev, f32)
    fmp32 = engine.fm_problem(prob32)
    one = engine.lm_step(fmp32, st32, spec, 1e-2, cg_tol=1e-4, cg_maxiter=100)
    two = engine.lm_step(fmp32, st32, spec, 1e-2, cg_tol=1e-4, cg_maxiter=100)
    same = all(torch.equal(a, c) for a, c in zip(one[:3], two[:3]))
    log(f"(a) f32 compact step twice (damping 1e-2, {one[4]} CG iterations):"
        f" bit-identical {same}")
    if not same:
        fail("rig (a): two f32 compact steps differ")
    del one, two, cp

    # ---- (b) time to converged on the rig ---------------------------------
    n_obs = 2 * int((prob64.obs_weight[:, 0, 0] > 0).sum())
    u = int(prob64.free_point.sum() + prob64.free_eo.sum()
            + prob64.free_global.sum())
    dof = n_obs - u

    def omega64(fmp, st):
        return float(engine.linearize(fmp, st, spec, 0.0).omega0)

    def gauss_newton(fmp, st):
        """One f64 Gauss-Newton step: (max|dx|, CG iterations)."""
        out = engine.lm_step(fmp, st, spec, 0.0, cg_tol=RIG_GN_CG_TOL,
                             cg_maxiter=RIG_CG_MAXITER)
        return float(torch.stack([a.abs().max() for a in out[:3]]).max()), \
            int(out[4])

    torch.cuda.synchronize()
    t = time.perf_counter()
    res = solver.solve(prob32, st32, spec, damping=1e-2, max_iterations=30,
                       tolerance=F32_STOP)
    torch.cuda.synchronize()
    t_f32 = time.perf_counter() - t
    hist = res.history
    st_f32 = type(st64)(*(a.double() for a in res.state))
    log(f"(b) solve (f32, plain): {res.status.name} after {res.iterations} "
        f"steps in {t_f32:.3f} s; max|dx| "
        + ", ".join(f"{h['max_dx']:.3e}" for h in hist)
        + f"; CG iterations {[h['cg_it'] for h in hist]}; preconditioner "
        f"{preconds(hist)}")
    # the coupled preconditioner at the f32 end: the definiteness of its
    # global Schur complement (it drops the camera-camera blocks)
    _, _, _, Mc = engine.prepare(fmp64, st_f32, spec, 0.0,
                                 couple_global=True)
    Sh = torch.linalg.inv(Mc.Sghat_inv)
    dsh = Sh.diagonal().abs().sqrt()
    eig_sh = torch.linalg.eigvalsh((Sh + Sh.T) / 2 / dsh[:, None]
                                   / dsh[None, :])
    n_neg = int((eig_sh < 0).sum())
    log(f"(b) coupled preconditioner at the f32 end (f64): Jacobi-scaled "
        f"Sghat eigenvalues {float(eig_sh[0]):.3e} .. "
        f"{float(eig_sh[-1]):.3e}, {n_neg} negative of {G}")
    del Mc, Sh
    # the mixed-precision refinement, the rig's route: its f32 inner solve
    # does not hold the rig's weakest mode, so the Refiner runs a rig's
    # inner solve in f64 (gated: the block-Jacobi run converges with an
    # f64 step; a run that reports convergence lies at
    # the optimum, one f64 Gauss-Newton step at its end moves <=
    # RIG_FALSE_END)
    prob_r = refine.upcast_problem(prob32)    # the refinement's problem
    fmp_r = engine.fm_problem(prob_r)
    phase = lm.LMPhase(steps=res.iterations, max_dx=res.max_abs_dx,
                       cg_iterations=[h["cg_it"] for h in hist],
                       seconds=t_f32)
    refined, ends = {}, {}
    for label, kw, steps in (
            ("block_jacobi", dict(couple_global=False), RIG_REFINE_STEPS),
            ("default", {}, RIG_COUPLED_STEPS)):
        torch.cuda.synchronize()
        refiner = refine.Refiner(prob32, spec, use_kernels=None, **kw)
        if refiner.use_kernels:
            fail("rig (b): the Refiner's own route took the kernels")
        s_ref, rec = refine.converge(refiner, (res.state, phase),
                                     tolerance=REFINE_TOL, damping=0.0,
                                     max_steps=steps)
        full = ends[label] = hilo.to_f64(s_ref)
        gn = gauss_newton(fmp_r, full)
        refined[label] = dict(steps=rec.refine_steps,
                              seconds=rec.refine_seconds,
                              max_dx=rec.max_dx, cg=rec.cg_iterations,
                              f64_steps=rec.f64_steps,
                              converged=rec.converged, f64_step=gn[0])
        log(f"(b) refine.converge undamped, {label} "
            f"({kw or 'coupled'}): converged {rec.converged}, "
            f"{rec.refine_steps} steps ({rec.f64_steps} in f64) in "
            f"{rec.refine_seconds:.3f} s; max|dx| "
            + ", ".join(f"{x:.3e}" for x in rec.max_dx)
            + (" (inf: the step's f64 CG returned its zero start)"
               if math.isinf(rec.max_dx[-1]) else "")
            + f"; CG iterations {rec.cg_iterations}; one f64 Gauss-Newton "
            f"step at its end moves {gn[0]:.3e} ({gn[1]} CG iterations)")
        if rec.converged and not gn[0] <= RIG_FALSE_END:
            fail(f"rig (b): refine.converge ({label}) reports convergence "
                 f"where one f64 Gauss-Newton step still moves {gn[0]:.3e}")
    bj = refined["block_jacobi"]
    if not (bj["converged"] and bj["f64_steps"] >= 1):
        fail(f"rig (b): the block-Jacobi refinement did not converge through "
             f"an f64 step (converged {bj['converged']}, f64 steps "
             f"{bj['f64_steps']}, max|dx| {bj['max_dx']})")
    # the cross-check: Gauss-Newton in f64 (plain path) from the f32 end,
    # on the refinement's f32-rounded observations (its optimum lies
    # ~5e-5 from that of the unrounded ones)
    torch.cuda.synchronize()
    t = time.perf_counter()
    res64 = solver.solve(prob_r, st_f32, spec, damping=0.0, max_iterations=10,
                         tolerance=REFINE_TOL, cg_tol=RIG_GN_CG_TOL,
                         cg_maxiter=RIG_CG_MAXITER)
    torch.cuda.synchronize()
    t_f64 = time.perf_counter() - t
    full = res64.state
    om_f32, om_end = omega64(fmp_r, st_f32), omega64(fmp_r, full)
    sigma0 = (om_end / dof) ** 0.5
    io_true = np.asarray(state_h.io)[:, 2]
    io_est = full.io[:, 2].cpu().numpy()
    own = [int(np.argmin(np.abs(io_true - x))) for x in io_est]
    prof = measure.device_profile(lambda: gauss_newton(fmp64, full))
    ttc = t_f32 + bj["seconds"]
    gap = max(float((a - b).abs().max())
              for a, b in zip(ends["block_jacobi"], full))
    log(f"(b) solve (f64, plain, Gauss-Newton from the f32 end, the "
        f"refinement's problem): "
        f"{res64.status.name} after {res64.iterations} steps in {t_f64:.3f} "
        f"s; max|dx| " + ", ".join(f"{h['max_dx']:.3e}"
                                   for h in res64.history)
        + f"; CG iterations {[h['cg_it'] for h in res64.history]}; "
        f"preconditioner {preconds(res64.history)}")
    log(f"(b) time_to_converged_s {ttc:.3f} (f32 {t_f32:.3f} + refinement "
        f"{bj['seconds']:.3f}); the refined state against the f64 solve's "
        f"end: {gap:.3e}; f64 Omega {om_f32:.10e} -> {om_end:.10e}; sigma0 "
        f"{sigma0:.6e} (dof {dof}); principal distances {io_est.tolist()} "
        f"(true {io_true.tolist()}); one f64 step under the profiler: "
        f"device busy {prof['busy_ms']:.1f} of {prof['wall_ms']:.1f} ms "
        f"(idle {prof['idle_share']:.1%}), {prof['launches']} launches")
    problems = []
    if not (res64.converged and res64.max_abs_dx <= REFINE_TOL):
        problems.append(f"the f64 solve did not reach max|dx| <= "
                        f"{REFINE_TOL} ({res64.status.name})")
    if not abs(sigma0 / SIGMA - 1.0) < 0.01:
        problems.append(f"sigma0 {sigma0:.6e} not within 1% of {SIGMA}")
    if not om_end <= om_f32 * (1.0 + 1e-9):
        problems.append("the f64 Omega rose above the f32 end's")
    if own != list(range(C)):
        problems.append(f"principal distances {io_est.tolist()} lie "
                        f"closest to cameras {own}")
    if not gap <= RIG_FALSE_END:
        problems.append(f"the refined state lies {gap:.3e} from the f64 "
                        f"solve's end")
    if problems:
        fail("rig (b): " + "; ".join(problems))

    # ---- (c) cov_all on the rig, f64 ----------------------------------------
    (Qall, s_cov) = events(lambda: cov_direct.cov_all(fmp64, full, spec))
    b0 = engine.materialize_global_rows(
        fmp64, engine.linearize(fmp64, full, spec, 0.0))
    S = cov_direct.assemble_reduced_dense(fmp64, b0)
    Qred = cov_direct.reduced_inverse(S)
    uu = S.shape[0]
    d = S.diagonal().sqrt()
    resid = float(((S @ Qred) * d[None, :] / d[:, None]
                   - torch.eye(uu, dtype=S.dtype, device=dev)).abs().max())
    S_ref = reduced_system_by_sums(fmp64, jacobian_rows(b0))
    s_err = float(((S - S_ref) / d[:, None] / d[None, :]).abs().max())
    del S_ref
    log(f"(c) cov_all (f64, u = {uu}): {s_cov:.3f} s between CUDA events; "
        f"Jacobi-scaled max|S - S_ref| (second assembly route) {s_err:.3e};"
        f" Jacobi-scaled residual {resid:.3e}")
    if not (s_err <= COV_S_TOL and resid <= COV_RESIDUAL_TOL):
        fail(f"rig (c): S vs the second route {s_err:.3e} (limit "
             f"{COV_S_TOL}), residual {resid:.3e} (limit {COV_RESIDUAL_TOL})")

    # ---- (d) covariance on demand against (c) ------------------------------
    rng = np.random.default_rng(10)
    free = np.flatnonzero(prob_h.free_point[:, 0] > 0)
    ids = rng.choice(free, RIG_COV_K, replace=False)
    pairs = rng.choice(free, (RIG_COV_K, 2), replace=False)
    images = rng.choice(NUM_IMAGES, RIG_COV_K, replace=False)
    b, Minv = covariance.prepare(fmp64, full, spec)
    precond = "coupled" if Minv.Scg is not None else "block Jacobi"
    log(f"(d) covariance.prepare's preconditioner: {precond} (the coupled "
        f"one where its global Schur complement is positive definite)")
    on_demand = {"preconditioner": precond}
    for name, fn, arg, ref in (
            ("points", covariance.point_covariance_blocks, ids,
             Qall[torch.as_tensor(ids, device=dev)]),
            ("pairs", covariance.point_pair_covariance_blocks, pairs,
             cov_direct.point_pair_covariance_dense(fmp64, b0, Qred, pairs)),
            ("cameras", covariance.camera_covariance_blocks, images,
             cov_direct.camera_covariance_dense(Qred, images))):
        stats = {}
        (blk, sec) = events(lambda: fn(fmp64, b, Minv, arg,
                                       tol=RIG_COV_PCG_TOL, maxiter=2000,
                                       stats=stats))
        err = block_err(blk, ref)
        on_demand[name] = dict(pcg_iterations=stats["iterations"],
                               seconds=sec, block_err=err)
        log(f"(d) {name} on demand: {stats['iterations']} PCG iterations in "
            f"{sec:.3f} s; block error vs the dense route {err:.3e}")
        if not err <= RIG_COV_TOL:
            fail(f"rig (d): the {name} blocks differ from the dense route "
                 f"by {err:.3e} > {RIG_COV_TOL}")
    # recorded: the point blocks with the coupled preconditioner, which
    # keeps no guarantee where it is indefinite
    _, _, _, Mc = engine.prepare(fmp64, full, spec, 0.0, couple_global=True)
    stats = {}
    (blk, sec) = events(lambda: covariance.point_covariance_blocks(
        fmp64, b, Mc, ids, tol=RIG_COV_PCG_TOL, maxiter=2000, stats=stats))
    err = block_err(blk, Qall[torch.as_tensor(ids, device=dev)])
    on_demand["points_coupled"] = dict(pcg_iterations=stats["iterations"],
                                       seconds=sec, block_err=err)
    log(f"(d) points with the coupled preconditioner, recorded: "
        f"{stats['iterations']} PCG iterations in {sec:.3f} s; block error "
        f"{err:.3e}")
    del b, Minv, Mc, b0, S, Qred, Qall

    # ---- (e) the reference API on a two-camera scene ------------------------
    MI, OK = T.MatrixInversion, T.EstimationState.ERROR_FREE_ESTIMATION

    def estimate(cls, scene, where):
        cams, bars, truth = scene
        adj = cls(device=where)
        adj.add(*cams, *bars)
        adj.set_invert_normal_equation(MI.NONE)
        (status, sec) = events(adj.estimate_model)
        if status != OK:
            fail(f"rig (e): {cls.__name__} on {where}: status {status!r}")
        xyz = np.array([[o.x.value, o.y.value, o.z.value]
                        for o in truth["coords"]])
        return adj, xyz, sec

    api = {}
    for cls in (T.ScaleBundleAdjustment, T.BundleAdjustment):
        adj, xyz, sec = estimate(cls, two_camera_scene(*RIG_API), dev)
        api[cls.__name__] = (adj, xyz, sec)
        log(f"(e) {cls.__name__}, two cameras, {RIG_API[0]} points / "
            f"{RIG_API[1]} images (n {adj.problem.num_observation_rows}, "
            f"u {adj.problem.num_unknowns}, d {adj.problem.defect}): "
            f"{adj.iteration_step} iterations in {sec:.3f} s, sigma0 "
            f"{np.sqrt(adj.get_variance_factor_aposteriori()):.6e}")
    (sa, xs, _), (da, xd, _) = api["ScaleBundleAdjustment"], \
        api["BundleAdjustment"]
    field = float(np.abs(xd).max())
    xyz_err = float(np.abs(xs - xd).max())
    log(f"(e) scale class against the dense solver: max|dxyz| {xyz_err:.3e}"
        f" ({xyz_err / field:.3e} of the field), Omega ratio "
        f"{sa.omega / da.omega:.12f}")
    if not xyz_err <= RIG_API_XYZ * field:
        fail(f"rig (e): the scale class differs from the dense solver by "
             f"{xyz_err:.3e} > {RIG_API_XYZ} of the field")
    cut = [estimate(T.ScaleBundleAdjustment, two_camera_scene(*RIG_API_CUT),
                    w)[1] for w in ("cpu", dev)]
    cut_err = float(np.abs(cut[1] - cut[0]).max() / np.abs(cut[0]).max())
    log(f"(e) scale class CPU against card at {RIG_API_CUT}: coordinates "
        f"{cut_err:.2e} of the field")
    if not cut_err <= API_CPU_TOL:
        fail(f"rig (e): card and CPU differ by {cut_err:.2e}")

    launches = kernels.launch_counts()
    seconds = time.time() - t_phase
    log(f"phase 10: {seconds:.1f} s; launches {launches} (route: plain, "
        "by design; the per-image sums through the image-sum kernel)")
    if any(solve_kernel_launches(launches).values()) \
            or not launches["image_sum"]:
        fail(f"the rig launched K1 to K4, or its per-image sums missed the "
             f"image-sum kernel: {launches}")
    return dict(
        rig_step_err=errs, rig_step_cg=cg_a,
        rig_solve_f32_steps=res.iterations, rig_solve_f32_s=t_f32,
        rig_solve_f32_cg=[h["cg_it"] for h in hist],
        rig_solve_f32_precond=preconds(hist),
        rig_solve_f64_steps=res64.iterations, rig_solve_f64_s=t_f64,
        rig_solve_f64_cg=[h["cg_it"] for h in res64.history],
        rig_solve_f64_precond=preconds(res64.history),
        rig_time_to_converged_s=ttc, rig_sigma0=sigma0,
        rig_sghat_negative=n_neg, rig_refine=refined,
        rig_refine_vs_f64_solve=gap,
        rig_f64_step_idle_share=prof["idle_share"],
        rig_cov_all_s=s_cov, rig_cov_residual=resid, rig_cov_s_err=s_err,
        rig_on_demand=on_demand, rig_api_xyz_err=xyz_err,
        rig_api_cpu_vs_card=cut_err, rig_image_sum=image_sum,
        rig_phase_s=seconds), launches


def same_bits(a, b) -> bool:
    """Equal dtype, shape and bits (floats compared as integers, so -0.0
    and 0.0 differ)."""
    import torch

    if a is None or b is None:
        return a is None and b is None
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        ints = {torch.float32: torch.int32, torch.float64: torch.int64}
        return torch.equal(a.contiguous().view(ints[a.dtype]),
                           b.contiguous().view(ints[b.dtype]))
    return torch.equal(a, b)


def file_route_phase(prob_h, state_h, spec, dev):
    """Phase 11 (see the module docstring).  Returns (summary dict, the
    launch counts of the file route's solve and refinement)."""
    import numpy as np
    import torch

    from bundle_adjustment_tpu_torch import convert, native, synthetic
    from bundle_adjustment_tpu_torch.io import columnar
    from bundle_adjustment_tpu_torch.parallel import (hilo, kernels, lm,
                                                      refine, solver)
    from bundle_adjustment_tpu_torch.solver import tracing
    from bundle_adjustment_tpu_torch.solver.checkpoint import LMCheckpoint

    f32 = torch.float32
    work = WORK / "phase11"
    work.mkdir(parents=True, exist_ok=True)
    t = time.perf_counter()
    paths = synthetic.write_flat(str(work / "net"), prob_h, state_h)
    write_s = time.perf_counter() - t
    sizes = {k: os.path.getsize(v) for k, v in paths.items()}
    log(f"flat files written in {write_s:.2f} s: " + ", ".join(
        f"{k} {v / 1e6:.1f} MB" for k, v in sizes.items()))

    # the native loader against its plain version on the image file
    t = time.perf_counter()
    native.build()
    loader_build_s = time.perf_counter() - t
    t = time.perf_counter()
    tn = native.parse_table(paths["imagecoords"], "iisfffff")
    parse_native_s = time.perf_counter() - t
    t = time.perf_counter()
    tp = native.parse_table_py(paths["imagecoords"], "iisfffff")
    parse_py_s = time.perf_counter() - t
    same = (tn.rows == tp.rows
            and np.array_equal(tn.floats, tp.floats, equal_nan=True)
            and np.array_equal(tn.ncols, tp.ncols)
            and all(np.array_equal(a[0], b[0]) and a[1] == b[1]
                    for a, b in zip(tn.keys, tp.keys)))
    log(f"parse of {tn.rows} image rows: native {parse_native_s:.3f} s "
        f"(g++ build {loader_build_s:.2f} s), Python {parse_py_s:.3f} s; "
        f"floats, keys and column counts equal: {same}")
    if not same:
        fail("the native loader's table differs from parse_table_py's")
    del tn, tp

    # build_rcs_problem against the in-memory problem without the pads
    torch.cuda.synchronize()
    t = time.perf_counter()
    fp, fs, _ = columnar.build_rcs_problem(
        paths["points"], paths["imagecoords"], paths["eor"],
        io_path=paths["ior"], spec=synthetic.scale_spec(), dist=state_h.dist,
        device=dev, dtype=f32)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    cp_h, cs_h = synthetic.as_read_from_files(prob_h, state_h)
    cp = convert.problem_to_torch(cp_h, dev, f32)
    cs = convert.state_to_torch(cs_h, dev, f32)
    diff = [f for f in fp._fields
            if not (same_bits(getattr(fp, f), getattr(cp, f))
                    if isinstance(getattr(cp, f), torch.Tensor)
                    or getattr(cp, f) is None
                    else getattr(fp, f) == getattr(cp, f))]
    diff += [f"state.{f}" for f in fs._fields
             if not same_bits(getattr(fs, f), getattr(cs, f))]
    log(f"build_rcs_problem: P={fp.num_points} M={fp.num_images} "
        f"V={fp.point_uniform} N={fp.obs_point.shape[0]} in {build_s:.2f} s "
        f"(host parse and layout, then the copy to the card); every field "
        f"and the state equal to the in-memory control bit for bit: "
        f"{not diff}")
    if diff:
        fail(f"the file-built problem differs from its control in {diff}")

    # solve (f32, through the kernels) on both; checkpoints
    kw = dict(damping=1e-2, max_iterations=30, tolerance=F32_STOP)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    rf = solver.solve(fp, fs, spec, **kw)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t
    launches_solve = kernels.launch_counts()
    rc = solver.solve(cp, cs, spec, **kw)
    equal = (rf.iterations == rc.iterations
             and all(same_bits(getattr(rf.state, f), getattr(rc.state, f))
                     for f in rf.state._fields))
    log(f"solve (f32, kernels) on the file route: {rf.status.name} after "
        f"{rf.iterations} steps in {solve_s:.3f} s, max|dx| "
        f"{rf.max_abs_dx:.3e}, CG {[h['cg_it'] for h in rf.history]}, "
        f"preconditioner {preconds(rf.history)}; "
        f"launches {launches_solve}; the control {rc.iterations} steps; "
        f"equal bits and steps: {equal}")
    if not equal:
        fail("solve on the file-built problem differs from the control's")
    if not rf.converged:
        fail(f"solve on the file route did not reach max|dx| <= {F32_STOP}")
    if min(launches_solve[k] for k in SOLVE_KERNELS) <= 0:
        fail(f"a kernel of the file route's solve never launched: "
             f"{launches_solve}")
    ck_path = work / "checkpoint.npz"
    rk = solver.solve(fp, fs, spec, **{**kw, "max_iterations":
                                       CHECKPOINT_EVERY},
                      checkpoint_path=str(ck_path),
                      checkpoint_every=CHECKPOINT_EVERY)
    ck = LMCheckpoint.load(str(ck_path))
    ck_same = (ck.iteration == CHECKPOINT_EVERY and all(
        same_bits(torch.as_tensor(getattr(ck.state, f)),
                  getattr(rk.state, f).cpu()) for f in rk.state._fields))
    log(f"checkpoint after {ck.iteration} iterations: points "
        f"{ck.state.points.shape}, equal to the returned state bit for bit:"
        f" {ck_same}")
    if not ck_same:
        fail("the checkpoint differs from the state solve returned")

    # the refinement, undamped, from the file route's end
    refiner = refine.Refiner(fp, spec, use_kernels=True)
    st = rf.state
    om_f32 = float(refiner.gradient64(
        refiner.fmp64, type(st)(*(a.double() for a in st)))[3])
    n_obs = 2 * int((fp.obs_weight[:, 0, 0] > 0).sum())
    u = int(fp.free_point.sum() + fp.free_eo.sum() + fp.free_global.sum())
    dof = n_obs - u
    phase = lm.LMPhase(steps=rf.iterations, max_dx=rf.max_abs_dx,
                       cg_iterations=[h["cg_it"] for h in rf.history],
                       seconds=solve_s)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    s_ref, rec = refine.converge(refiner, (st, phase), tolerance=REFINE_TOL,
                                 damping=0.0)
    launches_ref = kernels.launch_counts()
    om = float(refiner.gradient64(refiner.fmp64, hilo.to_f64(s_ref))[3])
    sigma0 = (om / dof) ** 0.5
    log(f"refinement (undamped, kernels): {rec.refine_steps} steps in "
        f"{rec.refine_seconds:.3f} s; max|dx| " + ", ".join(
            f"{x:.3e}" for x in rec.max_dx) + f"; CG {rec.cg_iterations}; "
        f"f64 Omega {om_f32:.10e} -> {om:.10e}; dof {dof}; sigma0 "
        f"{sigma0:.6e}; launches {launches_ref}")
    problems = []
    if not rec.max_dx[-1] <= REFINE_TOL:
        problems.append(f"max|dx| {rec.max_dx[-1]:.3e} > {REFINE_TOL}")
    if not om <= om_f32 * (1.0 + 1e-9):
        problems.append("Omega rose above the f32 end's")
    if not abs(sigma0 / SIGMA - 1.0) < 0.01:
        problems.append(f"sigma0 {sigma0:.6e} not within 1% of {SIGMA}")
    if min(launches_ref[k] for k in SOLVE_KERNELS) <= 0:
        problems.append(f"a kernel never launched: {launches_ref}")
    if problems:
        fail("the file route's refinement: " + "; ".join(problems))
    launches = {k: launches_solve[k] + launches_ref[k]
                for k in launches_solve}
    del refiner, s_ref, rc, cp, cs

    # one solve step under tracing.device_trace
    logdir = work / "trace"
    t = time.perf_counter()
    with tracing.device_trace(str(logdir)):
        solver.solve(fp, st, spec, damping=1e-2, max_iterations=1,
                     tolerance=F32_STOP)
    trace_s = time.perf_counter() - t
    text = (logdir / tracing.TRACE_FILE).read_text()
    named = {k: k in text for k in TRACE_KERNELS}
    log(f"device_trace of one step: {len(text) / 1e6:.1f} MB Chrome trace "
        f"in {trace_s:.2f} s; names {named}")
    if not all(named.values()):
        fail(f"the trace does not name every kernel of the step: {named}")
    return dict(
        file_write_s=write_s, file_sizes=sizes,
        file_parse_native_s=parse_native_s, file_parse_py_s=parse_py_s,
        file_loader_build_s=loader_build_s, file_build_s=build_s,
        file_solve_steps=rf.iterations, file_solve_s=solve_s,
        file_solve_cg=[h["cg_it"] for h in rf.history],
        file_solve_precond=preconds(rf.history),
        file_refine_steps=rec.refine_steps,
        file_refine_s=rec.refine_seconds, file_refine_max_dx=rec.max_dx,
        file_omega_f32=om_f32, file_omega=om, file_sigma0=sigma0,
        file_dof=dof, file_trace_s=trace_s), launches


def short_name(i: int) -> str:
    """i >= 1 in base 36: at most 3 characters up to 46,655."""
    digits = "0123456789abcdefghijklmnopqrstuvwxyz"
    out = ""
    while i:
        i, r = divmod(i, 36)
        out = digits[r] + out
    return out


def cli_phase(dev):
    """Phase 12 (see the module docstring).  Returns (summary dict, the
    launch counts of the phase: none, every run is float64)."""
    import numpy as np
    import scipy.io as sio
    import torch

    import bundle_adjustment_tpu_torch as T
    from bundle_adjustment_tpu_torch.init import dlt, transformation
    from bundle_adjustment_tpu_torch.io import readers, scene_files
    from bundle_adjustment_tpu_torch.models.problem import ParamState
    from bundle_adjustment_tpu_torch.ops.assembly import make_assembler
    from bundle_adjustment_tpu_torch.parallel import kernels
    from bundle_adjustment_tpu_torch.testing import make_synthetic_scene

    kernels.reset_launch_counts()
    work = WORK / "phase12"
    work.mkdir(parents=True, exist_ok=True)
    base = str(work / "net")
    cams, bars, truth = make_synthetic_scene(
        num_points=API_POINTS, num_images=API_IMAGES, noise=SIGMA,
        sigma=SIGMA, perturb=0.01, seed=0)
    # names of at most 3 characters: every point stays in the CLI's datum
    # (its --datum-name-length 3 heuristic), as in phase 9
    for i, oc in enumerate(truth["coords"]):
        oc.name = short_name(i + 1)
    t = time.perf_counter()
    scene_files.write_aicon_files(base, cams[0], bars)
    scene_files.write_aicon_report(base + ".txt", cams[0], bars)
    log(f"phase 9's scene written as AICON files and report in "
        f"{time.perf_counter() - t:.2f} s (.phc "
        f"{os.path.getsize(base + '.phc') / 1e6:.1f} MB, report "
        f"{os.path.getsize(base + '.txt') / 1e6:.1f} MB)")

    def cli(*args):
        cmd = [sys.executable, "-m", "bundle_adjustment_tpu_torch", *args]
        t = time.perf_counter()
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=900)
        wall = time.perf_counter() - t
        if res.returncode != 0:
            fail(f"{' '.join(cmd[1:])} exited {res.returncode}: "
                 f"{res.stderr[-2000:]}")
        nums = {}
        for line in res.stdout.splitlines():
            key, _, val = line.partition(":")
            if val and not key.startswith("Estimation time"):
                nums[key.strip()] = float(val)
        return nums, wall

    def in_process(sub, mode):
        """The CLI's network, read and estimated in this process on the
        card (the same readers and datum rule as the CLI)."""
        if sub == "flat":
            coords = readers.read_obc(base + ".obc")
            sbars = readers.read_scale(base + ".scale", coords)
            cam = readers.read_ior(base + ".ior")
            readers.read_eor(base + ".eor", cam)
            readers.read_phc(base + ".phc", cam, coords)
            adj = T.BundleAdjustment(device=dev)
            adj.add(cam, *sbars)
            cameras = [cam]
        else:
            adj, reader = readers.read_aicon_report(base + ".txt", device=dev)
            cameras = list(reader.cameras.values())
        for cam in cameras:
            for img in cam:
                for ic in img:
                    if len(ic.object_coordinate.name) > 3:
                        ic.object_coordinate.set_datum(False)
        adj.set_invert_normal_equation(mode)
        t = time.perf_counter()
        status = adj.estimate_model()
        sec = time.perf_counter() - t
        if status != T.EstimationState.ERROR_FREE_ESTIMATION:
            fail(f"in-process {sub} estimate: {status!r}")
        return adj, cameras, sec

    def mat_coords(m):
        c = m["coordinates"]
        return np.array([[np.asarray(c[a][0, i]).item() for a in "XYZ"]
                         for i in range(c.shape[1])])

    out, mats = {}, {}
    for sub, target in (("flat", base), ("report", base + ".txt")):
        exp = str(work / sub)
        nums, wall = cli(sub, target, "--inversion", "reduced", "--export",
                         exp, "--export-mat", exp)
        adj, _, sec = in_process(sub, T.MatrixInversion.REDUCED)
        want = {"Number of observations": adj.get_number_of_observations(),
                "Number of unknown parameters":
                    adj.get_number_of_unknown_parameters(),
                "Number of datum conditions":
                    adj.get_number_of_datum_conditions(),
                "Degree of freedom": adj.get_degree_of_freedom()}
        counts_ok = all(nums.get(k) == v for k, v in want.items())
        s_cli = math.sqrt(nums["Variance of unit weight (post)"])
        s_in = math.sqrt(adj.get_variance_factor_aposteriori())
        s_rel = abs(s_cli / s_in - 1.0)
        m = sio.loadmat(exp + ".mat")
        mats[sub] = m
        xyz = mat_coords(m)
        xyz_in = np.array([[oc.x.value, oc.y.value, oc.z.value]
                           for oc in adj.get_object_coordinates()])
        field = np.abs(xyz_in).max()
        xyz_rel = float(np.abs(xyz - xyz_in).max() / field)
        Q = adj.get_cofactor_matrix().cpu().numpy()
        cols = [p.column for oc in adj.get_object_coordinates()
                for p in oc.params if p.column >= 0]
        d_in = np.diagonal(Q)[cols]
        d_mat = np.diagonal(m["dispersion"])[:len(cols)]
        # of the largest variance (the gate), and entry by entry; the dense
        # assembly sums in a fixed order, so the two processes' cofactors
        # are the same bits (gated too)
        q_rel = float(np.abs(d_mat - d_in).max() / np.abs(d_in).max())
        q_each = float(np.abs(d_mat / d_in - 1.0).max())
        q_bits = bool(np.array_equal(d_mat, d_in))
        # two assemblies of the same state in this process: the same bits
        assemble = make_assembler(adj.compiled.problem, dev, torch.float64)
        st0 = ParamState(*(torch.as_tensor(np.asarray(a), device=dev,
                                           dtype=torch.float64)
                           for a in adj.compiled.state))
        N1, n1, _ = assemble(st0, 0.0)
        N2, n2, _ = assemble(st0, 0.0)
        asm_bits = bool(torch.equal(N1, N2) and torch.equal(n1, n2))
        del N1, N2, n1, n2
        # .info and .cxx against the .mat (15 decimals printed)
        info = np.loadtxt(exp + ".info", dtype=str, delimiter="\t")
        info_err = float(np.abs(info[:, 2].astype(float)
                                - xyz.reshape(-1)).max())
        cxx = np.loadtxt(exp + ".cxx")
        s2 = float(m["variance_of_unit_weight_post"].item())
        cxx_err = float(np.abs(cxx - s2 * m["dispersion"][:len(cols),
                                                         :len(cols)]).max())
        log(f"CLI {sub} on the card: exit 0 in {wall:.2f} s (in-process "
            f"estimate {sec:.2f} s); n {int(nums['Number of observations'])} "
            f"u {int(nums['Number of unknown parameters'])} "
            f"d {int(nums['Number of datum conditions'])} dof "
            f"{int(nums['Degree of freedom'])} equal to in-process: "
            f"{counts_ok}; sigma0 {s_cli:.12e} ({s_rel:.2e} relative); .mat "
            f"coordinates {xyz_rel:.2e} of the field, cofactor diagonal "
            f"{q_rel:.2e} of its largest entry ({q_each:.2e} entry by "
            f"entry; equal bits: {q_bits}); two assemblies equal bits: "
            f"{asm_bits}; .info vs .mat {info_err:.1e}, .cxx vs .mat "
            f"{cxx_err:.1e}")
        problems = []
        if not counts_ok:
            problems.append(f"counts {nums} against {want}")
        if not s_rel <= CLI_SIGMA0_RTOL:
            problems.append(f"sigma0 {s_rel:.2e} relative")
        if not (xyz_rel <= CLI_RTOL and q_rel <= CLI_RTOL):
            problems.append(f".mat {xyz_rel:.2e} / {q_rel:.2e}")
        if not (info_err <= 1e-12 * field and cxx_err <= 1e-15):
            problems.append(f".info {info_err:.1e} / .cxx {cxx_err:.1e}")
        if not (q_bits and asm_bits):
            problems.append(f"bits: cofactor diagonal {q_bits}, two "
                            f"assemblies {asm_bits}")
        if problems:
            fail(f"CLI {sub} against the in-process estimate: "
                 + "; ".join(problems))
        out[sub] = dict(wall_s=wall, in_process_s=sec, sigma0=s_cli,
                        sigma0_rel=s_rel, xyz_rel=xyz_rel, q_rel=q_rel,
                        q_rel_each=q_each, q_bits=q_bits,
                        assembly_bits=asm_bits,
                        n=int(nums["Number of observations"]),
                        u=int(nums["Number of unknown parameters"]))

    # the CLI on the CPU against the card
    exp = str(work / "flat_cpu")
    _, wall_cpu = cli("flat", base, "--inversion", "reduced", "--cpu",
                      "--export-mat", exp)
    m_cpu = sio.loadmat(exp + ".mat")
    xyz_c, xyz_g = mat_coords(m_cpu), mat_coords(mats["flat"])
    cpu_xyz = float(np.abs(xyz_c - xyz_g).max() / np.abs(xyz_g).max())
    cpu_s2 = abs(float(m_cpu["variance_of_unit_weight_post"].item())
                 / float(mats["flat"]["variance_of_unit_weight_post"].item())
                 - 1.0)
    log(f"CLI flat --cpu: exit 0 in {wall_cpu:.2f} s; against the card: "
        f"coordinates {cpu_xyz:.2e} of the field, sigma0^2 {cpu_s2:.2e}")
    if not (cpu_xyz <= CLI_RTOL and cpu_s2 <= CLI_RTOL):
        fail(f"the CLI on the CPU differs from the card: {cpu_xyz:.2e}, "
             f"{cpu_s2:.2e}")

    # DLT on noise-free images of the same geometry, card against CPU
    cams2, _, truth2 = make_synthetic_scene(
        num_points=API_POINTS, num_images=API_IMAGES, noise=0.0,
        with_distortion=False, with_scale_bar=False, seed=0)
    coords2 = {oc.name: oc for oc in truth2["coords"]}
    t = time.perf_counter()
    dlt_err, eo_err, c_err = 0.0, 0.0, 0.0
    for k, img in enumerate(cams2[0].images[:DLT_IMAGES]):
        rg = dlt.adjust(img, coords2, device=dev)
        rc_ = dlt.adjust(img, coords2, device="cpu")
        # the angles compared modulo 2 pi: atan2 near +-pi may land on
        # either side for the same rotation
        turn = np.remainder(rg.eo[3:] - rc_.eo[3:] + np.pi, 2 * np.pi) - np.pi
        for a, b in ((rg.b, rc_.b), (rg.eo[:3], rc_.eo[:3]), (turn, 0.0),
                     ([rg.x0, rg.y0, rg.c], [rc_.x0, rc_.y0, rc_.c])):
            a, b = np.asarray(a), np.asarray(b)
            dlt_err = max(dlt_err, float(np.abs(a - b).max()
                                         / max(1.0, np.abs(b).max())))
        eo_err = max(eo_err, float(np.abs(rg.eo[:3]
                                          - truth2["eo"][k, :3]).max()),
                     abs(rg.x0 - truth2["io"][0]),
                     abs(rg.y0 - truth2["io"][1]))
        c_err = max(c_err, abs(abs(rg.c) / abs(truth2["io"][2]) - 1.0))
    dlt_s = time.perf_counter() - t
    log(f"DLT on {DLT_IMAGES} images (card and CPU, {dlt_s:.2f} s): card "
        f"against CPU {dlt_err:.2e}; against the truth: centre / principal "
        f"point {eo_err:.2e}, |c| {c_err:.2e} relative")
    if not (dlt_err <= DLT_CPU_TOL and eo_err <= DLT_EO_ATOL
            and c_err <= DLT_C_RTOL):
        fail(f"DLT: card vs CPU {dlt_err:.2e}, truth {eo_err:.2e} / "
             f"{c_err:.2e}")

    # transform of datum points through a reference image with the card's
    # Qxx (a FULL estimate: Qxx holds the EO blocks), card against CPU
    adj, cameras, _ = in_process("flat", T.MatrixInversion.FULL)
    imgs = cameras[0].images
    pts = [ic.object_coordinate for ic in imgs[1]][:20]
    s2 = adj.get_variance_factor_aposteriori()
    t = time.perf_counter()
    tg = transformation.transform(pts, {imgs[0]: imgs[1:3]}, s2, adj.Qxx)
    tr_s = time.perf_counter() - t
    tc = transformation.transform(pts, {imgs[0]: imgs[1:3]}, s2,
                                  adj.Qxx.cpu())
    sd = np.sqrt(np.diagonal(tc.covariance))
    tr_pts = float(np.abs(tg.points - tc.points).max()
                   / np.abs(tc.points).max())
    tr_cov = float(np.abs((tg.covariance - tc.covariance) / sd[:, None]
                          / sd[None, :]).max())
    log(f"transform of {len(tg.names)} (point, image) pairs on the card "
        f"({tr_s:.3f} s) against the CPU: points {tr_pts:.2e}, covariance "
        f"{tr_cov:.2e} (correlation scale)")
    if not (tr_pts <= DLT_CPU_TOL and tr_cov <= DLT_CPU_TOL
            and len(tg.names) > 0):
        fail(f"transform: card vs CPU {tr_pts:.2e} / {tr_cov:.2e}")
    launches = kernels.launch_counts()
    if any(solve_kernel_launches(launches).values()):
        fail(f"the float64 CLI phase launched K1 to K4: {launches}")
    return dict(cli=out, cli_cpu_wall_s=wall_cpu, cli_cpu_xyz_rel=cpu_xyz,
                dlt_card_vs_cpu=dlt_err, dlt_truth=eo_err, dlt_s=dlt_s,
                transform_card_vs_cpu=[tr_pts, tr_cov]), launches


# ---------------------------------------------------------------------------
# phases 13-14: the sharded and scenario-batched paths
# ---------------------------------------------------------------------------

def _cpu(x):
    return x.detach().cpu()


def _state_rec(points, io, dist, eo, **extra):
    return dict(points=_cpu(points), io=_cpu(io), dist=_cpu(dist),
                eo=_cpu(eo), **extra)


def _timed(fn):
    """(fn(), seconds between synchronised ends)."""
    import torch

    sync = torch.cuda.synchronize if torch.cuda.is_available() \
        else (lambda: None)
    sync()
    t = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t


def sharded_rank(comm, shape, uneven_path):
    """Phase 13 on one rank of ``comm`` (a spawned process on the card):
    the point-sharded step (replicated and cam_shard, SHARD_STEPS steps
    each), the block-cyclic Cholesky of the reduced system and the
    observation-sharded step on the uniform network and, (e), on the
    file-order network saved at ``uneven_path`` (`save_network`), with
    wall times.  At world size 1 it also computes the single-process
    references on the card: engine.lm_step (SHARD_STEPS steps),
    torch.linalg.cholesky, PCG at TP_PCG_TOL, torch.cholesky_inverse, the
    Gauss-Newton engine step of (d) and `rcs.lm_step` of (e), and runs
    (e)'s f32 step through K3 and on the plain gather.  ``shape``:
    (points, images, views) of `synthetic.build_problem`.  Every value
    returned is on the host; ``launches`` counts (a)-(e) but (e)'s f32
    step through K3, which ``launches_k3`` counts."""
    import hashlib

    import torch

    from bundle_adjustment_tpu_torch import convert, synthetic
    from bundle_adjustment_tpu_torch.parallel import (engine, kernels, rcs,
                                                      spmd, spmd_fm, tp)

    kernels.reset_launch_counts()
    dev = comm.device
    prob_h, state_h, spec = synthetic.build_problem(*shape, seed=0)
    prob = convert.problem_to_torch(prob_h, dev, torch.float64)
    st = convert.state_to_torch(state_h, dev, torch.float64)
    fmp = engine.fm_problem(prob)
    out = dict(repr=repr(comm))
    runs = ((SHARD_CG_TOL, SHARD_STEPS), (SHARD_STATE_CG_TOL, 1))

    if comm.size == 1:
        for tol, steps in runs:
            ref, s = [], st
            for _ in range(steps):
                (dxp, dxc, dxg, b, it), sec = _timed(lambda: engine.lm_step(
                    fmp, s, spec, SHARD_DAMPING, cg_tol=tol,
                    cg_maxiter=SHARD_CG_MAXITER))
                s, mdx = rcs.apply_step(s, dxp, dxc, dxg)
                ref.append(_state_rec(*s, max_dx=float(mdx),
                                      omega0=float(b.omega0), it=it, s=sec))
            out[("engine", tol)] = ref

    # (a) / (b): the point-sharded step
    for mode in SHARD_MODES:
        cam = mode == "cam_shard"
        p2, s2, _ = spmd_fm.pad_for_mesh(prob, st, comm, images=cam)
        for tol, steps in runs:
            step, args = spmd_fm.make_spmd_fm_lm_step(
                p2, s2, spec, comm, damping=SHARD_DAMPING, cam_shard=cam,
                cg_tol=tol, cg_maxiter=SHARD_CG_MAXITER)
            res = []
            for _ in range(steps):
                (args, mdx, om, it), sec = _timed(lambda: step(*args))
                res.append(_state_rec(comm.all_gather(args[0]), *args[1:],
                                      max_dx=float(mdx), omega0=float(om),
                                      it=it, s=sec))
            out[(mode, tol)] = res

    # (c): the reduced system of that network, factorised over the ranks
    b, rc, rg, Minv = engine.prepare(fmp, st, spec, SHARD_DAMPING,
                                     couple_global=True)
    (S, r), t_asm = _timed(lambda: tp.assemble_reduced_system(fmp, b))
    u = S.shape[0]
    step_n = comm.size * TP_BLOCK
    Sp, rp = tp.pad_spd(S, r, -(-u // step_n) * step_n)
    tp.distributed_cholesky(Sp, comm, TP_BLOCK)  # warm
    L, t_fac = _timed(lambda: tp.distributed_cholesky(Sp, comm, TP_BLOCK))
    x, t_solve = _timed(lambda: tp.distributed_cholesky_solve(L, rp, comm))
    idx = [int(i) for i in torch.linspace(0, u - 1, TP_COLUMNS)]
    Q, t_cols = _timed(lambda: tp.reduced_cofactor_columns(L, idx, u, comm))
    out["tp"] = dict(
        u=u, n=Sp.shape[0], block=TP_BLOCK, L=_cpu(tp.gather_factor(
            L, comm)[:u, :u]), x=_cpu(x[:u]), Q=_cpu(Q), idx=idx,
        S_sha=hashlib.sha256(_cpu(S).numpy().tobytes()).hexdigest(),
        assemble_s=t_asm, factor_s=t_fac, solve_s=t_solve, columns_s=t_cols)
    if comm.size == 1:
        torch.linalg.cholesky(S)  # warm
        Lref, t_ref = _timed(lambda: torch.linalg.cholesky(S))
        Lcpu = torch.linalg.cholesky(S.cpu())
        (xc, xg, it), t_pcg = _timed(lambda: rcs.pcg(
            rc, rg, Minv, lambda c, g: engine.schur_matvec(fmp, b, c, g),
            tol=TP_PCG_TOL, maxiter=TP_PCG_MAXITER))
        out["tp_ref"] = dict(
            L=_cpu(Lref), L_cpu=Lcpu, S=_cpu(S),
            D=_cpu(torch.sqrt(torch.diagonal(S))),
            x=_cpu(torch.cat([xc.reshape(-1), xg])), pcg_it=it, pcg_s=t_pcg,
            Q=_cpu(torch.cholesky_inverse(Lref)[:, idx]), cholesky_s=t_ref)
    del S, Sp, L, b

    # (d): the observation-sharded Gauss-Newton step
    sp = spmd.shard_problem(prob, comm)
    step = spmd.make_spmd_lm_step(sp, spec, comm, cg_tol=SPMD_CG_TOL,
                                  cg_maxiter=SHARD_CG_MAXITER)
    (new, mdx, om, it), sec = _timed(lambda: step(st))
    out["spmd"] = _state_rec(*new, max_dx=float(mdx), omega0=float(om),
                             it=it, s=sec)
    if comm.size == 1:
        (dxp, dxc, dxg, b, it), sec = _timed(lambda: engine.lm_step(
            fmp, st, spec, 0.0, cg_tol=SPMD_CG_TOL,
            cg_maxiter=SHARD_CG_MAXITER))
        s, mdx = rcs.apply_step(st, dxp, dxc, dxg)
        out["spmd_ref"] = _state_rec(*s, max_dx=float(mdx),
                                     omega0=float(b.omega0), it=it, s=sec)
    del sp, step, fmp

    # (e): the observation-sharded step on the file-order network
    fh, fsh = load_network(uneven_path)
    p64 = convert.problem_to_torch(fh, dev, torch.float64)
    s64 = convert.state_to_torch(fsh, dev, torch.float64)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    sp = spmd.shard_problem(p64, comm)
    step = spmd.make_spmd_lm_step(sp, spec, comm, cg_tol=SPMD_CG_TOL,
                                  cg_maxiter=SHARD_CG_MAXITER)
    (new, mdx, om, it), sec = _timed(lambda: step(s64))
    out["spmd_file"] = _state_rec(
        *new, max_dx=float(mdx), omega0=float(om), it=it, s=sec,
        rows=sp.rows, rows_padded=sp.rows_padded,
        peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9 if cuda
        else float("nan"))
    if comm.size == 1:
        (dxp, dxc, dxg, b, it), sec = _timed(lambda: rcs.lm_step(
            p64, s64, spec, 0.0, cg_tol=SPMD_CG_TOL,
            cg_maxiter=SHARD_CG_MAXITER))
        s, mdx = rcs.apply_step(s64, dxp, dxc, dxg)
        out["spmd_file_ref"] = _state_rec(*s, max_dx=float(mdx),
                                          omega0=float(b.omega0), it=it,
                                          s=sec)
    del sp, step, p64, s64
    out["launches"] = kernels.launch_counts()
    if comm.size == 1:  # the f32 step through K3, then on the plain gather
        sp = spmd.shard_problem(
            convert.problem_to_torch(fh, dev, torch.float32), comm)
        s32 = convert.state_to_torch(fsh, dev, torch.float32)
        runs = []
        for use in (None, False):
            step = spmd.make_spmd_lm_step(sp, spec, comm, **SPMD_F32,
                                          use_kernels=use)
            step(s32)  # warm
            kernels.reset_launch_counts()
            (new, mdx, om, it), sec = _timed(lambda: step(s32))
            runs.append((new, float(mdx), float(om), it, sec,
                         kernels.launch_counts()))
        (k_new, k_mdx, k_om, k_it, k_s, k_l), (p_new, p_mdx, p_om, p_it,
                                               p_s, _) = runs
        out["launches_k3"] = k_l
        out["spmd_file_f32"] = dict(
            equal_bits=all(torch.equal(a, b) for a, b in zip(k_new, p_new))
            and (k_mdx, k_om, k_it) == (p_mdx, p_om, p_it),
            cg=k_it, s=k_s, plain_s=p_s, max_dx=k_mdx)
    return out


def save_network(path, problem, state):
    """A file-order host network (`synthetic.thin_views`) as one .npz the
    rank processes read (`load_network`)."""
    import numpy as np

    arrays = {f"p_{k}": np.asarray(v) for k, v in problem._asdict().items()
              if v is not None and k not in ("num_points", "num_images")}
    arrays.update({f"s_{k}": np.asarray(v)
                   for k, v in state._asdict().items()})
    np.savez(path, num_points=problem.num_points,
             num_images=problem.num_images, **arrays)


def load_network(path):
    """(problem, state) of `save_network`'s file, host arrays."""
    import numpy as np

    from bundle_adjustment_tpu_torch.models.problem import ParamState
    from bundle_adjustment_tpu_torch.parallel.rcs import RCSProblem

    with np.load(path) as z:
        prob = RCSProblem(num_points=int(z["num_points"]),
                          num_images=int(z["num_images"]),
                          **{k[2:]: z[k] for k in z.files
                             if k.startswith("p_")})
        state = ParamState(**{k[2:]: z[k] for k in z.files
                              if k.startswith("s_")})
    return prob, state


def _step_err(got, ref):
    """The largest gaps of a step's state, omega0 and max_dx, as
    tests/test_spmd.py gates them: for points, eo and io the largest
    |a - b| / (atol + rtol |b|) (<= 1 passes; ``state`` the worst of
    them), omega0 and max_dx relative; the distortion's largest absolute
    gap is recorded (that test does not gate it)."""
    import torch

    def over(a, b, rtol, atol):
        return float(((a - b).abs() / (atol + rtol * b.abs())).max())

    names = ("points", "eo", "io", "dist")
    fields = {n: over(got[n], ref[n], **SHARD_STATE_TOL[n])
              for n in names[:3]}
    return dict(
        state=max(fields.values()), fields=fields,
        dist_abs=float((got["dist"] - ref["dist"]).abs().max()),
        omega0=abs(got["omega0"] / ref["omega0"] - 1.0),
        max_dx=abs(got["max_dx"] / ref["max_dx"] - 1.0),
        equal_bits=all(torch.equal(got[n], ref[n]) for n in names)
        and got["omega0"] == ref["omega0"] and got["max_dx"] == ref["max_dx"])


def sharded_phase(shape=(NUM_POINTS, NUM_IMAGES, VIEWS),
                  launches=SHARD_LAUNCHES):
    """Phase 13 (see the module docstring).  Returns (summary dict, the
    launch counts of the ranks' (a)-(e) but (e)'s f32 step through K3:
    none, gated; the K3 launches of that step at world size 1).
    ``launches``: (world size, device, backend) of each launch."""
    import shutil

    import torch

    from bundle_adjustment_tpu_torch import synthetic
    from bundle_adjustment_tpu_torch.parallel import multihost

    work = WORK / "phase13"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    # (e)'s network, phase 15's, built once for every rank
    t = time.perf_counter()
    ph, sh, _ = synthetic.build_problem(shape[0], shape[1], UNEVEN_VIEWS,
                                        seed=0)
    fh, fsh = synthetic.thin_views(ph, sh, views=UNEVEN_KEEP,
                                   every=UNEVEN_EVERY)
    del ph
    uneven_path = work / "uneven.npz"
    save_network(uneven_path, fh, fsh)
    log(f"(e)'s network: N = {fh.obs_point.shape[0]:,} rows in file order, "
        f"built and saved in {time.perf_counter() - t:.1f} s")
    del fh, fsh
    runs, walls = {}, {}
    for D, device, backend in launches:
        t = time.perf_counter()
        runs[D] = multihost.run_ranks(
            sharded_rank, D, (shape, str(uneven_path)),
            workdir=work / f"ranks{D}", device=device,
            backend=backend, timeout=SHARD_TIMEOUT, wait=SHARD_WAIT,
            threads=SHARD_THREADS)
        walls[D] = time.perf_counter() - t
        log(f"phase 13 at {D} rank(s) over {backend}: "
            f"{runs[D][0]['repr']}; launch wall {walls[D]:.1f} s")
    one = runs[1][0]
    ref = one[("engine", SHARD_CG_TOL)]
    ref_state = one[("engine", SHARD_STATE_CG_TOL)][0]
    out = {"launch_wall_s": walls}
    problems = []

    # (a) world size 1 (NCCL) against engine.lm_step on the card, and
    # (b) 2 ranks (gloo on the card) against the same single-rank step:
    # CG counts, omega0, max_dx at SHARD_CG_TOL, the state at
    # SHARD_STATE_CG_TOL
    for D in (1, 2):
        for mode in SHARD_MODES:
            res = runs[D][0][(mode, SHARD_CG_TOL)]
            st_res = runs[D][0][(mode, SHARD_STATE_CG_TOL)][0]
            err = _step_err(res[0], ref[0])
            err_st = _step_err(st_res, ref_state)
            same = all(torch.equal(r[(mode, tol)][0]["points"],
                                   runs[D][0][(mode, tol)][0]["points"])
                       and r[(mode, tol)][0]["omega0"]
                       == runs[D][0][(mode, tol)][0]["omega0"]
                       for r in runs[D]
                       for tol in (SHARD_CG_TOL, SHARD_STATE_CG_TOL))
            omegas = [s["omega0"] for s in res]
            its = [s["it"] for s in res]
            log(f"(a/b) spmd_fm {mode} at {D} rank(s), cg_tol "
                f"{SHARD_CG_TOL:g}: CG {its} (engine "
                f"{[s['it'] for s in ref]}); omega0 {err['omega0']:.2e}, "
                f"max_dx {err['max_dx']:.2e} relative; state of its gate "
                + ", ".join(f"{n} {v:.2e}" for n, v in err["fields"].items())
                + f" (recorded); equal bits to engine.lm_step: "
                f"{err['equal_bits']}; omega {omegas[0]:.10e} -> "
                f"{omegas[-1]:.10e}; s per step "
                f"{[round(s['s'], 4) for s in res]} (engine "
                f"{[round(s['s'], 4) for s in ref]}); at cg_tol "
                f"{SHARD_STATE_CG_TOL:g}: CG {st_res['it']} (engine "
                f"{ref_state['it']}), state of its gate "
                + ", ".join(f"{n} {v:.2e}"
                            for n, v in err_st["fields"].items())
                + f" (distortion {err_st['dist_abs']:.1e} absolute), "
                f"equal bits: {err_st['equal_bits']}; ranks equal: {same}")
            if not (err["omega0"] <= SHARD_OMEGA_RTOL
                    and err["max_dx"] <= SHARD_MAXDX_RTOL
                    and err_st["state"] <= 1.0
                    and err_st["omega0"] <= SHARD_OMEGA_RTOL
                    and err_st["max_dx"] <= SHARD_MAXDX_RTOL):
                problems.append(f"spmd_fm {mode} at {D}: {err}, at the "
                                f"state's cg_tol {err_st}")
            if its[0] != ref[0]["it"]:
                problems.append(f"spmd_fm {mode} at {D}: {its[0]} CG "
                                f"iterations, engine {ref[0]['it']}")
            if not (same and omegas[-1] < omegas[0]
                    and math.isfinite(res[-1]["max_dx"])):
                problems.append(f"spmd_fm {mode} at {D}: ranks equal {same}, "
                                f"omega {omegas}")
            out[f"spmd_fm_{mode}_{D}"] = dict(
                cg=its, step_s=[s["s"] for s in res],
                equal_bits=err["equal_bits"], omega0_rel=err["omega0"],
                max_dx_rel=err["max_dx"], state_gate_at_cg_tol=err["state"],
                state_gate=err_st["state"], state_cg=st_res["it"],
                state_step_s=st_res["s"])
    out["engine_step_s"] = [s["s"] for s in ref]
    out["engine_cg"] = [s["it"] for s in ref]
    out["engine_state_cg"] = ref_state["it"]

    # (c) the distributed Cholesky against torch.linalg on the card
    tr = one["tp_ref"]
    Dj = tr["D"]
    Ss = tr["S"] / Dj[:, None] / Dj[None, :]

    def backward(L):
        Ls = L / Dj[:, None]
        return float((Ls @ Ls.T - Ss).abs().max())

    def scaled(L, ref):
        return float(((L - ref) / Dj[:, None]).abs().max())

    out["tp_lapack_vs_cusolver"] = scaled(tr["L_cpu"], tr["L"])
    out["tp_cusolver_backward"] = backward(tr["L"])
    for D in (1, 2):
        res = runs[D][0]["tp"]
        fac = scaled(res["L"], tr["L_cpu"])
        fac_gpu = scaled(res["L"], tr["L"])
        bwd = backward(res["L"])
        sol = float((res["x"] - tr["x"]).abs().max() / tr["x"].abs().max())
        col = float((res["Q"] - tr["Q"]).abs().max() / tr["Q"].abs().max())
        same_S = len({r["tp"]["S_sha"] for r in runs[D]}) == 1
        log(f"(c) tp at {D} rank(s): u {res['u']} padded {res['n']}, block "
            f"{res['block']}; factor {fac:.2e} Jacobi-scaled from LAPACK's "
            f"({fac_gpu:.2e} from cuSOLVER's, which is "
            f"{out['tp_lapack_vs_cusolver']:.2e} from LAPACK's), backward "
            f"error {bwd:.2e} (cuSOLVER's {out['tp_cusolver_backward']:.2e}), "
            f"solve {sol:.2e} "
            f"of PCG at tol {TP_PCG_TOL:g} ({tr['pcg_it']} iterations, "
            f"{tr['pcg_s']:.2f} s), {len(res['idx'])} cofactor columns "
            f"{col:.2e}; ranks' S equal: {same_S}; assemble "
            f"{res['assemble_s']:.3f} s, factor {res['factor_s']:.4f} s "
            f"(torch.linalg.cholesky {tr['cholesky_s']:.4f} s), solve "
            f"{res['solve_s']:.4f} s, columns {res['columns_s']:.4f} s")
        if not (fac <= TP_FACTOR_TOL and bwd <= TP_BACKWARD_TOL
                and sol <= TP_SOLVE_TOL and col <= TP_COLUMN_TOL and same_S):
            problems.append(f"tp at {D}: factor {fac:.2e}, backward "
                            f"{bwd:.2e}, solve {sol:.2e}, columns {col:.2e}, "
                            f"S equal {same_S}")
        out[f"tp_{D}"] = dict(
            factor_err=fac, factor_err_cusolver=fac_gpu, backward_err=bwd,
            solve_err=sol, columns_err=col,
            assemble_s=res["assemble_s"], factor_s=res["factor_s"],
            solve_s=res["solve_s"], columns_s=res["columns_s"])
    out["tp_cholesky_s"] = tr["cholesky_s"]

    # (d) the observation-sharded step against the engine's GN step
    sr = one["spmd_ref"]
    for D in (1, 2):
        res = runs[D][0]["spmd"]
        dp = float((res["points"] - sr["points"]).abs().max())
        de = float((res["eo"] - sr["eo"]).abs().max())
        dm = abs(res["max_dx"] / sr["max_dx"] - 1.0)
        dom = abs(res["omega0"] / sr["omega0"] - 1.0)
        same = all(torch.equal(r["spmd"]["points"], res["points"])
                   for r in runs[D])
        log(f"(d) spmd at {D} rank(s): CG {res['it']} (engine "
            f"{sr['it']}); points {dp:.2e}, eo {de:.2e} absolute; max_dx "
            f"{dm:.2e}, omega0 {dom:.2e} relative; ranks equal: {same}; "
            f"step {res['s']:.3f} s (engine {sr['s']:.3f} s)")
        if not (dp <= SPMD_ATOL and de <= SPMD_ATOL
                and dm <= SPMD_MAXDX_RTOL and dom <= SHARD_OMEGA_RTOL
                and same):
            problems.append(f"spmd at {D}: points {dp:.2e}, eo {de:.2e}, "
                            f"max_dx {dm:.2e}, omega0 {dom:.2e}, {same}")
        out[f"spmd_{D}"] = dict(cg=res["it"], step_s=res["s"], points=dp,
                                eo=de, max_dx_rel=dm, omega0_rel=dom)
    out["spmd_engine_s"] = sr["s"]

    # (e) the observation-sharded step on the file-order network against
    # rcs.lm_step, and its f32 step through K3 against the plain gather
    fr = one["spmd_file_ref"]
    for D in (1, 2):
        res = runs[D][0]["spmd_file"]
        dp = float((res["points"] - fr["points"]).abs().max())
        de = float((res["eo"] - fr["eo"]).abs().max())
        dm = abs(res["max_dx"] / fr["max_dx"] - 1.0)
        dom = abs(res["omega0"] / fr["omega0"] - 1.0)
        same = all(all(torch.equal(r["spmd_file"][n], res[n])
                       for n in ("points", "io", "dist", "eo"))
                   and r["spmd_file"]["it"] == res["it"] for r in runs[D])
        rows = [r["spmd_file"]["rows"] for r in runs[D]]
        peak = [round(r["spmd_file"]["peak_gb"], 3) for r in runs[D]]
        # the two psums of each matvec: Hpx x [P, 3], then the image and
        # global sums [M, 6] + [G]
        mv_bytes = 8 * (3 * fr["points"].shape[0]
                        + 6 * fr["eo"].shape[0] + fr["io"].numel()
                        + fr["dist"].numel())
        log(f"(e) spmd on the file order at {D} rank(s): rows per rank "
            f"{rows} of {res['rows_padded']:,} (padded to the ranks); CG "
            f"{res['it']} (rcs.lm_step {fr['it']}); points {dp:.2e}, eo "
            f"{de:.2e} absolute; max_dx {dm:.2e}, omega0 {dom:.2e} "
            f"relative; ranks equal: {same}; step {res['s']:.3f} s "
            f"(rcs.lm_step {fr['s']:.3f} s); peak memory per rank {peak} "
            f"GB; {mv_bytes / 1e6:.2f} MB all-reduced per matvec")
        if not (dp <= SPMD_ATOL and de <= SPMD_ATOL
                and dm <= SPMD_MAXDX_RTOL and dom <= SHARD_OMEGA_RTOL
                and same):
            problems.append(f"spmd file order at {D}: points {dp:.2e}, eo "
                            f"{de:.2e}, max_dx {dm:.2e}, omega0 {dom:.2e}, "
                            f"ranks equal {same}")
        out[f"spmd_file_{D}"] = dict(
            cg=res["it"], step_s=res["s"], rows=rows, peak_gb=peak,
            points=dp, eo=de, max_dx_rel=dm, omega0_rel=dom,
            matvec_allreduce_mb=mv_bytes / 1e6)
    out["spmd_file_rcs_s"] = fr["s"]
    out["spmd_file_rcs_cg"] = fr["it"]
    f32 = one["spmd_file_f32"]
    k3 = one["launches_k3"]
    log(f"(e) f32 step at world size 1 through K3: {f32['cg']} CG in "
        f"{f32['s']:.3f} s (plain gather {f32['plain_s']:.3f} s), equal "
        f"bits to the plain gather's step: {f32['equal_bits']}; launches "
        f"{k3}")
    if not (f32["equal_bits"] and k3["cam_gather"] > 0
            and k3["schur_matvec"] == 0 and k3["prepare_reduction"] == 0):
        problems.append(f"spmd f32 through K3: equal bits "
                        f"{f32['equal_bits']}, launches {k3}")
    out["spmd_file_f32"] = f32
    launches = {}
    for D in (1, 2):
        for r in runs[D]:
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
    if any(solve_kernel_launches(launches).values()):
        problems.append(f"K1 to K4 launches in the plain sharded path: "
                        f"{launches}")
    if problems:
        fail("phase 13: " + "; ".join(problems))
    return out, launches, k3


def fleet_phase(dev, fleet=FLEET, thin_fleet=THIN_FLEET):
    """Phase 14 (see the module docstring): ``fleet`` = (networks, points,
    images, views), uniform; ``thin_fleet`` = the same with the views of
    the network `synthetic.thin_scenarios` cuts to file order.  Returns
    (summary dict, the launch counts of the phase: none)."""
    import numpy as np
    import torch

    from bundle_adjustment_tpu_torch import convert, synthetic
    from bundle_adjustment_tpu_torch.parallel import kernels, rcs, scenario

    kernels.reset_launch_counts()
    summary = {}
    for name, shape in (("uniform", fleet), ("file", thin_fleet)):
        S, P, M, V = shape
        t = time.perf_counter()
        prob_h, xy, w, states, spec = synthetic.scenario_batch(S, P, M, V,
                                                               seed=0)
        if name == "file":
            prob_h, xy, w, states = synthetic.thin_scenarios(
                prob_h, xy, w, states, views=THIN_FLEET_KEEP,
                every=THIN_FLEET_EVERY)
        layout = rcs.choose_layout(prob_h.obs_point, prob_h.num_points)
        counts = np.bincount(prob_h.obs_point, minlength=prob_h.num_points)
        padded = prob_h.num_points * int(counts.max())
        prob = convert.problem_to_torch(prob_h, dev, torch.float64)
        batch = scenario.make_batch(prob, xy, w, states)
        N = int(prob.obs_image.shape[0])
        log(f"{name} fleet of {S} networks ({prob.num_points} points, {M} "
            f"images, views {counts.min()}..{counts.max()}; N = {N:,} rows "
            f"each against {padded:,} padded; the layout rule picks "
            f"{layout!r}, the batch holds point_uniform "
            f"{prob.point_uniform}) built in {time.perf_counter() - t:.1f} s")
        if (name == "file") != (layout == "file" and prob.point_uniform
                                is None):
            fail(f"phase 14: the {name} fleet is laid out {layout!r} "
                 f"(point_uniform {prob.point_uniform})")
        summary[name] = _fleet_run(batch, spec, S)
        summary[name].update(rows=N, padded_rows=padded)
    launches = kernels.launch_counts()
    log(f"phase 14 launches {launches}")
    if any(solve_kernel_launches(launches).values()):
        fail(f"phase 14: K1 to K4 launches {launches}")
    return {"fleet": summary}, launches


def _fleet_run(batch, spec, S):
    """One fleet of phase 14: the batched step against `rcs.lm_step` on
    each network (the gates), its repeat, the times, the fallback warning;
    recorded: the same at cg_tol 1e-12 and the vmapped against the
    unbatched blocks of scenario 0."""
    import warnings

    import torch

    from bundle_adjustment_tpu_torch.models.problem import ParamState
    from bundle_adjustment_tpu_torch.parallel import rcs, scenario

    prob = batch.problem

    def batched(tol):
        return scenario.scenario_lm_step(batch, spec, SHARD_DAMPING,
                                         cg_tol=tol,
                                         cg_maxiter=FLEET_CG_MAXITER)

    def sequential(tol):
        res = []
        for s in range(S):
            p = prob._replace(obs_xy=batch.obs_xy[s],
                              obs_weight=batch.obs_weight[s])
            st = ParamState(*(a[s] for a in batch.states))
            dxp, dxc, dxg, b, it = rcs.lm_step(
                p, st, spec, SHARD_DAMPING, cg_tol=tol,
                cg_maxiter=FLEET_CG_MAXITER)
            new, mdx = rcs.apply_step(st, dxp, dxc, dxg)
            res.append((new, float(mdx), float(b.omega0), it))
        return res

    def compare(out, seq):
        new, mdx, om, its = out
        worst = dict(state=0.0, max_dx=0.0, omega0=0.0)
        bad, same_cg = [], 0
        for s, (ref, mdx1, om1, it1) in enumerate(seq):
            st_err = max(float((getattr(new, n)[s] - getattr(ref, n)).abs()
                               .max() / getattr(ref, n).abs().max())
                         for n in ParamState._fields)
            e = dict(state=st_err, max_dx=abs(float(mdx[s]) / mdx1 - 1.0),
                     omega0=abs(float(om[s]) / om1 - 1.0))
            worst = {k: max(worst[k], e[k]) for k in worst}
            same_cg += int(its[s]) == it1
            if abs(int(its[s]) - it1) > FLEET_CG_SLACK \
                    or not all(v <= FLEET_TOL for v in e.values()):
                bad.append((s, int(its[s]), it1, e))
        return worst, bad, same_cg

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out0, t_b0 = _timed(lambda: batched(FLEET_CG_TOL))
        out, t_b = _timed(lambda: batched(FLEET_CG_TOL))
    fallback = [str(c.message)[:120] for c in caught
                if "batching rule" in str(c.message)]
    repeat = all(torch.equal(a, b) for a, b in zip(out0[0], out[0])) \
        and all(torch.equal(a, b) for a, b in zip(out0[1:], out[1:]))
    _, t_s0 = _timed(lambda: sequential(FLEET_CG_TOL))
    seq, t_s = _timed(lambda: sequential(FLEET_CG_TOL))
    worst, bad, same_cg = compare(out, seq)
    its = out[3]
    # recorded: the same at cg_tol 1e-12, and where the bits part: the
    # vmapped prepare and matvec against the unbatched ones (scenario 0)
    worst12, _, same12 = compare(batched(SHARD_CG_TOL),
                                 sequential(SHARD_CG_TOL))
    bd, rc, rg, md = scenario.prepare_batch(batch, spec, SHARD_DAMPING)
    p0 = prob._replace(obs_xy=batch.obs_xy[0], obs_weight=batch.obs_weight[0])
    b0, rc0, rg0, M0 = rcs.prepare(
        p0, ParamState(*(a[0] for a in batch.states)), spec, SHARD_DAMPING)
    oc, og = scenario.matvec_batch(prob, bd, rc, rg)
    oc0, og0 = rcs.schur_matvec(p0, b0, rc0, rg0)
    bits = dict(rg=scaled_err(rg[0], rg0),
                Minv_c=scaled_err(md["Minv_c"][0], M0.Minv_c),
                Minv_g=scaled_err(md["Minv_g"][0], M0.Minv_g),
                matvec_c=scaled_err(oc[0], oc0),
                matvec_g=scaled_err(og[0], og0))
    log(f"scenario_lm_step: CG per scenario {its.tolist()} (rcs.lm_step on "
        f"each: {[r[3] for r in seq]}, {same_cg} of {S} equal); worst state "
        f"{worst['state']:.2e}, max_dx {worst['max_dx']:.2e}, omega0 "
        f"{worst['omega0']:.2e} relative; two batched runs equal bits: "
        f"{repeat}; vmap fallback warnings: {len(fallback)}; batched step "
        f"{t_b:.3f} s (first {t_b0:.3f} s), {S} sequential steps "
        f"{t_s:.3f} s (first {t_s0:.3f} s); at cg_tol {SHARD_CG_TOL:g} "
        f"(recorded): {same12} of {S} counts equal, worst state "
        f"{worst12['state']:.2e}, max_dx {worst12['max_dx']:.2e}; vmapped "
        f"against unbatched (scenario 0): "
        + ", ".join(f"{k} {v:.1e}" for k, v in bits.items()))
    if bad or not repeat or fallback:
        fail(f"phase 14: scenarios off their single step {bad[:4]}; equal "
             f"bits on repeat {repeat}; vmap fallback {fallback[:1]}")
    return dict(cg=its.tolist(), cg_sequential=[r[3] for r in seq],
                same_cg=same_cg, batched_s=t_b, batched_first_s=t_b0,
                sequential_s=t_s, sequential_first_s=t_s0, worst=worst,
                same_cg_1e12=same12, worst_1e12=worst12, vmap_bits=bits)


# ---------------------------------------------------------------------------
# phase 15: a network of uneven visibility (the block-layout engine)
# ---------------------------------------------------------------------------

def uneven_phase(dev, shape=(NUM_POINTS, NUM_IMAGES)):
    """Phase 15 (see the module docstring).  Returns (summary dict, the
    launch counts of (b)'s f32 solve and (e)'s file-route solve)."""
    import numpy as np
    import torch

    from bundle_adjustment_tpu_torch import convert, synthetic
    from bundle_adjustment_tpu_torch.io import columnar
    from bundle_adjustment_tpu_torch.parallel import (covariance, engine,
                                                      kernels, rcs, solver)

    f32, f64 = torch.float32, torch.float64
    t_phase = time.time()
    P, M = shape
    ph, sh, spec = synthetic.build_problem(P, M, UNEVEN_VIEWS, seed=0)
    fh, fsh = synthetic.thin_views(ph, sh, views=UNEVEN_KEEP,
                                   every=UNEVEN_EVERY)
    del ph
    N = int(fh.obs_point.shape[0])
    P = int(fh.num_points)
    counts = np.bincount(fh.obs_point, minlength=P)
    u = int(fh.free_point.sum() + fh.free_eo.sum() + fh.free_global.sum())
    dof = 2 * N - u
    layout = rcs.choose_layout(fh.obs_point, P)
    log(f"network: P={P} M={M} N={N} (views {counts.min()}..{counts.max()},"
        f" {int((counts == counts.max()).sum())} points in all "
        f"{UNEVEN_VIEWS}); padded point-major {P * int(counts.max())} rows "
        f"({P * int(counts.max()) / N:.2f}x); the layout rule picks "
        f"{layout!r}; u={u} dof={dof}; built in {time.time() - t_phase:.1f} s")
    if layout != "file":
        fail(f"phase 15: the layout rule picked {layout!r} for the uneven "
             f"network")
    # the reckoning of the issue's case, not run: 1,000 targets in all 500
    # images, the rest in 12
    n_t = (P - 1000) * 12 + 1000 * 500
    pad_t = P * 500
    log(f"not run: 1,000 targets in all 500 images and the rest in 12 give "
        f"N={n_t:,} rows against {pad_t:,} padded ({pad_t / n_t:.1f}x); "
        f"K2's 78 f32 rows per observation ({K2_ROW_BYTES} B) need "
        f"{pad_t * K2_ROW_BYTES / 1e9:.1f} GB padded against "
        f"{n_t * K2_ROW_BYTES / 1e9:.2f} GB, and the same rows in f64 on "
        f"the plain path {2 * pad_t * K2_ROW_BYTES / 1e9:.1f} GB")

    p64 = convert.problem_to_torch(fh, dev, f64)
    s64 = convert.state_to_torch(fsh, dev, f64)
    pm64 = rcs.to_point_major(p64)

    def sigma0_at(state):
        om = float(rcs.linearize(p64, state, spec, 0.0).omega0)
        return om, (om / dof) ** 0.5

    def field_err(a, b):
        return float((a - b).abs().max() / b.abs().max())

    # ---- (a) f64 solve to its default tolerance in both layouts -----------
    runs = {}
    for name, prob in (("file", p64), ("point_major", pm64)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        res = solver.solve(prob, s64, spec, **UNEVEN_F64)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        om, s0 = sigma0_at(res.state)
        cg = [h["cg_it"] for h in res.history]
        runs[name] = dict(
            rows=int(prob.obs_point.shape[0]), steps=res.iterations,
            converged=res.converged, seconds=secs,
            s_per_step=secs / max(res.iterations, 1),
            cg_per_step=cg, precond=preconds(res.history),
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            omega=om, sigma0=s0, max_dx=res.max_abs_dx, state=res.state)
        log(f"(a) f64 solve, {name} layout: {runs[name]['rows']:,} rows, "
            f"{res.status.name} after {res.iterations} steps in {secs:.3f} s "
            f"({runs[name]['s_per_step']:.3f} s per step), CG per step {cg}, "
            f"preconditioner {preconds(res.history)}, "
            f"max|dx| {res.max_abs_dx:.3e}, peak memory "
            f"{runs[name]['peak_gb']:.2f} GB; Omega {om:.10e}, sigma0 "
            f"{s0:.6e}")
    fa, pa = runs["file"], runs["point_major"]
    om_rel = abs(fa["omega"] / pa["omega"] - 1.0)
    xyz = field_err(fa["state"].points, pa["state"].points)
    log(f"(a) file vs point-major: Omega {om_rel:.2e} relative, coordinates "
        f"{xyz:.2e} of the field")
    problems = []
    for name, r in runs.items():
        if not r["converged"]:
            problems.append(f"{name} solve did not converge")
        if not abs(r["sigma0"] / SIGMA - 1.0) < 0.01:
            problems.append(f"{name} sigma0 {r['sigma0']:.6e}")
    if not om_rel <= UNEVEN_OMEGA_RTOL:
        problems.append(f"Omega {om_rel:.2e} apart")
    if not xyz <= UNEVEN_XYZ_TOL:
        problems.append(f"coordinates {xyz:.2e} of the field apart")
    if problems:
        fail("phase 15 (a): " + "; ".join(problems))
    del pm64

    # ---- (b) f32 solve with K3 to F32_STOP, then f64 from its end -------
    p32 = convert.problem_to_torch(fh, dev, f32)
    s32 = convert.state_to_torch(fsh, dev, f32)
    img32 = p32.obs_image.to(torch.int32).contiguous()
    g_k = kernels.cam_gather_rows(s32.eo.contiguous(), img32)
    g_p = kernels.cam_gather_plain(s32.eo, img32)
    k3_exact = same_bits(g_k, g_p)
    log(f"(b) K3 on the file-order layout ({N:,} rows): equal to its plain "
        f"version bit for bit: {k3_exact}")
    if not k3_exact:
        fail("phase 15 (b): K3 differs from its plain version on the "
             "file-order layout")
    del g_k, g_p
    kw32 = dict(damping=1e-2, max_iterations=30, tolerance=F32_STOP)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    r32 = solver.solve(p32, s32, spec, **kw32)
    torch.cuda.synchronize()
    s32_s = time.perf_counter() - t
    launches_b = kernels.launch_counts()
    cg32 = [h["cg_it"] for h in r32.history]
    log(f"(b) f32 solve through K3: {r32.status.name} after {r32.iterations} "
        f"steps in {s32_s:.3f} s, max|dx| {r32.max_abs_dx:.3e}, CG per step "
        f"{cg32}; launches {launches_b}")
    t = time.perf_counter()
    rb = solver.solve(p64, type(r32.state)(*(a.double()
                                            for a in r32.state)), spec,
                      **UNEVEN_F64)
    torch.cuda.synchronize()
    b64_s = time.perf_counter() - t
    om_b, s0_b = sigma0_at(rb.state)
    om_b_rel = abs(om_b / fa["omega"] - 1.0)
    xyz_b = field_err(rb.state.points, fa["state"].points)
    log(f"(b) f64 solve from there: {rb.status.name} after {rb.iterations} "
        f"steps in {b64_s:.3f} s, CG per step "
        f"{[h['cg_it'] for h in rb.history]}; sigma0 {s0_b:.6e}, Omega "
        f"{om_b_rel:.2e} and coordinates {xyz_b:.2e} of the field from (a)'s")
    problems = []
    if launches_b["cam_gather"] <= 0:
        problems.append(f"K3 never launched: {launches_b}")
    if launches_b["schur_matvec"] or launches_b["prepare_reduction"]:
        problems.append(f"K1 / K2 launched on the file order: {launches_b}")
    if not r32.converged:
        problems.append(f"the f32 solve did not reach {F32_STOP}")
    if not rb.converged:
        problems.append("the f64 solve from its end did not converge")
    if not abs(s0_b / SIGMA - 1.0) < 0.01:
        problems.append(f"sigma0 {s0_b:.6e}")
    if not om_b_rel <= UNEVEN_OMEGA_RTOL:
        problems.append(f"Omega {om_b_rel:.2e} from (a)'s")
    if not xyz_b <= UNEVEN_XYZ_TOL:
        problems.append(f"coordinates {xyz_b:.2e} of the field from (a)'s")
    if problems:
        fail("phase 15 (b): " + "; ".join(problems))
    del rb

    # ---- (c) one f32 step, five times: equal bits ------------------------
    cgf = kernels.make_cam_gather(p32)
    t = time.perf_counter()
    steps = [rcs.lm_step_full(p32, s32, spec, 1e-2, cg_tol=1e-6,
                              cam_gather=cgf)
             for _ in range(UNEVEN_REPEATS)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t) / UNEVEN_REPEATS
    same = all(same_bits(a, b) for s in steps[1:]
               for a, b in zip(s[:3], steps[0][:3]))
    same = same and len({s[4] for s in steps}) == 1
    log(f"(c) one f32 step ({steps[0][4]} CG) {UNEVEN_REPEATS} times: "
        f"{step_s:.3f} s each, equal bits: {same}")
    if not same:
        fail("phase 15 (c): repeated f32 steps on the file order differ")
    del steps

    # ---- (d) covariance on demand: file order against padded FM ----------
    st = fa["state"]
    ids = np.array(UNEVEN_COV_POINTS, np.int32)
    imgs = np.array(UNEVEN_COV_IMAGES, np.int32)
    cov = {}
    for name, prob in (("file", p64),
                       ("point_major",
                        engine.fm_problem(rcs.to_point_major(p64)))):
        torch.cuda.synchronize()
        t = time.perf_counter()
        b, Minv = covariance.prepare(prob, st, spec)
        sp, sc = {}, {}
        qp = covariance.point_covariance_blocks(prob, b, Minv, ids, stats=sp)
        qc = covariance.camera_covariance_blocks(prob, b, Minv, imgs,
                                                 stats=sc)
        torch.cuda.synchronize()
        cov[name] = dict(points=qp, cameras=qc, s=time.perf_counter() - t,
                         pcg=(sp["iterations"], sc["iterations"]),
                         coupled=Minv.Scg is not None)
        del b, Minv
    errs = {k: block_err(cov["file"][k], cov["point_major"][k])
            for k in ("points", "cameras")}
    log("(d) covariance on demand, " + "; ".join(
        f"{n}: {c['s']:.2f} s, PCG {c['pcg']}, coupled {c['coupled']}"
        for n, c in cov.items()) + f"; file vs point-major: points "
        f"{errs['points']:.2e}, cameras {errs['cameras']:.2e} of each "
        f"block's largest entry")
    if not max(errs.values()) <= COV_BLOCK_TOL:
        fail(f"phase 15 (d): blocks differ between the layouts: {errs}")

    # ---- (e) the file route ---------------------------------------------
    work = WORK / "phase15"
    work.mkdir(parents=True, exist_ok=True)
    t = time.perf_counter()
    paths = synthetic.write_flat(str(work / "net"), fh, fsh)
    write_s = time.perf_counter() - t
    t = time.perf_counter()
    fp, fs, _ = columnar.build_rcs_problem(
        paths["points"], paths["imagecoords"], paths["eor"],
        io_path=paths["ior"], spec=synthetic.scale_spec(), dist=fsh.dist,
        device=dev, dtype=f32)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    cp_h, cs_h = synthetic.as_read_from_files(fh, fsh)
    cp = convert.problem_to_torch(cp_h, dev, f32)
    cs = convert.state_to_torch(cs_h, dev, f32)
    diff = [f for f in fp._fields
            if not (same_bits(getattr(fp, f), getattr(cp, f))
                    if isinstance(getattr(cp, f), torch.Tensor)
                    or getattr(cp, f) is None
                    else getattr(fp, f) == getattr(cp, f))]
    diff += [f"state.{f}" for f in fs._fields
             if not same_bits(getattr(fs, f), getattr(cs, f))]
    log(f"(e) files written in {write_s:.2f} s; build_rcs_problem "
        f"(layout None) in {build_s:.2f} s: point_uniform "
        f"{fp.point_uniform}, N={fp.obs_point.shape[0]:,}; every field and "
        f"the state equal to the in-memory control bit for bit: {not diff}")
    if fp.point_uniform is not None:
        fail("phase 15 (e): build_rcs_problem did not pick the file order")
    if diff:
        fail(f"phase 15 (e): the file-built problem differs in {diff}")
    kernels.reset_launch_counts()
    rf = solver.solve(fp, fs, spec, **kw32)
    launches_e = kernels.launch_counts()
    rc = solver.solve(cp, cs, spec, **kw32)
    equal = (rf.iterations == rc.iterations
             and all(same_bits(getattr(rf.state, f), getattr(rc.state, f))
                     for f in rf.state._fields))
    log(f"(e) f32 solve on the file route: {rf.status.name} after "
        f"{rf.iterations} steps, launches {launches_e}; equal bits and "
        f"steps to the control: {equal}")
    if not equal:
        fail("phase 15 (e): solve on the file-built problem differs from "
             "the control's")
    if launches_e["cam_gather"] <= 0:
        fail(f"phase 15 (e): K3 never launched: {launches_e}")
    seconds = time.time() - t_phase
    launches = {k: launches_b[k] + launches_e[k] for k in launches_b}
    log(f"phase 15: {seconds:.1f} s; launches {launches}")
    summary = dict(
        uneven_rows=N, uneven_padded_rows=pa["rows"], uneven_dof=dof,
        uneven_solve={n: {k: v for k, v in r.items() if k != "state"}
                      for n, r in runs.items()},
        uneven_f32_steps=r32.iterations, uneven_f32_s=s32_s,
        uneven_f32_cg=cg32, uneven_step_s=step_s,
        uneven_cov={n: dict(s=c["s"], pcg=c["pcg"]) for n, c in cov.items()},
        uneven_cov_err=errs, uneven_file_build_s=build_s,
        uneven_phase_s=seconds)
    return summary, launches


# ---------------------------------------------------------------------------
# phase 16: BASELINE config 5 (1M points / 5,000 images / 12 views)
# ---------------------------------------------------------------------------

def example_phase():
    """Phase 17 (see the module docstring).  Returns a summary dict."""
    t = time.time()
    r = subprocess.run([sys.executable, str(EXAMPLE),
                        *map(str, EXAMPLE_SHAPE)], cwd=ROOT,
                       capture_output=True, text=True,
                       timeout=EXAMPLE_TIMEOUT)
    seconds = time.time() - t
    if r.returncode != 0:
        fail(f"phase 17: the example exited {r.returncode}: "
             f"{r.stderr[-3000:]}")
    lines = r.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(f"  | {line}")
    out = json.loads(lines[-1])
    problems = []
    if out["device"] != "cuda":
        problems.append(f"it ran on {out['device']}")
    for part in ("point_major", "file"):
        res = out[part]
        if not (res["converged"] and res["max_dx"] <= REFINE_TOL):
            problems.append(f"the {part} part did not reach max|dx| <= "
                            f"{REFINE_TOL} ({res['max_dx']:.3e})")
        if not abs(res["sigma0"] / SIGMA - 1.0) < 0.01:
            problems.append(f"the {part} part's sigma0 {res['sigma0']:.6e}")
    log(f"example at {EXAMPLE_SHAPE}: {seconds:.1f} s as a process "
        f"({out['seconds']:.1f} s in its main); sigma0 point-major "
        f"{out['point_major']['sigma0']:.6e}, file order "
        f"{out['file']['sigma0']:.6e}")
    if problems:
        fail("phase 17: " + "; ".join(problems))
    return dict(example=dict(out, process_s=seconds))


def config5_kernels(fv, state0, spec, dev):
    """K3, K2, K1 and K4 against their plain versions at the config-5
    shapes, with phase 2's gates (K3 exact; K1, K2 and K2 through
    finish_reduction within TOL_SCALED; K4 within TOL_FLOOR; repeat runs
    of K1 and K2 equal bit for bit).  Returns {kernel: dict(max_abs_err,
    events_ms, plain_events_ms, device_ms, device_ms_raised)}: the times
    per call between CUDA events around back-to-back calls
    (`measure.time_ms`) are the phase's times; beside them the profiler's
    device time (`measure.device_ms`), or None and the message where it
    raised: late in a full run of this script torch.profiler once kept
    only some of these long calls' launches (K4 read 0.09 ms against a
    0.59 ms byte bound), which `device_ms` now refuses.  At these shapes
    each call takes 0.18 ms or more, so the launch gaps that events add
    are a small share."""
    import torch

    from bundle_adjustment_tpu_torch import measure
    from bundle_adjustment_tpu_torch.parallel import engine, kernels

    def device(row, fn):
        try:
            row["device_ms"], row["device_ms_raised"] = \
                measure.device_ms(fn, reps=10)[0], None
        except RuntimeError as exc:
            row["device_ms"], row["device_ms_raised"] = None, str(exc)

    out = {}
    b = engine.linearize(fv, state0, spec, 1e-2)
    pp = kernels.pack_fm(b, fv, with_pw=True)
    eo = state0.eo.contiguous()
    g_k = kernels.cam_gather_rows(eo, pp.obs_img)
    g_p = kernels.cam_gather_plain(eo, pp.obs_img)
    if not torch.equal(g_k, g_p):
        fail("phase 16: K3 differs from its plain version")
    out["cam_gather"] = dict(
        max_abs_err=0.0,
        events_ms=measure.time_ms(lambda: kernels.cam_gather_rows(eo, pp.obs_img)),
        plain_events_ms=measure.time_ms(lambda: kernels.cam_gather_plain(
            eo, pp.obs_img)))
    device(out["cam_gather"], lambda: kernels.cam_gather_rows(eo, pp.obs_img))
    del g_k, g_p

    out_k = kernels.prepare_reduction(pp)
    out_p = kernels.prepare_reduction_plain(pp)
    errs = {n: scaled_err(a, r) for n, a, r in zip(
        ("red", "rg_corr", "T2", "T3"), out_k, out_p)}
    fin_k = engine.finish_reduction(fv, b, state0, 1e-2, *out_k, True)
    fin_p = engine.finish_reduction(fv, b, state0, 1e-2, *out_p, True)
    errs.update({
        "rc": scaled_err(fin_k[1], fin_p[1]),
        "rg": scaled_err(fin_k[2], fin_p[2]),
        "bc": scaled_err(fin_k[0].bc, fin_p[0].bc),
        "Scg": scaled_err(fin_k[3].Scg, fin_p[3].Scg),
        "Minv_c/cond": inverse_err(fin_k[3].Minv_c, fin_p[3].Minv_c),
        "Sghat_inv/cond": inverse_err(fin_k[3].Sghat_inv,
                                      fin_p[3].Sghat_inv)})
    same = all(all(torch.equal(a, c) for a, c in zip(
        out_k, kernels.prepare_reduction(pp))) for _ in range(C5_K2_REPEATS))
    log("K2 scaled errors: " + ", ".join(f"{n} {e:.2e}"
                                         for n, e in errs.items())
        + f"; {C5_K2_REPEATS} repeat runs bit-identical: {same}")
    if not all(e <= TOL_SCALED for e in errs.values()):
        fail("phase 16: K2 disagrees with its plain version")
    if not same:
        fail("phase 16: K2 is not deterministic")
    out["prepare_reduction"] = dict(
        max_abs_err=max(float((a - r).abs().max())
                        for a, r in zip(out_k, out_p)),
        events_ms=measure.time_ms(lambda: kernels.prepare_reduction(pp), reps=10),
        plain_events_ms=measure.time_ms(lambda: kernels.prepare_reduction_plain(pp),
                                 reps=3, warm=1))
    device(out["prepare_reduction"], lambda: kernels.prepare_reduction(pp))
    ec, eg = fin_p[0].extra_c.contiguous(), fin_p[0].extra_g.contiguous()
    del out_k, out_p, fin_k, fin_p

    gen = torch.Generator().manual_seed(1)
    xc = torch.randn((fv.num_images, 6), generator=gen).to(dev)
    xg = torch.randn((pp.g,), generator=gen).to(dev)
    oc_k, og_k = kernels.schur_matvec_rows(pp, ec, eg, xc, xg)
    oc_p, og_p = kernels.schur_matvec_plain(pp, ec, eg, xc, xg)
    e_c, e_g = scaled_err(oc_k, oc_p), scaled_err(og_k, og_p)
    same = all(all(torch.equal(a, c) for a, c in zip(
        (oc_k, og_k), kernels.schur_matvec_rows(pp, ec, eg, xc, xg)))
        for _ in range(C5_K1_REPEATS))
    log(f"K1 scaled errors: c {e_c:.2e}, g {e_g:.2e}; {C5_K1_REPEATS} "
        f"repeat runs bit-identical: {same}")
    if not (e_c <= TOL_SCALED and e_g <= TOL_SCALED):
        fail("phase 16: K1 disagrees with its plain version")
    if not same:
        fail("phase 16: K1 is not deterministic")
    out["schur_matvec"] = dict(
        max_abs_err=max(float((oc_k - oc_p).abs().max()),
                        float((og_k - og_p).abs().max())),
        events_ms=measure.time_ms(lambda: kernels.schur_matvec_rows(
            pp, ec, eg, xc, xg)),
        plain_events_ms=measure.time_ms(lambda: kernels.schur_matvec_plain(
            pp, ec, eg, xc, xg), reps=5, warm=1))
    device(out["schur_matvec"], lambda: kernels.schur_matvec_rows(
        pp, ec, eg, xc, xg))
    del pp

    pp4 = kernels.pack_fm(b, fv, lean_only=True)
    del b
    xin = torch.randn((8, 128), generator=gen).to(dev)
    f_k = kernels.read_floor(pp4, xin)
    f_p = kernels.read_floor_plain(pp4, xin)
    f_scale = kernels.read_floor_plain(
        pp4._replace(packed=pp4.packed.abs()), torch.zeros_like(xin))
    e_floor = float(((f_k - f_p).abs() / f_scale.clamp_min(1e-30)).max())
    log(f"K4: max |kernel - plain| / sum|values| {e_floor:.2e}")
    if not e_floor <= TOL_FLOOR:
        fail("phase 16: K4 disagrees with its plain version")
    out["read_floor"] = dict(
        max_abs_err=float((f_k - f_p).abs().max()),
        events_ms=measure.time_ms(lambda: kernels.read_floor(pp4, xin)),
        plain_events_ms=measure.time_ms(lambda: kernels.read_floor_plain(pp4, xin),
                                 reps=3, warm=1))
    device(out["read_floor"], lambda: kernels.read_floor(pp4, xin))
    return out


def config5_covariance(prob, st64, spec, dev, dup_point):
    """Phase 16's f64 covariance (see the module docstring): cov_all cold
    and warm, the stage split with the peak memory after each stage, and
    the gates.  Returns a summary dict."""
    import numpy as np
    import torch

    from bundle_adjustment_tpu_torch.parallel import cov_direct, engine, refine

    fmp = engine.fm_problem(refine.upcast_problem(prob))
    P, M = fmp.num_points, fmp.num_images
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    cold = cov_direct.cov_all(fmp, st64, spec)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t
    cold_peak = torch.cuda.max_memory_allocated() / 1e9
    warm_ms, warm = time_cov_all(fmp, st64, spec)
    torch.cuda.reset_peak_memory_stats()
    Qall, b, S, Q, ms, peak = cov_staged(fmp, st64, spec)
    u = S.shape[0]
    log(f"f64 cov_all (u={u}): cold {cold_s:.3f} s, "
        f"peak {cold_peak:.2f} GB ({base_gb:.2f} GB held before); warm "
        f"{warm_ms / 1e3:.3f} s ({P / (warm_ms / 1e3):.1f} point blocks/s); "
        "stages " + ", ".join(f"{n} {v:.1f} ms (peak {peak[n]:.2f} GB)"
                              for n, v in ms.items()))
    repeat_err = max(block_err(cold, Qall), block_err(warm, Qall))
    del cold, warm

    rng = np.random.default_rng(16)
    d = S.diagonal().sqrt()
    nc = min(C5_RESID_COLS, u)
    cols = torch.as_tensor(np.sort(rng.choice(u, nc, replace=False)),
                           device=dev)
    eye = torch.zeros((u, nc), dtype=S.dtype, device=dev)
    eye[cols, torch.arange(nc, device=dev)] = 1.0
    resid = float(((S @ Q[:, cols]) * d[cols][None, :] / d[:, None]
                   - eye).abs().max())
    del eye
    cam_ids = torch.as_tensor(rng.choice(M, C5_CAMERAS, replace=False),
                              device=dev)
    idx = 6 * cam_ids[:, None] + torch.arange(6, device=dev)
    cams_same = bool(torch.equal(
        cov_direct.camera_covariance_dense(Q, cam_ids),
        torch.stack([Q[i][:, i] for i in idx])))

    # the LU route on a pool of points, and pairs among them
    free = (fmp.free_point.sum(dim=0) > 0).cpu().numpy()
    free_ids = np.flatnonzero(free)
    pool = np.concatenate([[1, dup_point, P - 1], rng.choice(
        np.setdiff1d(free_ids, [dup_point]), C5_POOL - 3, replace=False)])
    pool_t = torch.as_tensor(pool, device=dev)
    R = jacobian_rows(b)
    hinv, Hxp = coupling_by_sums(fmp, R, pool_t)
    del R
    C = Hxp @ hinv                                            # [k, u, 3]
    Cu = C.permute(1, 0, 2).reshape(u, -1)
    X = solve_scaled(S, Cu).reshape(u, C5_POOL, 3).permute(1, 0, 2)
    lu = hinv + C.mT @ X
    err_lu = block_err(Qall[pool_t], lu)
    # recorded: LU on the raw S, and the scaled condition number
    X_raw = torch.linalg.solve(S, Cu).reshape(u, C5_POOL, 3).permute(1, 0, 2)
    err_raw = block_err(Qall[pool_t], hinv + C.mT @ X_raw)
    del X_raw, Cu
    kappa = scaled_condition(S, Q)
    sel_err = block_err(cov_direct.point_covariance_dense(
        fmp, b, Q, point_ids=pool_t), lu)
    ij = np.concatenate([
        np.stack([np.arange(C5_SELF_PAIRS)] * 2, axis=1),
        rng.integers(0, C5_POOL, (C5_PAIRS - C5_SELF_PAIRS, 2))])
    pairs = pool[ij]
    pq = cov_direct.point_pair_covariance_dense(fmp, b, Q, pairs)
    ij_t = torch.as_tensor(ij, device=dev)
    pq_lu = torch.einsum("kua,kub->kab", C[ij_t[:, 0]], X[ij_t[:, 1]])
    scale = torch.maximum(
        lu[ij_t[:, 0]].flatten(1).abs().max(dim=1).values,
        lu[ij_t[:, 1]].flatten(1).abs().max(dim=1).values)
    pair_err = float(((pq - pq_lu).flatten(1).abs().max(dim=1).values
                      / scale).max())
    s_ids = torch.as_tensor(pool[:C5_SELF_PAIRS], device=dev)
    self_err = block_err(pq[:C5_SELF_PAIRS] + hinv[:C5_SELF_PAIRS],
                         Qall[s_ids])
    del C, X, Hxp, S

    # the block gather against dense panels on sampled chunks
    cd = cov_direct.dense_recovery_chunk(P, u)
    n_chunks = max(1, min(C5_SAMPLE // cd, P // cd))
    starts = (np.sort(rng.choice(P // cd, n_chunks, replace=False))
              * cd).tolist()
    ids = torch.as_tensor(np.concatenate([np.arange(c0, min(c0 + cd, P))
                                          for c0 in starts]), device=dev)

    def events(fn):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        r = fn()
        ev[1].record()
        torch.cuda.synchronize()
        return r, ev[0].elapsed_time(ev[1])

    dense, dense_ms = events(lambda: cov_direct.point_covariance_panels(
        fmp, b, Q, starts=starts))
    gath, gath_ms = events(lambda: cov_direct.point_covariance_dense(
        fmp, b, Q, point_ids=ids))
    gather_err = block_err(gath, dense)
    all_err = block_err(Qall[ids], dense)
    k = ids.shape[0]
    log(f"recovery on {k} sampled points ({n_chunks} chunks of {cd}): "
        f"dense panels {dense_ms:.1f} ms, block gathers {gath_ms:.1f} ms "
        f"(each with its per-call set-up over all points); dense panels "
        f"extrapolated to {P} points {dense_ms * P / k / 1e3:.1f} s, "
        f"cov_all's recovery stage {ms['recovery'] / 1e3:.3f} s; "
        f"block gather vs dense {gather_err:.3e}, cov_all's blocks vs dense "
        f"{all_err:.3e}")
    del dense, gath, Q, b

    Qf = Qall[torch.as_tensor(free, device=dev)]
    sym = bool(torch.equal(Qf, Qf.mT))
    finite = bool(torch.isfinite(Qf).all())
    # on the card: a Cholesky of every block (the gate), and the smallest
    # eigenvalue in closed form (cuSOLVER's batched eigensolver,
    # syevBatched, refuses batches of 32,768 3x3 blocks and more)
    spd = int((torch.linalg.cholesky_ex(Qf).info != 0).sum()) == 0
    eig_min = float(sym3_eigmin(Qf).min())
    log(f"residual max|D^-1 (S S^-1 - I)[:, cols] D| on {nc} "
        f"columns {resid:.3e}; {C5_CAMERAS} camera blocks equal Q's "
        f"diagonal blocks: {cams_same}; points {pool.tolist()} (datum 1, "
        f"sees an image twice {dup_point}, dummy {P - 1}): cov_all vs the "
        f"LU route {err_lu:.3e}, selected {sel_err:.3e} (LU on the unscaled "
        f"S, recorded: {err_raw:.3e}; the Jacobi-scaled S's condition "
        f"number >= {kappa:.3e}); {C5_PAIRS} pairs "
        f"vs the LU route {pair_err:.3e} of the larger point block, (p, p) "
        f"pairs + Hpp^-1 vs the point blocks "
        f"{self_err:.3e}; "
        f"{len(free_ids)} free blocks finite: {finite}, symmetric: {sym}, "
        f"Cholesky of each on the card: {spd}, "
        f"smallest eigenvalue {eig_min:.3e}; cov_all (cold, warm) vs the "
        f"staged run "
        f"{repeat_err:.3e}")
    problems = []
    if not resid <= COV_RESIDUAL_TOL:
        problems.append(f"residual {resid:.3e} > {COV_RESIDUAL_TOL}")
    if not cams_same:
        problems.append("camera blocks differ from Q's diagonal blocks")
    if not (err_lu <= COV_BLOCK_TOL and sel_err <= COV_BLOCK_TOL):
        problems.append(f"point blocks disagree with the LU route (all "
                        f"{err_lu:.3e}, selected {sel_err:.3e})")
    if not pair_err <= COV_BLOCK_TOL:
        problems.append(f"pair blocks disagree with the LU route "
                        f"({pair_err:.3e})")
    if not self_err <= C5_SELF_TOL:
        problems.append(f"(p, p) pairs + Hpp^-1 differ from the point "
                        f"blocks ({self_err:.3e})")
    if not (gather_err <= C5_GATHER_TOL and all_err <= C5_GATHER_TOL):
        problems.append(f"the recovery differs from dense panels (block "
                        f"gather {gather_err:.3e}, cov_all {all_err:.3e})")
    if not (finite and sym and spd and eig_min > 0):
        problems.append("a free point's block is not symmetric positive "
                        "definite")
    if not repeat_err <= COV_BLOCK_TOL:
        problems.append(f"cov_all differs from its staged run "
                        f"({repeat_err:.3e})")
    if problems:
        fail("phase 16 covariance: " + "; ".join(problems))
    return dict(u=u, cold_s=cold_s, cold_peak_gb=cold_peak,
                warm_s=warm_ms / 1e3, stage_ms=ms, stage_peak_gb=peak,
                sample_points=k, sample_dense_ms=dense_ms,
                sample_block_gather_ms=gath_ms,
                dense_extrapolated_s=dense_ms * P / k / 1e3,
                residual=resid, lu_err=max(err_lu, sel_err),
                lu_unscaled_err=err_raw, scaled_condition=kappa,
                pair_err=pair_err, self_pair_err=self_err,
                gather_err=gather_err, eig_min=eig_min)


def config5_phase(dev, shape=C5_SHAPE):
    """Phase 16 (see the module docstring).  Returns (summary dict, the
    launch counts of the LM phase and the refinement, {kernel: dict(ms,
    plain_ms, max_abs_err)} at these shapes)."""
    import numpy as np
    import torch

    from bundle_adjustment_tpu_torch import convert, synthetic
    from bundle_adjustment_tpu_torch.parallel import (engine, hilo, kernels,
                                                      lm, rcs, refine)

    t_phase = time.time()
    host = {}

    def lap(name, t):
        torch.cuda.synchronize()
        host[name] = time.time() - t
        return time.time()

    t = time.time()
    prob_h, state_h, spec = synthetic.build_problem(*shape, VIEWS, seed=0)
    t = lap("build_problem", t)
    prob = convert.problem_to_torch(prob_h, dev, torch.float32)
    state0 = convert.state_to_torch(state_h, dev, torch.float32)
    t = lap("problem_to_torch", t)
    # the f64 objective of phase 3: the same problem from its f64 arrays
    prob64 = convert.problem_to_torch(prob_h, dev, torch.float64)
    t = time.time()
    fmp = engine.fm_problem(prob)
    t = lap("fm_problem", t)
    G = 3 + spec.num_coefficients
    fv = kernels.kernel_layout(fmp)
    pb = fv.vm_pb
    t = lap("to_view_major", t)
    del fmp
    P, M = fv.num_points, fv.num_images
    N = P * VIEWS
    img = prob_h.obs_image.reshape(P, VIEWS)
    srt = np.sort(img[:shape[0]], axis=1)
    dup = np.flatnonzero((srt[:, 1:] == srt[:, :-1]).any(axis=1)
                         & (prob_h.free_point[:shape[0], 0] > 0))
    n_obs = 2 * int((prob.obs_weight[:, 0, 0] > 0).sum())
    u_all = int(prob.free_point.sum() + prob.free_eo.sum()
                + prob.free_global.sum())
    dof = n_obs - u_all
    log(f"problem: P={P} M={M} V={VIEWS} G={G} N={N} pb={pb}; "
        f"{len(dup)} points see an image twice; host s " + ", ".join(
            f"{n} {v:.2f}" for n, v in host.items()))
    if not len(dup):
        fail("phase 16: no free point sees an image twice")
    t = time.time()
    digest = synthetic.digest(prob_h, state_h)
    log(f"digest {digest} ({time.time() - t:.1f} s)")
    del prob_h, state_h

    results = config5_kernels(fv, state0, spec, dev)
    log("kernels at these shapes, ms per call between CUDA events "
        "(plain); device time under the profiler: " + ", ".join(
        f"{n} {r['events_ms']:.4f} ({r['plain_events_ms']:.4f}); "
        + (f"{r['device_ms']:.4f}" if r["device_ms"] is not None
           else f"device_ms raised: {r['device_ms_raised']}")
        for n, r in results.items()))

    # the LM phase through the kernels
    fv64 = kernels.kernel_layout(engine.fm_problem(prob64))
    del prob64

    def omega(s):
        return float(engine.linearize(fv64, type(s)(*(a.double() for a in s)),
                                      spec, 0.0).omega0)

    om0 = omega(state0)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    st, ph = lm.run(fv, state0, spec, damping=1e-2, max_steps=60,
                    use_kernels=True)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    om1 = omega(st)
    s0 = (om1 / dof) ** 0.5
    log(f"LM phase (kernels): {ph.steps} steps in {ph.seconds:.2f} s, "
        f"max|dx| {ph.max_dx:.3e}, CG {ph.cg_iterations}; Omega {om0:.6e} -> "
        f"{om1:.6e}; dof {dof}; sigma0 {s0:.6e}; launches {launches}")
    if not (om1 < om0 and abs(s0 / SIGMA - 1.0) < 0.01):
        fail("phase 16: the LM phase did not reach sigma0 within 1% of the "
             "injected noise")
    if min(launches[k] for k in SOLVE_KERNELS) <= 0:
        fail(f"phase 16: a kernel of the LM phase was never launched: "
             f"{launches}")
    del fv64

    def fixed(use_kernels):
        s = st
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(C5_FIXED_REPS):
            dxp, dxc, dxg, _, _ = engine.lm_step(
                fv, s, spec, 1e-6, cg_tol=0.0, cg_maxiter=8, stall_limit=9,
                use_kernels=use_kernels)
            s = rcs.apply_step(s, dxp, dxc, dxg)[0]
        torch.cuda.synchronize()
        return (time.time() - t0) / C5_FIXED_REPS * 1e3

    fixed(True)
    fixed(False)
    turns = [fixed(False), fixed(True), fixed(True), fixed(False)]
    step_k, step_p = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    log(f"fixed-cg8 step: kernels {step_k:.2f} ms, plain {step_p:.2f} ms "
        f"(turns plain/kernels/kernels/plain " + ", ".join(
            f"{x:.2f}" for x in turns) + ")")

    # the undamped refinement through the kernels
    refiner = refine.Refiner(prob, spec, use_kernels=True)
    om3 = float(refiner.gradient64(refiner.fmp64, type(st)(
        *(a.double() for a in st)))[3])
    kernels.reset_launch_counts()
    s_ref, rec = refine.converge(refiner, (st, ph), tolerance=REFINE_TOL,
                                 damping=0.0, max_steps=15)
    launches_r = kernels.launch_counts()
    st64 = hilo.to_f64(s_ref)
    om5 = float(refiner.gradient64(refiner.fmp64, st64)[3])
    ttc = ph.seconds + rec.refine_seconds
    log(f"undamped refinement (kernels): {rec.refine_steps} steps in "
        f"{rec.refine_seconds:.2f} s; max|dx| " + ", ".join(
            f"{x:.3e}" for x in rec.max_dx) + f"; CG {rec.cg_iterations}; "
        f"f64 Omega {om3:.10e} -> {om5:.10e}; launches {launches_r}")
    log(f"time_to_converged_s {ttc:.3f} (LM phase {ph.seconds:.3f} s + "
        f"refinement {rec.refine_seconds:.3f} s)")
    if not rec.max_dx[-1] <= REFINE_TOL:
        fail(f"phase 16: the refinement did not reach max|dx| <= "
             f"{REFINE_TOL}")
    if not om5 <= om3 * (1.0 + 1e-9):
        fail("phase 16: the refinement raised the f64 Omega above the LM "
             "phase's end")
    if min(launches_r[k] for k in SOLVE_KERNELS) <= 0:
        fail(f"phase 16: a kernel of the refinement was never launched: "
             f"{launches_r}")
    del refiner, fv, st, state0, s_ref
    torch.cuda.empty_cache()

    cov = config5_covariance(prob, st64, spec, dev, int(dup[0]))
    seconds = time.time() - t_phase
    log(f"phase 16: {seconds:.1f} s (budget {C5_BUDGET_S} s)")
    if not seconds <= C5_BUDGET_S:
        fail(f"phase 16 took {seconds:.1f} s, over its budget of "
             f"{C5_BUDGET_S} s")
    launches_all = {k: launches[k] + launches_r[k] for k in launches}
    summary = dict(
        shape=dict(N=N, P=P, M=M, G=G), digest=digest, host_s=host,
        lm_steps=ph.steps,
        lm_s=ph.seconds, sigma0=s0, lm_cg=ph.cg_iterations,
        fixed_cg8_step_ms=step_k,
        fixed_cg8_step_plain_ms=step_p, refine_steps=rec.refine_steps,
        refine_s=rec.refine_seconds, refine_cg=rec.cg_iterations,
        converged_max_dx=rec.max_dx[-1], time_to_converged_s=ttc, cov=cov,
        phase_s=seconds)
    return {"config5": summary}, launches_all, results


def main(profile_refinement=False):
    t_start = time.time()
    try:
        import torch
    except ImportError as exc:
        fail(f"torch is not importable: {exc}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a GPU")
    try:
        from bundle_adjustment_tpu_torch import (convert, kernel_build,
                                                 measure, synthetic)
        from bundle_adjustment_tpu_torch.parallel import (engine, hilo,
                                                          kernels, lm, rcs,
                                                          refine)
    except ImportError as exc:
        fail(f"the port package is not importable here: {exc}")

    # ---- 1. card and build -------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else f"nvidia-smi failed: {smi.stderr.strip()}"
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; device {kind}")
    log(f"card: {card}")
    built = kernel_build.build(verbose=True)
    log(f"kernel build: {built.seconds:.1f} s")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"  ptxas {line.strip()}")
    lib = kernel_build.library()
    # choose_pb's model of K2's tile against the kernel's own plan, for
    # every block the kernels take, at this card's shared-memory limit
    grid = [(pb, V, G) for V in range(1, kernels.MAX_BLOCK_THREADS // 32 + 1)
            for pb in range(32, kernels.MAX_BLOCK_THREADS // V + 1, 32)
            for G in range(1, kernels.MAX_G + 1)]
    off = [x for x in grid
           if lib.ba_prepare_fits(*x, 0) != int(kernels.k2_tile_fits(*x))]
    log(f"K2 tile fit: model vs kernel on {len(grid)} (pb, V, G), "
        f"{len(off)} differ")
    if off:
        fail(f"kernels.k2_tile_fits disagrees with ba_prepare_fits at "
             f"(pb, V, G) {off[:8]}")

    # ---- 2. kernels vs plain versions at the main-path shapes -------------
    log(f"-- phase 2 at {time.time() - t_start:.1f} s")
    t0 = time.time()
    prob_h, state_h, spec = synthetic.build_problem(NUM_POINTS, NUM_IMAGES,
                                                    VIEWS, seed=0)
    prob = convert.problem_to_torch(prob_h, dev, torch.float32)
    state0 = convert.state_to_torch(state_h, dev, torch.float32)
    fmp = engine.fm_problem(prob)
    G = 3 + spec.num_coefficients
    fv = kernels.kernel_layout(fmp)
    pb = fv.vm_pb
    N = fv.num_points * fv.views
    log(f"problem: P={fv.num_points} M={fv.num_images} V={fv.views} G={G} "
        f"N={N} pb={pb}; built in {time.time() - t0:.1f} s; digest "
        f"{synthetic.digest(prob_h, state_h)}")

    results = {}
    b = engine.linearize(fv, state0, spec, 1e-2)
    pp = kernels.pack_fm(b, fv, with_pw=True)
    torch.cuda.synchronize()

    # K3
    eo = state0.eo.contiguous()
    g_k = kernels.cam_gather_rows(eo, pp.obs_img)
    g_p = kernels.cam_gather_plain(eo, pp.obs_img)
    if not torch.equal(g_k, g_p):
        fail(f"K3 cam_gather differs from its plain version "
             f"(max abs {float((g_k - g_p).abs().max()):.3e})")
    idx64 = pp.obs_img.long()

    def k3():
        return kernels.cam_gather_rows(eo, pp.obs_img)

    # K3 is shorter than its wrapper's host cost, so CUDA events around
    # back-to-back calls read the host: its plain version and the library
    # call are held against device times too.  Device activities per call
    # (the profile is held to them): the plain version's index cast, gather,
    # zero rows and concatenation, 4; the library call's 2
    results["cam_gather"] = dict(
        max_abs_err=float((g_k - g_p).abs().max()),
        ms=measure.device_ms(k3, reps=50, warm=20)[0],
        ms_l2_flushed=measure.device_ms(k3, flush_l2=True)[0],
        events_ms=measure.time_ms(k3, reps=50),
        plain_ms=measure.device_ms(
            lambda: kernels.cam_gather_plain(eo, pp.obs_img),
            launches=4)[0],
        # the one PyTorch call for the same gather (timed here, used nowhere
        # in the port): index_select, then the transpose copy
        library_ms=measure.device_ms(
            lambda: torch.index_select(eo, 0, idx64).t().contiguous(),
            launches=2)[0])
    del idx64
    log("K3 cam_gather: exact; device time {ms:.4f} ms, {ms_l2_flushed:.4f} "
        "ms with the L2 flushed before each launch ({events_ms:.4f} ms per "
        "call between CUDA events, back to back), plain {plain_ms:.4f} ms, "
        "index_select + transpose copy {library_ms:.4f} ms".format(
            **results["cam_gather"]))

    # K2
    out_k = kernels.prepare_reduction(pp)
    out_p = kernels.prepare_reduction_plain(pp)
    names = ("red", "rg_corr", "T2", "T3")
    errs = {n: scaled_err(a, r) for n, a, r in zip(names, out_k, out_p)}
    log("K2 scaled errors: " + ", ".join(f"{n} {e:.2e}"
                                         for n, e in errs.items()))
    fin_k = engine.finish_reduction(fv, b, state0, 1e-2, *out_k, True)
    fin_p = engine.finish_reduction(fv, b, state0, 1e-2, *out_p, True)
    fin_errs = {
        "rc": scaled_err(fin_k[1], fin_p[1]),
        "rg": scaled_err(fin_k[2], fin_p[2]),
        "bc": scaled_err(fin_k[0].bc, fin_p[0].bc),
        "extra_c": scaled_err(fin_k[0].extra_c, fin_p[0].extra_c),
        "Scg": scaled_err(fin_k[3].Scg, fin_p[3].Scg),
        "Minv_c/cond": inverse_err(fin_k[3].Minv_c, fin_p[3].Minv_c),
        "Sghat_inv/cond": inverse_err(fin_k[3].Sghat_inv,
                                      fin_p[3].Sghat_inv),
    }
    log("K2 through finish_reduction: " + ", ".join(
        f"{n} {e:.2e}" for n, e in fin_errs.items()) + "; raw scaled "
        f"Minv_c {scaled_err(fin_k[3].Minv_c, fin_p[3].Minv_c):.2e}")
    bad = [n for n, e in {**errs, **fin_errs}.items()
           if not e <= TOL_SCALED]
    if bad:
        fail(f"K2 prepare_reduction disagrees with its plain version: {bad}")
    for _ in range(K2_REPEATS):
        if not all(torch.equal(a, c) for a, c in zip(
                out_k, kernels.prepare_reduction(pp))):
            fail("K2 prepare_reduction is not deterministic")
    log(f"K2 repeat runs bit-identical: {K2_REPEATS} of {K2_REPEATS}")
    k2_ms, k2_by = measure.device_ms(lambda: kernels.prepare_reduction(pp),
                                     reps=10)
    results["prepare_reduction"] = dict(
        max_abs_err=max(float((a - r).abs().max())
                        for a, r in zip(out_k, out_p)),
        ms=k2_ms, by_kernel_ms=k2_by,
        events_ms=measure.time_ms(lambda: kernels.prepare_reduction(pp),
                                  reps=10),
        plain_ms=measure.time_ms(
            lambda: kernels.prepare_reduction_plain(pp), reps=5, warm=1))
    log("K2 prepare_reduction: device time {ms:.4f} ms ({events_ms:.4f} ms "
        "between CUDA events), plain {plain_ms:.4f} ms; by kernel ".format(
            **results["prepare_reduction"]) + by_kernel(k2_by))

    # K1
    gen = torch.Generator().manual_seed(1)
    xc = torch.randn((fv.num_images, 6), generator=gen).to(dev)
    xg = torch.randn((G,), generator=gen).to(dev)
    ec, eg = fin_p[0].extra_c.contiguous(), fin_p[0].extra_g.contiguous()
    oc_k, og_k = kernels.schur_matvec_rows(pp, ec, eg, xc, xg)
    oc_p, og_p = kernels.schur_matvec_plain(pp, ec, eg, xc, xg)
    e_c, e_g = scaled_err(oc_k, oc_p), scaled_err(og_k, og_p)
    # many repeats: a missing barrier of the shared-memory ring would give
    # other bits only now and then
    same = True
    for _ in range(K1_REPEATS):
        oc_k2, og_k2 = kernels.schur_matvec_rows(pp, ec, eg, xc, xg)
        same = same and bool(torch.equal(oc_k, oc_k2)
                             and torch.equal(og_k, og_k2))
    log(f"K1 scaled errors: c {e_c:.2e}, g {e_g:.2e}; "
        f"{K1_REPEATS} repeat runs bit-identical: {same}")
    if not (e_c <= TOL_SCALED and e_g <= TOL_SCALED):
        fail("K1 schur_matvec disagrees with its plain version")
    if not same:
        fail("K1 schur_matvec is not deterministic")
    def k1():
        return kernels.schur_matvec_rows(pp, ec, eg, xc, xg)

    k1_ms, k1_by = measure.device_ms(k1, reps=50)
    results["schur_matvec"] = dict(
        max_abs_err=max(float((oc_k - oc_p).abs().max()),
                        float((og_k - og_p).abs().max())),
        ms=k1_ms, by_kernel_ms=k1_by,
        ms_l2_flushed=measure.device_ms(k1, flush_l2=True)[0],
        events_ms=measure.time_ms(k1, reps=50),
        plain_ms=measure.time_ms(lambda: kernels.schur_matvec_plain(
            pp, ec, eg, xc, xg), reps=10))
    log("K1 schur_matvec: device time {ms:.4f} ms, {ms_l2_flushed:.4f} ms "
        "with the L2 flushed before each launch ({events_ms:.4f} ms between "
        "CUDA events, back to back), plain {plain_ms:.4f} ms; by "
        "kernel ".format(**results["schur_matvec"]) + by_kernel(k1_by))
    del b, pp, out_k, out_p, fin_k, fin_p

    # ---- 3. the LM phase through the kernels -------------------------------
    log(f"-- phase 3 at {time.time() - t_start:.1f} s")
    prob64 = convert.problem_to_torch(prob_h, dev, torch.float64)
    fv64 = kernels.kernel_layout(engine.fm_problem(prob64))
    n_obs = 2 * int((prob64.obs_weight[:, 0, 0] > 0).sum())
    u = int(prob64.free_point.sum() + prob64.free_eo.sum()
            + prob64.free_global.sum())
    dof = n_obs - u

    def omega(st):
        st64 = type(st)(*(a.double() for a in st))
        return float(engine.linearize(fv64, st64, spec, 0.0).omega0)

    om0 = omega(state0)

    def lm_phase(use_kernels):
        torch.cuda.synchronize()
        t = time.time()
        st, ph = lm.run(fv, state0, spec, damping=1e-2, max_steps=60,
                        use_kernels=use_kernels)
        torch.cuda.synchronize()
        return st, ph, time.time() - t

    kernels.reset_launch_counts()
    st, ph, t_lm = lm_phase(True)
    launches = kernels.launch_counts()
    om1 = omega(st)
    s0 = (om1 / dof) ** 0.5
    log(f"LM phase (kernels): {ph.steps} steps in {t_lm:.2f} s, final "
        f"max|dx| {ph.max_dx:.3e}, CG iterations {ph.cg_iterations}")
    log(f"Omega {om0:.6e} -> {om1:.6e}; dof {dof}; sigma0 {s0:.6e} "
        f"(injected {SIGMA})")
    log(f"launches during the LM phase: {launches}")
    ok_lm = om1 < om0 and abs(s0 / SIGMA - 1.0) < 0.01
    if not ok_lm:
        st_p, ph_p, t_p = lm_phase(False)
        s0_p = (omega(st_p) / dof) ** 0.5
        log(f"plain-path LM phase: {ph_p.steps} steps, max|dx| "
            f"{ph_p.max_dx:.3e}, sigma0 {s0_p:.6e}")
        fail("LM phase through the kernels did not converge to sigma0 "
             "within 1% of the injected noise")
    if min(launches[k] for k in SOLVE_KERNELS) <= 0:
        fail(f"a kernel of the LM phase was never launched: {launches}")
    total = dict(launches)
    by_phase = {"lm_phase": launches}

    # ---- 4. steady-state fixed-CG step -------------------------------------
    log(f"-- phase 4 at {time.time() - t_start:.1f} s")
    def fixed_step(st, use_kernels):
        dxp, dxc, dxg, _, _ = engine.lm_step(
            fv, st, spec, 1e-6, cg_tol=0.0, cg_maxiter=8, stall_limit=9,
            use_kernels=use_kernels)
        return rcs.apply_step(st, dxp, dxc, dxg)[0]

    def run_fixed(use_kernels, reps=5):
        s = st
        torch.cuda.synchronize()
        t = time.time()
        for _ in range(reps):
            s = fixed_step(s, use_kernels)
        torch.cuda.synchronize()
        return (time.time() - t) / reps

    kernels.reset_launch_counts()
    run_fixed(True, 1)
    by_phase["fixed_cg8_step"] = kernels.launch_counts()
    log(f"launches during one fixed-cg8 step: {by_phase['fixed_cg8_step']}")
    run_fixed(False, 1)
    tp = [run_fixed(False), run_fixed(True), run_fixed(True),
          run_fixed(False)]
    step_plain = (tp[0] + tp[3]) / 2 * 1e3
    step_kern = (tp[1] + tp[2]) / 2 * 1e3
    log(f"fixed-cg8 LM step: kernels {step_kern:.3f} ms, plain "
        f"{step_plain:.3f} ms (turns plain/kernels/kernels/plain: "
        + ", ".join(f"{x * 1e3:.3f}" for x in tp) + " ms)")

    def log_profile(label, prof, per=1):
        log(f"{label}: device busy {prof['busy_ms'] / per:.3f} ms of "
            f"{prof['wall_ms'] / per:.3f} ms profiled (idle "
            f"{prof['idle_share']:.1%}), {prof['launches'] // per} launches; "
            + "; ".join(f"{n} x{c // per} {t / per:.3f} ms"
                        for n, c, t in prof["top"]))

    prof_step = measure.device_profile(lambda: run_fixed(True, 3))
    log_profile("fixed-cg8 step under torch.profiler, per step", prof_step, 3)

    # ---- 5. convergence: mixed-precision refinement through the kernels ---
    log(f"-- phase 5 at {time.time() - t_start:.1f} s")
    refiner = refine.Refiner(prob, spec, use_kernels=True)
    st64 = type(st)(*(a.double() for a in st))
    om3_r = float(refiner.gradient64(refiner.fmp64, st64)[3])

    def refine_phase(r, damping, max_steps=15):
        torch.cuda.synchronize()
        return refine.converge(r, (st, ph), tolerance=REFINE_TOL,
                               damping=damping, max_steps=max_steps)

    def contraction(hist):
        """Geometric mean of max|dx| ratios over the last 5 steps."""
        h = hist[-6:]
        return (h[-1] / h[0]) ** (1.0 / (len(h) - 1)) if len(h) > 1 else 0.0

    def plain_diagnosis(damping):
        """The same refinement through the plain path, to tell a kernel
        fault from a slice fault."""
        _, rec_p = refine_phase(refine.Refiner(prob, spec, use_kernels=False),
                                damping, max_steps[damping])
        log(f"plain-path refinement, damping {damping:g}: "
            f"{rec_p.refine_steps} steps, max|dx| {rec_p.max_dx}, "
            f"CG iterations {rec_p.cg_iterations}")

    runs = {}
    max_steps = {BENCH_DAMPING: BENCH_DAMPED_STEPS, 0.0: 15}
    for label, damping in (("bench", BENCH_DAMPING), ("undamped", 0.0)):
        kernels.reset_launch_counts()
        s_ref, rec = refine_phase(refiner, damping, max_steps[damping])
        launches5 = kernels.launch_counts()
        om5_r = float(refiner.gradient64(refiner.fmp64,
                                         hilo.to_f64(s_ref))[3])
        s0_5 = (om5_r / dof) ** 0.5
        log(f"refinement, damping {damping:g} (kernels): {rec.refine_steps} "
            f"steps in {rec.refine_seconds:.2f} s; max|dx| " + ", ".join(
                f"{x:.3e}" for x in rec.max_dx) + f"; CG iterations "
            f"{rec.cg_iterations}; contraction over the last steps "
            f"{contraction(rec.max_dx):.3f} per step")
        log(f"  f64 Omega of the refinement's objective {om3_r:.10e} -> "
            f"{om5_r:.10e}; sigma0 {s0_5:.6e}; on the f64 observations "
            f"{om1:.10e} -> {omega(hilo.to_f64(s_ref)):.10e}")
        log(f"  launches during the refinement: {launches5}")
        if min(launches5[k] for k in SOLVE_KERNELS) <= 0:
            fail(f"a kernel of the refinement was never launched: "
                 f"{launches5}")
        problems = []
        if not (om5_r <= om3_r * (1.0 + 1e-9)
                and abs(s0_5 / SIGMA - 1.0) < 0.01):
            problems.append(f"refinement (damping {damping:g}) raised Omega "
                            "above phase 3's or moved sigma0 off the "
                            "injected noise")
        if label == "undamped" and not rec.max_dx[-1] <= REFINE_TOL:
            problems.append(f"the undamped refinement through the kernels "
                            f"did not reach max|dx| <= {REFINE_TOL} within "
                            f"15 steps")
        if problems:
            plain_diagnosis(damping)
            fail("; ".join(problems))
        total = {k: total[k] + launches5[k] for k in total}
        by_phase[f"refine_{label}"] = launches5
        runs[label] = dict(steps=rec.refine_steps, seconds=rec.refine_seconds,
                           max_dx=rec.max_dx, cg_iterations=rec.cg_iterations,
                           sigma0=s0_5, omega=om5_r)
    del s_ref
    prof_ref = None
    if profile_refinement:
        prof_ref = measure.device_profile(lambda: refine_phase(refiner, 0.0))
        log_profile("undamped refinement under torch.profiler", prof_ref)
    ttc = t_lm + rec.refine_seconds
    log(f"time_to_converged_s {ttc:.3f} (LM phase {t_lm:.3f} s, "
        f"{ph.steps} steps + undamped refinement {rec.refine_seconds:.3f} s, "
        f"{rec.refine_steps} steps)")
    del refiner

    # ---- 6. the matvec roofline: K4 and the K1 stages ----------------------
    log(f"-- phase 6 at {time.time() - t_start:.1f} s")
    b6 = engine.linearize(fv, st, spec, 1e-6)
    pp6 = kernels.pack_fm(b6, fv, lean_only=True)
    ec6 = torch.zeros((fv.num_images, 6), dtype=torch.float32, device=dev)
    eg6 = b6.extra_g.contiguous()
    del b6
    gen = torch.Generator().manual_seed(4)
    xc6 = torch.randn((fv.num_images, 6), generator=gen).to(dev)
    xg6 = torch.randn((G,), generator=gen).to(dev)
    xin = torch.randn((8, 128), generator=gen).to(dev)
    f_k = kernels.read_floor(pp6, xin)
    f_p = kernels.read_floor_plain(pp6, xin)
    f_scale = kernels.read_floor_plain(pp6._replace(packed=pp6.packed.abs()),
                                       torch.zeros_like(xin))
    e_floor = float(((f_k - f_p).abs() / f_scale.clamp_min(1e-30)).max())
    log(f"K4 read_floor: max |kernel - plain| / sum|values| {e_floor:.2e}")
    if not e_floor <= TOL_FLOOR:
        fail("K4 read_floor disagrees with its plain version")
    stage_err, stage_abs, stage_plain_ms = {}, 0.0, {}
    for name in kernels.MATVEC_STAGES[:-1]:
        o_k = torch.cat(kernels.matvec_stage(pp6, name, ec6, eg6, xc6, xg6))
        o_p = torch.cat(kernels.matvec_stage_plain(pp6, name, ec6, eg6, xc6,
                                                   xg6))
        stage_err[name] = scaled_err(o_k, o_p)
        stage_abs = max(stage_abs, float((o_k - o_p).abs().max()))
        stage_plain_ms[name] = measure.time_ms(
            lambda n=name: kernels.matvec_stage_plain(pp6, n, ec6, eg6, xc6,
                                                      xg6), reps=5, warm=1)
    full = kernels.matvec_stage(pp6, "full", ec6, eg6, xc6, xg6)
    k1 = kernels.schur_matvec_rows(pp6, ec6, eg6, xc6, xg6)
    full_same = all(torch.equal(a, c) for a, c in zip(full, k1))
    log("K1 stages vs plain, scaled errors: " + ", ".join(
        f"{n} {e:.2e}" for n, e in stage_err.items())
        + f"; full stage equal to K1 bit for bit: {full_same}")
    if not all(e <= TOL_SCALED for e in stage_err.values()):
        fail("a K1 stage kernel disagrees with its plain version")
    if not full_same:
        fail("the full stage differs from K1")
    stage_plain_ms["full"] = measure.time_ms(
        lambda: kernels.schur_matvec_plain(pp6, ec6, eg6, xc6, xg6), reps=5,
        warm=1)
    floor_plain_ms = measure.time_ms(
        lambda: kernels.read_floor_plain(pp6, xin), reps=5, warm=1)

    # the one PyTorch call for K4's fold (timed here, used nowhere in the
    # port): the pad rows of the lean prefix are zero, so one sum over the
    # prefix viewed [.., 8, N / 128, 128] is the same fold; it reads the pad
    # rows too (48 rows for K4's 41 at G = 10)
    def fold_one_call():
        return pp6.packed.view(-1, 8, N // 128, 128).sum(dim=(0, 2))

    e_lib = float(((fold_one_call() - f_p).abs()
                   / f_scale.clamp_min(1e-30)).max())
    if not e_lib <= 10 * TOL_FLOOR:
        fail(f"the one-call fold is not K4's function (error {e_lib:.2e})")
    # its device activities per call: the reduction and a memset
    floor_library_ms = measure.device_ms(fold_one_call, launches=2)[0]

    kernels.reset_launch_counts()
    roof = measure.roofline(pp6, ec6, eg6, xc6, xg6, reps=20)
    torch.cuda.synchronize()
    launches6 = kernels.launch_counts()
    log(f"launches during the roofline: {launches6}")
    if min(launches6[k] for k in ("read_floor", "matvec_stage",
                                  "schur_matvec")) <= 0:
        fail(f"a kernel of the roofline was never launched: {launches6}")
    total = {k: total[k] + launches6[k] for k in total}
    by_phase["roofline"] = launches6
    sm = roof["stage_ms"]
    # the same probes' device time (after the counters were read: these
    # launches are measurements, not the roofline's)
    dm = {"dma": measure.device_ms(lambda: kernels.read_floor(pp6, xin))[0]}
    for name in kernels.MATVEC_STAGES:
        dm[name] = measure.device_ms(
            lambda n=name: kernels.matvec_stage(pp6, n, ec6, eg6, xc6,
                                                xg6))[0]
    log(f"bytes: rows read {roof['rows_read_bytes']} (41 rows), padded "
        f"count of bench.matvec_cost {roof['padded_bytes']} (48 rows)")
    log("stage ms between CUDA events: " + ", ".join(
        f"{n} {t:.4f}" for n, t in sm.items()) + "; device time: " + ", ".join(
            f"{n} {t:.4f}" for n, t in dm.items())
        + f"; the fold as one torch sum {floor_library_ms:.4f} (error "
        f"{e_lib:.2e} of the sum of |values|); plain ms: " + f"dma {floor_plain_ms:.4f}, " + ", ".join(
            f"{n} {t:.4f}" for n, t in stage_plain_ms.items()))
    log(f"matvec {roof['matvec_gbps']:.1f} GB/s on the rows read, "
        f"{roof['matvec_padded_gbps']:.1f} GB/s on the padded count; read "
        f"floor {roof['matvec_read_floor_gbps']:.1f} GB/s on the rows read, "
        f"{roof['matvec_read_floor_padded_gbps']:.1f} GB/s on the padded "
        f"count; matvec_vs_read_floor {roof['matvec_vs_read_floor']:.4f}")
    if not sm["dma"] < sm["full"]:
        fail(f"the read floor ({sm['dma']:.4f} ms) is not faster than K1 "
             f"({sm['full']:.4f} ms)")
    results["read_floor"] = dict(
        max_abs_err=float((f_k - f_p).abs().max()), ms=dm["dma"],
        events_ms=sm["dma"], plain_ms=floor_plain_ms,
        library_ms=floor_library_ms)
    results["matvec_stage"] = dict(
        max_abs_err=stage_abs, ms=dm["gather"], events_ms=sm["gather"],
        plain_ms=stage_plain_ms["gather"],
        stages={n: dict(ms=dm[n], events_ms=sm[n],
                        plain_ms=stage_plain_ms[n])
                for n in kernels.MATVEC_STAGES})
    del pp6

    # ---- 7. covariance: every point's 3x3 block ----------------------------
    log(f"-- phase 7 at {time.time() - t_start:.1f} s")
    cov, k3_7 = covariance_phase(prob, st, spec, dev)
    total["cam_gather"] += k3_7
    by_phase["covariance_f32"] = {"cam_gather": k3_7}

    # ---- 8. the free network: solve + refinement with extras ---------------
    log(f"-- phase 8 at {time.time() - t_start:.1f} s")
    free, launches8 = free_network_phase(prob_h, state_h, spec, dev)
    total = {k: total[k] + launches8[k] for k in total}
    by_phase["free_network"] = launches8

    # ---- 9. the reference API: scene model, dense f64, scale class ----------
    log(f"-- phase 9 at {time.time() - t_start:.1f} s")
    api, launches9 = reference_api_phase(dev)
    by_phase["reference_api"] = launches9

    # ---- 10. the multi-camera rig: the compact layout, plain path ----------
    log(f"-- phase 10 at {time.time() - t_start:.1f} s")
    rig, launches10 = multi_camera_phase(dev)
    by_phase["multi_camera"] = launches10

    # ---- 11. the file-driven scale path ------------------------------------
    log(f"-- phase 11 at {time.time() - t_start:.1f} s")
    files, launches11 = file_route_phase(prob_h, state_h, spec, dev)
    total = {k: total[k] + launches11[k] for k in total}
    by_phase["file_route"] = launches11

    # ---- 12. the CLI and initialisation at the reference-API size ----------
    log(f"-- phase 12 at {time.time() - t_start:.1f} s")
    cli_res, launches12 = cli_phase(dev)
    by_phase["cli"] = launches12

    # ---- 13. the sharded steps and the distributed Cholesky ----------------
    log(f"-- phase 13 at {time.time() - t_start:.1f} s")
    shard_res, launches13, k3_13 = sharded_phase()
    total = {k: total[k] + k3_13[k] for k in total}
    by_phase["sharded"] = launches13
    by_phase["sharded_file_f32"] = k3_13

    # ---- 14. the scenario-batched fleet ------------------------------------
    log(f"-- phase 14 at {time.time() - t_start:.1f} s")
    fleet_res, launches14 = fleet_phase(dev)
    by_phase["fleet"] = launches14

    # ---- 15. uneven visibility: the block-layout engine ------------------
    log(f"-- phase 15 at {time.time() - t_start:.1f} s")
    uneven, launches15 = uneven_phase(dev)
    total = {k: total[k] + launches15[k] for k in total}
    by_phase["uneven"] = launches15

    # ---- 16. BASELINE config 5: 1M points / 5,000 images / 12 views -------
    log(f"-- phase 16 at {time.time() - t_start:.1f} s")
    config5, launches16, kernels5 = config5_phase(dev)
    total = {k: total[k] + launches16[k] for k in total}
    by_phase["config5"] = launches16

    # ---- 17. the port's example as a user runs it ------------------------
    log(f"-- phase 17 at {time.time() - t_start:.1f} s")
    example_res = example_phase()

    log(json.dumps({
        "lm_phase_steps": ph.steps, "lm_phase_s": t_lm, "sigma0": s0,
        "fixed_cg8_step_ms": step_kern,
        "fixed_cg8_step_plain_ms": step_plain,
        "time_to_converged_s": ttc, "refine_steps": rec.refine_steps,
        "refine_s": rec.refine_seconds, "converged_max_dx": rec.max_dx[-1],
        "refine_cg_iterations": rec.cg_iterations,
        "refine_bench_damping": runs["bench"],
        "matvec_gbps": roof["matvec_gbps"],
        "matvec_padded_gbps": roof["matvec_padded_gbps"],
        "matvec_read_floor_gbps": roof["matvec_read_floor_gbps"],
        "matvec_read_floor_padded_gbps":
            roof["matvec_read_floor_padded_gbps"],
        "matvec_vs_read_floor": roof["matvec_vs_read_floor"],
        "stage_ms": sm, "launches_by_phase": by_phase,
        "profile_fixed_cg8_3_steps": prof_step,
        "profile_refine_undamped": prof_ref, **cov, **free, **api,
        **rig, **files, **cli_res, "sharded": shard_res, **fleet_res,
        **uneven, **config5, **example_res}))
    # the least time the card could take for each kernel's work at these
    # shapes (measure.py: bytes over 3.35 TB/s, f32 flops over 67 TFLOP/s)
    P_, M_ = fv.num_points, fv.num_images
    work = {"cam_gather": measure.k3_work(N, M_, state0.eo.shape[1]),
            "prepare_reduction": measure.k2_work(N, P_, M_, G, VIEWS),
            "schur_matvec": measure.k1_work(N, P_, M_, G, VIEWS),
            "read_floor": measure.k4_work(N, G),
            "matvec_stage": measure.stage_work(N, P_, M_, G, VIEWS)}
    c5 = config5["config5"]["shape"]
    work5 = {"cam_gather": measure.k3_work(c5["N"], c5["M"],
                                           state0.eo.shape[1]),
             "prepare_reduction": measure.k2_work(c5["N"], c5["P"], c5["M"],
                                                  G, VIEWS),
             "schur_matvec": measure.k1_work(c5["N"], c5["P"], c5["M"], G,
                                             VIEWS),
             "read_floor": measure.k4_work(c5["N"], G)}
    # the image-sum kernel at the rig's product call (phase 10 (i)); its
    # launches are every phase's own, its check's not
    ris = rig["rig_image_sum"]
    work["image_sum"] = measure.image_sum_work(
        ris["shape"]["N"], ris["shape"]["M"], ris["shape"]["F"], 8)
    results["image_sum"] = ris
    total["image_sum"] = sum(c.get("image_sum", 0)
                             for c in by_phase.values())
    kernel_rows = []
    for n in SOURCES:
        b_ms, b_by = measure.bound_ms(work[n])
        row = dict(name=n, route="cuda", source=SOURCES[n],
                   replaces=TPU_SITES[n], launches=total[n],
                   max_abs_err=results[n]["max_abs_err"],
                   ms=results[n]["ms"], plain_ms=results[n]["plain_ms"],
                   bound_ms=b_ms, bound_by=b_by,
                   share_of_bound=b_ms / results[n]["ms"],
                   library_ms=results[n].get("library_ms"),
                   work_bytes=work[n][0])
        for extra in ("events_ms", "ms_l2_flushed", "by_kernel_ms",
                      "stages", "shape", "stack_err", "check_launches"):
            if extra in results[n]:
                row[extra] = results[n][extra]
        if n in kernels5:
            b5, b5_by = measure.bound_ms(work5[n])
            row["config5"] = dict(**kernels5[n], launches=launches16[n],
                                  bound_ms=b5, bound_by=b5_by,
                                  share_of_bound=b5
                                  / kernels5[n]["events_ms"],
                                  work_bytes=work5[n][0])
        kernel_rows.append(row)
    log(f"-- done at {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernel_rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:] not in ([], [PROFILE_REFINEMENT]):
        fail(f"usage: chip_smoke.py [{PROFILE_REFINEMENT}]")
    main(profile_refinement=PROFILE_REFINEMENT in sys.argv[1:])
