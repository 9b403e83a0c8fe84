#!/usr/bin/env python3
"""Chip check of the PyTorch + CUDA port: the scale solve on one GPU.

    python3 chip_smoke.py

Phases (any failed check exits non-zero, before the result line):
  1. card and build: the card's name and power limit (nvidia-smi), then the
     CUDA kernels built from csrc/ with nvcc (sm_90a);
  2. each kernel (K3 camera gather, K2 fused assembly, K1 Schur matvec)
     against its plain PyTorch version at the main-path shapes (100,352
     points incl. padding, 500 images, 12 views, G = 10): K3 exactly, K1
     and K2 within a scaled error of 2e-4 (the reference's f32 kernel
     tolerance), K2 also through finish_reduction; K1 run twice must give
     identical bits (deterministic reductions); times from CUDA events;
  3. the LM phase (parallel/lm.py) from synthetic.build_problem(seed=0),
     entirely through the kernels: launch counters reset before and read
     after, each must be > 0; Omega must drop and sigma0 = sqrt(Omega/dof)
     must land within 1% of the injected 5e-4 (on failure the same phase
     runs through the plain path to tell kernel from slice);
  4. the steady-state fixed-CG step (8 CG iterations, tol 0) through the
     kernels and through the plain path, timed in turns;
  5. convergence: from phase 3's end state, mixed-precision refinement
     (parallel/refine.py `converge`: cg_tol 1e-12, cg_maxiter 800,
     stall_limit 300, at most 15 steps) through K1-K3, the f64 gradient in
     plain PyTorch on the GPU, run twice: with the bench's damping 1e-7,
     recorded, and undamped, which must reach max|dx| <= 1e-6 (at this
     size the bench's damping limits the contraction to ~2/3 per step, see
     refine.py).  For each run the launch counters are reset before and
     read after, each > 0; the f64 Omega of the refinement's own objective
     (the f32-rounded observations) at the refined state must be <= its
     value at phase 3's state x (1 + 1e-9) and sigma0 within 1% of 5e-4.
     time_to_converged_s = phase 3's seconds + the undamped refinement's
     (a run that fails a check runs again through the plain path);
  6. the matvec roofline (measure.py) on the lean rows at phase 3's state:
     K4 (read floor) against its plain version, each entry within 1e-6 of
     the sum of |values| it folds; each cut K1 stage within a scaled error
     of 2e-4, the full stage equal to K1 bit for bit; then with the
     counters reset, K4, every stage and K1 timed over 20 warm runs, GB/s
     on the rows read and on the padded count, and matvec_vs_read_floor;
     the floor must not be slower than K1.
Then one JSON line with the kernels (``launches`` summed over the runs of
phases 3, 5 and 6, each between a reset and a read of the counters), and
last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

NUM_POINTS, NUM_IMAGES, VIEWS = 100_000, 500, 12
SIGMA = 5e-4
TOL_SCALED = 2e-4       # kernel vs plain, f32 (tests/test_pallas_prepare.py)
TOL_FLOOR = 1e-6        # K4 vs plain, per entry, of the sum of |values|
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
}
SOURCES = {
    "cam_gather": "bundle_adjustment_tpu_torch/csrc/cam_gather.cu",
    "prepare_reduction": "bundle_adjustment_tpu_torch/csrc/prepare_reduction.cu",
    "schur_matvec": "bundle_adjustment_tpu_torch/csrc/schur_matvec.cu",
    "read_floor": "bundle_adjustment_tpu_torch/csrc/read_floor.cu",
    "matvec_stage": "bundle_adjustment_tpu_torch/csrc/schur_matvec.cu",
}
SOLVE_KERNELS = ("cam_gather", "prepare_reduction", "schur_matvec")


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


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


def main():
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
    kernel_build.library()

    # ---- 2. kernels vs plain versions at the main-path shapes -------------
    t0 = time.time()
    prob_h, state_h, spec = synthetic.build_problem(NUM_POINTS, NUM_IMAGES,
                                                    VIEWS, seed=0)
    prob = convert.problem_to_torch(prob_h, dev, torch.float32)
    state0 = convert.state_to_torch(state_h, dev, torch.float32)
    fmp = engine.fm_problem(prob)
    pb = kernels.choose_pb(fmp.num_points, fmp.views)
    fv = engine.to_view_major(fmp, pb)
    G = 3 + spec.num_coefficients
    N = fv.num_points * fv.views
    log(f"problem: P={fv.num_points} M={fv.num_images} V={fv.views} G={G} "
        f"N={N} pb={pb}; built in {time.time() - t0:.1f} s")

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
    results["cam_gather"] = dict(
        max_abs_err=float((g_k - g_p).abs().max()),
        ms=measure.time_ms(lambda: kernels.cam_gather_rows(eo, pp.obs_img)),
        plain_ms=measure.time_ms(
            lambda: kernels.cam_gather_plain(eo, pp.obs_img)))
    log(f"K3 cam_gather: exact; {results['cam_gather']['ms']:.4f} ms vs "
        f"plain {results['cam_gather']['plain_ms']:.4f} ms")

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
    results["prepare_reduction"] = dict(
        max_abs_err=max(float((a - r).abs().max())
                        for a, r in zip(out_k, out_p)),
        ms=measure.time_ms(lambda: kernels.prepare_reduction(pp), reps=10),
        plain_ms=measure.time_ms(
            lambda: kernels.prepare_reduction_plain(pp), reps=5, warm=1))
    log(f"K2 prepare_reduction: {results['prepare_reduction']['ms']:.4f} ms "
        f"vs plain {results['prepare_reduction']['plain_ms']:.4f} ms")

    # K1
    gen = torch.Generator().manual_seed(1)
    xc = torch.randn((fv.num_images, 6), generator=gen).to(dev)
    xg = torch.randn((G,), generator=gen).to(dev)
    ec, eg = fin_p[0].extra_c.contiguous(), fin_p[0].extra_g.contiguous()
    oc_k, og_k = kernels.schur_matvec_rows(pp, ec, eg, xc, xg)
    oc_k2, og_k2 = kernels.schur_matvec_rows(pp, ec, eg, xc, xg)
    oc_p, og_p = kernels.schur_matvec_plain(pp, ec, eg, xc, xg)
    e_c, e_g = scaled_err(oc_k, oc_p), scaled_err(og_k, og_p)
    same = bool(torch.equal(oc_k, oc_k2) and torch.equal(og_k, og_k2))
    log(f"K1 scaled errors: c {e_c:.2e}, g {e_g:.2e}; "
        f"repeat run bit-identical: {same}")
    if not (e_c <= TOL_SCALED and e_g <= TOL_SCALED):
        fail("K1 schur_matvec disagrees with its plain version")
    if not same:
        fail("K1 schur_matvec is not deterministic")
    results["schur_matvec"] = dict(
        max_abs_err=max(float((oc_k - oc_p).abs().max()),
                        float((og_k - og_p).abs().max())),
        ms=measure.time_ms(lambda: kernels.schur_matvec_rows(
            pp, ec, eg, xc, xg), reps=50),
        plain_ms=measure.time_ms(lambda: kernels.schur_matvec_plain(
            pp, ec, eg, xc, xg), reps=10))
    log(f"K1 schur_matvec: {results['schur_matvec']['ms']:.4f} ms vs plain "
        f"{results['schur_matvec']['plain_ms']:.4f} ms")
    del b, pp, out_k, out_p, fin_k, fin_p

    # ---- 3. the LM phase through the kernels -------------------------------
    prob64 = convert.problem_to_torch(prob_h, dev, torch.float64)
    fv64 = engine.to_view_major(engine.fm_problem(prob64), pb)
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

    # ---- 4. steady-state fixed-CG step -------------------------------------
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

    run_fixed(True, 1)
    run_fixed(False, 1)
    tp = [run_fixed(False), run_fixed(True), run_fixed(True),
          run_fixed(False)]
    step_plain = (tp[0] + tp[3]) / 2 * 1e3
    step_kern = (tp[1] + tp[2]) / 2 * 1e3
    log(f"fixed-cg8 LM step: kernels {step_kern:.3f} ms, plain "
        f"{step_plain:.3f} ms (turns plain/kernels/kernels/plain: "
        + ", ".join(f"{x * 1e3:.3f}" for x in tp) + " ms)")

    # ---- 5. convergence: mixed-precision refinement through the kernels ---
    refiner = refine.Refiner(prob, spec, use_kernels=True)
    st64 = type(st)(*(a.double() for a in st))
    om3_r = float(refiner.gradient64(refiner.fmp64, st64)[3])

    def refine_phase(r, damping):
        torch.cuda.synchronize()
        return refine.converge(r, (st, ph), tolerance=REFINE_TOL,
                               damping=damping)

    def contraction(hist):
        """Geometric mean of max|dx| ratios over the last 5 steps."""
        h = hist[-6:]
        return (h[-1] / h[0]) ** (1.0 / (len(h) - 1)) if len(h) > 1 else 0.0

    def plain_diagnosis(damping):
        """The same refinement through the plain path, to tell a kernel
        fault from a slice fault."""
        _, rec_p = refine_phase(refine.Refiner(prob, spec, use_kernels=False),
                                damping)
        log(f"plain-path refinement, damping {damping:g}: "
            f"{rec_p.refine_steps} steps, max|dx| {rec_p.max_dx}, "
            f"CG iterations {rec_p.cg_iterations}")

    runs = {}
    for label, damping in (("bench", BENCH_DAMPING), ("undamped", 0.0)):
        kernels.reset_launch_counts()
        s_ref, rec = refine_phase(refiner, damping)
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
        runs[label] = dict(steps=rec.refine_steps, seconds=rec.refine_seconds,
                           max_dx=rec.max_dx, cg_iterations=rec.cg_iterations,
                           sigma0=s0_5, omega=om5_r)
    del s_ref
    ttc = t_lm + rec.refine_seconds
    log(f"time_to_converged_s {ttc:.3f} (LM phase {t_lm:.3f} s, "
        f"{ph.steps} steps + undamped refinement {rec.refine_seconds:.3f} s, "
        f"{rec.refine_steps} steps)")
    del refiner

    # ---- 6. the matvec roofline: K4 and the K1 stages ----------------------
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

    kernels.reset_launch_counts()
    roof = measure.roofline(pp6, ec6, eg6, xc6, xg6, reps=20)
    torch.cuda.synchronize()
    launches6 = kernels.launch_counts()
    log(f"launches during the roofline: {launches6}")
    if min(launches6[k] for k in ("read_floor", "matvec_stage",
                                  "schur_matvec")) <= 0:
        fail(f"a kernel of the roofline was never launched: {launches6}")
    total = {k: total[k] + launches6[k] for k in total}
    sm = roof["stage_ms"]
    log(f"bytes: rows read {roof['rows_read_bytes']} (41 rows), padded "
        f"count of bench.matvec_cost {roof['padded_bytes']} (48 rows)")
    log("stage ms: " + ", ".join(f"{n} {t:.4f}" for n, t in sm.items())
        + "; plain ms: " + f"dma {floor_plain_ms:.4f}, " + ", ".join(
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
        max_abs_err=float((f_k - f_p).abs().max()), ms=sm["dma"],
        plain_ms=floor_plain_ms)
    results["matvec_stage"] = dict(
        max_abs_err=stage_abs, ms=sm["gather"],
        plain_ms=stage_plain_ms["gather"],
        stages={n: dict(ms=sm[n], plain_ms=stage_plain_ms[n])
                for n in kernels.MATVEC_STAGES})

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
        "stage_ms": sm}))
    kernel_rows = []
    for n in SOURCES:
        row = dict(name=n, route="cuda", source=SOURCES[n],
                   replaces=TPU_SITES[n], launches=total[n],
                   max_abs_err=results[n]["max_abs_err"],
                   ms=results[n]["ms"], plain_ms=results[n]["plain_ms"])
        if "stages" in results[n]:
            row["stages"] = results[n]["stages"]
        kernel_rows.append(row)
    print(json.dumps({"kernels": kernel_rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
