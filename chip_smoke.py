#!/usr/bin/env python3
"""Chip check of the PyTorch + CUDA port: the f32 scale LM phase on one GPU.

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
     kernels and through the plain path, timed in turns.
Then one JSON line with the kernels, and last
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
TPU_SITES = {  # pallas_call of the TPU kernel each CUDA kernel replaces
    "cam_gather": "bundle_adjustment_tpu/parallel/kernels.py:312",
    "prepare_reduction": "bundle_adjustment_tpu/parallel/kernels.py:761",
    "schur_matvec": "bundle_adjustment_tpu/parallel/kernels.py:467",
}
SOURCES = {
    "cam_gather": "bundle_adjustment_tpu_torch/csrc/cam_gather.cu",
    "prepare_reduction": "bundle_adjustment_tpu_torch/csrc/prepare_reduction.cu",
    "schur_matvec": "bundle_adjustment_tpu_torch/csrc/schur_matvec.cu",
}


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def time_ms(torch, fn, reps=20, warm=3):
    """Mean device time of fn() over ``reps`` back-to-back runs."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


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
        from bundle_adjustment_tpu_torch import convert, kernel_build, synthetic
        from bundle_adjustment_tpu_torch.parallel import (engine, kernels, lm,
                                                          rcs)
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
        ms=time_ms(torch, lambda: kernels.cam_gather_rows(eo, pp.obs_img)),
        plain_ms=time_ms(torch,
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
        ms=time_ms(torch, lambda: kernels.prepare_reduction(pp), reps=10),
        plain_ms=time_ms(torch, lambda: kernels.prepare_reduction_plain(pp),
                         reps=5, warm=1))
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
        ms=time_ms(torch, lambda: kernels.schur_matvec_rows(
            pp, ec, eg, xc, xg), reps=50),
        plain_ms=time_ms(torch, lambda: kernels.schur_matvec_plain(
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
    if min(launches.values()) <= 0:
        fail(f"a kernel of the main path was never launched: {launches}")
    for name, n in launches.items():
        results[name]["launches"] = n

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

    log(json.dumps({"lm_phase_steps": ph.steps, "lm_phase_s": t_lm,
                    "sigma0": s0, "fixed_cg8_step_ms": step_kern,
                    "fixed_cg8_step_plain_ms": step_plain}))
    print(json.dumps({"kernels": [
        dict(name=n, route="cuda", source=SOURCES[n], replaces=TPU_SITES[n],
             launches=results[n]["launches"],
             max_abs_err=results[n]["max_abs_err"], ms=results[n]["ms"],
             plain_ms=results[n]["plain_ms"])
        for n in ("cam_gather", "prepare_reduction", "schur_matvec")]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
