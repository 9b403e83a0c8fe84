"""The port's CUDA kernels against their plain PyTorch versions on a GPU.

Marked ``cuda``: each test skips (with the reason) where torch sees no
CUDA device.  This file imports no JAX, so on a GPU machine without JAX it
runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: K3 exact (a copy, on the view-major and the point-major
layout); K1 and K2 within a scaled error of 2e-4
(f32, other summation order than the plain versions), also on random
packed rows at G = 1, 3, 16, at V = 4 (pb > 32) and with 130 uneven images
(some empty); K1 run 50 times and K2 run 5 times give identical bits (their
reductions are deterministic, and a missing barrier in the shared-memory
ring would show only sometimes).  K4: each fold entry
within 1e-6 of the sum of |values| it folds (f32 sums in another order);
the cut K1 stages within a scaled error of 2e-4 of their plain versions,
and the ``full`` stage equal to K1 bit for bit.  The free-network step
(`engine.lm_step_full`, damping 1e-2, cg_tol 1e-8) through K3 / K2 / K1
against the plain path on the GPU, on the view-major and on the point-major
layout, at G = 10 and at G = 3 (the fewest a camera has: no distortion
terms): dxp, dxc, dxg within a scaled 2e-4, |B dxp| <= 1e-5 max|dxp|, and
the same bits when run again.  The covariance (`cov_all`)
on the GPU against the CPU's f64 blocks: f64 within a scaled 1e-9, f32
(through K3) within kappa x 2^-24 of each block's largest entry.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def case():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    from bundle_adjustment_tpu_torch import convert, synthetic
    from bundle_adjustment_tpu_torch.parallel import engine, kernels

    dev = torch.device("cuda", 0)
    prob_h, state_h, spec = synthetic.build_problem(1000, 24, 8, seed=5)
    prob = convert.problem_to_torch(prob_h, dev, torch.float32)
    state = convert.state_to_torch(state_h, dev, torch.float32)
    fmp = engine.fm_problem(prob)
    fv = engine.to_view_major(fmp, kernels.choose_pb(fmp.num_points,
                                                     fmp.views))
    b = engine.linearize(fv, state, spec, 1e-3)
    pp = kernels.pack_fm(b, fv, with_pw=True)
    return dict(prob=prob, fv=fv, state=state, spec=spec, b=b, pp=pp)


def _scaled(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def test_cam_gather_kernel_is_exact(case):
    from bundle_adjustment_tpu_torch.parallel import kernels

    for tbl in (case["state"].eo.contiguous(),
                case["fv"].free_eo[:, :3].contiguous()):
        out = kernels.cam_gather_rows(tbl, case["pp"].obs_img)
        torch.testing.assert_close(
            out, kernels.cam_gather_plain(tbl, case["pp"].obs_img),
            rtol=0, atol=0)


def test_cam_gather_kernel_is_exact_point_major(case):
    """K3 over the point-major layout (the covariance's linearise) equals
    the plain gather bit for bit."""
    from bundle_adjustment_tpu_torch.parallel import engine, kernels

    fmp = engine.fm_problem(case["prob"])
    assert fmp.vm_pb is None
    before = kernels.cam_gather_rows.launches
    out = kernels.make_cam_gather(fmp)(case["state"].eo)
    assert kernels.cam_gather_rows.launches == before + 1
    torch.testing.assert_close(
        out, kernels.cam_gather_plain(case["state"].eo, fmp.obs_image),
        rtol=0, atol=0)


def test_prepare_reduction_kernel_matches_plain(case):
    from bundle_adjustment_tpu_torch.parallel import kernels

    out = kernels.prepare_reduction(case["pp"])
    ref = kernels.prepare_reduction_plain(case["pp"])
    for name, a, r in zip(("red", "rg_corr", "T2", "T3"), out, ref):
        assert _scaled(a, r) < 2e-4, name


def test_schur_matvec_kernel_matches_plain_and_repeats(case):
    from bundle_adjustment_tpu_torch.parallel import engine, kernels

    fv, b, pp = case["fv"], case["b"], case["pp"]
    fin = engine.finish_reduction(fv, b, case["state"], 1e-3,
                                  *kernels.prepare_reduction_plain(pp), True)
    ec, eg = fin[0].extra_c.contiguous(), fin[0].extra_g.contiguous()
    gen = torch.Generator().manual_seed(0)
    xc = torch.randn((fv.num_images, 6), generator=gen).cuda()
    xg = torch.randn((eg.shape[0],), generator=gen).cuda()
    oc, og = kernels.schur_matvec_rows(pp, ec, eg, xc, xg)
    oc2, og2 = kernels.schur_matvec_rows(pp, ec, eg, xc, xg)
    rc, rg = kernels.schur_matvec_plain(pp, ec, eg, xc, xg)
    assert _scaled(oc, rc) < 2e-4 and _scaled(og, rg) < 2e-4
    assert torch.equal(oc, oc2) and torch.equal(og, og2)


def _random_packed(P, V, M, G, seed):
    """A PackedFM of random rows on the GPU: N(0, 1) rows in the kernel
    layout, random Hpp^{-1} rows, uneven random images (the last tenth of
    them empty, most images' last 512-entry block partly padding)."""
    import numpy as np

    from bundle_adjustment_tpu_torch.parallel import engine, kernels, rcs

    rng = np.random.default_rng(seed)
    N = P * V
    pb = kernels.choose_pb(P, V)
    off = kernels._offsets(G, with_pw=True)
    f_pad = (off["F"] + 7) // 8 * 8
    packed = np.zeros((f_pad, N), np.float32)
    packed[:off["F_lean"]] = rng.normal(0, 1, (off["F_lean"], N))
    packed[off["PJp"]:off["F"]] = rng.normal(
        0, 1, (off["F"] - off["PJp"], N))
    hpp = np.zeros((8, P), np.float32)
    hpp[:6] = rng.normal(0, 1, (6, P))
    used = max(1, M - M // 10)
    obs_img = np.minimum(rng.integers(0, used, N),
                         rng.integers(0, used, N)).astype(np.int32)
    perm, bstarts = rcs.build_image_block_layout(obs_img, M)
    dev = torch.device("cuda", 0)
    perm_t = torch.as_tensor(perm, device=dev)
    pos, valid = engine.image_positions(perm_t, N)
    return kernels.PackedFM(
        packed=torch.as_tensor(packed, device=dev),
        obs_img=torch.as_tensor(obs_img, device=dev),
        hppinv=torch.as_tensor(hpp, device=dev), img_perm=perm_t,
        img_block_starts=torch.as_tensor(bstarts, device=dev),
        num_points=P, views=V, num_images=M, g=G, f_pad=f_pad, pb=pb,
        img_pos=pos, img_block_valid=valid)


# (P, V, M, G): G = 1, 3, 16; V = 4 gives pb = 128; M = 130 uneven images
SHAPES = [(1024, 8, 24, 1), (1024, 12, 24, 3), (960, 12, 130, 16),
          (1280, 4, 130, 10), (4096, 12, 130, 10)]


@pytest.mark.parametrize("P,V,M,G", SHAPES)
def test_schur_matvec_kernel_shapes(case, P, V, M, G):
    """K1 against its plain version over G, V (pb) and M, and the same
    bits on 50 runs."""
    from bundle_adjustment_tpu_torch.parallel import kernels

    pp = _random_packed(P, V, M, G, seed=P + G)
    gen = torch.Generator().manual_seed(G)
    xc = torch.randn((M, 6), generator=gen).cuda()
    xg = torch.randn((G,), generator=gen).cuda()
    ec = torch.rand((M, 6), generator=gen).cuda()
    eg = torch.rand((G,), generator=gen).cuda()
    oc, og = kernels.schur_matvec_rows(pp, ec, eg, xc, xg)
    rc, rg = kernels.schur_matvec_plain(pp, ec, eg, xc, xg)
    assert _scaled(oc, rc) < 2e-4 and _scaled(og, rg) < 2e-4
    for _ in range(50):
        oc2, og2 = kernels.schur_matvec_rows(pp, ec, eg, xc, xg)
        assert torch.equal(oc, oc2) and torch.equal(og, og2)
    for stage in ("rowmath", "pointred", "gather"):
        out = torch.cat(kernels.matvec_stage(pp, stage, ec, eg, xc, xg))
        ref = torch.cat(kernels.matvec_stage_plain(pp, stage, ec, eg, xc, xg))
        assert _scaled(out, ref) < 2e-4, stage


@pytest.mark.parametrize("P,V,M,G", SHAPES)
def test_prepare_reduction_kernel_shapes(case, P, V, M, G):
    """K2 against its plain version over G, V (pb) and M, and the same
    bits on 5 runs."""
    from bundle_adjustment_tpu_torch.parallel import kernels

    pp = _random_packed(P, V, M, G, seed=P + G + 1)
    out = kernels.prepare_reduction(pp)
    ref = kernels.prepare_reduction_plain(pp)
    for name, a, r in zip(("red", "rg_corr", "T2", "T3"), out, ref):
        assert a.shape == r.shape, name
        assert _scaled(a, r) < 2e-4, name
    for _ in range(5):
        again = kernels.prepare_reduction(pp)
        assert all(torch.equal(a, b) for a, b in zip(out, again))


def test_image_pass_layout_on_the_card(case):
    """The scatter to image-sorted positions and the two-level sum, as the
    kernels take it, against `engine._image_sum_stack` on CUDA tensors."""
    from bundle_adjustment_tpu_torch.parallel import engine, kernels

    pp = _random_packed(960, 12, 130, 3, seed=9)
    x = torch.randn((960 * 12, 6), generator=torch.Generator().manual_seed(1))
    x = x.cuda()
    ref = engine._image_sum_stack(pp, list(x.T))
    assert _scaled(kernels.image_sum_sorted_plain(pp, x), ref) < 1e-5


def test_kernels_refuse_a_tile_that_does_not_fit(case):
    """G = 16 at V * pb = 512: K2's tile (102 rows x 512 lanes) leaves no
    room for its scratch; the wrapper raises and names the sizes."""
    from bundle_adjustment_tpu_torch.parallel import kernels

    pp = _random_packed(1024, 16, 24, 16, seed=3)
    assert pp.views * pp.pb == 512
    with pytest.raises(RuntimeError, match="V\\*pb=512"):
        kernels.prepare_reduction(pp)


def test_lm_step_through_kernels_contracts(case):
    from bundle_adjustment_tpu_torch.parallel import engine, kernels

    fv, st, spec = case["fv"], case["state"], case["spec"]
    kernels.reset_launch_counts()
    dxp, dxc, dxg, b, _ = engine.lm_step(fv, st, spec, 1e-4, cg_tol=1e-6,
                                         cg_maxiter=100, use_kernels=True)
    counts = kernels.launch_counts()
    assert min(counts[k] for k in ("cam_gather", "prepare_reduction",
                                   "schur_matvec")) > 0, counts
    om = float(engine.omega_at(fv, b, dxp, dxc, dxg))
    d_ref = engine.lm_step(fv, st, spec, 1e-4, cg_tol=1e-6, cg_maxiter=100)
    om_ref = float(engine.omega_at(fv, d_ref[3], *d_ref[:3]))
    assert om < 0.9 * float(b.omega0)
    assert om < 1.05 * om_ref


def _probe_inputs(case):
    from bundle_adjustment_tpu_torch.parallel import engine, kernels

    fv, b, pp = case["fv"], case["b"], case["pp"]
    fin = engine.finish_reduction(fv, b, case["state"], 1e-3,
                                  *kernels.prepare_reduction_plain(pp), True)
    gen = torch.Generator().manual_seed(2)
    xc = torch.randn((fv.num_images, 6), generator=gen).cuda()
    xg = torch.randn((b.bg.shape[0],), generator=gen).cuda()
    return (fin[0].extra_c.contiguous(), fin[0].extra_g.contiguous(), xc,
            xg)


def test_read_floor_kernel_matches_plain(case):
    from bundle_adjustment_tpu_torch.parallel import kernels

    pp = case["pp"]
    xin = torch.randn((8, 128), generator=torch.Generator().manual_seed(3))
    xin = xin.cuda()
    before = kernels.read_floor.launches
    out = kernels.read_floor(pp, xin)
    assert kernels.read_floor.launches == before + 1
    ref = kernels.read_floor_plain(pp, xin)
    scale = kernels.read_floor_plain(pp._replace(packed=pp.packed.abs()),
                                     torch.zeros_like(xin))
    assert bool(((out - ref).abs() <= 1e-6 * scale).all())
    assert torch.equal(out, kernels.read_floor(pp, xin))


@pytest.mark.parametrize("stage", ["rowmath", "pointred", "gather"])
def test_matvec_stage_kernel_matches_plain(case, stage):
    from bundle_adjustment_tpu_torch.parallel import kernels

    ec, eg, xc, xg = _probe_inputs(case)
    out = torch.cat(kernels.matvec_stage(case["pp"], stage, ec, eg, xc, xg))
    ref = torch.cat(kernels.matvec_stage_plain(case["pp"], stage, ec, eg, xc,
                                               xg))
    assert _scaled(out, ref) < 2e-4


def test_full_stage_is_k1_bit_for_bit(case):
    from bundle_adjustment_tpu_torch.parallel import kernels

    ec, eg, xc, xg = _probe_inputs(case)
    full = kernels.matvec_stage(case["pp"], "full", ec, eg, xc, xg)
    k1 = kernels.schur_matvec_rows(case["pp"], ec, eg, xc, xg)
    assert all(torch.equal(a, b) for a, b in zip(full, k1))


def test_refiner_step_through_kernels_contracts(case):
    from bundle_adjustment_tpu_torch.parallel import hilo, kernels, refine

    kernels.reset_launch_counts()
    r = refine.Refiner(case["prob"], case["spec"], use_kernels=True)
    s = hilo.from_f32(case["state"])
    s, mdx1, _, _ = r.step(s)
    counts = kernels.launch_counts()
    assert min(counts[k] for k in ("cam_gather", "prepare_reduction",
                                   "schur_matvec")) > 0, counts
    s, mdx2, _, _ = r.step(s)
    assert float(mdx2) < 0.5 * float(mdx1)


@pytest.mark.parametrize("G", [10, 3])
def test_lm_step_full_through_kernels_matches_plain(case, G):
    """A free network (4 bars, one of them sharing an end, six-defect
    datum, a populated group and diagonal dp / de / dg observations)."""
    import numpy as np

    from bundle_adjustment_tpu_torch import convert, synthetic
    from bundle_adjustment_tpu_torch.models.distortion import DistortionSpec
    from bundle_adjustment_tpu_torch.parallel import engine, kernels

    dev = torch.device("cuda", 0)
    spec = None if G == 10 else DistortionSpec()  # no distortion terms
    prob_h, state_h, spec = synthetic.build_problem(1000, 24, 8, seed=6,
                                                    spec=spec)
    truth = synthetic.true_points(1000, 6)
    prob_h = synthetic.free_network(
        prob_h, state_h, bars=4, seed=2, truth=truth,
        direct=dict(group=12, dp=30, de=4, dg=True))
    # the last bar ends where the first begins
    sb_b = np.concatenate([prob_h.sb_b[:3], prob_h.sb_a[:1]]).astype(np.int32)
    prob_h = prob_h._replace(sb_b=sb_b, sb_length=np.linalg.norm(
        truth[sb_b] - truth[prob_h.sb_a], axis=1))
    prob = convert.problem_to_torch(prob_h, dev, torch.float32)
    st = convert.state_to_torch(state_h, dev, torch.float32)
    assert prob.free_global.shape[0] == G and prob.has_extras
    fmp = engine.fm_problem(prob)
    fv = engine.to_view_major(fmp, kernels.choose_pb(fmp.num_points,
                                                     fmp.views))
    kw = dict(cg_tol=1e-8, cg_maxiter=300)
    kernels.reset_launch_counts()
    out = engine.lm_step_full(fv, prob, st, spec, 1e-2, use_kernels=True,
                              **kw)
    counts = kernels.launch_counts()
    assert min(counts[k] for k in ("cam_gather", "prepare_reduction",
                                   "schur_matvec")) > 0, counts
    assert counts["schur_matvec"] == out[4]
    again = engine.lm_step_full(fv, prob, st, spec, 1e-2, use_kernels=True,
                                **kw)
    assert all(torch.equal(a, b) for a, b in zip(out[:3], again[:3]))
    for layout in (fv, fmp):
        ref = engine.lm_step_full(layout, prob, st, spec, 1e-2, **kw)
        for name, a, r in zip(("dxp", "dxc", "dxg"), out[:3], ref[:3]):
            assert _scaled(a, r) < 2e-4, (name, layout.vm_pb)
    ext, dxp = out[5], out[0]
    bdx = torch.einsum("kpa,pa->k", ext.Brows, dxp)
    assert float(bdx.abs().max()) <= 1e-5 * float(dxp.abs().max())
    om = float(engine.omega_at_full(fv, prob, out[3], ext, *out[:3], st))
    assert om < float(out[3].omega0)


def test_solve_defaults_to_the_kernels_on_cuda(case):
    """`solver.solve` on CUDA tensors goes through K3 / K2 / K1 unless told
    otherwise, pads to the kernels' block size and drops the padding."""
    from bundle_adjustment_tpu_torch import convert, synthetic
    from bundle_adjustment_tpu_torch.parallel import kernels, solver

    dev = torch.device("cuda", 0)
    prob_h, state_h, spec = synthetic.build_problem(1000, 24, 8, seed=6)
    prob_h = synthetic.free_network(prob_h, state_h, bars=4, seed=2,
                                    truth=synthetic.true_points(1000, 6))
    prob = convert.problem_to_torch(prob_h, dev, torch.float32)
    st = convert.state_to_torch(state_h, dev, torch.float32)
    kernels.reset_launch_counts()
    res = solver.solve(prob, st, spec, damping=1e-2, max_iterations=12,
                       tolerance=1e-3)
    counts = kernels.launch_counts()
    assert min(counts[k] for k in ("cam_gather", "prepare_reduction",
                                   "schur_matvec")) > 0, counts
    assert counts["prepare_reduction"] == res.iterations
    assert res.state.points.shape == st.points.shape
    assert res.history[-1]["omega0"] < 0.01 * res.history[0]["omega0"]


@pytest.fixture(scope="module")
def cov_ref(case):
    """cov_all on the CPU in f64 (point-major), and the condition number
    of the Jacobi-scaled reduced system."""
    from bundle_adjustment_tpu_torch.parallel import (cov_direct, engine,
                                                      rcs, refine)

    prob = rcs.RCSProblem(*(x.cpu() if isinstance(x, torch.Tensor) else x
                            for x in refine.upcast_problem(case["prob"])))
    st = type(case["state"])(*(a.double().cpu() for a in case["state"]))
    fmp = engine.fm_problem(prob)
    S = cov_direct.assemble_reduced_dense(
        fmp, engine.linearize(fmp, st, case["spec"], 0.0))
    d = S.diagonal().sqrt()
    kappa = float(torch.linalg.cond(S / d[:, None] / d[None, :]))
    return dict(blocks=cov_direct.cov_all(fmp, st, case["spec"]),
                free=fmp.free_point.sum(dim=0) > 0, kappa=kappa)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_cov_all_matches_cpu(case, cov_ref, dtype):
    """cov_all on the GPU (point-major; f32 through K3) against the CPU's
    f64 blocks: f64 within a scaled 1e-9 (sums in another order); f32
    within kappa x 2^-24 of each free point's largest entry (the
    first-order bound of an inverse of f32-rounded input)."""
    from bundle_adjustment_tpu_torch.parallel import (cov_direct, engine,
                                                      kernels, refine)

    prob, st = case["prob"], case["state"]
    cg = None
    if dtype == torch.float64:
        prob = refine.upcast_problem(prob)
        st = type(st)(*(a.double() for a in st))
    fmp = engine.fm_problem(prob)
    if dtype == torch.float32:
        cg = kernels.make_cam_gather(fmp)
    before = kernels.cam_gather_rows.launches
    out = cov_direct.cov_all(fmp, st, case["spec"], cam_gather=cg)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.is_cuda
    ref = cov_ref["blocks"]
    if dtype == torch.float64:
        assert _scaled(out.cpu(), ref) < 1e-9
        return
    assert kernels.cam_gather_rows.launches > before
    free = cov_ref["free"]
    o, r = out.double().cpu()[free], ref[free]
    err = ((o - r).flatten(1).abs().max(dim=1).values
           / r.flatten(1).abs().max(dim=1).values)
    assert float(err.max()) <= cov_ref["kappa"] * 2.0 ** -24


def test_wrappers_refuse_f64_on_cuda(case):
    from bundle_adjustment_tpu_torch.parallel import kernels

    tbl = case["state"].eo.double().contiguous()
    with pytest.raises(ValueError, match="dtype"):
        kernels.cam_gather_rows(tbl, case["pp"].obs_img)
