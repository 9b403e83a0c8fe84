"""The port's CUDA kernels against their plain PyTorch versions on a GPU.

Marked ``cuda``: each test skips (with the reason) where torch sees no
CUDA device.  This file imports no JAX, so on a GPU machine without JAX it
runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: K3 exact (a copy); K1 and K2 within a scaled error of 2e-4
(f32, other summation order than the plain versions); K1 run twice gives
identical bits (its reductions are deterministic).
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
    return dict(fv=fv, state=state, spec=spec, b=b, pp=pp)


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


def test_lm_step_through_kernels_contracts(case):
    from bundle_adjustment_tpu_torch.parallel import engine, kernels

    fv, st, spec = case["fv"], case["state"], case["spec"]
    kernels.reset_launch_counts()
    dxp, dxc, dxg, b, _ = engine.lm_step(fv, st, spec, 1e-4, cg_tol=1e-6,
                                         cg_maxiter=100, use_kernels=True)
    counts = kernels.launch_counts()
    assert min(counts.values()) > 0, counts
    om = float(engine.omega_at(fv, b, dxp, dxc, dxg))
    d_ref = engine.lm_step(fv, st, spec, 1e-4, cg_tol=1e-6, cg_maxiter=100)
    om_ref = float(engine.omega_at(fv, d_ref[3], *d_ref[:3]))
    assert om < 0.9 * float(b.omega0)
    assert om < 1.05 * om_ref


def test_wrappers_refuse_f64_on_cuda(case):
    from bundle_adjustment_tpu_torch.parallel import kernels

    tbl = case["state"].eo.double().contiguous()
    with pytest.raises(ValueError, match="dtype"):
        kernels.cam_gather_rows(tbl, case["pp"].obs_img)
