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
the same bits when run again.  `rcs.pcg`'s CUDA-graph route (through K1
and through the plain product) against its eager route: the same bits
and count, one capture per call, K1's launches its runs, and no more
device memory than one K1 workspace over the eager route's; so does the
4-camera rig's f64 product as the Refiner marks it (a 2,000-point rig,
block Jacobi, undamped), at the refinement's CG settings and where the
stall rule ends the loop, with no more memory than the eager route's
but the start carry `rcs.pcg` holds while the graph runs.  The
covariance (`cov_all`)
on the GPU against the CPU's f64 blocks: f64 within a scaled 1e-9, f32
(through K3) within kappa x 2^-24 of each block's largest entry; the
block-gather recovery against the dense panels at u = 3,010 within 1e-10
of each block's largest entry.  An f64
`solve` on the card takes the plain path (no launch); `k2_tile_fits`, the
model `choose_pb` consults, agrees with the kernel's own plan
(`ba_prepare_fits`) on every block the kernels take; `choose_pb` with G
picks a block whose K2 tile fits at V = 4, G = 16, where K2 and K1 then
hold their plain versions (2e-4) and a Refiner step runs through them; so
do they on the rows of a Zernike spec
(G = 12).  The reference API (`BundleAdjustment`, `ScaleBundleAdjustment`)
on CUDA by default against the same code on the CPU: status and
iterations equal, sigma0 within 1e-9, coordinates within 1e-9 of the
field, the cofactor matrix within 1e-7 of its largest entry.  A 4-camera
rig (the compact rows, plain path): one f64 step on the card against the
CPU (rtol 3e-4, atol 1e-6 of max), the f32 step twice bit for bit,
``use_kernels=True`` refused before any launch, and the Refiner's default
route: the kernels for one camera in f32, the plain compact rows for the
rig, whose refinement converges with no launch.  The file route: a
2,048-point network written as flat files and read by
`io.columnar.build_rcs_problem` on the card equals its in-memory control
bit for bit, and `solve` on it runs through K1, K2 and K3 (launches > 0)
to the control's bits and steps; the CLI as a subprocess on the card
prints what its ``--cpu`` run prints (1e-9 relative).  The file-order
layout (a 1,000-point network of uneven visibility, `synthetic.thin_views`):
K3 equal to its plain version bit for bit, one f32 step of the
block-layout engine through K3 twice to the same bits, `solve`'s
default there launching K3 and not K1, and the Refiner there through K3
converging to its own plain route's optimum (1e-8, Omega rtol 1e-9)
with no K1 or K2 launch.  The image-sum kernel (f32 and f64,
every caller's F, rows with a leading dimension, an image over several
512-entry blocks, images without observations): its plain model's bits,
the stack path within 1e-12 (f64) / 1e-5 (f32) of the largest sum, the
same bits twice and in a CUDA-graph replay, one launch counted per call,
279 rows in three launches of at most 128, ValueError for mixed devices,
another dtype and a strided row, and the entry point refusing 129 rows;
an f64 `solve` and the rig's `solve` and refinement launch it and no K1,
K2 or K3.
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
    fv = kernels.kernel_layout(fmp)
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


def _random_packed(P, V, M, G, seed, pb=None):
    """A PackedFM of random rows on the GPU: N(0, 1) rows in the kernel
    layout, random Hpp^{-1} rows, uneven random images (the last tenth of
    them empty, most images' last 512-entry block partly padding).
    ``pb``: the point block (default: `choose_pb(P, V, G)`)."""
    import numpy as np

    from bundle_adjustment_tpu_torch.parallel import engine, kernels, rcs

    rng = np.random.default_rng(seed)
    N = P * V
    pb = kernels.choose_pb(P, V, G) if pb is None else pb
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
    kernels take it, against the stack path (`engine._image_sum_plain`) on
    CUDA tensors."""
    from bundle_adjustment_tpu_torch.parallel import engine, kernels

    pp = _random_packed(960, 12, 130, 3, seed=9)
    x = torch.randn((960 * 12, 6), generator=torch.Generator().manual_seed(1))
    x = x.cuda()
    ref = engine._image_sum_plain(pp, list(x.T))
    assert _scaled(kernels.image_sum_sorted_plain(pp, x), ref) < 1e-5


def test_kernels_refuse_a_tile_that_does_not_fit(case):
    """G = 16 at V * pb = 512: K2's tile (102 rows x 512 lanes) leaves no
    room for its scratch; the wrapper raises and names the sizes."""
    from bundle_adjustment_tpu_torch.parallel import kernels

    pp = _random_packed(1024, 16, 24, 16, seed=3, pb=32)
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


#: `test_pcg_graph_route_matches_the_eager_route`'s calls: maxiter 13 and
#: 29 at tol 0 with no stall stop, then each route's own stop: f32 to tol
#: 1e-6 under the f32 stall window; the rig's f64 solve at the
#: refinement's settings (`refine.converge`: tol 1e-12, maxiter 800, stall
#: 300; on this rig the tolerance ends it, at ~370 iterations), and with
#: a window of 40 that its plateaus (up to ~50 iterations) exceed, so that
#: the stall rule ends it (checked against the same call without one)
GRAPH_CALLS = [dict(tol=0.0, maxiter=13, stall_limit=14),
               dict(tol=0.0, maxiter=29, stall_limit=30)]
STALL_STOP = dict(tol=1e-12, maxiter=800, stall_limit=40)
GRAPH_STOPS = {
    "k1": [dict(tol=1e-6, maxiter=300)],
    "plain": [dict(tol=1e-6, maxiter=300)],
    "rig_f64": [dict(tol=1e-12, maxiter=800, stall_limit=300),
                STALL_STOP],
}


def _graph_route_system(case, route):
    """(rc, rg, Minv, a function that builds the route's marked product,
    the name of the kernel wrapper each product call launches once, the
    bytes the graph route's peak may exceed the eager route's by) for
    `test_pcg_graph_route_matches_the_eager_route`.  ``rig_f64``: the
    compact rows of a 4-camera rig (`synthetic.build_problem(2000, 40,
    12, seed=0, num_cameras=4)`) upcast to f64 as `refine.Refiner` upcasts
    them, undamped, with the block-Jacobi `Precond` the rig's refinement
    takes, and the plain product its step marks; its excess is the start
    carry (`rcs._cg_start`, in the allocator's 512-byte blocks), which
    `rcs.pcg` holds while `_cg_graph` runs (13,312 bytes here, on the
    H100).  K1 and the one-camera plain product: one K1 workspace."""
    from bundle_adjustment_tpu_torch import convert, synthetic
    from bundle_adjustment_tpu_torch.models.problem import ParamState
    from bundle_adjustment_tpu_torch.parallel import (engine, kernels, rcs,
                                                      refine)

    if route == "rig_f64":
        dev = torch.device("cuda", 0)
        ph, sh, spec = synthetic.build_problem(2000, 40, 12, seed=0,
                                               num_cameras=4)
        p = engine.fm_problem(refine.upcast_problem(
            convert.problem_to_torch(ph, dev, torch.float32)))
        st = convert.state_to_torch(sh, dev, torch.float32)
        b, rc, rg, Minv = engine.prepare(
            p, ParamState(*(a.double() for a in st)), spec, 0.0,
            couple_global=False)
        assert b.Jg is None and rc.dtype == torch.float64
        start, _ = rcs._cg_start(rc, rg, Minv, None, 0.0, 1, 1, None)
        slack = sum(-(-t.untyped_storage().nbytes() // 512) * 512
                    for t in start)
    else:
        p, pp = case["fv"], case["pp"]
        b, rc, rg, Minv = engine.finish_reduction(
            p, case["b"], case["state"], 1e-3,
            *kernels.prepare_reduction(pp), True)
        slack = sum(t.numel() * t.element_size()
                    for t in kernels.matvec_workspace(pp))

    def product():
        if route == "k1":
            return kernels.make_matvec(pp, b.extra_c, b.extra_g)

        def matvec(c, g):
            return engine.schur_matvec(p, b, c, g)

        matvec.capturable = True
        return matvec

    launched = "schur_matvec" if route == "k1" else "image_sum"
    return rc, rg, Minv, product, launched, slack


@pytest.mark.parametrize("route", ["k1", "plain", "rig_f64"])
def test_pcg_graph_route_matches_the_eager_route(case, route, monkeypatch):
    """`rcs.pcg` on the card: the CUDA-graph route (K1 through
    `kernels.make_matvec`, the plain product marked ``capturable``, or the
    rig's f64 plain product as the Refiner marks it) against the eager
    route of the same product (an unmarked wrapper), at the calls of
    `GRAPH_CALLS` and `GRAPH_STOPS`: the same iterate bits and count; one
    capture per call; `rcs.CG_CHUNK` replays per read of the stop, the
    warm-up outside them, the rest masked; the product's kernel (K1, or
    the image-sum kernel of the plain products) launched = iterations +
    masked (the eager warm-up is one of the iterations); the call's device
    memory peak no higher than the eager route's by more than one K1
    workspace (on the rig: than the start carry `rcs.pcg` holds)."""
    from bundle_adjustment_tpu_torch.parallel import kernels, rcs
    from bundle_adjustment_tpu_torch.solver import tracing

    rc, rg, Minv, product, launched, slack = _graph_route_system(case,
                                                                 route)
    captures = []
    begin = torch.cuda.CUDAGraph.capture_begin

    def counted(self, *args, **kwargs):
        captures.append(1)
        return begin(self, *args, **kwargs)

    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin", counted)

    def run(mv, kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        kernels.reset_launch_counts()
        with tracing.recording() as spans:
            out = rcs.pcg(rc, rg, Minv, mv, **kw)
        torch.cuda.synchronize()
        pcg = [s.counts for s in spans if s.name == "pcg"]
        return (out, torch.cuda.max_memory_allocated() - base, pcg[0],
                kernels.launch_counts()[launched])

    for kw in GRAPH_CALLS + GRAPH_STOPS[route]:
        eager = product()
        (ex, eg, eit), epeak, ecounts, _ = run(
            lambda c, g, mv=eager: mv(c, g), kw)
        assert ecounts["replays"] == 0 and ecounts["masked"] == 0
        if kw is STALL_STOP:
            longer = rcs.pcg(rc, rg, Minv, lambda c, g, mv=eager: mv(c, g),
                             **dict(kw, stall_limit=kw["maxiter"] + 1))[2]
            assert eit < longer, (eit, longer)
        del captures[:]
        (gx, gg, git), gpeak, gcounts, runs = run(product(), kw)
        assert git == eit > 1, kw
        assert torch.equal(gx, ex) and torch.equal(gg, eg), kw
        chunks = -(-(git - 1) // rcs.CG_CHUNK)
        assert len(captures) == 1
        assert gcounts["replays"] == rcs.CG_CHUNK * chunks
        assert gcounts["graph_iterations"] == git - 1
        masked = rcs.CG_CHUNK * chunks - (git - 1)
        assert gcounts["masked"] == masked
        assert runs == git + masked, (launched, runs, git, masked)
        assert gpeak <= epeak + slack, (kw, gpeak, epeak, slack)


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
    fv = kernels.kernel_layout(fmp)
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


def test_block_gather_recovery_matches_dense_panels_at_u3010():
    """The block-gather recovery (`_pcd_chunk`) of every point against the
    dense panels (`point_covariance_panels`) on the card, f64, at the 100k
    shape's u = 3,010 (500 images, G = 10) on a 20,000-point network:
    within 1e-10 of each block's largest entry (chip_smoke.py phase 16
    holds the same on 4,096 points at 1M)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    from bundle_adjustment_tpu_torch import convert, synthetic
    from bundle_adjustment_tpu_torch.parallel import cov_direct, engine

    dev = torch.device("cuda", 0)
    prob_h, state_h, spec = synthetic.build_problem(20_000, 500, 12, seed=3)
    fmp = engine.fm_problem(convert.problem_to_torch(prob_h, dev,
                                                     torch.float64))
    st = convert.state_to_torch(state_h, dev, torch.float64)
    b = engine.linearize(fmp, st, spec, 0.0)
    Q = cov_direct.reduced_inverse(cov_direct.assemble_reduced_dense(fmp, b))
    assert Q.shape[0] == 3010
    ids = torch.arange(fmp.num_points, device=dev)
    gath = cov_direct.point_covariance_dense(fmp, b, Q, point_ids=ids)
    dense = cov_direct.point_covariance_panels(fmp, b, Q)
    err = ((gath - dense).flatten(1).abs().max(dim=1).values
           / dense.flatten(1).abs().max(dim=1).values)
    assert float(err.max()) <= 1e-10


def test_wrappers_refuse_f64_on_cuda(case):
    from bundle_adjustment_tpu_torch.parallel import kernels

    tbl = case["state"].eo.double().contiguous()
    with pytest.raises(ValueError, match="dtype"):
        kernels.cam_gather_rows(tbl, case["pp"].obs_img)


def test_f64_solve_runs_without_the_kernels(case):
    """An f64 `solve` on CUDA tensors takes the plain path by default (K1,
    K2 and K3 take f32 only) and converges; its per-image sums go through
    the image-sum kernel, which takes f64."""
    from bundle_adjustment_tpu_torch import convert, synthetic
    from bundle_adjustment_tpu_torch.parallel import kernels, solver

    dev = torch.device("cuda", 0)
    prob_h, state_h, spec = synthetic.build_problem(1000, 24, 8, seed=6)
    prob = convert.problem_to_torch(prob_h, dev, torch.float64)
    st = convert.state_to_torch(state_h, dev, torch.float64)
    kernels.reset_launch_counts()
    res = solver.solve(prob, st, spec, damping=1e-2, max_iterations=20,
                       cg_tol=1e-12, cg_maxiter=500)
    counts = kernels.launch_counts()
    assert counts.pop("image_sum") > 0
    assert all(v == 0 for v in counts.values()), counts
    assert res.converged and res.state.points.dtype == torch.float64


def test_k2_tile_fits_matches_the_kernel(case):
    """`kernels.k2_tile_fits`, the Python model that `choose_pb` consults,
    against the kernel's own plan (`ba_prepare_fits`, the launch's code)
    for every block the kernels take (pb a multiple of 32, V * pb <= 512,
    G = 1 .. 16), at the H100's limit and, on an H100, at the card's own."""
    from bundle_adjustment_tpu_torch import kernel_build
    from bundle_adjustment_tpu_torch.parallel import kernels

    fits = kernel_build.library().ba_prepare_fits
    assert fits(32, 1, 1, 0) == 1
    h100 = "H100" in torch.cuda.get_device_name(0)
    seen = set()
    for V in range(1, kernels.MAX_BLOCK_THREADS // 32 + 1):
        for pb in range(32, kernels.MAX_BLOCK_THREADS // V + 1, 32):
            for G in range(1, kernels.MAX_G + 1):
                model = kernels.k2_tile_fits(pb, V, G)
                assert fits(pb, V, G, kernels.MAX_SMEM_H100) == int(model), \
                    (pb, V, G)
                if h100:
                    assert fits(pb, V, G, 0) == int(model), (pb, V, G)
                seen.add(model)
    assert seen == {True, False}


def _g16_v4_problem(dev):
    """1,280 points seen 4 times each by 130 images, with 13 distortion
    terms (affinity, tangential, radial 1-3, Zernike-gradient fringes 4, 5,
    6, 12, Zernike-X 5, 7): G = 16 at V = 4."""
    from bundle_adjustment_tpu_torch import convert, synthetic
    from bundle_adjustment_tpu_torch.models.distortion import (
        DistortionSpecBuilder, DistortionType)

    zg, zx = DistortionType.ZERNIKE_GRADIENT, DistortionType.ZERNIKE_X
    spec = (DistortionSpecBuilder().add_affinity().add_tangential()
            .add_radial_order(1).add_radial_order(2).add_radial_order(3)
            .add_zernike(zg, 4).add_zernike(zg, 5).add_zernike(zg, 6)
            .add_zernike(zg, 12).add_zernike(zx, 5).add_zernike(zx, 7)
            .build())
    prob_h, state_h, spec = synthetic.build_problem(1280, 130, 4, seed=9,
                                                    spec=spec)
    prob = convert.problem_to_torch(prob_h, dev, torch.float32)
    st = convert.state_to_torch(state_h, dev, torch.float32)
    assert prob.free_global.shape[0] == 3 + spec.num_coefficients == 16
    return prob, st, spec


def test_choose_pb_fits_k2_at_g16_v4(case):
    """At V = 4, G = 16 the largest block the thread limit allows (pb = 128)
    does not fit K2's tile; `choose_pb(P, V, G)` picks one that does, and K2
    and K1 run there against their plain versions.  The Refiner lays its
    f32 problem out through `choose_pb` with its own G, and its step runs
    through K2 and K1 at that block."""
    from bundle_adjustment_tpu_torch.parallel import hilo, kernels, refine

    P, V, M, G = 1280, 4, 130, 16
    assert not kernels.k2_tile_fits(128, V, G)
    pb = kernels.choose_pb(P, V, G)
    assert pb == 64 and kernels.k2_tile_fits(pb, V, G)
    pp = _random_packed(P, V, M, G, seed=4, pb=pb)
    out = kernels.prepare_reduction(pp)
    ref = kernels.prepare_reduction_plain(pp)
    for name, a, r in zip(("red", "rg_corr", "T2", "T3"), out, ref):
        assert _scaled(a, r) < 2e-4, name
    gen = torch.Generator().manual_seed(5)
    xc = torch.randn((M, 6), generator=gen).cuda()
    xg = torch.randn((G,), generator=gen).cuda()
    ec = torch.rand((M, 6), generator=gen).cuda()
    eg = torch.rand((G,), generator=gen).cuda()
    oc, og = kernels.schur_matvec_rows(pp, ec, eg, xc, xg)
    rc, rg = kernels.schur_matvec_plain(pp, ec, eg, xc, xg)
    assert _scaled(oc, rc) < 2e-4 and _scaled(og, rg) < 2e-4

    prob, st, spec = _g16_v4_problem(torch.device("cuda", 0))
    r = refine.Refiner(prob, spec, use_kernels=True)
    assert r.fmp32.vm_pb == 96
    kernels.reset_launch_counts()
    s, max_dx, omega0, it = r.step(hilo.from_f32(st), cg_maxiter=50)
    counts = kernels.launch_counts()
    assert counts["prepare_reduction"] > 0 and counts["schur_matvec"] > 0
    assert torch.isfinite(max_dx) and torch.isfinite(omega0)
    assert bool(torch.isfinite(hilo.to_f64(s).points).all())


def test_zernike_rows_through_k1_and_k2(case):
    """A Zernike spec (gradient fringes 4 and 12, X fringe 5 beside
    affinity, tangential and radial; G = 12): the linearised f32 rows
    through K2 and K1 against their plain versions."""
    from bundle_adjustment_tpu_torch import convert, synthetic
    from bundle_adjustment_tpu_torch.models.distortion import (
        DistortionSpecBuilder, DistortionType)
    from bundle_adjustment_tpu_torch.parallel import engine, kernels

    spec = (DistortionSpecBuilder().add_affinity().add_tangential()
            .add_radial_order(1).add_radial_order(2)
            .add_zernike(DistortionType.ZERNIKE_GRADIENT, 4)
            .add_zernike(DistortionType.ZERNIKE_GRADIENT, 12)
            .add_zernike(DistortionType.ZERNIKE_X, 5).build())
    dev = torch.device("cuda", 0)
    prob_h, state_h, spec = synthetic.build_problem(1000, 24, 8, seed=8,
                                                    spec=spec)
    G = 3 + spec.num_coefficients
    assert G == 12
    prob = convert.problem_to_torch(prob_h, dev, torch.float32)
    st = convert.state_to_torch(state_h, dev, torch.float32)
    fmp = engine.fm_problem(prob)
    fv = kernels.kernel_layout(fmp)
    b = engine.linearize(fv, st, spec, 1e-3)
    pp = kernels.pack_fm(b, fv, with_pw=True)
    out = kernels.prepare_reduction(pp)
    ref = kernels.prepare_reduction_plain(pp)
    for name, a, r in zip(("red", "rg_corr", "T2", "T3"), out, ref):
        assert _scaled(a, r) < 2e-4, name
    fin = engine.finish_reduction(fv, b, st, 1e-3, *ref, True)
    ec, eg = fin[0].extra_c.contiguous(), fin[0].extra_g.contiguous()
    gen = torch.Generator().manual_seed(6)
    xc = torch.randn((fv.num_images, 6), generator=gen).cuda()
    xg = torch.randn((G,), generator=gen).cuda()
    oc, og = kernels.schur_matvec_rows(pp, ec, eg, xc, xg)
    rc, rg = kernels.schur_matvec_plain(pp, ec, eg, xc, xg)
    assert _scaled(oc, rc) < 2e-4 and _scaled(og, rg) < 2e-4


def _small_scene():
    from bundle_adjustment_tpu_torch.testing import make_synthetic_scene

    return make_synthetic_scene(num_points=60, num_images=10, noise=5e-4,
                                sigma=5e-4, perturb=0.01, seed=3)


@pytest.mark.parametrize("cls_name", ["BundleAdjustment",
                                      "ScaleBundleAdjustment"])
def test_reference_api_on_the_card_matches_the_cpu(case, cls_name):
    """The dense solver (REDUCED) and the scale class on CUDA by default,
    against the same code on the CPU: the same status and iterations,
    sigma0 within 1e-9, coordinates within 1e-9 of the field, the cofactor
    matrix within 1e-7 of its largest entry."""
    import numpy as np

    import bundle_adjustment_tpu_torch as T

    out = {}
    for dev in ("cuda", "cpu"):
        cams, bars, truth = _small_scene()
        cls = getattr(T, cls_name)
        adj = cls() if dev == "cuda" else cls(device="cpu")
        assert adj.device.type == dev
        adj.add(*cams, *bars)
        adj.set_invert_normal_equation(T.MatrixInversion.REDUCED)
        st = adj.estimate_model()
        out[dev] = (int(st), adj.iteration_step,
                    adj.get_variance_factor_aposteriori(),
                    np.array([[o.x.value, o.y.value, o.z.value]
                              for o in truth["coords"]]),
                    adj.get_cofactor_matrix().cpu().numpy())
        assert adj.state.points.device.type == dev
    (s1, i1, v1, x1, q1), (s2, i2, v2, x2, q2) = out["cuda"], out["cpu"]
    assert s1 == s2 == int(T.EstimationState.ERROR_FREE_ESTIMATION)
    assert i1 == i2
    assert abs(np.sqrt(v1 / v2) - 1.0) < 1e-9
    assert np.abs(x1 - x2).max() <= 1e-9 * np.abs(x2).max()
    assert np.abs(q1 - q2).max() <= 1e-7 * np.abs(q2).max()


# ---- the per-image sum of feature rows (csrc/image_sum.cu) ----------------

#: every F the port's callers sum per image (tests/test_torch_image_sum.py)
IMAGE_SUM_F = (6, 10, 16, 20, 39, 81, 99)


@pytest.fixture(scope="module")
def image_layout():
    """An image-sorted blocked layout on the card: 130 images of skewed
    sizes, image 3 over several 512-entry blocks, images 100-129 without
    an observation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    import numpy as np

    from bundle_adjustment_tpu_torch.parallel import engine, kernels, rcs

    rng = np.random.default_rng(4)
    img = np.concatenate([np.minimum(rng.integers(0, 100, 6000),
                                     rng.integers(0, 100, 6000)),
                          np.full(1500, 3)])
    img = rng.permutation(img).astype(np.int32)
    M, dev = 130, torch.device("cuda", 0)
    perm, bstarts = rcs.build_image_block_layout(img, M)
    perm_t = torch.as_tensor(perm, device=dev)
    pos, valid = engine.image_positions(perm_t, img.shape[0])
    assert int((torch.as_tensor(bstarts[1:] - bstarts[:-1])).max()) > 2
    return kernels.PackedFM(
        packed=None, obs_img=None, hppinv=None, img_perm=perm_t,
        img_block_starts=torch.as_tensor(bstarts, device=dev),
        num_points=img.shape[0], views=1, num_images=M, g=1, f_pad=0, pb=32,
        img_pos=pos, img_block_valid=valid)


@pytest.mark.parametrize("lead", [(), (3,)], ids=["rows", "lead3"])
@pytest.mark.parametrize("F", IMAGE_SUM_F)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_image_sum_kernel_matches_its_plain_versions(image_layout, dtype, F,
                                                     lead):
    """The kernel on F rows (views of one [*lead, F, N] array: unit last
    stride, a leading stride of F N) against its plain model of the
    two-level order (`image_sum_sorted_plain`: the same bits) and against
    the stack path that the card took before it (`engine._image_sum_plain`:
    f64 within 1e-12, f32 within 1e-5 of the largest sum, other orders of
    the sums); a second call gives the same bits, an image without
    observations sums to 0, and each call counts one launch."""
    from bundle_adjustment_tpu_torch.parallel import engine, kernels

    p = image_layout
    gen = torch.Generator().manual_seed(F)
    x = torch.randn((*lead, F, p.num_points), generator=gen,
                    dtype=dtype).cuda()
    rows = list(x.unbind(-2))
    before = kernels.image_sum_rows.launches
    out = kernels.image_sum_rows(p, rows)
    again = kernels.image_sum_rows(p, rows)
    assert kernels.image_sum_rows.launches == before + 2
    assert out.shape == (*lead, p.num_images, F) and out.dtype == dtype
    assert _bits(out, again)
    assert _bits(out, kernels.image_sum_sorted_plain(p, x.transpose(-1, -2)))
    ref = engine._image_sum_plain(p, rows)
    assert _scaled(out, ref) < (1e-12 if dtype == torch.float64 else 1e-5)
    assert bool((out[..., 100:, :] == 0).all())


def test_image_sum_kernel_replays_in_a_cuda_graph(image_layout):
    """Captured into a CUDA graph (the rig's f32 CG product captures it),
    a replay on new row values equals the eager call on them bit for bit;
    the capture counts one launch."""
    from bundle_adjustment_tpu_torch.parallel import kernels

    p = image_layout
    x = torch.randn((16, p.num_points), dtype=torch.float64, device="cuda")
    rows = list(x.unbind(0))
    kernels.image_sum_rows(p, rows)            # warm: library, module
    torch.cuda.synchronize()
    before = kernels.image_sum_rows.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = kernels.image_sum_rows(p, rows)
    assert kernels.image_sum_rows.launches == before + 1
    for _ in range(3):
        x.copy_(torch.randn_like(x))
        graph.replay()
        torch.cuda.synchronize()
        assert _bits(captured, kernels.image_sum_rows(p, rows))


def test_image_sum_wrapper_refuses_what_the_kernel_does_not_take(
        image_layout):
    """CPU and CUDA rows mixed, rows of another or an unsupported dtype and
    a last-dimension stride other than 1: each raises ValueError before
    any launch; the kernel's entry point refuses more rows than its table
    holds (the wrapper never asks it to)."""
    import ctypes

    from bundle_adjustment_tpu_torch.parallel import kernels

    p = image_layout
    N = p.num_points
    x = torch.randn((2, N), device="cuda")
    strided = torch.randn((N, 2), device="cuda")
    cases = [([x[0], x[1].cpu()], "on cpu"),
             ([x[0], x[1].double()], "dtype"),
             ([x[0].half(), x[1].half()], "dtype"),
             ([strided[:, 0], strided[:, 1]], "stride")]
    before = kernels.image_sum_rows.launches
    for rows, match in cases:
        with pytest.raises(ValueError, match=match):
            kernels.image_sum_rows(p, rows)
    assert kernels.image_sum_rows.launches == before
    F = kernels.MAX_IMAGE_SUM_ROWS + 1
    out = torch.empty((p.num_images, F), device="cuda")
    with pytest.raises(RuntimeError, match="ba_image_sum: CUDA error"):
        kernels._launch(
            "ba_image_sum", 4, (ctypes.c_void_p * F)(*[x.data_ptr()] * F),
            (ctypes.c_longlong * F)(*[N] * F), F, 1, N, p.num_images,
            p.img_pos.data_ptr(), p.img_block_valid.data_ptr(),
            p.img_block_starts.data_ptr(), p.img_block_valid.shape[0],
            out.data_ptr(), out.data_ptr(), F)


def test_image_sum_kernel_takes_more_rows_in_groups(image_layout):
    """279 f64 rows (the coupled reduction of a 4-camera rig's materialized
    global columns, 39 + 6 G): three launches of at most 128 rows, written
    into one [M, 279] output, equal to the plain model bit for bit and to
    the stack path within 1e-12."""
    from bundle_adjustment_tpu_torch.parallel import engine, kernels

    p = image_layout
    x = torch.randn((279, p.num_points), dtype=torch.float64, device="cuda")
    rows = list(x.unbind(0))
    before = kernels.image_sum_rows.launches
    out = kernels.image_sum_rows(p, rows)
    assert kernels.image_sum_rows.launches == before + 3
    assert _bits(out, kernels.image_sum_sorted_plain(p, x.T))
    assert _scaled(out, engine._image_sum_plain(p, rows)) < 1e-12


# ---- multi-camera rigs: the compact layout on the plain path ----------------


@pytest.fixture(scope="module")
def rig(case):
    """A 4-camera rig (the compact rows) on the card and on the CPU."""
    from bundle_adjustment_tpu_torch import convert, synthetic

    prob_h, state_h, spec = synthetic.build_problem(1000, 24, 8, seed=6,
                                                    num_cameras=4)
    out = dict(spec=spec)
    for where in ("cpu", "cuda"):
        for dt in (torch.float32, torch.float64):
            out[where, dt] = (convert.problem_to_torch(prob_h, where, dt),
                              convert.state_to_torch(state_h, where, dt))
    return out


def test_rig_step_on_the_card_matches_the_cpu(rig):
    """One f64 compact step (damping 1e-4, cg_tol 1e-13) on the card
    against the CPU: within rtol 3e-4, atol 1e-6 of max (the 16-camera
    test's tolerance: two f64 PCGs in other summation orders)."""
    from bundle_adjustment_tpu_torch.parallel import engine

    out = {}
    for where in ("cpu", "cuda"):
        prob, st = rig[where, torch.float64]
        out[where] = engine.lm_step(engine.fm_problem(prob), st, rig["spec"],
                                    1e-4, cg_tol=1e-13, cg_maxiter=3000)
    assert out["cuda"][3].Jg is None
    for a, r in zip(out["cuda"][:3], out["cpu"][:3]):
        torch.testing.assert_close(a.cpu(), r, rtol=3e-4,
                                   atol=1e-6 * float(r.abs().max()))


def test_rig_step_repeats_bit_for_bit(rig):
    """The compact f32 step twice on the card: the camera sums are
    fixed-order products and `_scg_correction` sums per image without
    atomics, so the bits repeat."""
    from bundle_adjustment_tpu_torch.parallel import engine

    prob, st = rig["cuda", torch.float32]
    fmp = engine.fm_problem(prob)
    one, two = (engine.lm_step(fmp, st, rig["spec"], 1e-2, cg_tol=1e-5,
                               cg_maxiter=100) for _ in range(2))
    for a, b in zip(one[:3], two[:3]):
        assert torch.equal(a, b)


def test_kernels_refuse_a_rig_on_the_card(rig):
    """`use_kernels=True` on compact blocks raises, before any launch; the
    default route of `solve` for a rig is the plain path (no K1, K2 or K3
    launch; its per-image sums through the image-sum kernel)."""
    from bundle_adjustment_tpu_torch.parallel import (engine, kernels,
                                                      refine, solver)

    prob, st = rig["cuda", torch.float32]
    fmp = engine.fm_problem(prob)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="single-camera"):
        engine.lm_step(fmp, st, rig["spec"], 1e-2, use_kernels=True)
    with pytest.raises(ValueError, match="single-camera"):
        refine.Refiner(prob, rig["spec"], use_kernels=True)
    res = solver.solve(prob, st, rig["spec"], max_iterations=2,
                       tolerance=1e-3)
    assert res.iterations == 2
    counts = kernels.launch_counts()
    assert counts.pop("image_sum") > 0
    assert not any(counts.values()), counts


def test_refiner_route_follows_the_problem(rig):
    """`Refiner(use_kernels=None)` takes `solve`'s rule: the kernels for a
    single-camera f32 problem on the card (not in f64), the plain compact
    rows for a rig; the rig's refinement (block Jacobi, undamped) from the
    f32 solve's end converges there and launches no K1, K2 or K3 (its
    per-image sums go through the image-sum kernel)."""
    from bundle_adjustment_tpu_torch import convert, synthetic
    from bundle_adjustment_tpu_torch.parallel import (kernels, lm, refine,
                                                      solver)

    ph, _, spec1 = synthetic.build_problem(512, 12, 6, seed=1)
    for dt, takes in ((torch.float32, True), (torch.float64, False)):
        r = refine.Refiner(convert.problem_to_torch(ph, "cuda", dt), spec1)
        assert r.use_kernels is takes
    prob, st = rig["cuda", torch.float32]
    kernels.reset_launch_counts()
    res = solver.solve(prob, st, rig["spec"], damping=1e-2,
                       max_iterations=30, tolerance=1e-3)
    r = refine.Refiner(prob, rig["spec"], couple_global=False)
    assert r.use_kernels is False
    phase = lm.LMPhase(steps=res.iterations, max_dx=res.max_abs_dx,
                       cg_iterations=[], seconds=0.0)
    _, rec = refine.converge(r, (res.state, phase), damping=0.0)
    assert rec.converged, rec.max_dx
    counts = kernels.launch_counts()
    assert counts.pop("image_sum") > 0
    assert not any(counts.values()), counts


def _bits(a, b):
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    if a.dtype in ints:
        return a.dtype == b.dtype and torch.equal(a.view(ints[a.dtype]),
                                                  b.view(ints[b.dtype]))
    return torch.equal(a, b)


def test_file_route_solves_through_the_kernels(case, tmp_path):
    from bundle_adjustment_tpu_torch import convert, synthetic
    from bundle_adjustment_tpu_torch.io import columnar
    from bundle_adjustment_tpu_torch.parallel import kernels, solver

    dev = torch.device("cuda", 0)
    ph, sh, spec = synthetic.build_problem(2048, 40, 12, seed=4)
    paths = synthetic.write_flat(str(tmp_path / "net"), ph, sh)
    fp, fs, _ = columnar.build_rcs_problem(
        paths["points"], paths["imagecoords"], paths["eor"],
        io_path=paths["ior"], spec=spec, dist=sh.dist)
    assert fp.obs_xy.is_cuda and fp.obs_xy.dtype == torch.float32
    cp_h, cs_h = synthetic.as_read_from_files(ph, sh)
    cp = convert.problem_to_torch(cp_h, dev, torch.float32)
    cs = convert.state_to_torch(cs_h, dev, torch.float32)
    for f in cp._fields:
        a, b = getattr(fp, f), getattr(cp, f)
        assert (_bits(a, b) if isinstance(b, torch.Tensor) else a == b), f
    kw = dict(damping=1e-2, max_iterations=30, tolerance=1e-3)
    kernels.reset_launch_counts()
    rf = solver.solve(fp, fs, spec, **kw)
    counts = kernels.launch_counts()
    rc = solver.solve(cp, cs, spec, **kw)
    assert min(counts[k] for k in ("cam_gather", "prepare_reduction",
                                   "schur_matvec")) > 0, counts
    assert rf.converged and rf.iterations == rc.iterations
    for f in rf.state._fields:
        assert _bits(getattr(rf.state, f), getattr(rc.state, f)), f


def test_cli_on_the_card_matches_its_cpu_run(case, tmp_path):
    import os
    import subprocess
    import sys

    from bundle_adjustment_tpu_torch.io import scene_files
    from bundle_adjustment_tpu_torch.testing import make_synthetic_scene

    cams, bars, _ = make_synthetic_scene(num_points=60, num_images=10,
                                         noise=5e-4, sigma=5e-4,
                                         perturb=0.01, seed=2)
    base = str(tmp_path / "net")
    scene_files.write_aicon_files(base, cams[0], bars)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def run(*extra):
        res = subprocess.run(
            [sys.executable, "-m", "bundle_adjustment_tpu_torch", "flat",
             base, "--quiet", *extra], cwd=root, capture_output=True,
            text=True, timeout=600)
        assert res.returncode == 0, res.stderr[-2000:]
        return [float(v) for line in res.stdout.splitlines()
                if ":" in line and not line.startswith("Estimation time")
                for v in [line.split(":", 1)[1]]]

    card, cpu = run(), run("--cpu")
    assert len(card) == len(cpu) == 6
    assert card[:4] == cpu[:4]
    for a, b in zip(card[4:], cpu[4:]):
        assert abs(a / b - 1.0) <= 1e-9


# ---------------------------------------------------------------------------
# the sharded paths on the card: world size 1 on NCCL, 2 ranks over gloo
# ---------------------------------------------------------------------------

def _sharded_worker(comm):
    """`spmd_fm` (both modes), `tp` and `spmd` on a 512-point network on
    the card (a spawned rank; imports torch and the port only)."""
    from bundle_adjustment_tpu_torch import convert, synthetic
    from bundle_adjustment_tpu_torch.parallel import (engine, kernels, spmd,
                                                      spmd_fm, tp)

    prob_h, state_h, spec = synthetic.build_problem(512, 24, 8, seed=3)
    prob = convert.problem_to_torch(prob_h, comm.device, torch.float64)
    st = convert.state_to_torch(state_h, comm.device, torch.float64)
    out = {"form": comm.form}
    for cam in (False, True):
        step, args = spmd_fm.make_spmd_fm_lm_step(
            prob, st, spec, comm, damping=1e-4, cg_tol=1e-12, cg_maxiter=500,
            cam_shard=cam)
        (pts, io, _dist, eo), mdx, om, it = step(*args)
        out[cam] = dict(points=comm.all_gather(pts).cpu(), eo=eo.cpu(),
                        io=io.cpu(), omega0=float(om), max_dx=float(mdx),
                        it=it)
    fmp = engine.fm_problem(prob)
    b = engine.prepare(fmp, st, spec, 1e-4, couple_global=True)[0]
    S, r = tp.assemble_reduced_system(fmp, b)
    n = -(-S.shape[0] // (comm.size * 8)) * comm.size * 8
    Sp, rp = tp.pad_spd(S, r, n)
    L = tp.distributed_cholesky(Sp, comm, 8)
    out.update(L=tp.gather_factor(L, comm).cpu(), S=Sp.cpu(), r=rp.cpu(),
               x=tp.distributed_cholesky_solve(L, rp, comm).cpu())
    new, mdx, _om, _it = spmd.make_spmd_lm_step(
        spmd.shard_problem(prob, comm), spec, comm, cg_tol=1e-13,
        cg_maxiter=1000)(st)
    out["spmd"] = dict(points=new.points.cpu(), max_dx=float(mdx))
    fh, fs, _ = _thinned_host()
    fprob = convert.problem_to_torch(fh, comm.device, torch.float64)
    new, mdx, _om, _it = spmd.make_spmd_lm_step(
        spmd.shard_problem(fprob, comm), spec, comm, cg_tol=1e-13,
        cg_maxiter=1000)(convert.state_to_torch(fs, comm.device,
                                                torch.float64))
    out["spmd_file"] = dict(points=new.points.cpu(), max_dx=float(mdx))
    if comm.size == 1:  # K3 in the f32 step: an exact gather
        sp = spmd.shard_problem(
            convert.problem_to_torch(fh, comm.device, torch.float32), comm)
        s32 = convert.state_to_torch(fs, comm.device, torch.float32)
        kernels.reset_launch_counts()
        runs = [spmd.make_spmd_lm_step(sp, spec, comm, cg_tol=1e-6,
                                       use_kernels=use)(s32)
                for use in (None, False)]
        out["k3"] = dict(launches=kernels.launch_counts(), same=all(
            torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
            and runs[0][3] == runs[1][3])
    return out


def _thinned_host():
    """A 512-point network of uneven visibility in file order (host
    arrays): every 10th point in 8 views, the rest in 4."""
    from bundle_adjustment_tpu_torch import synthetic

    ph, sh, spec = synthetic.build_problem(512, 24, 8, seed=3)
    ph, sh = synthetic.thin_views(ph, sh, views=4, every=10)
    return ph, sh, spec


@pytest.mark.parametrize("world,device,backend",
                         [(1, "cuda", "nccl"), (2, "cuda:0", "gloo")])
def test_sharded_paths_on_the_card(tmp_path, world, device, backend):
    """The point-sharded step (both modes) against `engine.lm_step` on the
    card (points / eo rtol 1e-9 atol 1e-11, omega0 rtol 1e-10, max_dx rtol
    1e-7), the block-cyclic factor's backward error (Jacobi-scaled, 1e-13)
    and solve (rtol 1e-9 of `torch.linalg.solve`), the observation-sharded
    Gauss-Newton step against the engine's (points atol 1e-9, max_dx rtol
    1e-8); gloo on the card takes the all_reduce form."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    from bundle_adjustment_tpu_torch import convert, synthetic
    from bundle_adjustment_tpu_torch.parallel import engine, multihost, rcs

    res = multihost.run_ranks(_sharded_worker, world, workdir=tmp_path,
                              device=device, backend=backend, timeout=120,
                              wait=600)
    out = res[0]
    assert out["form"] == ("direct" if backend == "nccl" else "all_reduce")
    dev = torch.device("cuda", 0)
    prob_h, state_h, spec = synthetic.build_problem(512, 24, 8, seed=3)
    prob = convert.problem_to_torch(prob_h, dev, torch.float64)
    st = convert.state_to_torch(state_h, dev, torch.float64)
    fmp = engine.fm_problem(prob)
    dxp, dxc, dxg, b, _ = engine.lm_step(fmp, st, spec, 1e-4, cg_tol=1e-12,
                                         cg_maxiter=500)
    ref, mdx = rcs.apply_step(st, dxp, dxc, dxg)
    for cam in (False, True):
        got = out[cam]
        torch.testing.assert_close(got["points"], ref.points.cpu(),
                                   rtol=1e-9, atol=1e-11)
        torch.testing.assert_close(got["eo"], ref.eo.cpu(), rtol=1e-9,
                                   atol=1e-11)
        assert abs(got["omega0"] / float(b.omega0) - 1) <= 1e-10
        assert abs(got["max_dx"] / float(mdx) - 1) <= 1e-7
        for other in res[1:]:
            assert torch.equal(other[cam]["points"], got["points"])
    D = torch.sqrt(torch.diagonal(out["S"]))
    Ls = out["L"] / D[:, None]
    assert float((Ls @ Ls.T - out["S"] / D[:, None] / D[None, :]).abs()
                 .max()) <= 1e-13
    torch.testing.assert_close(out["x"], torch.linalg.solve(out["S"],
                                                            out["r"]),
                               rtol=1e-9, atol=1e-12)
    dxp, dxc, dxg, b, _ = engine.lm_step(fmp, st, spec, 0.0, cg_tol=1e-13,
                                         cg_maxiter=1000)
    ref, mdx = rcs.apply_step(st, dxp, dxc, dxg)
    torch.testing.assert_close(out["spmd"]["points"], ref.points.cpu(),
                               rtol=0, atol=1e-9)
    assert abs(out["spmd"]["max_dx"] / float(mdx) - 1) <= 1e-8
    # the file order (uneven visibility) against rcs.lm_step on the card
    fh, fs, _ = _thinned_host()
    fprob = convert.problem_to_torch(fh, dev, torch.float64)
    fst = convert.state_to_torch(fs, dev, torch.float64)
    dxp, dxc, dxg, b, _ = rcs.lm_step(fprob, fst, spec, 0.0, cg_tol=1e-13,
                                      cg_maxiter=1000)
    ref, mdx = rcs.apply_step(fst, dxp, dxc, dxg)
    for r in res:
        assert torch.equal(r["spmd_file"]["points"],
                           out["spmd_file"]["points"])
    torch.testing.assert_close(out["spmd_file"]["points"], ref.points.cpu(),
                               rtol=0, atol=1e-9)
    assert abs(out["spmd_file"]["max_dx"] / float(mdx) - 1) <= 1e-8
    if world == 1:  # K3 launched in the f32 step, equal to the plain one
        k3 = out["k3"]
        assert k3["same"] and k3["launches"]["cam_gather"] > 0
        assert k3["launches"]["schur_matvec"] == 0
        assert k3["launches"]["prepare_reduction"] == 0


def test_scenario_step_on_the_card():
    """`scenario_lm_step` on the card against `rcs.lm_step` per network
    (3 networks of 300 points, uniform and cut to file order by
    `synthetic.thin_scenarios`, f64, cg_tol 1e-14): states and omega0
    within 1e-12, max_dx within 1e-10, CG counts within 3 (the batched
    reductions over the rows sum in another order on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    from bundle_adjustment_tpu_torch import convert, synthetic
    from bundle_adjustment_tpu_torch.models.problem import ParamState
    from bundle_adjustment_tpu_torch.parallel import rcs, scenario

    dev = torch.device("cuda", 0)
    for views, thin in ((6, None), (12, dict(views=4, every=10))):
        prob_h, xy, w, states, spec = synthetic.scenario_batch(
            3, 300, 12, views, seed=2)
        if thin:
            prob_h, xy, w, states = synthetic.thin_scenarios(
                prob_h, xy, w, states, **thin)
        prob = convert.problem_to_torch(prob_h, dev, torch.float64)
        assert (prob.point_uniform is None) == bool(thin)
        batch = scenario.make_batch(prob, xy, w, states)
        new, mdx, om, it = scenario.scenario_lm_step(
            batch, spec, 1e-4, cg_tol=1e-14, cg_maxiter=600)
        for s in range(3):
            p = prob._replace(obs_xy=batch.obs_xy[s],
                              obs_weight=batch.obs_weight[s])
            st = ParamState(*(a[s] for a in batch.states))
            dxp, dxc, dxg, b, it1 = rcs.lm_step(p, st, spec, 1e-4,
                                                cg_tol=1e-14, cg_maxiter=600)
            ref, mdx1 = rcs.apply_step(st, dxp, dxc, dxg)
            assert abs(int(it[s]) - it1) <= 3
            for name in ParamState._fields:
                assert _scaled(getattr(new, name)[s],
                               getattr(ref, name)) <= 1e-12
            assert abs(float(mdx[s] / mdx1) - 1) <= 1e-10
            assert abs(float(om[s] / b.omega0) - 1) <= 1e-12


@pytest.fixture(scope="module")
def file_order():
    """A 1,000-point network of uneven visibility in file order on the
    card (`synthetic.thin_views`: every 10th point in 8 views, the rest in
    3), f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    from bundle_adjustment_tpu_torch import convert, synthetic

    dev = torch.device("cuda", 0)
    ph, sh, spec = synthetic.build_problem(1000, 24, 8, seed=5)
    ph, sh = synthetic.thin_views(ph, sh, views=3, every=10)
    prob = convert.problem_to_torch(ph, dev, torch.float32)
    assert prob.point_uniform is None
    return prob, convert.state_to_torch(sh, dev, torch.float32), spec


def test_cam_gather_kernel_is_exact_file_order(file_order):
    """K3 over the file-order layout (the block-layout engine's EO gather)
    equals the plain gather bit for bit."""
    from bundle_adjustment_tpu_torch.parallel import kernels

    prob, state, _ = file_order
    before = kernels.cam_gather_rows.launches
    for tbl in (state.eo, prob.free_eo):
        out = kernels.make_cam_gather(prob)(tbl)
        torch.testing.assert_close(
            out, kernels.cam_gather_plain(tbl, prob.obs_image), rtol=0,
            atol=0)
    assert kernels.cam_gather_rows.launches == before + 2


def test_file_order_step_repeats_bit_for_bit(file_order):
    """One f32 step of the block-layout engine through K3, run twice: the
    same bits (no per-point or per-image sum uses atomics), K3 launched;
    and `solve`'s default on f32 CUDA takes K3 on this layout."""
    from bundle_adjustment_tpu_torch.parallel import kernels, rcs, solver

    prob, state, spec = file_order
    cg = kernels.make_cam_gather(prob)
    kernels.reset_launch_counts()
    runs = [rcs.lm_step_full(prob, state, spec, 1e-2, cg_tol=1e-6,
                             cam_gather=cg)[:3] for _ in range(2)]
    assert kernels.launch_counts()["cam_gather"] > 0
    for a, b in zip(*runs):
        assert _bits(a, b)
    kernels.reset_launch_counts()
    solver.solve(prob, state, spec, damping=1e-2, max_iterations=1)
    counts = kernels.launch_counts()
    assert counts["cam_gather"] > 0 and counts["schur_matvec"] == 0


def test_file_order_refiner_runs_k3_and_matches_its_plain_route():
    """The Refiner on the file order, the port's normal path (`solve` ->
    `Refiner` -> `converge`, undamped, block Jacobi), on the network of
    tests/test_torch_refine_file.py (`thin_views(build_problem(800, 24,
    16, seed=3), views=6, every=10)`: the undamped refinement needs no
    point in fewer than ~6 views, where a repeated image leaves it
    singular): with the card's
    default (`use_kernels=None`, f32: K3 for the EO gathers) it converges
    and agrees with its own plain route (``use_kernels=False``) within the
    tolerance of tests/test_torch_refine_file.py's (b): both refined to
    max|dx| <= 1e-8, every parameter within 1e-8 and the f64 Omega at rtol
    1e-9; the default launches K3 and no K1 or K2, the plain route
    nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    from bundle_adjustment_tpu_torch import convert, synthetic
    from bundle_adjustment_tpu_torch.parallel import (hilo, kernels, lm,
                                                      refine, solver)

    dev = torch.device("cuda", 0)
    ph, sh, spec = synthetic.build_problem(800, 24, 16, seed=3)
    ph, sh = synthetic.thin_views(ph, sh, views=6, every=10)
    prob = convert.problem_to_torch(ph, dev, torch.float32)
    state = convert.state_to_torch(sh, dev, torch.float32)
    res = solver.solve(prob, state, spec, damping=1e-2, max_iterations=30,
                       tolerance=1e-3)
    phase = lm.LMPhase(steps=res.iterations, max_dx=res.max_abs_dx,
                       cg_iterations=[], seconds=0.0)
    out = {}
    for use in (None, False):
        kernels.reset_launch_counts()
        r = refine.Refiner(prob, spec, use_kernels=use, couple_global=False)
        s, rec = refine.converge(r, (res.state, phase), tolerance=1e-8,
                                 damping=0.0)
        assert rec.converged, (use, rec.max_dx)
        x = hilo.to_f64(s)
        out[use] = (x, float(r.gradient64(r.fmp64, x)[3]),
                    kernels.launch_counts(), r.use_kernels)
    (x, om, counts, on), (y, om_plain, plain, off) = out[None], out[False]
    assert on and not off
    assert counts["cam_gather"] > 0
    assert counts["schur_matvec"] == counts["prepare_reduction"] == 0
    assert set(plain.values()) == {0}
    for a, b in zip(x, y):
        assert float((a - b).abs().max()) <= 1e-8
    assert abs(om / om_plain - 1.0) <= 1e-9
