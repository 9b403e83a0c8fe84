"""Plain versions of the port's kernels (K3 camera gather, K1 Schur matvec,
K2 fused assembly) against the JAX Pallas kernels run in interpret mode on
the CPU, on the same packed rows and the same view-major lane order.

Tolerances and why:
  * K3, f32: rtol 1e-6 -- the Pallas gather multiplies the table by an
    exact one-hot in three bf16 chunks, exact to ~2^-24 relative.
  * K1, f32 vs make_matvec: rtol 2e-4 with atol 1e-4 (c) / 1e-3 (g), the
    reference kernel's own tolerance (tests/test_pallas_prepare.py:62-65):
    different f32 summation orders over ~N terms.  At M = 130 a few output
    entries (~1e7) are the small difference of Schur terms of ~1e12, so
    the absolute atol is below f32 resolution there; that case takes the
    reference's M > 128 matvec harness tolerance, rtol 2e-4 with atol
    2e-4 x max|output| (tests/test_engine_fm.py:178-181).
  * K1, f64 vs engine.schur_matvec: rtol 1e-9 (same sums, f64).
  * K2 outputs vs make_prepare_reduction: rtol 2e-4 with atol 1e-5 times
    each output's scale (tests/test_pallas_prepare.py:140-143).
  * K2 through finish_reduction vs prepare_pallas, per case as the
    reference compares them (tests/test_pallas_prepare.py): coupled -- rc,
    rg, bc rtol 2e-4, Minv_c and Sghat_inv within a scaled error of 5e-4;
    uncoupled -- rc, and Minv_g rtol 5e-3; M = 130 -- rc, rg, bc.  In
    every case each inverse also agrees to 2e-4 relative per unit of its
    block's condition number (f32 inverses amplify input differences by
    cond(S), which grows as the damping shrinks).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import (blocks_to_torch, build_pair, inverse_err, np_,
                           packed_to_torch, scaled_err)
from bundle_adjustment_tpu.parallel import engine as E
from bundle_adjustment_tpu.parallel import kernels as K
from bundle_adjustment_tpu_torch.parallel import kernels as TK


@pytest.fixture(scope="module")
def small32():
    return build_pair(128, 6, 4, seed=11, f64=False)


@pytest.fixture(scope="module")
def wide32():
    """M = 130 images: the factored one-hot (W > 1) on the JAX side; 8
    views of 256 points give every camera block enough observations."""
    return build_pair(256, 130, 8, seed=14, f64=False)


@pytest.mark.parametrize("M", [6, 130])
def test_cam_gather_plain_matches_pallas(M):
    pr = build_pair(128, M, 4, seed=9, f64=False)
    gj = K.make_cam_gather(pr.fj, interpret=True)
    rng = np.random.default_rng(3)
    tbl = rng.normal(size=(M, 6)).astype(np.float32)
    ref = np.asarray(gj(jnp.asarray(tbl)))
    out = TK.cam_gather_plain(torch.as_tensor(tbl), pr.ft.obs_image)
    np.testing.assert_allclose(np_(out), ref, rtol=1e-6, atol=0)
    assert out.shape == (8, pr.ft.num_points * pr.ft.views)
    np.testing.assert_array_equal(np_(out[6:]), 0.0)


def test_cam_gather_wrapper_takes_plain_on_cpu(small32):
    tbl = torch.randn(small32.ft.num_images, 3, generator=torch.Generator()
                      .manual_seed(0))
    before = TK.cam_gather_rows.launches
    rows = TK.make_cam_gather(small32.ft)(tbl)
    torch.testing.assert_close(rows, TK.cam_gather_plain(
        tbl, small32.ft.obs_image), rtol=0, atol=0)
    assert TK.cam_gather_rows.launches == before  # no kernel launched


def test_cam_gather_wrapper_point_major(small32):
    """K3's wrapper takes the point-major layout (the covariance
    linearises it) and gathers in its lane order: a layout check of the
    plain path on the CPU (the kernel itself is held exactly against the
    plain gather on this layout in tests/test_torch_cuda.py)."""
    from bundle_adjustment_tpu_torch import convert
    from bundle_adjustment_tpu_torch.parallel import engine as TE

    pm = TE.fm_problem(convert.problem_to_torch(
        small32.problem_j, torch.device("cpu"), torch.float32))
    assert pm.vm_pb is None
    tbl = torch.randn(pm.num_images, 6,
                      generator=torch.Generator().manual_seed(1))
    rows = TK.make_cam_gather(pm)(tbl)
    ref = TE._gather_rows(pm, tbl, 6)
    torch.testing.assert_close(rows[:6], torch.stack(ref), rtol=0, atol=0)
    np.testing.assert_array_equal(np_(rows[6:]), 0.0)


def _matvec_case(pr, scaled_atol=False):
    lam = jnp.asarray(1e-3, jnp.float32)
    b, rc, rg, Minv, pp = K.prepare_pallas(pr.fj, pr.state_j, pr.spec, lam,
                                           couple_global=True, interpret=True)
    mv = K.make_matvec(pp, b.extra_c, b.extra_g, interpret=True)
    ocj, ogj = mv(rc, rg)
    ppt = packed_to_torch(pp, pr.ft)
    oct_, ogt = TK.schur_matvec_plain(
        ppt, torch.as_tensor(np.array(b.extra_c)),
        torch.as_tensor(np.array(b.extra_g)),
        torch.as_tensor(np.array(rc)), torch.as_tensor(np.array(rg)))
    ocj, ogj = np.asarray(ocj), np.asarray(ogj)
    atol_c = 2e-4 * np.max(np.abs(ocj)) if scaled_atol else 1e-4
    atol_g = 2e-4 * np.max(np.abs(ogj)) if scaled_atol else 1e-3
    np.testing.assert_allclose(np_(oct_), ocj, rtol=2e-4, atol=atol_c)
    np.testing.assert_allclose(np_(ogt), ogj, rtol=2e-4, atol=atol_g)


def test_matvec_plain_matches_pallas(small32):
    _matvec_case(small32)


def test_matvec_plain_matches_pallas_many_images(wide32):
    _matvec_case(wide32, scaled_atol=True)


@pytest.mark.parametrize("P,M,V", [(128, 12, 4), (256, 130, 8)])
def test_matvec_plain_f64_matches_engine(P, M, V):
    """K1's plain version in f64 on the port's own packed rows vs the JAX
    engine's matvec."""
    from bundle_adjustment_tpu_torch.parallel import engine as TE

    pr = build_pair(P, M, V, seed=5)
    lam = 1e-3
    bj, rcj, rgj, _ = E.prepare(pr.fj, pr.state_j, pr.spec, jnp.asarray(lam))
    bt, _, _, _ = TE.prepare(pr.ft, pr.state_t, pr.spec, lam)
    pp = TK.pack_fm(bt, pr.ft, dtype=torch.float64, lean_only=True)
    rng = np.random.default_rng(1)
    xc = rng.normal(size=np.shape(rcj))
    xg = rng.normal(size=np.shape(rgj))
    ocj, ogj = E.schur_matvec(pr.fj, bj, jnp.asarray(xc), jnp.asarray(xg))
    oct_, ogt = TK.schur_matvec_plain(pp, bt.extra_c, bt.extra_g,
                                      torch.as_tensor(xc), torch.as_tensor(xg))
    np.testing.assert_allclose(np_(oct_), np.asarray(ocj), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(np_(ogt), np.asarray(ogj), rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize("which", ["small", "wide"])
def test_prepare_reduction_plain_matches_pallas(which, small32, wide32):
    pr = small32 if which == "small" else wide32
    b = E.linearize(pr.fj, pr.state_j, pr.spec, jnp.asarray(1e-3, jnp.float32))
    pp = K.pack_fm(b, pr.fj, with_pw=True)
    ref = K.make_prepare_reduction(pp, interpret=True)()
    out = TK.prepare_reduction_plain(packed_to_torch(pp, pr.ft))
    for name, a, r in zip(("red", "rg_corr", "T2", "T3"), out, ref):
        r = np.asarray(r)
        scale = max(np.max(np.abs(r)), 1e-30)
        np.testing.assert_allclose(np_(a), r, rtol=2e-4, atol=1e-5 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("which,couple", [("small", True), ("small", False),
                                          ("wide", True)])
def test_k2_through_finish_matches_prepare_pallas(which, couple, small32,
                                                  wide32):
    """Pack + plain K2 + finish_reduction on the JAX side's own f32
    linearisation vs kernels.prepare_pallas (two f32 forward models would
    differ in the misclosures, not in the assembly)."""
    from bundle_adjustment_tpu_torch.parallel import engine as TE

    pr = small32 if which == "small" else wide32
    lam = 1e-3 if couple else 1e-4
    lam_j = jnp.asarray(lam, jnp.float32)
    bj, rcj, rgj, Mj, _ = K.prepare_pallas(
        pr.fj, pr.state_j, pr.spec, lam_j, couple_global=couple,
        interpret=True)
    b0 = blocks_to_torch(E.linearize(pr.fj, pr.state_j, pr.spec, lam_j))
    pp = TK.pack_fm(b0, pr.ft, with_pw=True)
    bt, rct, rgt, Mt = TE.finish_reduction(
        pr.ft, b0, pr.state_t, lam, *TK.prepare_reduction(pp), couple)
    np.testing.assert_allclose(np_(rct), np.asarray(rcj), rtol=2e-4,
                               atol=1e-5)
    assert inverse_err(np_(Mt.Minv_c), Mj.Minv_c) < 2e-4
    if not couple:
        assert Mt.Scg is None
        np.testing.assert_allclose(np_(Mt.Minv_g), np.asarray(Mj.Minv_g),
                                   rtol=5e-3, atol=1e-5)
        assert inverse_err(np_(Mt.Minv_g), Mj.Minv_g) < 2e-4
        return
    np.testing.assert_allclose(np_(rgt), np.asarray(rgj), rtol=2e-4,
                               atol=1e-4)
    np.testing.assert_allclose(np_(bt.bc), np.asarray(bj.bc), rtol=2e-4,
                               atol=1e-5)
    assert inverse_err(np_(Mt.Sghat_inv), Mj.Sghat_inv) < 2e-4
    if which == "small":
        assert scaled_err(np_(Mt.Minv_c), Mj.Minv_c) < 5e-4
        assert scaled_err(np_(Mt.Sghat_inv), Mj.Sghat_inv) < 5e-4


@pytest.mark.parametrize("couple", [True, False])
def test_prepare_kernels_f64_matches_engine(couple):
    """The port's whole K2 path (linearise with the K3 gathers, pack, K2,
    finish) in f64 vs the JAX engine's prepare: rtol 1e-9 for the
    reduced system, 1e-7 for the inverses (tests/test_engine_fm.py)."""
    pr = build_pair(128, 10, 4, seed=2)
    lam = 1e-3
    bj, rcj, rgj, Mj = E.prepare(pr.fj, pr.state_j, pr.spec,
                                 jnp.asarray(lam), couple_global=couple)
    bt, rct, rgt, Mt, ppt = TK.prepare_kernels(
        pr.ft, pr.state_t, pr.spec, lam, couple_global=couple,
        cam_gather=TK.make_cam_gather(pr.ft))
    assert ppt.packed.dtype == torch.float64
    np.testing.assert_allclose(np_(rct), np.asarray(rcj), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(np_(rgt), np.asarray(rgj), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(np_(Mt.Minv_c), np.asarray(Mj.Minv_c),
                               rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(np_(Mt.Minv_g), np.asarray(Mj.Minv_g),
                               rtol=1e-7, atol=1e-10)
    if couple:
        np.testing.assert_allclose(np_(Mt.Sghat_inv),
                                   np.asarray(Mj.Sghat_inv), rtol=1e-7,
                                   atol=1e-10)


def test_pack_fm_layout_matches_jax(small32):
    """On the same rows, the packed [F, N] array, hppinv and obs_img equal
    the JAX pack_fm's exactly."""
    pr = small32
    bj = E.linearize(pr.fj, pr.state_j, pr.spec,
                     jnp.asarray(1e-3, jnp.float32))
    bt = blocks_to_torch(bj)
    for kw in (dict(with_pw=True), dict(), dict(lean_only=True)):
        pj = K.pack_fm(bj, pr.fj, **kw)
        pt = TK.pack_fm(bt, pr.ft, **kw)
        assert pt.f_pad == pj.f_pad
        np.testing.assert_array_equal(np_(pt.packed), np.asarray(pj.packed))
        np.testing.assert_array_equal(np_(pt.hppinv), np.asarray(pj.hppinv))
        np.testing.assert_array_equal(np_(pt.obs_img),
                                      np.asarray(pj.obs_img).reshape(-1))
        assert pt.pb == pj.pb == 128


def test_choose_pb():
    assert TK.choose_pb(100352, 12, 10) == 32
    assert TK.choose_pb(512, 4, 10) == 128
    assert TK.choose_pb(512, 8, 10) == 64
    # G = 16: K2's tile of 102 rows leaves no room for its scratch at
    # V * pb = 512, so the block halves
    assert not TK.k2_tile_fits(128, 4, 16) and TK.k2_tile_fits(64, 4, 16)
    assert TK.choose_pb(512, 4, 16) == 64
    assert TK.choose_pb(512, 8, 16) == 32
    with pytest.raises(ValueError, match="G=10"):
        TK.choose_pb(100, 4, 10)
    with pytest.raises(ValueError, match="G=16"):
        TK.choose_pb(512, 16, 16)


def test_k2_tile_model_reads_the_kernels_constants():
    """`k2_tile_fits` models K2's shared memory from csrc: its chunk step,
    row pad, ring header, thread and G limits and the formula of
    `prepare_user_bytes` (tests/test_torch_cuda.py also holds the model
    against the built kernel's own plan)."""
    import re

    from bundle_adjustment_tpu_torch import kernel_build

    src = {s.name: s.read_text() for s in kernel_build.sources()}
    k2, common = src["prepare_reduction.cu"], src["common.cuh"]

    def const(text, name):
        m = re.search(rf"constexpr int {name} = (\d+);", text)
        assert m, name
        return int(m.group(1))

    assert const(k2, "kChunkStep") == TK.K2_CHUNK_STEP
    assert const(k2, "kRowPad") == TK.K2_ROW_PAD
    assert const(common, "kRingHeader") == TK.RING_HEADER
    assert const(common, "kMaxBlockThreads") == TK.MAX_BLOCK_THREADS
    assert const(common, "kMaxG") == TK.MAX_G
    assert ("(nthr * (cw + kRowPad) + (3 + 6 * G) * (pb + 1) + "
            "kMaxWarps * kMaxG)") in " ".join(k2.split())


# (N, M, images used, seed): uneven images, M = 130, empty images, images of
# exactly one block, and one image that holds everything
@pytest.mark.parametrize("N,M,used,seed", [
    (3000, 130, 130, 0), (3000, 130, 100, 1), (5000, 7, 7, 2),
    (1024, 2, 2, 3), (2000, 3, 1, 4), (700, 130, 130, 5)])
def test_image_positions_and_sorted_sum(N, M, used, seed):
    """`engine.image_positions` inverts `img_perm`, every block's valid
    entries are a prefix, and a scatter to the image-sorted positions
    followed by the two-level segmented sum (`image_sum_sorted_plain`, the
    plain model of the kernels' streaming per-image pass) equals
    `engine._image_sum_stack` (f64: rtol 1e-12, the order of the sums
    differs)."""
    from bundle_adjustment_tpu_torch.parallel import engine as TE
    from bundle_adjustment_tpu_torch.parallel import rcs as TR

    rng = np.random.default_rng(seed)
    if N == 1024:
        obs_img = np.repeat(np.arange(2), 512).astype(np.int32)
    else:
        obs_img = np.minimum(rng.integers(0, used, N),
                             rng.integers(0, used, N)).astype(np.int32)
    perm, bstarts = TR.build_image_block_layout(obs_img, M)
    perm_t = torch.as_tensor(perm)
    pos, valid = TE.image_positions(perm_t, N)
    assert pos.dtype == torch.int32 and valid.dtype == torch.int32
    np.testing.assert_array_equal(perm[pos.numpy()], np.arange(N))
    blocks = perm.reshape(-1, TR.IMG_BLOCK) < N
    np.testing.assert_array_equal(valid.numpy(), blocks.sum(1))
    assert int(valid.sum()) == N
    for b, n in enumerate(valid.tolist()):
        assert blocks[b, :n].all() and not blocks[b, n:].any()
    if N != 1024:
        assert (perm >= N).any()              # padded entries
    pp = TK.PackedFM(
        packed=None, obs_img=torch.as_tensor(obs_img), hppinv=None,
        img_perm=perm_t, img_block_starts=torch.as_tensor(bstarts),
        num_points=N, views=1, num_images=M, g=1, f_pad=0, pb=32,
        img_pos=pos, img_block_valid=valid)
    x = torch.as_tensor(rng.normal(0, 1, (N, 5)))
    ref = TE._image_sum_stack(pp, list(x.T))
    out = TK.image_sum_sorted_plain(pp, x)
    assert out.shape == (M, 5)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-12,
                               atol=1e-12)
    direct = np.zeros((M, 5))
    np.add.at(direct, obs_img, x.numpy())
    np.testing.assert_allclose(out.numpy(), direct, rtol=1e-12, atol=1e-12)


def test_fm_problem_carries_the_inverse_layout(small32):
    """fm_problem and to_view_major build img_pos / img_block_valid beside
    img_perm, and pack_fm hands them to the kernels."""
    ft = small32.ft
    N = ft.num_points * ft.views
    assert ft.img_pos.shape == (N,)
    np.testing.assert_array_equal(
        ft.img_perm.numpy()[ft.img_pos.numpy()], np.arange(N))
    assert int(ft.img_block_valid.sum()) == N
