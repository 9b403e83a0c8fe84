"""The port's covariance recovery and LM step at config 5's visibility
(12 views per point among many images) against the JAX package on the CPU.

One problem, `bench.build_problem(1000, 200, 12, f64, seed=5)` padded to
1,024 points (u = 1,210): at 12 views in 200 images about a quarter of the
points see some image twice, so every recovery form must sum both views of
such a point (the JAX module's "exact for arbitrary visibility").  The JAX
side (linearise, S, S^{-1}, its dense-panel and row-gather recoveries, its
pair blocks) is computed once, in the module fixture.

Tolerances: f64, rtol 1e-9 with atol 1e-9 x max|reference|
(tests/test_torch_cov_direct.py's); the f64 LM step within 1e-6 x max|dx|
of the JAX step (tests/test_torch_slice.py's: both CG runs converge to
the same solution at cg_tol 1e-10).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import CPU, blocks_to_torch, np_
from bundle_adjustment_tpu.parallel import cov_direct as CJ
from bundle_adjustment_tpu.parallel import engine as E
from bundle_adjustment_tpu_torch import convert
from bundle_adjustment_tpu_torch.parallel import cov_direct as CT
from bundle_adjustment_tpu_torch.parallel import engine as TE
from _torch_threads import one_torch_thread  # noqa: F401

SHAPE = (1000, 200, 12)
SEED = 5
# 100 selected points: a count that chunk 7 does not divide
IDS = np.arange(3, 1003, 10)
CHUNK = 7


@pytest.fixture(scope="module")
def case():
    import bench

    problem, state, spec = bench.build_problem(*SHAPE, jnp.float64,
                                               seed=SEED)
    problem, state, _ = E.pad_problem(problem, state, multiple=64)
    fj = E.fm_problem(problem)
    bj = E.linearize(fj, state, spec, jnp.asarray(0.0))
    S = CJ.assemble_reduced_dense(fj, bj)
    Q = CJ.reduced_inverse(S)
    img = np.asarray(problem.obs_image).reshape(-1, SHAPE[2])[:SHAPE[0]]
    srt = np.sort(img, axis=1)
    dup = np.flatnonzero((srt[:, 1:] == srt[:, :-1]).any(axis=1))
    dup = dup[dup >= 3]                       # free points only
    pool = np.concatenate([[1, 1010], dup[:6], np.arange(100, 900, 100)])
    pairs = np.concatenate([np.stack([pool, pool], axis=1),
                            np.stack([pool, pool[::-1]], axis=1)[:-1]])
    ref = dict(
        S=S, Q=Q,
        dense=CJ.point_covariance_dense(fj, bj, Q),
        rows=CJ.point_covariance_dense(fj, bj, Q, chunk=64),
        sel=CJ.point_covariance_dense(fj, bj, Q, jnp.asarray(IDS), chunk=5),
        pairs=CJ.point_pair_covariance_dense(fj, bj, Q, pairs))
    ref = {k: np.array(v) for k, v in ref.items()}
    ft = TE.fm_problem(convert.problem_to_torch(problem, CPU, torch.float64))
    return dict(ft=ft, bt=blocks_to_torch(bj),
                st=convert.state_to_torch(state, CPU, torch.float64),
                spec=spec, ref=ref, dup=dup, pairs=pairs, problem=problem,
                state=state)


def _close(out, ref, rtol=1e-9, atol_scale=1e-9):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np_(out), ref, rtol=rtol,
                               atol=atol_scale * np.abs(ref).max())


def test_network_has_points_that_see_an_image_twice(case):
    assert case["ft"].num_points == 1024
    assert case["ref"]["S"].shape == (1210, 1210)
    assert 150 <= len(case["dup"]) <= 400


@pytest.mark.parametrize("branch", ["dense", "block_gather"])
@pytest.mark.parametrize("jax_form", ["dense", "rows"])
def test_all_points_each_branch_match_jax(case, branch, jax_form):
    """Every point by the dense panels (`point_covariance_panels`, the
    reference) and by the block gathers (`point_covariance_dense`) against
    the JAX dense panels and row gathers."""
    recover = (CT.point_covariance_panels if branch == "dense"
               else CT.point_covariance_dense)
    out = recover(case["ft"], case["bt"], torch.as_tensor(case["ref"]["Q"]))
    assert out.shape == (1024, 3, 3)
    _close(out, case["ref"][jax_form])


def test_selected_ids_with_a_remainder_chunk_match_jax(case):
    out = CT.point_covariance_dense(case["ft"], case["bt"],
                                    torch.as_tensor(case["ref"]["Q"]),
                                    point_ids=IDS, chunk=CHUNK)
    assert len(IDS) % CHUNK != 0
    _close(out, case["ref"]["sel"])
    _close(out, case["ref"]["dense"][IDS])


def test_sampled_dense_panels_match_all_points(case):
    """`point_covariance_panels` on chosen chunks (the chip check's sample)
    gives those chunks' rows of the all-points run."""
    Q = torch.as_tensor(case["ref"]["Q"])
    cd = CT.dense_recovery_chunk(1024, Q.shape[0])
    starts = [cd, 3 * cd] if 1024 // cd > 3 else [0]
    out = CT.point_covariance_panels(case["ft"], case["bt"], Q,
                                     starts=starts)
    ids = np.concatenate([np.arange(s, min(s + cd, 1024)) for s in starts])
    _close(out, case["ref"]["dense"][ids])


@pytest.mark.parametrize("chunk", [None, 3])
def test_chunked_pairs_match_jax(case, monkeypatch, chunk):
    """Pairs in `recovery_chunk`'s chunks (a target of 3 pairs' bytes
    leaves a remainder) against JAX; for p = q the pair block is
    C_p^T S^{-1} C_p, so adding Hpp^{-1} gives the point's own block."""
    pairs = case["pairs"]
    if chunk is not None:
        sized = CT.recovery_chunk

        def small(k, V, G, dtype):
            target = chunk * CT.recovery_bytes(V, G, 8)
            c = sized(k, V, G, dtype, target_bytes=target)
            assert c == chunk and k % c != 0
            return c

        monkeypatch.setattr(CT, "recovery_chunk", small)
    out = CT.point_pair_covariance_dense(case["ft"], case["bt"],
                                         torch.as_tensor(case["ref"]["Q"]),
                                         pairs)
    _close(out, case["ref"]["pairs"])
    same = pairs[:, 0] == pairs[:, 1]
    hinv = CT._hinv3(case["bt"])[torch.as_tensor(pairs[same, 0])]
    _close(out[torch.as_tensor(same)] + hinv,
           case["ref"]["dense"][pairs[same, 0]])


def test_cov_all_matches_jax(case):
    out = CT.cov_all(case["ft"], case["st"], case["spec"])
    assert out.dtype == torch.float64
    _close(out, case["ref"]["dense"])


@pytest.mark.parametrize("use_kernels", [False, True])
def test_lm_step_f64_matches_jax(case, use_kernels):
    """One f64 LM step at 200 images, on the plain path and through the
    kernels' plain versions (CPU tensors), against the JAX engine."""
    pb = 128
    fj = E.to_view_major(E.fm_problem(case["problem"]), pb)
    ft = TE.to_view_major(case["ft"], pb)
    lam = 1e-3
    dj = E.lm_step(fj, case["state"], case["spec"], jnp.asarray(lam),
                   cg_tol=1e-10, cg_maxiter=300)
    dt = TE.lm_step(ft, case["st"], case["spec"], lam, cg_tol=1e-10,
                    cg_maxiter=300, use_kernels=use_kernels)
    for a, b in zip(dj[:3], dt[:3]):
        a = np.asarray(a)
        np.testing.assert_allclose(np_(b), a, rtol=0,
                                   atol=1e-6 * np.max(np.abs(a)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("V,G", [(12, 10), (64, 10), (4, 40)])
def test_recovery_chunk_within_its_target(dtype, V, G):
    """recovery_chunk sizes the chunk by the block-gather form's bytes in
    the tensor's own dtype; a remainder chunk is allowed, so a prime count
    does not fall to chunks of one."""
    target = 4.0e8
    item = torch.empty((), dtype=dtype).element_size()
    per = CT.recovery_bytes(V, G, item)
    assert per >= (6 * V) ** 2 * item
    for k in (1_000_448, 1_000_003, 100):
        c = CT.recovery_chunk(k, V, G, dtype, target_bytes=target)
        assert 1 <= c <= k and c * per <= target
        assert c == min(k, 8192, int(target // per))
    assert (CT.recovery_chunk(10 ** 6, V, G, torch.float32)
            >= CT.recovery_chunk(10 ** 6, V, G, torch.float64))


@pytest.mark.parametrize("M", [7, 500, 5000])
def test_true_eo_is_look_at_wpk_bit_for_bit(M):
    """`synthetic.true_eo` for all images at once gives the values of
    `testing.look_at_wpk` image by image, bit for bit."""
    from bundle_adjustment_tpu_torch import synthetic
    from bundle_adjustment_tpu_torch.testing import look_at_wpk

    R = synthetic.FIELD * 2.0
    ref = np.zeros((M, 6))
    for m in range(M):
        ang = 2 * np.pi * m / M + 0.37 * (m % 5)
        radius = R * (0.7 + 0.12 * (m % 4))
        height = R * (0.5 + 0.2 * (m % 5))
        pos = np.array([radius * np.cos(ang), radius * np.sin(ang), height])
        w, p_, k = look_at_wpk(pos, np.zeros(3))
        ref[m] = [*pos, w, p_, k + (m % 4) * np.pi / 2]
    out = synthetic.true_eo(M)
    assert out.dtype == ref.dtype and out.tobytes() == ref.tobytes()


@pytest.mark.parametrize("cameras", [1, 3])
def test_predict_chunks_give_one_calls_bits(monkeypatch, cameras):
    """`synthetic.predict` in chunks (one that leaves a remainder) equals
    one call over all observations bit for bit, for one camera and a
    rig."""
    from bundle_adjustment_tpu_torch import synthetic

    rng = np.random.default_rng(12)
    P, M, V = 400, 40, 12
    spec = synthetic.scale_spec()
    pts = synthetic.true_points(P, seed=12)
    io = np.array([[0.02, -0.03, -30.0]]) + 0.01 * np.arange(
        cameras)[:, None] * np.array([1.0, -1.0, 30.0])
    dist = rng.normal(0, 1e-6, (cameras, spec.num_coefficients))
    eo = synthetic.true_eo(M)
    obs_point = np.repeat(np.arange(P, dtype=np.int32), V)
    obs_image = rng.integers(0, M, P * V).astype(np.int32)
    cam = (np.arange(M) % cameras).astype(np.int32)
    args = (pts, io, dist, eo, obs_point, obs_image, spec, cam)
    monkeypatch.setattr(synthetic, "PREDICT_CHUNK", 10 ** 9)
    whole = synthetic.predict(*args)
    monkeypatch.setattr(synthetic, "PREDICT_CHUNK", 1000)
    assert (P * V) % 1000 != 0
    chunked = synthetic.predict(*args)
    assert chunked.shape == (P * V, 2)
    assert chunked.tobytes() == whole.tobytes()


@pytest.mark.parametrize("M", [5000, 40_000])
def test_image_block_layout_matches_a_wide_key_stable_sort(M):
    """The image-block layout from 16-bit sort keys (M <= 32,768) equals
    the one from a stable sort of the 64-bit image ids."""
    from bundle_adjustment_tpu_torch.parallel import rcs

    obs_image = np.random.default_rng(M).integers(0, M, 60_000).astype(
        np.int32)
    perm, starts = rcs.build_image_block_layout(obs_image, M, block=64)
    order = np.argsort(obs_image.astype(np.int64), kind="stable")
    counts = np.bincount(obs_image, minlength=M)
    pad = -(-counts // 64) * 64
    first = np.concatenate([[0], np.cumsum(pad)])
    ref = np.full(int(first[-1]), obs_image.shape[0], np.int32)
    src = np.concatenate([[0], np.cumsum(counts)])
    for m in range(M):
        ref[first[m]:first[m] + counts[m]] = order[src[m]:src[m + 1]]
    assert np.array_equal(perm, ref)
    assert np.array_equal(starts, (first // 64).astype(np.int32))
