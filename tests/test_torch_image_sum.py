"""The per-image sum of feature rows: the card's two-level order
(`kernels.image_sum_sorted_plain`, the plain model of csrc/image_sum.cu and
of K1's and K2's per-image pass) against the plain route that the CPU takes
(`engine._image_sum_stack` -> `engine._image_sum_plain`: a gather,
512-entry block sums, a cumsum difference), on the CPU.

Tolerances and why:
  * f64: rtol 1e-12 of each column's largest sum; the two routes add the
    same terms in other orders.
  * f32: within 2^-24 x (|c_lo| + |c_hi| + 2 (512 + b_m) S_m) for image m and
    column f, where S_m is the sum of |x| over the image's observations, b_m
    its blocks and c_lo, c_hi the running sums at its block bounds: either
    route adds no term of the image more than 512 + b_m times, and the
    cumsum difference also carries one rounding of the running sum over
    every earlier image at each end.
"""

import numpy as np
import pytest
import torch

from bundle_adjustment_tpu_torch.parallel import engine, kernels, rcs
from _torch_threads import one_torch_thread  # noqa: F401

#: every F the port's callers sum per image: the refinement's gradient (6),
#: the compact rows' rhs (10, 20 with the diagonal), the rig's product (16),
#: the reduction without (39) and with (99) the coupled rows at G = 10, the
#: covariance's assembly (81), and on a 4-camera rig's materialized global
#: columns (G = 40) the covariance's (261) and the coupled reduction's (279),
#: more than one launch's 128 rows
CALLER_F = (6, 10, 16, 20, 39, 81, 99, 261, 279)


def _layout(kind, seed=0):
    """(N, M, obs_image): observations over images, image-sorted blocked
    layout padded per image to 512 entries."""
    rng = np.random.default_rng(seed)
    if kind == "uneven":            # skewed image sizes, 30 images empty
        N, M = 3000, 130
        img = np.minimum(rng.integers(0, 100, N), rng.integers(0, 100, N))
    elif kind == "few":             # images of several blocks each
        N, M = 5000, 7
        img = rng.integers(0, M, N)
    elif kind == "whole_blocks":    # two images of exactly one block
        N, M = 1024, 2
        img = np.repeat(np.arange(2), 512)
    elif kind == "one_image":       # one image holds everything
        N, M = 2000, 3
        img = np.zeros(N, np.int64)
    else:                           # more images than observations per image
        N, M = 700, 130
        img = rng.integers(0, M, N)
    return N, M, img.astype(np.int32)


def _problem(kind):
    N, M, img = _layout(kind)
    perm, bstarts = rcs.build_image_block_layout(img, M)
    perm_t = torch.as_tensor(perm)
    pos, valid = engine.image_positions(perm_t, N)
    return kernels.PackedFM(
        packed=None, obs_img=torch.as_tensor(img), hppinv=None,
        img_perm=perm_t, img_block_starts=torch.as_tensor(bstarts),
        num_points=N, views=1, num_images=M, g=1, f_pad=0, pb=32,
        img_pos=pos, img_block_valid=valid), img


def _check(p, img, x, out, ref):
    """Hold the two-level order ``out`` against the stack path ``ref``."""
    if x.dtype == torch.float64:
        scale = ref.abs().amax(dim=-2, keepdim=True).clamp_min(1e-300)
        err = float(((out - ref).abs() / scale).max())
        assert err <= 1e-12, err
        return
    x64 = x.double()
    M = p.num_images
    s_m = torch.zeros((*x.shape[:-2], M, x.shape[-1]), dtype=torch.float64)
    s_m.index_add_(-2, torch.as_tensor(img).long(), x64.abs())
    # the running sums of the stack path's cumsum at each image's bounds
    run = torch.cumsum(torch.cat([torch.zeros_like(s_m[..., :1, :]),
                                  engine._image_sum_plain(p, list(
                                      x64.unbind(-1)))], dim=-2), dim=-2)
    blocks = (p.img_block_starts[1:] - p.img_block_starts[:-1]).double()
    tol = 2.0 ** -24 * (run[..., :-1, :].abs() + run[..., 1:, :].abs()
                        + 2 * (512 + blocks[:, None]) * s_m)
    gap = (out.double() - ref.double()).abs()
    assert bool((gap <= tol).all()), float((gap - tol).max())


@pytest.mark.parametrize("F", CALLER_F)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_two_level_order_matches_the_stack_path_at_every_callers_f(dtype, F):
    """At each caller's F, on skewed images (some empty): the card's order
    and the CPU's route agree (tolerances above)."""
    p, img = _problem("uneven")
    rng = np.random.default_rng(F)
    x = torch.as_tensor(rng.normal(0, 1, (img.shape[0], F))).to(dtype)
    out = kernels.image_sum_sorted_plain(p, x)
    ref = engine._image_sum_stack(p, list(x.T))
    assert out.shape == ref.shape == (p.num_images, F)
    _check(p, img, x, out, ref)


@pytest.mark.parametrize("kind", ["uneven", "few", "whole_blocks",
                                  "one_image", "sparse"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_two_level_order_matches_the_stack_path_with_leading_dims(dtype,
                                                                  kind):
    """Leading dimensions [2, 3] of the rows and the padded layouts: images
    of several blocks, of exactly one block, one image holding every
    observation, more images than observations per image; an image with no
    observation sums to 0."""
    p, img = _problem(kind)
    rng = np.random.default_rng(7)
    F = 16
    x = torch.as_tensor(rng.normal(0, 1, (2, 3, img.shape[0], F))).to(dtype)
    out = kernels.image_sum_sorted_plain(p, x)
    ref = engine._image_sum_stack(p, list(x.unbind(-1)))
    assert out.shape == ref.shape == (2, 3, p.num_images, F)
    _check(p, img, x, out, ref)
    empty = np.setdiff1d(np.arange(p.num_images), img)
    assert bool((out[..., empty, :] == 0).all())
    if dtype == torch.float64:
        direct = np.zeros((2, 3, p.num_images, F))
        np.add.at(direct, (slice(None), slice(None), img), x.numpy())
        np.testing.assert_allclose(out.numpy(), direct, rtol=1e-12,
                                   atol=1e-12 * np.abs(direct).max())


@pytest.mark.parametrize("F,dtype,lanes", [
    (6, torch.float32, 64), (16, torch.float64, 64), (81, torch.float64, 8),
    (99, torch.float32, 16), (128, torch.float64, 8), (1, torch.float64, 64)])
def test_block_sum_lanes_follow_the_kernels_columns(F, dtype, lanes):
    """The entry lanes of the card's block sum for F columns of ``dtype``
    (16-byte columns, at most 512 threads and 64 lanes), which the plain
    model takes by default; K1's six f32 terms give K1's 64 lanes."""
    cols = kernels.image_sum_columns(F, dtype) * (
        torch.finfo(dtype).bits // 8) // 16
    assert kernels.block_sum_lanes(cols) == lanes
    assert cols * lanes <= kernels.SUM_THREADS


def test_the_wrapper_takes_the_plain_route_on_the_cpu():
    """`image_sum_rows` on CPU rows is `engine._image_sum_plain` bit for
    bit and launches nothing; more rows than the kernel takes are fine
    there."""
    p, img = _problem("few")
    rows = list(torch.randn((kernels.MAX_IMAGE_SUM_ROWS + 1,
                             img.shape[0]), dtype=torch.float64))
    before = kernels.image_sum_rows.launches
    assert torch.equal(kernels.image_sum_rows(p, rows),
                       engine._image_sum_plain(p, rows))
    assert kernels.image_sum_rows.launches == before
