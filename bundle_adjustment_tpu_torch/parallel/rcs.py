"""Reduced camera system of the large-scale solver (PyTorch port of
`bundle_adjustment_tpu/parallel/rcs.py`): the problem container and its
two layouts, the block-layout engine, the (coupled) block preconditioner,
PCG on the implicit Schur complement and the state update.

Eliminating the points from the bundle normal equations gives the reduced
system over x = (cameras, globals)

    S x = rhs,   S = Hxx - Hxp Hpp^{-1} Hpx,   rhs = bx - Hxp Hpp^{-1} bp

whose product is computed implicitly from per-observation Jacobian blocks
and solved by PCG.

Layouts of the observations (`rcs_from_problem(layout=...)`):

* ``"point_major"``: every point padded to the views of the most-viewed
  one (zero-weight pad rows), ``point_uniform`` = that count: the layout
  of the feature-major engine (`engine.py`) and of the CUDA kernels K1
  and K2.  P x Vmax rows.
* ``"file"``: the observations as given (`compile_problem` or file
  order), any number of views per point, ``point_uniform`` None: the
  layout of the block-layout engine below (`linearize` .. `lm_step_full`).
  N rows.

The block-layout engine holds per-observation blocks [N, 2, k] (`Blocks`)
and sums them per point and per image in a fixed order, with no atomics
on CUDA: per point by a point-sorted permutation made once on the host
(``point_order`` / ``point_counts``) and `torch.segment_reduce` (one
sequential sum per point), per image by the blocked image layout
(``img_perm``: 512-row block sums, then a cumsum difference).  The EO
gathers of `linearize` and `back_substitute_points` can go through the
K3 kernel (``cam_gather=``, `kernels.make_cam_gather`).  JAX's dense
visibility tables (``point2obs`` / ``img2obs``) are not ported: they
bring back P x Vmax index memory.

Spans (`solver.tracing`, no-ops outside a recording): the engine's
entry points carry the feature-major engine's names (``linearize``,
``prepare``, ``lm_step``, ``back_substitute``), its per-point and
per-image sums ``rcs.point_sum`` / ``rcs.image_sum`` (run on every CG
iteration: `tracing.traced` tests ``tracing.ACTIVE`` before anything
else).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.problem import ParamState
from ..ops.residuals import image_weight_2x2
from ..solver import tracing


class RCSProblem(NamedTuple):
    """Static arrays of the large-scale problem: numpy arrays on the host
    (as `synthetic.build_problem` returns them) or tensors on a device
    (`convert.problem_to_torch`).  Datum: fixed coordinates (free_* masks).
    """

    obs_point: object      # [N] int32
    obs_image: object      # [N] int32
    obs_xy: object         # [N, 2]
    obs_weight: object     # [N, 2, 2] (already includes validity mask)
    r0: object             # [C]
    num_points: int
    num_images: int
    free_point: object     # [P, 3] 1.0 = free, 0.0 = fixed
    free_eo: object        # [M, 6]
    free_global: object    # [G] with G = C * (3 + K)
    # blocked image-reduction layout: permutation into image-sorted order
    # padded per image to a multiple of IMG_BLOCK (pad entries == N)
    img_perm: object = None         # [Nip] int32
    img_block_starts: object = None  # [M+1] int32 (block units)
    # uniform views per point in point-major order (static int)
    point_uniform: int | None = None
    # camera of each image (None: every image on camera 0, C = 1 only)
    cam_of_image: object = None     # [M] int32
    # ---- free-network extensions (parallel/freenet.py) ----
    # scale bars: rank-1 rows over two points, folded into the reduced
    # system by Woodbury
    sb_a: object = None       # [S] int32
    sb_b: object = None       # [S] int32
    sb_length: object = None  # [S]
    sb_weight: object = None  # [S] sigma0^2 / sigma_s^2
    # Helmert inner constraints
    datum_mask_d: object = None          # [P] 1.0 = datum point
    defect_flags_d: tuple | None = None  # 7 bools (tx ty tz rx ry rz s)
    # directly observed parameters with diagonal weights; weight 0 = not
    # observed
    dp_w: object = None    # [P, 3]
    dp_val: object = None  # [P, 3]
    de_w: object = None    # [M, 6]
    de_val: object = None  # [M, 6]
    dg_w: object = None    # [G]
    dg_val: object = None  # [G]
    # directly observed point coordinates with a fully populated
    # dispersion: n coordinates (point, axis) with the cofactor block
    # dpg_cov = Sigma / sigma0^2 = W^{-1}, folded as exact low-rank rows
    dpg_idx: object = None   # [n] int32 point ids
    dpg_axis: object = None  # [n] int32 axis (0/1/2)
    dpg_val: object = None   # [n] observed values
    dpg_cov: object = None   # [n, n]
    # file-order layout (point_uniform None): the observations sorted
    # stably by point, and each point's count (`point_segments`), made
    # once on the host; None = computed at each per-point sum
    point_order: object = None   # [N] int64
    point_counts: object = None  # [P] int64

    @property
    def has_extras(self) -> bool:
        """Scale bars, inner constraints or a populated direct group
        present (the `engine.lm_step_full` route)."""
        return ((self.sb_a is not None and int(self.sb_a.shape[0]) > 0)
                or (self.defect_flags_d is not None
                    and any(self.defect_flags_d))
                or (self.dpg_idx is not None
                    and int(self.dpg_idx.shape[0]) > 0))


#: block size of the image-sorted blocked reduction
IMG_BLOCK = 512


def build_image_block_layout(obs_image, num_images, block=IMG_BLOCK):
    """Host-side: permutation into image-sorted order with per-image padding
    to a multiple of ``block``; returns (img_perm [Nip], img_block_starts
    [M+1] in block units), both int32 numpy."""
    obs_image = np.asarray(obs_image)
    N = obs_image.shape[0]
    # a stable sort has one result; numpy sorts 16-bit keys by radix
    # sort, ~5x faster than 32-bit ones at 12M observations
    key = (obs_image.astype(np.int16) if num_images <= 1 << 15
           else obs_image)
    order = np.argsort(key, kind="stable")
    counts = np.bincount(obs_image, minlength=num_images)
    padded = ((counts + block - 1) // block) * block
    starts = np.concatenate([[0], np.cumsum(padded)])
    perm = np.full(int(starts[-1]), N, np.int32)
    src = 0
    for m in range(num_images):
        c = int(counts[m])
        perm[starts[m]:starts[m] + c] = order[src:src + c]
        src += c
    return perm, (starts // block).astype(np.int32)


class PointMajor(NamedTuple):
    """The uniform point-major layout of observations given in any order
    (`point_major_layout`): entry e = point * views + view."""

    src: np.ndarray   # [P * V] int64 the observation entry e takes, -1 none
    live: np.ndarray  # [P * V] bool: one of the point's own observations
    views: int        # V

    def gather(self, a, fill):
        """a [N, ...] in the observations' order -> [P * V, ...] in the
        layout's; ``fill`` where a point has no observation at all."""
        a = np.asarray(a)
        seen = (self.src >= 0).reshape((-1,) + (1,) * (a.ndim - 1))
        return np.where(seen, a[np.maximum(self.src, 0)], fill)


def point_major_layout(obs_point, num_points) -> PointMajor:
    """The layout the feature-major engine reads, for observations of
    points ``obs_point`` [N] in any order: V = the most views any point
    has (at least 1), each point's own observations first, in their
    order, then pad entries that repeat its first observation (none for
    a point no image sees).  The callers give pad entries zero weight."""
    obs_point = np.asarray(obs_point, np.int64)
    P = int(num_points)
    counts = np.bincount(obs_point, minlength=P)
    V = max(int(counts.max()) if counts.size else 0, 1)
    order = np.argsort(obs_point, kind="stable")
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    view = np.arange(obs_point.shape[0]) - first[obs_point[order]]
    src = np.full((P, V), -1, np.int64)
    src[obs_point[order], view] = order
    real = src >= 0
    fill = np.where(counts > 0, src[:, 0], -1)
    src = np.where(real, src, fill[:, None]).reshape(-1)
    return PointMajor(src=src, live=real.reshape(-1), views=V)


#: the observation layouts of `rcs_from_problem` (module docstring)
LAYOUTS = ("file", "point_major")


def choose_layout(obs_point, num_points) -> str:
    """The layout rule of ``layout=None``: ``"point_major"`` where padding
    every point to the most views any point has costs at most twice the
    rows (P x Vmax <= 2 N), else ``"file"``."""
    counts = np.bincount(np.asarray(obs_point, np.int64),
                         minlength=int(num_points))
    vmax = max(int(counts.max()) if counts.size else 0, 1)
    n = int(np.asarray(obs_point).shape[0])
    return "point_major" if int(num_points) * vmax <= 2 * n else "file"


def point_order(obs_point, num_points):
    """Host-side: (order [N] int64, the observations sorted stably by
    point; counts [P] int64, each point's observations), numpy."""
    obs_point = np.asarray(obs_point, np.int64)
    return (np.argsort(obs_point, kind="stable"),
            np.bincount(obs_point, minlength=int(num_points)))


def check_layout(layout):
    """Raise ValueError for a layout that is not one of `LAYOUTS`."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS} or None, "
                         f"not {layout!r}")


def rcs_from_problem(bp, device, dtype=torch.float64,
                     layout: str | None = None) -> RCSProblem:
    """The tensor RCSProblem of a compiled dense `models.problem.BundleProblem`
    on ``device``, in one of the `LAYOUTS` (None: `choose_layout`).

    ``"file"``: the JAX `rcs.rcs_from_problem` layout (without its dense
    visibility tables): the observations in `compile_problem` order,
    ``point_uniform`` None, the point order (`point_order`) and the
    blocked image layout; the block-layout engine reads it.

    ``"point_major"``: the layout the feature-major engine reads:
    observations point-major with a uniform V = the most views any point
    has, each point's own observations first (in their order), then
    zero-weight pad rows that repeat its first observation (image 0 at
    (0, 0) for a point no image sees); and the blocked image layout.  Zero
    weights null every pad row's contribution, so the sums are those of
    the observations alone.

    Carried over as in the JAX `rcs.rcs_from_problem`: scale bars, the
    inner-constraint datum (``datum_mask_d`` = the problem's datum points,
    its defect flags) and every direct observation: diagonal weights fold
    into dp / de / dg; a group with a fully populated dispersion over point
    coordinates becomes dpg rows.  A populated dispersion over IO / EO /
    distortion parameters raises ValueError, as in the reference."""
    P, M, C = bp.num_points, bp.num_images, bp.num_cameras
    K = bp.spec.num_coefficients
    if layout is None:
        layout = choose_layout(bp.obs_point, P)
    check_layout(layout)

    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    def flt(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device,
                               dtype=dtype)

    free_global = np.concatenate(
        [np.concatenate([bp.col_io[c] >= 0, bp.col_dist[c] >= 0])
         for c in range(C)]).astype(np.float64)
    fields = {}
    if bp.num_scale_bars:
        fields.update(sb_a=idx(bp.sb_a), sb_b=idx(bp.sb_b),
                      sb_length=flt(bp.sb_length),
                      sb_weight=flt(bp.sigma2_apriori / bp.sb_var))
    if bp.defect > 0:
        fields.update(datum_mask_d=flt(bp.datum_mask),
                      defect_flags_d=tuple(bool(f) for f in bp.defect_flags))
    if bp.direct_groups:
        fields.update(_direct_fields(bp, C, K, idx, flt))
    common = dict(
        r0=flt(bp.r0), num_points=P, num_images=M,
        free_point=flt(bp.col_points >= 0), free_eo=flt(bp.col_eo >= 0),
        free_global=flt(free_global), cam_of_image=idx(bp.cam_of_image),
        **fields)

    if layout == "file":
        w2 = image_weight_2x2(flt(bp.obs_var[:, 0]), flt(bp.obs_var[:, 1]),
                              flt(bp.obs_rho), bp.sigma2_apriori)
        img_perm, img_bstarts = build_image_block_layout(bp.obs_image, M)
        order, counts = point_order(bp.obs_point, P)
        return RCSProblem(
            obs_point=idx(bp.obs_point), obs_image=idx(bp.obs_image),
            obs_xy=flt(bp.obs_xy), obs_weight=w2,
            img_perm=idx(img_perm), img_block_starts=idx(img_bstarts),
            point_uniform=None,
            point_order=torch.as_tensor(order, device=device),
            point_counts=torch.as_tensor(counts, device=device), **common)

    pm = point_major_layout(bp.obs_point, P)
    obs_image = pm.gather(bp.obs_image, 0).astype(np.int32)
    var = flt(pm.gather(bp.obs_var, 1.0))
    w2 = image_weight_2x2(var[:, 0], var[:, 1],
                          flt(pm.gather(bp.obs_rho, 0.0)), bp.sigma2_apriori)
    w2 = w2 * flt(pm.live)[:, None, None]
    img_perm, img_bstarts = build_image_block_layout(obs_image, M)
    V = pm.views
    return RCSProblem(
        obs_point=idx(np.repeat(np.arange(P), V)), obs_image=idx(obs_image),
        obs_xy=flt(pm.gather(bp.obs_xy, 0.0)), obs_weight=w2,
        img_perm=idx(img_perm), img_block_starts=idx(img_bstarts),
        point_uniform=V, **common)


def to_point_major(problem: RCSProblem) -> RCSProblem:
    """A file-order tensor RCSProblem re-laid point-major and padded
    (`point_major_layout`: pad rows repeat the point's first observation,
    with zero weight), with its blocked image layout: the same network in
    the layout the feature-major engine reads.  Per-point and per-image
    fields are unchanged.  No entry point calls it: padding a file-order
    problem is the caller's choice."""
    if problem.point_uniform is not None:
        raise ValueError("the problem is point-major already")
    dev = problem.obs_xy.device
    P, M = problem.num_points, problem.num_images
    pm = point_major_layout(problem.obs_point.cpu().numpy(), P)
    src = torch.as_tensor(np.maximum(pm.src, 0), device=dev)
    live = torch.as_tensor(pm.live, device=dev)
    seen = torch.as_tensor(pm.src >= 0, device=dev)
    obs_image = torch.where(seen, problem.obs_image[src], 0).to(torch.int32)
    img_perm, img_bstarts = build_image_block_layout(obs_image.cpu().numpy(),
                                                     M)
    w = problem.obs_weight[src] * live.to(problem.obs_weight.dtype)[
        :, None, None]
    return problem._replace(
        obs_point=torch.arange(P, dtype=torch.int32, device=dev)
        .repeat_interleave(pm.views),
        obs_image=obs_image, obs_xy=problem.obs_xy[src], obs_weight=w,
        img_perm=torch.as_tensor(img_perm, device=dev),
        img_block_starts=torch.as_tensor(img_bstarts, device=dev),
        point_uniform=pm.views, point_order=None, point_counts=None)


def _direct_fields(bp, C, K, idx, flt) -> dict:
    """dp / de / dg (diagonal weights) and dpg (populated point groups) of
    a BundleProblem's direct groups."""
    G = C * (3 + K)
    dp_w, dp_val = np.zeros((bp.num_points, 3)), np.zeros((bp.num_points, 3))
    de_w, de_val = np.zeros((bp.num_images, 6)), np.zeros((bp.num_images, 6))
    dg_w, dg_val = np.zeros(G), np.zeros(G)
    dpg_idx, dpg_axis, dpg_val, dpg_cov = [], [], [], []
    for dg in bp.direct_groups:
        if not dg.diagonal:
            if not (dg.kind == 0).all():
                raise ValueError(
                    "fully populated direct-observation dispersion over "
                    "IO/EO/distortion parameters is the dense solver's "
                    "domain (DirectlyObservedParameterGroup.java:67-92); "
                    "at scale only point-coordinate groups are supported")
            # weight = sigma0^2 Sigma^{-1}; freenet takes W^{-1}
            dpg_idx.append(dg.flat // 3)
            dpg_axis.append(dg.flat % 3)
            dpg_val.append(dg.values)
            dpg_cov.append(np.linalg.inv(dg.weight))
            continue
        for kind, flat, wv, val in zip(dg.kind, dg.flat,
                                       np.diagonal(dg.weight), dg.values):
            if kind == 0:
                dp_w.flat[flat] += wv
                dp_val.flat[flat] = val
            elif kind == 3:
                de_w.flat[flat] += wv
                de_val.flat[flat] = val
            elif kind == 1:  # io: per-camera global slot
                c, k = divmod(int(flat), 3)
                dg_w[c * (3 + K) + k] += wv
                dg_val[c * (3 + K) + k] = val
            else:  # dist
                c, k = divmod(int(flat), K)
                dg_w[c * (3 + K) + 3 + k] += wv
                dg_val[c * (3 + K) + 3 + k] = val
    out = {}
    if dp_w.any():
        out.update(dp_w=flt(dp_w), dp_val=flt(dp_val))
    if de_w.any():
        out.update(de_w=flt(de_w), de_val=flt(de_val))
    if dg_w.any():
        out.update(dg_w=flt(dg_w), dg_val=flt(dg_val))
    if dpg_idx:
        n = sum(len(i) for i in dpg_idx)
        cov = np.zeros((n, n))
        o = 0
        for blk in dpg_cov:
            cov[o:o + blk.shape[0], o:o + blk.shape[0]] = blk
            o += blk.shape[0]
        out.update(dpg_idx=idx(np.concatenate(dpg_idx)),
                   dpg_axis=idx(np.concatenate(dpg_axis)),
                   dpg_val=flt(np.concatenate(dpg_val)), dpg_cov=flt(cov))
    return out


class Precond(NamedTuple):
    """Block preconditioner of the reduced system: exact 6x6 camera blocks
    plus the exact global block.  With ``Scg``/``W``/``Sghat_inv`` set, it
    also carries the exact camera-global blocks and is applied exactly via
    a Schur complement on the small global block:

        u  = D^{-1} rc
        zg = (Sgg - Scg^T D^{-1} Scg)^{-1} (rg - Scg^T u)
        zc = u - (D^{-1} Scg) zg
    """

    Minv_c: torch.Tensor                  # [M, 6, 6]
    Minv_g: torch.Tensor                  # [G, G]
    Scg: torch.Tensor | None = None       # [M, 6, G]
    W: torch.Tensor | None = None         # [M, 6, G]  (= D^{-1} Scg)
    Sghat_inv: torch.Tensor | None = None  # [G, G]


def _psum(comm, x):
    return x if comm is None else comm.psum(x)


#: apply the preconditioner blocks with elementwise multiply-sums instead
#: of einsums (`exact_preconditioner`); off by default
_EXACT_APPLY = False


class exact_preconditioner:
    """Context manager: the preconditioners built and applied inside it
    (`finish_coupling`, `make_apply_M`) take elementwise multiply-sums
    instead of einsums, as the JAX context manager of the same name does
    (there it avoids the TPU's bf16 matmul passes; here it only fixes
    the order of the small sums)."""

    def __enter__(self):
        global _EXACT_APPLY
        self._old = _EXACT_APPLY
        _EXACT_APPLY = True
        return self

    def __exit__(self, *exc):
        global _EXACT_APPLY
        _EXACT_APPLY = self._old
        return False


def finish_coupling(Minv: Precond, Scg, Sgg, comm_cam=None) -> Precond:
    """Complete a coupled `Precond` from the exact Scg [M, 6, G] and Sgg
    [G, G] blocks: W = D^{-1} Scg and the inverse of the global Schur
    complement Sghat = Sgg - Scg^T D^{-1} Scg.  ``comm_cam``: a
    `sharding.Comm` when the camera rows are sharded over its ranks
    (tensor-parallel mode): the sum over images is psum-ed, so every rank
    holds the same Sghat^{-1}."""
    if _EXACT_APPLY:
        W = (Minv.Minv_c[:, :, :, None] * Scg[:, None, :, :]).sum(dim=2)
        corr = _psum(comm_cam, (Scg[:, :, :, None]
                                * W[:, :, None, :]).sum(dim=(0, 1)))
    else:
        W = torch.einsum("mab,mbg->mag", Minv.Minv_c, Scg)
        corr = _psum(comm_cam, torch.einsum("mag,mah->gh", Scg, W))
    return Minv._replace(Scg=Scg, W=W,
                         Sghat_inv=torch.linalg.inv_ex(Sgg - corr)[0])


def definite_coupling(Minv: Precond) -> Precond:
    """``Minv`` where its global Schur complement Sghat is positive definite
    (a Cholesky of the symmetrised Sghat^{-1} succeeds), else the
    block-Jacobi `Precond` of the same camera and global blocks.  The
    coupled preconditioner keeps the camera-global blocks and drops the
    camera-camera ones, so its Sghat can be indefinite (on camera rigs,
    and for one camera on small networks), and PCG has no convergence
    guarantee with an indefinite preconditioner.  One G x G Cholesky and
    one host read."""
    Sh = Minv.Sghat_inv
    if int(torch.linalg.cholesky_ex((Sh + Sh.T) / 2).info) != 0:
        return Precond(Minv_c=Minv.Minv_c, Minv_g=Minv.Minv_g)
    return Minv


def make_apply_M(Minv: Precond, comm_cam=None):
    """Preconditioner apply (zc, zg) = M^{-1} (rc, rg) of a `Precond`:
    the exact coupled form when it carries Scg, else block-diagonal.  An
    apply that is already a callable (`freenet.wrap_precond`) passes
    through.  ``comm_cam``: camera rows sharded over ranks (the coupled
    form's Scg^T u is psum-ed)."""
    if callable(Minv):
        return Minv
    if _EXACT_APPLY and Minv.Scg is not None:
        def apply_M(rc_, rg_):
            u = (Minv.Minv_c * rc_[:, None, :]).sum(dim=2)
            zg = Minv.Sghat_inv @ (rg_ - _psum(
                comm_cam, (Minv.Scg * u[:, :, None]).sum(dim=(0, 1))))
            zc = u - (Minv.W * zg[None, None, :]).sum(dim=2)
            return zc, zg
    elif _EXACT_APPLY:
        def apply_M(rc_, rg_):
            return ((Minv.Minv_c * rc_[:, None, :]).sum(dim=2),
                    Minv.Minv_g @ rg_)
    elif Minv.Scg is not None:
        def apply_M(rc_, rg_):
            u = torch.einsum("mab,mb->ma", Minv.Minv_c, rc_)
            zg = Minv.Sghat_inv @ (rg_ - _psum(
                comm_cam, torch.einsum("mag,ma->g", Minv.Scg, u)))
            zc = u - torch.einsum("mag,g->ma", Minv.W, zg)
            return zc, zg
    else:
        def apply_M(rc_, rg_):
            return (_per_item(lambda a, r: torch.einsum("mab,mb->ma", a, r),
                              Minv.Minv_c, rc_),
                    _per_item(torch.matmul, Minv.Minv_g, rg_))
    return apply_M


#: replays of the captured CG iteration per host read of the stop (`pcg`
#: on the card); 4 and 16 timed no better in the adjustment benchmarks
CG_CHUNK = 8


class _CG(NamedTuple):
    """The CG loop's state, every field a tensor on the solve's device:
    the iterate, the best-residual iterate, residual, direction, r^T z,
    |r|_2, the best |r|_2, the stall count, the iterations (int32) and
    ``done``, the loop's stop (the negation of the reference's ``cond``)."""

    xc: torch.Tensor
    xg: torch.Tensor
    bxc: torch.Tensor
    bxg: torch.Tensor
    rc: torch.Tensor
    rg: torch.Tensor
    pc: torch.Tensor
    pg: torch.Tensor
    rz: torch.Tensor
    rnorm: torch.Tensor
    best: torch.Tensor
    stall: torch.Tensor
    it: torch.Tensor
    done: torch.Tensor | None


class _Loop(NamedTuple):
    """What the CG iterations share: the products, and the stopping test's
    bounds (``limit`` = tol (1 + |r0|_2), a tensor in the residual's
    dtype)."""

    matvec: object
    apply_M: object
    dot: object
    limit: torch.Tensor
    maxiter: int
    stall_limit: int


def _cond(c: _CG, k: _Loop):
    """The reference's ``cond``, compared in the residual's dtype."""
    return ((c.it < k.maxiter) & (c.stall < k.stall_limit)
            & (c.rnorm > k.limit))


def _cg_start(rc, rg, Minv, matvec, tol, maxiter, stall_limit, comm_cam):
    """(carry, loop) at the zero iterate; every field of the carry is a
    tensor of its own (the masked iteration writes them in place)."""
    apply_M = make_apply_M(Minv, comm_cam=comm_cam)

    def dot(ac, ag, bc_, bg_):
        return _psum(comm_cam, torch.sum(ac * bc_)) + torch.sum(ag * bg_)

    if stall_limit is None:
        stall_limit = 8 if rc.dtype == torch.float32 else maxiter + 1
    zc, zg = apply_M(rc, rg)
    r0norm = torch.sqrt(dot(rc, rg, rc, rg))
    zero = torch.zeros((), dtype=torch.int32, device=rc.device)
    c = _CG(xc=torch.zeros_like(rc), xg=torch.zeros_like(rg),
            bxc=torch.zeros_like(rc), bxg=torch.zeros_like(rg),
            rc=rc.clone(), rg=rg.clone(), pc=zc, pg=zg,
            rz=dot(rc, rg, zc, zg), rnorm=r0norm, best=r0norm.clone(),
            stall=zero, it=zero.clone(), done=None)
    k = _Loop(matvec=matvec, apply_M=apply_M, dot=dot,
              limit=tol * (1.0 + r0norm), maxiter=maxiter,
              stall_limit=stall_limit)
    return c._replace(done=~_cond(c, k)), k


def _cg_iteration(c: _CG, k: _Loop, masked: bool) -> _CG:
    """One iteration of the reference's ``while_loop`` body
    (`bundle_adjustment_tpu/parallel/rcs.py` pcg) from the carry ``c``.

    Unmasked (``c`` not done): returns the next carry.  Masked: writes
    the next carry into ``c`` in place where ``c`` was not done and keeps
    ``c`` where it was, by selection (``torch.where``), so a stopped
    loop stays stopped with the bits it had, even where the body divides
    0 by 0; returns ``c``.  Nothing is read on the host."""
    qc, qg = k.matvec(c.pc, c.pg)
    alpha = c.rz / k.dot(c.pc, c.pg, qc, qg)
    xc = c.xc + alpha * c.pc
    xg = c.xg + alpha * c.pg
    rc = c.rc - alpha * qc
    rg = c.rg - alpha * qg
    zc, zg = k.apply_M(rc, rg)
    rz = k.dot(rc, rg, zc, zg)
    beta = rz / c.rz
    pc = zc + beta * c.pc
    pg = zg + beta * c.pg
    rnorm = torch.sqrt(k.dot(rc, rg, rc, rg))
    # the best-residual iterate: long f32 runs can wander (or blow up to
    # NaN) past the rounding floor
    is_best = rnorm < c.best
    improved = rnorm < 0.9 * c.best
    n = _CG(xc=xc, xg=xg, bxc=torch.where(is_best, xc, c.bxc),
            bxg=torch.where(is_best, xg, c.bxg), rc=rc, rg=rg, pc=pc,
            pg=pg, rz=rz, rnorm=rnorm,
            best=torch.where(is_best, rnorm, c.best),
            stall=torch.where(improved, 0, c.stall + 1), it=c.it + 1,
            done=None)
    if not masked:
        return n._replace(done=~_cond(n, k))
    for new, old in zip(n[:-1], c[:-1]):
        torch.where(c.done, old, new, out=old)
    torch.logical_not(_cond(c, k), out=c.done)
    return c


def _cg_chunks(c: _CG, run_chunk) -> int:
    """Run ``run_chunk`` (which advances ``c`` in place by `CG_CHUNK`
    masked iterations) until ``c`` is done; one host read of ``done``
    per chunk.  Returns the chunks run."""
    chunks = 0
    while not bool(c.done):
        run_chunk()
        chunks += 1
    return chunks


#: per device: the side stream the loop body is captured on, and the last
#: graph captured there, kept so that the next capture draws on its memory
#: pool instead of allocating a new one
_CAPTURE = {}


def _cg_graph(c: _CG, k: _Loop):
    """The card's route from the start carry ``c`` (not done): one
    iteration runs eagerly on the capture stream (the warm-up a capture
    needs: library workspaces, the kernels' shared-memory limits), then
    one masked iteration is captured into a CUDA graph, and the graph is
    replayed `CG_CHUNK` times on the current stream per read of ``done``
    until a read says stop.  Returns (carry, chunks)."""
    from . import kernels

    dev = c.rc.device
    side, last = _CAPTURE.get(dev) or (torch.cuda.Stream(dev), None)
    main = torch.cuda.current_stream()
    # cuBLAS keeps a workspace per stream it has run on: freed on both
    # sides of the call, the capture stream's takes the place of the
    # current stream's instead of adding a second
    torch._C._cuda_clearCublasWorkspaces()
    side.wait_stream(main)
    try:
        with torch.cuda.stream(side):
            c = _cg_iteration(c, k, masked=False)
            if bool(c.done):
                main.wait_stream(side)
                return c, 0
            before = kernels.launch_counts()
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=None if last is None else last.pool(),
                                capture_error_mode="thread_local")
            try:
                _cg_iteration(c, k, masked=True)
            finally:
                graph.capture_end()
        _CAPTURE[dev] = (side, graph)
        main.wait_stream(side)

        def chunk():
            for _ in range(CG_CHUNK):
                graph.replay()

        chunks = 0
        try:
            chunks = _cg_chunks(c, chunk)
        finally:
            kernels.count_replays(before, CG_CHUNK * chunks)
        return c, chunks
    finally:
        torch._C._cuda_clearCublasWorkspaces()


def _graph_route(rc, Minv, matvec, comm_cam) -> bool:
    """Whether `pcg` replays its loop body as a CUDA graph: CUDA tensors,
    no collectives, a `Precond`, and a matvec that its builder marked
    ``capturable`` (`kernels.make_matvec`, and the plain products of
    `engine.lm_step` and `refine.Refiner`; a product wrapped by
    `freenet.wrap_matvec` carries no mark)."""
    return (rc.is_cuda and comm_cam is None and isinstance(Minv, Precond)
            and getattr(matvec, "capturable", False))


def pcg(rc, rg, Minv, matvec, tol=1e-10, maxiter=200, stall_limit=None,
        comm_cam=None):
    """Preconditioned CG on the implicit reduced system.

    ``matvec(xc, xg) -> (Sc, Sg)`` is the implicit Schur product;
    ``Minv`` a `Precond` or a callable apply (rc, rg) -> (zc, zg).
    Returns the best-residual iterate (long f32 runs can wander past the
    rounding floor) and the iteration count.  ``stall_limit``: stop once
    no iteration in a window of this many improves the best residual by
    >= 10%; default 8 for f32, disabled for f64.  Where no iterate
    lowers |r|_2 below the first residual, the best iterate is the zero
    start.

    The loop is the JAX reference's ``while_loop``: its state and its
    stopping test live on the device (`_CG`), compared in the residual's
    dtype.  On the card, where ``rc`` is a CUDA tensor, ``comm_cam`` is
    None, ``Minv`` a `Precond` and ``matvec`` marked ``capturable`` (an
    attribute that `kernels.make_matvec`, `engine.lm_step` and the
    `refine.Refiner` step, in f32 and in f64, set on the single-device
    products they build), one masked iteration is captured as a CUDA
    graph, replayed `CG_CHUNK` times per host read of the stop
    (`_cg_graph`); up to `CG_CHUNK` - 1 replays may run past the stop,
    masked, which change nothing.  Every other call runs the same body
    one iteration at a time and reads the stop after each.

    ``comm_cam``: a `sharding.Comm` when rc / xc hold only this rank's
    image rows (tensor-parallel mode): the sums over images (the dots, the
    coupled preconditioner's Scg^T u) are psum-ed, so every rank takes the
    same steps and stops together.

    A span ``pcg`` (`solver.tracing`) holds the call and counts, once at
    the end, its ``iterations``, the graph ``replays``, the iterations
    that counted among them (``graph_iterations``) and the ``masked``
    rest (0, 0 and 0 off the graph route)."""
    with tracing.span("pcg"):
        c, k = _cg_start(rc, rg, Minv, matvec, tol, maxiter, stall_limit,
                         comm_cam)
        chunks = 0
        if _graph_route(rc, Minv, matvec, comm_cam) and not bool(c.done):
            c, chunks = _cg_graph(c, k)
            it = int(c.it)
        else:
            it = 0
            while not bool(c.done):
                c = _cg_iteration(c, k, masked=False)
                it += 1
        graph_it = it - 1 if chunks else 0
        tracing.count("iterations", it)
        tracing.count("replays", CG_CHUNK * chunks)
        tracing.count("graph_iterations", graph_it)
        tracing.count("masked", CG_CHUNK * chunks - graph_it)
    return c.bxc, c.bxg, it


# ---------------------------------------------------------------------------
# the block-layout engine
# ---------------------------------------------------------------------------

class Blocks(NamedTuple):
    """Linearisation of the block-layout engine: per-observation blocks
    [N, 2, k] and the per-point / per-image / global sums."""

    Jp: torch.Tensor       # [N, 2, 3]
    Jc: torch.Tensor       # [N, 2, 6]
    Jg: torch.Tensor       # [N, 2, G] (masked per camera where C > 1)
    PJp: torch.Tensor      # [N, 2, 3]  P-weighted blocks
    PJc: torch.Tensor      # [N, 2, 6]
    PJg: torch.Tensor      # [N, 2, G]
    P2: torch.Tensor       # [N, 2, 2]
    w: torch.Tensor        # [N, 2]
    Hpp_inv: torch.Tensor  # [P, 3, 3]
    bp: torch.Tensor       # [P, 3]
    bc: torch.Tensor       # [M, 6]
    bg: torch.Tensor       # [G]
    extra_c: torch.Tensor  # [M, 6] diagonal damping / fixed additions
    extra_g: torch.Tensor  # [G]
    omega0: torch.Tensor   # scalar: w^T P w at the linearisation point
    # misclosures of directly observed parameters (None when absent)
    w_dp: torch.Tensor | None = None  # [P, 3]
    w_de: torch.Tensor | None = None  # [M, 6]
    w_dg: torch.Tensor | None = None  # [G]


def point_segments(p: RCSProblem):
    """(order [N], counts [P]) int64 tensors of the per-point sums: the
    problem's ``point_order`` / ``point_counts``, else computed from
    ``obs_point`` (a stable sort on the device)."""
    if p.point_order is not None:
        return p.point_order, p.point_counts
    ids = p.obs_point.long()
    return (torch.argsort(ids, stable=True),
            torch.bincount(ids, minlength=p.num_points))


def _batched(*args) -> bool:
    """Whether a tensor among ``args`` carries a `torch.func.vmap` batch."""
    return any(isinstance(a, torch.Tensor)
               and torch._C._functorch.is_batchedtensor(a) for a in args)


def _segment_sum(x, order, counts):
    return torch.segment_reduce(x[order], "sum", lengths=counts, axis=0)


class _SortedSum(torch.autograd.Function):
    """`_segment_sum` with a batching rule: `torch.func.vmap` has none for
    ``aten::segment_reduce`` and would loop over the batch in Python.
    Under vmap the batch axis of x moves behind its columns, [S, N, ...]
    -> [N, ..., S], and one sum takes every scenario: each column is
    summed on its own in the segment's order, so the batched sums are the
    bits of the unbatched ones."""

    generate_vmap_rule = False

    @staticmethod
    def forward(x, order, counts):
        return _segment_sum(x, order, counts)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, x, order, counts):
        if in_dims[1] is not None or in_dims[2] is not None:
            raise ValueError("the point order is shared by the batch")
        out = _segment_sum(x.movedim(in_dims[0], -1), order, counts)
        return out, out.dim() - 1


def _sorted_sum(x, order, counts):
    """Segment sums of x [N, ...] over the segments of a sorted order:
    one sequential sum per segment (`torch.segment_reduce`), the same
    bits on every run and under `torch.func.vmap`; an empty segment sums
    to 0."""
    if _batched(x):
        return _SortedSum.apply(x, order, counts)
    return _segment_sum(x, order, counts)


class _PerItem(torch.autograd.Function):
    """fn(*tensors) -> one tensor, with a batching rule that runs fn on
    each batch item in turn.  Under `torch.func.vmap` a batched reduction
    or product (more outputs per launch, bmm for mm) sums in another order
    than the unbatched one, on the card and on the CPU, and those last
    bits steer a fleet's CG counts away from each network's own step; one
    call per item gives the unbatched bits (`scenario`)."""

    generate_vmap_rule = False

    @staticmethod
    def forward(fn, *args):
        return fn(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, fn, *args):
        cols = [[_as_unbatched(i) for i in a.movedim(d, 0).unbind(0)]
                if d is not None else [a] * info.batch_size
                for a, d in zip(args, in_dims[1:])]
        outs = [fn(*item) for item in zip(*cols)]
        # stacked in the items' own dense layout (an inverse's transposed
        # one), which the next product reads as the unbatched one does
        order = sorted(range(outs[0].dim()),
                       key=lambda k: -outs[0].stride(k))
        out = torch.stack([o.permute(order) for o in outs])
        return out.permute(0, *(1 + order.index(k)
                                for k in range(len(order)))), 0


def _as_unbatched(item):
    """A batch item laid out as the unbatched tensor is: fresh from the
    allocator in its own dense layout (the transposed one of an inverse
    stays transposed), else copied row-major; loads and reductions are
    vectorised by the address and the strides."""
    order = sorted(range(item.dim()), key=lambda k: -item.stride(k))
    if not item.permute(order).is_contiguous():
        return item.contiguous()
    return item if item.data_ptr() % 512 == 0 else item.clone()


def _per_item(fn, *args):
    """fn(*args); under `torch.func.vmap` one call per item (`_PerItem`)."""
    if _batched(*args):
        return _PerItem.apply(fn, *args)
    return fn(*args)


def _sum_rows(x):
    """x.sum(dim=0), the unbatched bits under `torch.func.vmap`."""
    return _per_item(lambda a: a.sum(dim=0), x)


@tracing.traced("rcs.point_sum")
def _seg_point(p: RCSProblem, x):
    """Sum per point of x [N, ...]: a reshape in the uniform point-major
    layout, else the point-sorted segment sums."""
    if p.point_uniform is not None:
        return _per_item(lambda a: a.reshape(
            (p.num_points, p.point_uniform) + tuple(a.shape[1:])).sum(dim=1),
            x)
    return _sorted_sum(x, *point_segments(p))


def _expand_point(p: RCSProblem, z):
    """Per-point values z [P, ...] gathered back to the observations."""
    if p.point_uniform is not None:
        return z.repeat_interleave(p.point_uniform, dim=0)
    return z[p.obs_point.long()]


def _block_prefix(xi):
    """[0; cumsum of the IMG_BLOCK-row block sums] of image-sorted rows
    xi [Nip, F]: [Nip / IMG_BLOCK + 1, F]."""
    bl = xi.reshape(xi.shape[0] // IMG_BLOCK, IMG_BLOCK, -1).sum(dim=1)
    return torch.cat([bl.new_zeros((1, bl.shape[1])),
                      torch.cumsum(bl, dim=0)])


@tracing.traced("rcs.image_sum")
def _seg_image(p: RCSProblem, x):
    """Sum per image of x [N, ...]: the blocked image layout (one row
    gather into image-sorted order, 512-row block sums, a cumsum
    difference over the block boundaries), else image-sorted segment
    sums."""
    if p.img_perm is None:
        ids = p.obs_image.long()
        return _sorted_sum(x, torch.argsort(ids, stable=True),
                           torch.bincount(ids, minlength=p.num_images))
    flat = x.reshape(x.shape[0], -1)
    xp = torch.cat([flat, flat.new_zeros((1, flat.shape[1]))])
    cs = _per_item(_block_prefix, xp[p.img_perm.long()])
    bs = p.img_block_starts.long()
    out = cs[bs[1:]] - cs[bs[:-1]]
    return out.reshape((p.num_images,) + tuple(x.shape[1:]))


# products of the [N, 2, k] blocks, written out over the 2 rows (no
# batched matmul of 2 x k tiles)

def _wmul(P2, J):
    """P J per observation: [N, 2, 2] x [N, 2, k] -> [N, 2, k]."""
    return P2[:, :, 0, None] * J[:, None, 0, :] \
        + P2[:, :, 1, None] * J[:, None, 1, :]


def _tt(A, B):
    """A^T B per observation: [N, 2, a] x [N, 2, b] -> [N, a, b]."""
    return A[:, 0, :, None] * B[:, 0, None, :] \
        + A[:, 1, :, None] * B[:, 1, None, :]


def _tv(A, v):
    """A^T v per observation: [N, 2, a] x [N, 2] -> [N, a]."""
    return A[:, 0, :] * v[:, 0, None] + A[:, 1, :] * v[:, 1, None]


def _mv(A, x):
    """A x per observation: [N, 2, a] x [N, a] -> [N, 2]."""
    return (A * x[:, None, :]).sum(dim=2)


def _hv(H, v):
    """H v per point: [P, 3, 3] x [..., P, 3] -> [..., P, 3]."""
    return (H * v[..., None, :]).sum(dim=-1)


def _cam_rows(p: RCSProblem, tbl, cam_gather=None):
    """tbl [M, 6] at each observation's image: [N, 6] (``cam_gather``:
    the K3 wrapper, whose [8, N] rows are read as [N, 6])."""
    if cam_gather is not None:
        return cam_gather(tbl)[:6].T
    return tbl[p.obs_image.long()]


def _cameras(p: RCSProblem):
    """The camera of each image [M] int64 (all 0 where not given)."""
    if p.cam_of_image is not None:
        return p.cam_of_image.long()
    return torch.zeros(p.num_images, dtype=torch.int64,
                       device=p.obs_image.device)


@tracing.traced("linearize")
def linearize(problem: RCSProblem, state: ParamState, spec, damping,
              skip_image_reductions: bool = False,
              cam_gather=None) -> Blocks:
    """Jacobian blocks, misclosures, point blocks (Hpp^{-1}, bp), the
    per-image (bc, extra_c) and global (bg, extra_g) sums at ``state``,
    any layout.  ``skip_image_reductions``: leave bc / extra_c zero
    (`prepare` makes them in its fused reduction).  ``cam_gather``:
    fn(tbl [M, c<=8]) -> [8, N] for the EO rows and the EO masks (the K3
    wrapper, `kernels.make_cam_gather`; f32 CUDA)."""
    from ..ops import analytic
    from ..ops.residuals import image_point_jacobian, predict_image_point

    p = problem
    obs_point = p.obs_point.long()
    cams = _cameras(p)[p.obs_image.long()]
    local = torch.cat([state.points[obs_point], state.io[cams],
                       _cam_rows(p, state.eo, cam_gather),
                       state.dist[cams]], dim=1)
    r0 = p.r0[cams]
    if analytic.supports_spec(spec):
        J, w = analytic.analytic_image_jacobian_and_residual(
            local, p.obs_xy, spec, r0)
    else:
        J = image_point_jacobian(local, spec, r0)
        w = p.obs_xy - predict_image_point(local, spec, r0)
    P2 = p.obs_weight

    # fixed parameters: mask the Jacobian columns
    Jp = J[:, :, 0:3] * p.free_point[obs_point][:, None, :]
    Jc = J[:, :, 6:12] * _cam_rows(p, p.free_eo, cam_gather)[:, None, :]

    C = state.io.shape[0]
    Gpc = J.shape[2] - 9     # 3 + K
    Jg = torch.cat([J[:, :, 3:6], J[:, :, 12:]], dim=2)   # [N, 2, Gpc]
    if C > 1:
        # the masked [N, 2, C Gpc] rows: each observation's camera slot
        sel = (cams[:, None] == torch.arange(C, device=cams.device)) \
            .to(J.dtype)
        Jg = (Jg[:, :, None, :] * sel[:, None, :, None]).reshape(
            J.shape[0], 2, C * Gpc)
    Jg = Jg * p.free_global

    Pw = (P2 * w[:, None, :]).sum(dim=2)
    omega0 = _per_item(torch.sum, w * Pw)
    PJp, PJc, PJg = _wmul(P2, Jp), _wmul(P2, Jc), _wmul(P2, Jg)

    Hpp = _seg_point(p, _tt(Jp, PJp))
    extra_p = damping * torch.diagonal(Hpp, dim1=1, dim2=2) \
        + (1.0 - p.free_point)
    bp = _seg_point(p, _tv(Jp, Pw))

    # directly observed point coordinates (diagonal weights): W joins the
    # damped diagonal and W (obs - x) the rhs
    w_dp = w_de = w_dg = None
    if p.dp_w is not None:
        w_dp = p.dp_val - state.points
        wp = p.dp_w * p.free_point
        extra_p = extra_p + wp * (1.0 + damping)
        bp = bp + wp * w_dp
        omega0 = omega0 + torch.sum(p.dp_w * w_dp * w_dp)
    Hpp_inv = torch.linalg.inv_ex(Hpp + torch.diag_embed(extra_p))[0]

    M_ = p.num_images
    if skip_image_reductions:
        extra_c = J.new_zeros((M_, 6))
        bc = J.new_zeros((M_, 6))
    else:
        red = _seg_image(p, torch.cat([(Jc * PJc).sum(dim=1),
                                       _tv(Jc, Pw)], dim=1))
        extra_c = damping * red[:, :6] + (1.0 - p.free_eo)
        bc = red[:, 6:]
        if p.de_w is not None:
            we = p.de_w * p.free_eo
            extra_c = extra_c + we * (1.0 + damping)
            bc = bc + we * (p.de_val - state.eo)
    if p.de_w is not None:
        w_de = p.de_val - state.eo
        omega0 = omega0 + torch.sum(p.de_w * w_de * w_de)

    extra_g = damping * _per_item(lambda a: a.sum(dim=(0, 1)), Jg * PJg) \
        + (1.0 - p.free_global)
    bg = _sum_rows(_tv(Jg, Pw))
    if p.dg_w is not None:
        w_dg = p.dg_val - torch.cat([state.io, state.dist], dim=1).reshape(-1)
        wg = p.dg_w * p.free_global
        extra_g = extra_g + wg * (1.0 + damping)
        bg = bg + wg * w_dg
        omega0 = omega0 + torch.sum(p.dg_w * w_dg * w_dg)

    return Blocks(Jp=Jp, Jc=Jc, Jg=Jg, PJp=PJp, PJc=PJc, PJg=PJg, P2=P2, w=w,
                  Hpp_inv=Hpp_inv, bp=bp, bc=bc, bg=bg, extra_c=extra_c,
                  extra_g=extra_g, omega0=omega0,
                  w_dp=w_dp, w_de=w_de, w_dg=w_dg)


def _hpx(p: RCSProblem, b: Blocks, xc, xg, cam_gather=None):
    """(Hpx [xc; xg] per point [P, 3], t = P (Jc xc + Jg xg) [N, 2])."""
    t = _mv(b.PJc, _cam_rows(p, xc, cam_gather)) \
        + _per_item(torch.matmul, b.PJg, xg)
    return _seg_point(p, _tv(b.Jp, t)), t


def _one_schur_matvec(p: RCSProblem, b: Blocks, xc, xg):
    y, t = _hpx(p, b, xc, xg)
    tv = t - _mv(b.PJp, _expand_point(p, _hv(b.Hpp_inv, y)))
    return (_seg_image(p, _tv(b.Jc, tv)) + b.extra_c * xc,
            _sum_rows(_tv(b.Jg, tv)) + b.extra_g * xg)


def schur_matvec(p: RCSProblem, b: Blocks, xc, xg):
    """Implicit S @ [xc; xg]: O(N) per product, S never formed.  A leading
    axis of xc [..., M, 6] / xg [..., G] runs one product per right-hand
    side."""
    if xc.dim() == 2:
        return _one_schur_matvec(p, b, xc, xg)
    outs = [schur_matvec(p, b, c, g) for c, g in zip(xc, xg)]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


def reduced_rhs(p: RCSProblem, b: Blocks):
    """rhs = bx - Hxp Hpp^{-1} bp: (rc [M, 6], rg [G])."""
    u0 = _mv(b.PJp, _expand_point(p, _hv(b.Hpp_inv, b.bp)))
    return (b.bc - _seg_image(p, _tv(b.Jc, u0)),
            b.bg - _sum_rows(_tv(b.Jg, u0)))


def _scc_terms(p: RCSProblem, b: Blocks):
    """Per-observation terms [N, 6, 6] of the exact camera blocks of S:
    Jc^T P Jc - Hcp Hpp^{-1}[pt] Hpc (one observation per point and
    image makes the per-image sum exact)."""
    Hpc = _tt(b.Jp, b.PJc)                                   # [N, 3, 6]
    corr = Hpc.transpose(1, 2) @ (_expand_point(p, b.Hpp_inv) @ Hpc)
    return _tt(b.Jc, b.PJc) - corr


def camera_block_preconditioner(p: RCSProblem, b: Blocks):
    """The exact 6x6 camera blocks of S, inverted: [M, 6, 6]."""
    Scc = _seg_image(p, _scc_terms(p, b)) + torch.diag_embed(b.extra_c)
    return torch.linalg.inv_ex(Scc)[0]


def couple_preconditioner(matvec, Minv: Precond, num_images: int, G: int,
                          dtype=None) -> Precond:
    """Upgrade a block `Precond` with the exact camera-global blocks: Scg
    [M, 6, G] and Sgg [G, G] from the G products S @ [0; e_g] of
    ``matvec`` (G is small: 3 + K per camera), then `finish_coupling`.
    ``dtype``: that of the unit vectors (default: the preconditioner's)."""
    dt = Minv.Minv_c.dtype if dtype is None else dtype
    dev = Minv.Minv_c.device
    cols_c, cols_g = [], []
    for g in range(G):
        eg = torch.zeros(G, dtype=dt, device=dev)
        eg[g] = 1.0
        sc, sg = matvec(torch.zeros((num_images, 6), dtype=dt, device=dev),
                        eg)
        cols_c.append(sc)
        cols_g.append(sg)
    return finish_coupling(Minv, torch.stack(cols_c, dim=2),
                           torch.stack(cols_g, dim=1))


def global_block_preconditioner(p: RCSProblem, b: Blocks):
    """The exact global block of S, inverted: Sgg = Hgg - Hgp Hpp^{-1} Hpg
    with Hpg summed per point."""
    def block(Jg, PJg, Jp, Hpp_inv, extra_g):
        G = Jg.shape[2]
        Hgg = Jg.reshape(-1, G).T @ PJg.reshape(-1, G) + torch.diag(extra_g)
        Hpg = _seg_point(p, _tt(Jp, PJg))                      # [P, 3, G]
        W = Hpp_inv @ Hpg
        return torch.linalg.inv_ex(
            Hgg - Hpg.reshape(-1, G).T @ W.reshape(-1, G))[0]

    return _per_item(block, b.Jg, b.PJg, b.Jp, b.Hpp_inv, b.extra_g)


@tracing.traced("back_substitute")
def back_substitute_points(p: RCSProblem, b: Blocks, xc, xg,
                           cam_gather=None):
    """dx_p = Hpp^{-1} (bp - Hpx x): [P, 3]."""
    return _hv(b.Hpp_inv, b.bp - _hpx(p, b, xc, xg, cam_gather)[0])


def omega_at(p: RCSProblem, b: Blocks, dxp, dxc, dxg):
    """Omega(dx) = sum (w - J dx)^T P (w - J dx) at the linearisation
    point (getOmega semantics, BundleAdjustment.java:472-491)."""
    v = b.w - (_mv(b.Jp, dxp[p.obs_point.long()])
               + _mv(b.Jc, dxc[p.obs_image.long()]) + b.Jg @ dxg)
    return torch.sum(v * (b.P2 * v[:, None, :]).sum(dim=2))


@tracing.traced("prepare")
def prepare(problem: RCSProblem, state: ParamState, spec, damping,
            cam_gather=None):
    """Linearise and build what the PCG needs, with every per-image
    reduction fused into one [N, 54] pass: [bc | Hcc diagonal | Hxp
    Hpp^{-1} bp | Scc blocks].  The preconditioner is block Jacobi: the
    exact camera blocks and the exact global block.
    Returns (blocks, rc, rg, Precond)."""
    p = problem
    b = linearize(p, state, spec, damping, skip_image_reductions=True,
                  cam_gather=cam_gather)
    u0 = _mv(b.PJp, _expand_point(p, _hv(b.Hpp_inv, b.bp)))
    Pw = (b.P2 * b.w[:, None, :]).sum(dim=2)
    big = torch.cat([_tv(b.Jc, Pw), (b.Jc * b.PJc).sum(dim=1), _tv(b.Jc, u0),
                     _scc_terms(p, b).reshape(-1, 36)], dim=1)
    red = _seg_image(p, big)                                 # [M, 54]

    bc = red[:, :6]
    extra_c = damping * red[:, 6:12] + (1.0 - p.free_eo)
    if p.de_w is not None:
        we = p.de_w * p.free_eo
        bc = bc + we * (p.de_val - state.eo)
        extra_c = extra_c + we * (1.0 + damping)
    rc = bc - red[:, 12:18]
    Scc = red[:, 18:].reshape(p.num_images, 6, 6) + torch.diag_embed(extra_c)
    b = b._replace(bc=bc, extra_c=extra_c)
    rg = b.bg - _sum_rows(_tv(b.Jg, u0))
    Minv = Precond(Minv_c=torch.linalg.inv_ex(Scc)[0],
                   Minv_g=global_block_preconditioner(p, b))
    return b, rc, rg, Minv


def point_ops(p: RCSProblem, b: Blocks, cam_gather=None):
    """The point-block closures `freenet` takes (`engine.PointOps`), on the
    block layout.  ``hinv`` takes a leading batch axis."""
    from .engine import PointOps

    def hinv(v):
        return _hv(b.Hpp_inv, v)

    def hinv_at(idx):
        return b.Hpp_inv[idx]

    def hxp(v):
        u = _mv(b.PJp, _expand_point(p, v))
        return _seg_image(p, _tv(b.Jc, u)), _tv(b.Jg, u).sum(dim=0)

    def hpx(xc, xg):
        return _hpx(p, b, xc, xg, cam_gather)[0]

    return PointOps(hinv=hinv, hinv_at=hinv_at, hxp=hxp, hpx=hpx)


def omega_at_full(p: RCSProblem, b: Blocks, ext, dxp, dxc, dxg):
    """Omega(dx) including the scale-bar and direct-group rows (``ext``, a
    `freenet.Extras` or None) and the diagonal direct observations."""
    from . import freenet

    om = omega_at(p, b, dxp, dxc, dxg)
    if ext is not None:
        om = om + freenet.omega_extras(p, ext, dxp)
    if b.w_dp is not None:
        v = b.w_dp - dxp
        om = om + torch.sum(p.dp_w * v * v)
    if b.w_de is not None:
        v = b.w_de - dxc
        om = om + torch.sum(p.de_w * v * v)
    if b.w_dg is not None:
        v = b.w_dg - dxg
        om = om + torch.sum(p.dg_w * v * v)
    return om


@tracing.traced("lm_step")
def lm_step_full(problem: RCSProblem, state: ParamState, spec, damping,
                 cg_tol=1e-10, cg_maxiter=200, matvec_factory=None,
                 cam_gather=None, stall_limit=None):
    """`lm_step` with scale bars, the inner-constraint datum and populated
    direct groups: the exact low-rank corrections of `freenet` around the
    block-layout step.  ``matvec_factory(blocks) -> matvec``: another base
    S @ x (the corrections wrap it).  ``cam_gather``: as `linearize`.
    Returns (dxp, dxc, dxg, blocks, cg_iterations, Extras or None)."""
    from . import freenet

    b, rc, rg, Minv = prepare(problem, state, spec, damping,
                              cam_gather=cam_gather)
    ext = None
    if problem.has_extras:
        ext = freenet.prepare_extras(problem, state, b.bp, rc, rg,
                                     point_ops(problem, b, cam_gather),
                                     b.omega0)
        b = b._replace(omega0=ext.omega0)
        rc, rg = ext.rc, ext.rg
    if matvec_factory is not None:
        base = matvec_factory(b)
    else:
        def base(c, g):
            return schur_matvec(problem, b, c, g)
    mv = freenet.wrap_matvec(base, ext) if ext is not None else base
    Mi = (freenet.wrap_precond(make_apply_M(Minv), ext)
          if ext is not None else Minv)
    xc, xg, it = pcg(rc, rg, Mi, mv, tol=cg_tol, maxiter=cg_maxiter,
                     stall_limit=stall_limit)
    if ext is not None:
        dxp, _lam = freenet.back_substitute(
            problem, ext, point_ops(problem, b, cam_gather), xc, xg)
    else:
        dxp = back_substitute_points(problem, b, xc, xg, cam_gather)
    return dxp, xc, xg, b, it, ext


@tracing.traced("lm_step")
def lm_step(problem: RCSProblem, state: ParamState, spec, damping,
            cg_tol=1e-10, cg_maxiter=200, matvec=None, stall_limit=None,
            cam_gather=None):
    """One LM inner solve on the block layout: linearise, reduce, PCG,
    back-substitute.  ``matvec``: another S @ x.  ``cam_gather``: as
    `linearize`.  Returns (dxp [P, 3], dxc [M, 6], dxg [G], blocks,
    cg_iterations)."""
    b, rc, rg, Minv = prepare(problem, state, spec, damping,
                              cam_gather=cam_gather)
    if matvec is None:
        def matvec(c, g):
            return schur_matvec(problem, b, c, g)
    xc, xg, it = pcg(rc, rg, Minv, matvec, tol=cg_tol, maxiter=cg_maxiter,
                     stall_limit=stall_limit)
    dxp = back_substitute_points(problem, b, xc, xg, cam_gather)
    return dxp, xc, xg, b, it


def apply_step(state: ParamState, dxp, dxc, dxg):
    """x <- x + dx with the global vector split back into (io, dist);
    returns (state, max|dx|) with max|dx| a 0-d tensor."""
    C = state.io.shape[0]
    K = state.dist.shape[1]
    g = dxg.reshape(C, 3 + K)
    mdx = torch.max(torch.stack([dxp.abs().max(), dxc.abs().max(),
                                 dxg.abs().max()]))
    return ParamState(points=state.points + dxp, io=state.io + g[:, :3],
                      dist=state.dist + g[:, 3:], eo=state.eo + dxc), mdx
