"""Feature-major RCS engine (PyTorch port of
`bundle_adjustment_tpu/parallel/engine.py`).

Every per-observation quantity is a feature row of length N.  Reductions:

  per point : uniform point-major reshape [P, V] (or the view-major blocked
              order [P/pb, V, pb]) -> sum over views
  per image : static permutation to image-sorted order (pad row N), 512-row
              block sums, cumsum-diff over block boundaries; on the card
              one kernel in a fixed two-level order (`_image_sum_stack`)
  per camera: the per-image sums times the [C, M] image -> camera one-hot
              (a fixed-order product: no atomics)
  global    : plain row sums / small matrix products

A network of C > 1 cameras runs in the COMPACT layout (`FMBlocks`): the
2 Gp unmasked local rows of the global parameters (Gp = 3 + K per camera)
plus each observation's camera id, O(Gp N) memory instead of the
O(C Gp N) masked rows; `materialize_global_rows` builds the masked rows
for consumers that index them (`cov_direct`).  The CUDA kernels take the
single-camera packed rows only: ``use_kernels=True`` on a multi-camera
problem raises ValueError.

``lm_step(use_kernels=True)`` runs the hand-written CUDA kernels of
`kernels.py` for CUDA tensors (K3 camera gather, K2 fused assembly, K1
Schur matvec); for CPU tensors the same wrappers take their plain
PyTorch versions.  `lm_step_full` is the same step for a free network:
scale bars, the inner-constraint datum and populated direct groups enter
as low-rank corrections around those kernels (`freenet.py`), diagonal
direct observations through the kernels' inputs (Hpp^{-1}, extra_c,
extra_g).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.problem import ParamState
from ..solver import tracing
from . import rcs


class FMProblem(NamedTuple):
    """Feature-major problem tensors (static per adjustment)."""

    obs_image: torch.Tensor   # [N] int32
    obs_x: torch.Tensor       # [N]
    obs_y: torch.Tensor       # [N]
    wxx: torch.Tensor         # [N]  2x2 weight rows (sigma0^2 Sigma^{-1})
    wxy: torch.Tensor         # [N]
    wyy: torch.Tensor         # [N]
    r0: torch.Tensor          # [C]
    num_points: int
    num_images: int
    views: int                # uniform views per point
    free_point: torch.Tensor  # [3, P] rows
    free_eo: torch.Tensor     # [M, 6]
    free_global: torch.Tensor  # [G]
    img_perm: torch.Tensor    # [Nip] int32 (pad entries == N)
    img_block_starts: torch.Tensor  # [M+1] int32 (block units)
    # view-major blocked lane layout (the kernels' layout): lane =
    # i*vm_pb*V + v*vm_pb + p for point i*vm_pb + p; None = point-major
    vm_pb: int | None = None
    # inverse of img_perm (`image_positions`): observation n sits at entry
    # img_pos[n] of the image-sorted blocked layout, and block b holds
    # img_block_valid[b] observations (a prefix; the rest is padding)
    img_pos: torch.Tensor | None = None          # [N] int32
    img_block_valid: torch.Tensor | None = None  # [Nip / 512] int32
    # directly observed parameters with diagonal weights (rcs.RCSProblem);
    # indexed by point, image and global id, not by lane
    dp_w: torch.Tensor | None = None    # [P, 3]
    dp_val: torch.Tensor | None = None  # [P, 3]
    de_w: torch.Tensor | None = None    # [M, 6]
    de_val: torch.Tensor | None = None  # [M, 6]
    dg_w: torch.Tensor | None = None    # [G]
    dg_val: torch.Tensor | None = None  # [G]
    # the RCSProblem's has_extras (scale bars, inner constraints or a
    # populated direct group): the rows here do not carry those
    has_extras: bool = False
    # camera of each image; C = r0.shape[0]
    cam_of_image: torch.Tensor | None = None  # [M] int32


class FMBlocks(NamedTuple):
    """Linearisation in feature rows.  J*/PJ* are tuples of [N] rows.

    COMPACT mode (C > 1): ``Jg`` / ``PJg`` are None and the global rows are
    carried per LOCAL slot (2 Gp rows, Gp = 3 + K) in ``Jg_loc`` /
    ``PJg_loc`` plus the camera of each observation ``cam_obs``.  The
    masked global row of slot g = c Gp + g' is Jg_loc[g'] * (cam_obs == c)
    * free_global[g]; consumers reduce per image and sum per camera (each
    image belongs to one camera) instead of materialising it."""

    Jp: tuple        # 6 rows: (i, a) for i in (x,y), a in (X,Y,Z)
    PJp: tuple       # 6 rows
    Jc: tuple        # 12 rows: (i, a) over EO
    PJc: tuple       # 12 rows
    Jg: tuple | None   # 2G rows: (i, g) over IO+distortion (None = compact)
    PJg: tuple | None  # 2G rows (None = compact)
    w: tuple         # 2 rows (misclosure)
    Pw: tuple        # 2 rows
    Hpp_inv: tuple   # 6 rows [P]: symmetric 3x3 inverse (00,01,02,11,12,22)
    bp: tuple        # 3 rows [P]
    bc: torch.Tensor | None       # [M, 6]
    bg: torch.Tensor              # [G]
    extra_c: torch.Tensor | None  # [M, 6]
    extra_g: torch.Tensor         # [G]
    omega0: torch.Tensor          # scalar
    # compact multi-camera fields (None in the single-camera layout)
    Jg_loc: tuple | None = None          # 2 Gp unmasked local-slot rows
    PJg_loc: tuple | None = None         # 2 Gp rows
    cam_obs: torch.Tensor | None = None  # [N] int64


def num_cameras(p) -> int:
    """C of an FMProblem or RCSProblem (its r0 entries)."""
    return int(p.r0.shape[0])


def refuse_kernels(p) -> None:
    """The CUDA kernels take the single-camera packed rows: raise
    ValueError for a multi-camera problem (FMProblem or RCSProblem), whose
    compact rows they do not read (as the JAX `kernels.pack_fm` does)."""
    if num_cameras(p) > 1:
        raise ValueError(
            f"the CUDA kernels take single-camera problems; this one has "
            f"{num_cameras(p)} cameras (the compact multi-camera rows run "
            "the plain path: use_kernels=False)")


def _camera_onehot(p: FMProblem, dtype):
    """[C, M] image -> camera one-hot."""
    C = num_cameras(p)
    cams = torch.arange(C, device=p.cam_of_image.device)
    return (p.cam_of_image.long()[None, :] == cams[:, None]).to(dtype)


#: the span (`solver.tracing`) around the compact rows' global work in
#: each caller of `_camera_sum`: linearise, the reduction and the product
CAMERA_SUM_SPAN = "compact.camera_sum"


def _camera_sum(p: FMProblem, per_image):
    """[M, F] per-image sums -> [C, F] per-camera sums, as one fixed-order
    product with the image -> camera one-hot (deterministic, unlike an
    indexed add with atomics)."""
    return _camera_onehot(p, per_image.dtype) @ per_image


def image_positions(img_perm, N: int):
    """Inverse of the image-sorted blocked layout `img_perm` [Nip] (pad
    entries == N): (img_pos [N] int32 with img_perm[img_pos[n]] == n,
    img_block_valid [Nip / 512] int32, the observations in each 512-entry
    block).  `rcs.build_image_block_layout` fills every image from the
    start of its first block, so the valid entries of a block are a
    prefix of it.  A pass that writes observation n's values at entry
    img_pos[n] leaves each image's values contiguous, in img_perm's order."""
    perm = img_perm.long()
    valid = perm < N
    entry = torch.arange(perm.shape[0], dtype=torch.int32, device=perm.device)
    pos = torch.empty(N, dtype=torch.int32, device=perm.device)
    pos[perm[valid]] = entry[valid]
    counts = valid.reshape(-1, rcs.IMG_BLOCK).sum(dim=1).to(torch.int32)
    return pos, counts


def fm_problem(p: rcs.RCSProblem) -> FMProblem:
    """Convert a tensor RCSProblem (`convert.problem_to_torch`; uniform
    point-major layout and blocked image layout required)."""
    if p.point_uniform is None:
        raise ValueError("engine requires the uniform point-major layout")
    if p.img_perm is None:
        raise ValueError("engine requires the blocked image layout")
    w = p.obs_weight
    img_pos, img_block_valid = image_positions(p.img_perm,
                                               p.obs_image.shape[0])
    cam_of_image = p.cam_of_image
    if cam_of_image is None:
        if num_cameras(p) != 1:
            raise ValueError("a multi-camera RCSProblem needs cam_of_image")
        cam_of_image = torch.zeros(p.num_images, dtype=torch.int32,
                                   device=p.obs_image.device)
    return FMProblem(
        obs_image=p.obs_image,
        obs_x=p.obs_xy[:, 0].contiguous(), obs_y=p.obs_xy[:, 1].contiguous(),
        wxx=w[:, 0, 0].contiguous(), wxy=w[:, 0, 1].contiguous(),
        wyy=w[:, 1, 1].contiguous(),
        r0=p.r0, num_points=p.num_points, num_images=p.num_images,
        views=p.point_uniform,
        free_point=p.free_point.T.contiguous(),
        free_eo=p.free_eo, free_global=p.free_global,
        img_perm=p.img_perm, img_block_starts=p.img_block_starts,
        img_pos=img_pos, img_block_valid=img_block_valid,
        dp_w=p.dp_w, dp_val=p.dp_val, de_w=p.de_w, de_val=p.de_val,
        dg_w=p.dg_w, dg_val=p.dg_val, has_extras=p.has_extras,
        cam_of_image=cam_of_image,
    )


def pad_problem(problem: rcs.RCSProblem, state: ParamState,
                multiple: int = 128):
    """Pad the point count to a multiple of ``multiple`` with zero-weight
    dummy points (tensor RCSProblem).

    Dummy points copy point 0's coordinates (finite geometry, so their
    rows are finite; zero weights null every contribution) and are marked
    fixed, so Hpp gets a unit diagonal and dx stays 0.  A dummy point is
    neither directly observed nor a datum point (zero dp_w / dp_val /
    datum_mask_d rows).
    Returns (padded RCSProblem, padded ParamState, P_original)."""
    P = problem.num_points
    V = problem.point_uniform
    if V is None:
        raise ValueError("pad_problem requires the uniform point-major layout")
    P_pad = -(-P // multiple) * multiple
    if P_pad == P:
        return problem, state, P
    extra = P_pad - P
    n_extra = extra * V
    dt = problem.obs_xy.dtype
    dev = problem.obs_xy.device
    i32 = torch.int32
    obs_point = torch.cat([problem.obs_point, torch.repeat_interleave(
        torch.arange(P, P_pad, dtype=i32, device=dev), V)])
    obs_image = torch.cat([problem.obs_image,
                           torch.zeros(n_extra, dtype=i32, device=dev)])
    obs_xy = torch.cat([problem.obs_xy,
                        torch.zeros((n_extra, 2), dtype=dt, device=dev)])
    obs_weight = torch.cat([problem.obs_weight,
                            torch.zeros((n_extra, 2, 2), dtype=dt, device=dev)])
    free_point = torch.cat([problem.free_point,
                            torch.zeros((extra, 3), dtype=dt, device=dev)])
    img_perm, img_bs = rcs.build_image_block_layout(
        obs_image.cpu().numpy(), problem.num_images)
    extra_fields = {}
    if problem.dp_w is not None:
        zeros = torch.zeros((extra, 3), dtype=dt, device=dev)
        extra_fields["dp_w"] = torch.cat([problem.dp_w, zeros])
        extra_fields["dp_val"] = torch.cat([problem.dp_val, zeros])
    if problem.datum_mask_d is not None:
        extra_fields["datum_mask_d"] = torch.cat(
            [problem.datum_mask_d, torch.zeros(extra, dtype=dt, device=dev)])
    problem = problem._replace(
        **extra_fields,
        obs_point=obs_point, obs_image=obs_image, obs_xy=obs_xy,
        obs_weight=obs_weight, free_point=free_point, num_points=P_pad,
        img_perm=torch.as_tensor(img_perm, device=dev),
        img_block_starts=torch.as_tensor(img_bs, device=dev))
    state = state._replace(points=torch.cat(
        [state.points, state.points[:1].expand(extra, 3)]))
    return problem, state, P


def pad_images(problem: rcs.RCSProblem, state: ParamState, multiple: int):
    """Pad the image count to a multiple of ``multiple`` with fully fixed
    dummy images (tensor RCSProblem): no observation references them,
    free_eo = 0 gives their reduced blocks a unit diagonal, so their step
    stays exactly 0.  The camera-sharded step (`spmd_fm`, ``cam_shard``)
    needs it where M is not a multiple of the ranks.  A dummy image sits
    on camera 0 and is not directly observed.
    Returns (padded RCSProblem, padded ParamState, M_original)."""
    M = problem.num_images
    Mp = -(-M // multiple) * multiple
    if Mp == M:
        return problem, state, M
    extra = Mp - M

    def cat0(a):
        return torch.cat([a, a.new_zeros((extra,) + tuple(a.shape[1:]))])

    fields = {}
    if problem.de_w is not None:
        fields.update(de_w=cat0(problem.de_w), de_val=cat0(problem.de_val))
    if problem.cam_of_image is not None:
        fields["cam_of_image"] = cat0(problem.cam_of_image)
    bs = problem.img_block_starts
    problem = problem._replace(
        num_images=Mp, free_eo=cat0(problem.free_eo),
        img_block_starts=torch.cat([bs, bs[-1:].expand(extra)]), **fields)
    state = state._replace(eo=torch.cat(
        [state.eo, state.eo[:1].expand(extra, 6)]))
    return problem, state, M


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def _point_sum(p: FMProblem, row):
    """[..., N] -> [..., P] over the uniform views (layout-aware)."""
    lead = row.shape[:-1]
    if p.vm_pb is None:
        return row.reshape(*lead, p.num_points, p.views).sum(dim=-1)
    nb = p.num_points // p.vm_pb
    return row.reshape(*lead, nb, p.views, p.vm_pb).sum(dim=-2).reshape(
        *lead, -1)


def _point_expand(p: FMProblem, col):
    """[..., P] -> [..., N] broadcast over views (layout-aware)."""
    lead = col.shape[:-1]
    if p.vm_pb is None:
        return col[..., None].expand(*lead, p.num_points, p.views).reshape(
            *lead, -1)
    nb = p.num_points // p.vm_pb
    return col.reshape(*lead, nb, 1, p.vm_pb).expand(
        *lead, nb, p.views, p.vm_pb).reshape(*lead, -1)


def point_lanes(p: FMProblem, point_ids):
    """Lanes [k, V] of the observations of the points ``point_ids`` [k]
    (int64) in either lane layout."""
    v = torch.arange(p.views, device=point_ids.device)
    if p.vm_pb is None:
        return point_ids[:, None] * p.views + v[None, :]
    pb = p.vm_pb
    return ((point_ids // pb) * (pb * p.views) + point_ids % pb)[:, None] \
        + v[None, :] * pb


def lane_points(p: FMProblem, lanes):
    """Point id of each lane (int64), either lane layout."""
    if p.vm_pb is None:
        return lanes // p.views
    pb = p.vm_pb
    return (lanes // (pb * p.views)) * pb + lanes % pb


def view_major_perm(P: int, V: int, pb: int) -> np.ndarray:
    """perm[new_lane] = point-major index: new order (block, view, p_local)."""
    nblocks = P // pb
    i = np.arange(nblocks)[:, None, None]
    v = np.arange(V)[None, :, None]
    q = np.arange(pb)[None, None, :]
    return ((i * pb + q) * V + v).reshape(-1)


def to_view_major(p: FMProblem, pb: int) -> FMProblem:
    """Re-lay the observation axis into the view-major blocked order the
    kernels consume (see FMProblem.vm_pb).  One-time host cost; all engine
    reductions stay exact (same sums, permuted order).  Requires
    pb | num_points (pad_problem first)."""
    if p.vm_pb is not None:
        if p.vm_pb != pb:
            raise ValueError(f"already view-major with pb={p.vm_pb}")
        return p
    if p.num_points % pb != 0:
        raise ValueError(f"pb={pb} must divide num_points={p.num_points}; "
                         "use pad_problem")
    dev = p.obs_x.device
    perm = view_major_perm(p.num_points, p.views, pb)
    obs_image = p.obs_image.cpu().numpy()[perm]
    img_perm, img_bs = rcs.build_image_block_layout(obs_image, p.num_images)
    perm_t = torch.as_tensor(perm, device=dev)
    img_perm_t = torch.as_tensor(img_perm, device=dev)
    img_pos, img_block_valid = image_positions(img_perm_t, perm.shape[0])

    def g(a):
        return a[perm_t].contiguous()

    return p._replace(
        obs_image=torch.as_tensor(obs_image, device=dev),
        obs_x=g(p.obs_x), obs_y=g(p.obs_y),
        wxx=g(p.wxx), wxy=g(p.wxy), wyy=g(p.wyy),
        img_perm=img_perm_t,
        img_block_starts=torch.as_tensor(img_bs, device=dev),
        vm_pb=pb, img_pos=img_pos, img_block_valid=img_block_valid,
    )


def _image_sum_stack(p: FMProblem, rows):
    """Per-image sums of F feature rows [..., N]: returns [..., M, F].  CUDA
    rows go to one hand-written kernel (`kernels.image_sum_rows`, a fixed
    two-level order), CPU rows to `_image_sum_plain`."""
    if rows[0].is_cuda:
        from . import kernels

        return kernels.image_sum_rows(p, rows)
    return _image_sum_plain(p, rows)


def _image_sum_plain(p: FMProblem, rows):
    """`_image_sum_stack` in plain PyTorch on any device: one row gather
    into image-sorted order + 512-block sums + cumsum-diff (the numerics of
    the reference's blocked image reduction)."""
    x = torch.stack(rows, dim=-1)  # [..., N, F]
    lead = x.shape[:-2]
    xp = torch.cat([x, x.new_zeros((*lead, 1, x.shape[-1]))], dim=-2)
    xi = xp[..., p.img_perm.long(), :]  # [..., Nip, F]
    nb = xi.shape[-2] // rcs.IMG_BLOCK
    return _blocks_to_images(p, xi.reshape(
        *lead, nb, rcs.IMG_BLOCK, x.shape[-1]).sum(dim=-2))


def _blocks_to_images(p: FMProblem, bl):
    """512-block sums [..., Nip / 512, F] of the image-sorted layout ->
    per-image sums [..., M, F] by cumsum-diff over the block boundaries."""
    lead = bl.shape[:-2]
    cs = torch.cat([bl.new_zeros((*lead, 1, bl.shape[-1])),
                    torch.cumsum(bl, dim=-2)], dim=-2)
    bs = p.img_block_starts.long()
    return cs[..., bs[1:], :] - cs[..., bs[:-1], :]


def _sym3_inverse(m00, m01, m02, m11, m12, m22):
    """Closed-form symmetric 3x3 inverse rows (adjugate / det)."""
    i00 = m11 * m22 - m12 * m12
    i01 = m02 * m12 - m01 * m22
    i02 = m01 * m12 - m02 * m11
    i11 = m00 * m22 - m02 * m02
    i12 = m01 * m02 - m00 * m12
    i22 = m00 * m11 - m01 * m01
    det = m00 * i00 + m01 * i01 + m02 * i02
    inv_det = 1.0 / det
    return (i00 * inv_det, i01 * inv_det, i02 * inv_det,
            i11 * inv_det, i12 * inv_det, i22 * inv_det)


def _hinv_apply(H, a0, a1, a2):
    """(6-row symmetric 3x3) @ [3] rows."""
    h00, h01, h02, h11, h12, h22 = H
    return (h00 * a0 + h01 * a1 + h02 * a2,
            h01 * a0 + h11 * a1 + h12 * a2,
            h02 * a0 + h12 * a1 + h22 * a2)


# ---------------------------------------------------------------------------
# linearisation
# ---------------------------------------------------------------------------

def _global_vector(state: ParamState):
    """The global parameters [G] = per camera (io, dist), flattened."""
    return torch.cat([state.io, state.dist], dim=1).reshape(-1)


def _gather_rows(p: FMProblem, tbl, ncols, cam_gather=None):
    """tbl [..., M, c] -> ``ncols`` rows [..., N] of tbl[obs_image]
    (``cam_gather`` takes an [M, c] table only)."""
    if cam_gather is not None:
        rows = cam_gather(tbl)
        return [rows[a] for a in range(ncols)]
    idx = p.obs_image.long()
    return [tbl[..., a][..., idx] for a in range(ncols)]


@tracing.traced("linearize")
def linearize(p: FMProblem, state: ParamState, spec, damping,
              state_lo: ParamState | None = None,
              cam_gather=None, comm=None) -> FMBlocks:
    """Jacobian rows, misclosures, point blocks and global diagonal at
    ``state``; C > 1 cameras give the compact global rows (`FMBlocks`).
    ``cam_gather``: optional fn(tbl [M, c<=8]) -> [8, N] replacing the
    per-row EO gathers (the K3 wrapper, `kernels.make_cam_gather`).
    ``state_lo``: low-order part of a two-float state (see
    ops.fm.project_rows).  ``comm``: a `sharding.Comm` when the points are
    sharded over ranks (each rank holds whole points, `spmd_fm`): the
    cross-shard sums (Omega, the global diagonal and rhs) are psum-ed, the
    per-point blocks stay shard-local."""
    from ..ops import fm

    pts = state.points
    X = _point_expand(p, pts[:, 0])
    Y = _point_expand(p, pts[:, 1])
    Z = _point_expand(p, pts[:, 2])
    eog = _gather_rows(p, state.eo, 6, cam_gather)

    lo = None
    if state_lo is not None:
        lo = tuple(_point_expand(p, state_lo.points[:, a]) for a in range(3))
        lo = lo + tuple(_gather_rows(p, state_lo.eo[:, :3], 3, cam_gather))

    C = state.io.shape[0]
    K = state.dist.shape[1]
    Gp = 3 + K
    if C == 1:
        iog = [state.io[0, a].expand_as(X) for a in range(3)]
        cg = [state.dist[0, k].expand_as(X) for k in range(K)]
        r0 = p.r0[0].expand_as(X)
        cams = None
    else:
        cams = p.cam_of_image.long()[p.obs_image.long()]
        iog = [state.io[:, a][cams] for a in range(3)]
        cg = [state.dist[:, k][cams] for k in range(K)]
        r0 = p.r0[cams]

    rows_x, rows_y, pred_x, pred_y = fm.jacobian_rows(
        X, Y, Z, iog[0], iog[1], iog[2],
        eog[0], eog[1], eog[2], eog[3], eog[4], eog[5], cg, spec, r0, lo=lo)
    w0 = p.obs_x - pred_x
    w1 = p.obs_y - pred_y

    # fixed-parameter masks
    fp = [_point_expand(p, p.free_point[a]) for a in range(3)]
    fe = _gather_rows(p, p.free_eo, 6, cam_gather)

    Jp = tuple(rows_x[a] * fp[a] for a in range(3)) \
        + tuple(rows_y[a] * fp[a] for a in range(3))
    Jc = tuple(rows_x[6 + a] * fe[a] for a in range(6)) \
        + tuple(rows_y[6 + a] * fe[a] for a in range(6))

    # global rows [x0 y0 c dist...]; x0 / y0 identity entries in slots 0/1
    one = torch.ones_like(X)
    zero = torch.zeros_like(X)
    gx = [one, zero, rows_x[5]] + [rows_x[12 + k] for k in range(K)]
    gy = [zero, one, rows_y[5]] + [rows_y[12 + k] for k in range(K)]

    # weight application: PJ = W2x2 J (correlated x/y,
    # PartialDerivativeFactory.java:313-319)
    def apply_w(rows):
        n = len(rows) // 2
        return tuple(p.wxx * rows[a] + p.wxy * rows[n + a] for a in range(n)) \
            + tuple(p.wxy * rows[a] + p.wyy * rows[n + a] for a in range(n))

    fg = p.free_global
    if C == 1:
        Jg = tuple(gx[g] * fg[g] for g in range(Gp)) \
            + tuple(gy[g] * fg[g] for g in range(Gp))
        PJg = apply_w(Jg)
        Jg_loc = PJg_loc = None
    else:
        # compact: the 2 Gp unmasked local rows + the camera of each
        # observation (FMBlocks)
        Jg = PJg = None
        Jg_loc = tuple(gx) + tuple(gy)
        PJg_loc = apply_w(Jg_loc)
    PJp = apply_w(Jp)
    PJc = apply_w(Jc)
    Pw = (p.wxx * w0 + p.wxy * w1, p.wxy * w0 + p.wyy * w1)
    omega0 = torch.sum(w0 * Pw[0] + w1 * Pw[1])

    def hpp(a, b):
        return _point_sum(p, Jp[a] * PJp[b] + Jp[3 + a] * PJp[3 + b])

    m00, m01, m02 = hpp(0, 0), hpp(0, 1), hpp(0, 2)
    m11, m12, m22 = hpp(1, 1), hpp(1, 2), hpp(2, 2)
    fpc = p.free_point
    e0 = damping * m00 + (1.0 - fpc[0])
    e1 = damping * m11 + (1.0 - fpc[1])
    e2 = damping * m22 + (1.0 - fpc[2])
    bp = [_point_sum(p, Jp[a] * Pw[0] + Jp[3 + a] * Pw[1])
          for a in range(3)]
    # directly observed point coordinates and EO, diagonal weights
    if p.dp_w is not None:
        w_dp = p.dp_val - pts
        for a in range(3):
            bp[a] = bp[a] + p.dp_w[:, a] * fpc[a] * w_dp[:, a]
        e0 = e0 + p.dp_w[:, 0] * fpc[0] * (1.0 + damping)
        e1 = e1 + p.dp_w[:, 1] * fpc[1] * (1.0 + damping)
        e2 = e2 + p.dp_w[:, 2] * fpc[2] * (1.0 + damping)
        omega0 = omega0 + torch.sum(p.dp_w * w_dp * w_dp)
    if comm is not None:
        omega0 = comm.psum(omega0)  # observation + per-point terms
    if p.de_w is not None:
        w_de = p.de_val - state.eo
        omega0 = omega0 + torch.sum(p.de_w * w_de * w_de)
    bp = tuple(bp)
    Hpp_inv = _sym3_inverse(m00 + e0, m01, m02, m11 + e1, m12, m22 + e2)

    if C == 1:
        Hgg_diag = torch.stack([
            torch.sum(Jg[g] * PJg[g] + Jg[Gp + g] * PJg[Gp + g])
            for g in range(Gp)])
        bg = torch.stack([torch.sum(Jg[g] * Pw[0] + Jg[Gp + g] * Pw[1])
                          for g in range(Gp)])
        if comm is not None:
            Hgg_diag, bg = comm.psum(Hgg_diag), comm.psum(bg)
    else:
        # per-image sums of the Gp diagonal / rhs rows, summed per camera;
        # free applied once (0/1 mask)
        with tracing.span(CAMERA_SUM_SPAN):
            rows_d = [Jg_loc[g] * PJg_loc[g]
                      + Jg_loc[Gp + g] * PJg_loc[Gp + g] for g in range(Gp)]
            rows_b = [Jg_loc[g] * Pw[0] + Jg_loc[Gp + g] * Pw[1]
                      for g in range(Gp)]
            red_g = _image_sum_stack(p, rows_d + rows_b)
            if comm is not None:
                red_g = comm.psum(red_g)
            camsum = _camera_sum(p, red_g)
            Hgg_diag = camsum[:, :Gp].reshape(-1) * fg
            bg = camsum[:, Gp:].reshape(-1) * fg
    extra_g = damping * Hgg_diag + (1.0 - fg)
    if p.dg_w is not None:
        w_dg = p.dg_val - _global_vector(state)
        wg = p.dg_w * fg
        extra_g = extra_g + wg * (1.0 + damping)
        bg = bg + wg * w_dg
        omega0 = omega0 + torch.sum(p.dg_w * w_dg * w_dg)
    return FMBlocks(Jp=Jp, PJp=PJp, Jc=Jc, PJc=PJc, Jg=Jg, PJg=PJg,
                    w=(w0, w1), Pw=Pw, Hpp_inv=Hpp_inv, bp=bp,
                    bc=None, bg=bg, extra_c=None, extra_g=extra_g,
                    omega0=omega0, Jg_loc=Jg_loc, PJg_loc=PJg_loc,
                    cam_obs=cams)


# ---------------------------------------------------------------------------
# reduced system
# ---------------------------------------------------------------------------

def _xg_obs_rows(p: FMProblem, b: FMBlocks, xg):
    """Compact mode: Gp rows [..., N] of (free * xg) at each observation's
    camera slot, so that Sum_g PJg[g] xg[g] == Sum_g' PJg_loc[g'] xs[g']."""
    Gp = len(b.Jg_loc) // 2
    xg_eff = (xg * p.free_global).reshape(*xg.shape[:-1], -1, Gp)
    return [xg_eff[..., b.cam_obs, g] for g in range(Gp)]


def _global_terms(p: FMProblem, b: FMBlocks, xg, weighted: bool):
    """(rows, factors) with Sum_g rows[i Gn + g] * factors[g] = (P) Jg xg
    per observation, i in (x, y): the masked rows and xg[g] (single
    camera), or the compact local rows and `_xg_obs_rows`."""
    if b.Jg is None:
        return (b.PJg_loc if weighted else b.Jg_loc), _xg_obs_rows(p, b, xg)
    rows = b.PJg if weighted else b.Jg
    return rows, [xg[..., g, None] for g in range(len(rows) // 2)]


def _t_rows(p: FMProblem, b: FMBlocks, xc, xg, cam_gather=None):
    """t = P (Jc xc + Jg xg) per observation: 2 rows [..., N] for xc
    [..., M, 6], xg [..., G]."""
    xcg = _gather_rows(p, xc, 6, cam_gather)
    rows, xs = _global_terms(p, b, xg, weighted=True)
    Gn = len(xs)
    t = []
    for i in (0, 1):
        acc = 0.0
        for a in range(6):
            acc = acc + b.PJc[i * 6 + a] * xcg[a]
        for g in range(Gn):
            acc = acc + rows[i * Gn + g] * xs[g]
        t.append(acc)
    return t


def _point_solve_expand(p: FMProblem, b: FMBlocks, t):
    """z = Hpp^{-1} Jp^T t per point, expanded back to observations."""
    y = [_point_sum(p, b.Jp[a] * t[0] + b.Jp[3 + a] * t[1]) for a in range(3)]
    z = _hinv_apply(b.Hpp_inv, *y)
    return [_point_expand(p, z[a]) for a in range(3)]


def _global_out(p: FMProblem, b: FMBlocks, u, qc, comm=None,
                cam_scatter: bool = False):
    """(Hcx-type per-image sums [..., M, 6] of the rows ``qc``, Jg^T u
    [..., G]) for the observation rows u = (u_x, u_y): single camera by
    row sums; compact by the Gp local rows reduced per image beside
    ``qc``, summed per camera and masked by free_global.  ``comm``: the
    points are sharded; the per-image sums are psum-ed (psum_scatter-ed to
    this rank's image rows with ``cam_scatter``), the global sums
    psum-ed."""
    def ps(x):
        return x if comm is None else comm.psum(x)

    def image_part(oc):
        return comm.psum_scatter(oc, dim=-2) if cam_scatter else ps(oc)

    if b.Jg is None:
        with tracing.span(CAMERA_SUM_SPAN):
            Gp = len(b.Jg_loc) // 2
            qg = [b.Jg_loc[g] * u[0] + b.Jg_loc[Gp + g] * u[1]
                  for g in range(Gp)]
            stack = _image_sum_stack(p, qc + qg)
            og = _camera_sum(p, ps(stack[..., 6:]))
            return image_part(stack[..., :6]), \
                og.reshape(*og.shape[:-2], -1) * p.free_global
    G2 = len(b.Jg) // 2
    og = torch.stack([torch.sum(b.Jg[g] * u[0] + b.Jg[G2 + g] * u[1], dim=-1)
                      for g in range(G2)], dim=-1)
    return image_part(_image_sum_stack(p, qc)), ps(og)


def _check_scatter(comm, cam_scatter):
    if cam_scatter and comm is None:
        raise ValueError("cam_scatter requires comm (a sharding.Comm)")


def schur_matvec(p: FMProblem, b: FMBlocks, xc, xg, comm=None,
                 cam_scatter: bool = False):
    """Implicit S @ [xc; xg], feature-major: returns ([..., M, 6],
    [..., G]); a leading axis of xc [..., M, 6] / xg [..., G] runs several
    right-hand sides in one pass (temporaries [..., N] per row).

    ``comm``: psum the cross-shard (image / global) sums when the points
    are sharded over ranks.  ``cam_scatter`` (needs ``comm``): the reduced
    camera system is sharded by image rows too (tensor-parallel mode):
    ``xc`` holds this rank's M / D rows and the result likewise; the full
    xc is re-formed by one tiled all_gather, and the per-image output is
    combined by one psum_scatter that leaves each rank its own rows."""
    _check_scatter(comm, cam_scatter)
    xc_full = comm.all_gather(xc, dim=-2) if cam_scatter else xc
    t = _t_rows(p, b, xc_full, xg)
    zo = _point_solve_expand(p, b, t)
    tv = []
    for i in (0, 1):
        u = sum(b.PJp[i * 3 + a] * zo[a] for a in range(3))
        tv.append(t[i] - u)
    qc = [b.Jc[a] * tv[0] + b.Jc[6 + a] * tv[1] for a in range(6)]
    oc, og = _global_out(p, b, tv, qc, comm, cam_scatter)
    return oc + b.extra_c * xc, og + b.extra_g * xg


@tracing.traced("prepare")
def prepare(p: FMProblem, state: ParamState, spec, damping,
            couple_global: bool = False,
            state_lo: ParamState | None = None, comm=None,
            cam_scatter: bool = False):
    """Linearise + build rhs and the (camera, global) block preconditioner.
    Returns (blocks, rc, rg, rcs.Precond).  ``comm`` / ``cam_scatter``: the
    point-sharded step (`spmd_fm`), see `reduce_blocks`."""
    b = linearize(p, state, spec, damping, state_lo=state_lo, comm=comm)
    return reduce_blocks(p, b, state, damping, couple_global=couple_global,
                         comm=comm, cam_scatter=cam_scatter)


def reduce_blocks(p: FMProblem, b: FMBlocks, state: ParamState, damping,
                  couple_global: bool = False, comm=None,
                  cam_scatter: bool = False):
    """`prepare` minus the linearisation: the fused per-image reduction of
    39 (+ 6G with ``couple_global``; compact: + 6 Gp local Hcg rows)
    feature rows, the global rhs correction and the Sgg product pieces,
    finished by `finish_reduction`.

    ``comm``: the points are sharded over ranks; every cross-shard sum is
    psum-ed.  ``cam_scatter`` (tensor-parallel mode): the fused [M, F]
    image stack lands by one psum_scatter, so each rank keeps its own M / D
    image rows (rc, bc, extra_c, the 6x6 blocks and Scg of those rows)."""
    _check_scatter(comm, cam_scatter)

    def _ps(x):
        return x if comm is None else comm.psum(x)

    G2 = p.free_global.shape[0]
    compact = b.Jg is None
    fg = p.free_global

    # z0 = Hpp^{-1} bp expanded; u0 = P Jp z0
    z0o = [_point_expand(p, z) for z in _hinv_apply(b.Hpp_inv, *b.bp)]
    u0 = [sum(b.PJp[i * 3 + a] * z0o[a] for a in range(3)) for i in (0, 1)]

    # Hpg per point [3][G][P] and W = Hpp^{-1} Hpg [G][3][P]
    if compact:
        # per-camera point sums of the Gp local products: O(Gp P) output,
        # the [C, N] masked products transient; free applied once
        Gp = len(b.Jg_loc) // 2
        C = G2 // Gp
        with tracing.span(CAMERA_SUM_SPAN):
            sel = torch.stack([(b.cam_obs == c).to(b.Jp[0].dtype)
                               for c in range(C)])                # [C, N]
            hpg = [[None] * G2 for _ in range(3)]
            for a in range(3):
                for g in range(Gp):
                    q = b.Jp[a] * b.PJg_loc[g] \
                        + b.Jp[3 + a] * b.PJg_loc[Gp + g]
                    per_cam = _point_sum(p, q * sel)              # [C, P]
                    for c in range(C):
                        hpg[a][c * Gp + g] = per_cam[c] * fg[c * Gp + g]
    else:
        hpg = [[_point_sum(p, b.Jp[a] * b.PJg[g]
                           + b.Jp[3 + a] * b.PJg[G2 + g])
                for g in range(G2)] for a in range(3)]
    W = [_hinv_apply(b.Hpp_inv, hpg[0][g], hpg[1][g], hpg[2][g])
         for g in range(G2)]

    rows = []
    # bc terms (6)
    rows += [b.Jc[a] * b.Pw[0] + b.Jc[6 + a] * b.Pw[1] for a in range(6)]
    # Hcc diagonal (6)
    rows += [b.Jc[a] * b.PJc[a] + b.Jc[6 + a] * b.PJc[6 + a]
             for a in range(6)]
    # rc correction terms (6)
    rows += [b.Jc[a] * u0[0] + b.Jc[6 + a] * u0[1] for a in range(6)]
    # Scc = Hcc - Hcp Hpp^{-1} Hpc, upper triangle (21), exact per
    # observation: each contributes Hpc_n^T Hppinv[pt] Hpc_n
    hp = [[b.Jp[a] * b.PJc[e] + b.Jp[3 + a] * b.PJc[6 + e] for e in range(6)]
          for a in range(3)]
    H = tuple(_point_expand(p, h) for h in b.Hpp_inv)
    for e in range(6):
        he = _hinv_apply(H, hp[0][e], hp[1][e], hp[2][e])
        for f in range(e, 6):
            jpj = b.Jc[e] * b.PJc[f] + b.Jc[6 + e] * b.PJc[6 + f]
            corr = sum(he[a] * hp[a][f] for a in range(3))
            rows.append(jpj - corr)
    scg_corr = None
    if couple_global and compact:
        # Hcg is camera-local (an image's rows touch its own camera's
        # slots only): 6 Gp local rows in the image stack, expanded in
        # finish_reduction.  The Schur correction Hcp Hpp^{-1} Hpg is not
        # local (shared points couple images to other cameras' slots):
        # `_scg_correction`
        fg_obs = [fg.reshape(C, Gp)[:, g][b.cam_obs] for g in range(Gp)]
        for e in range(6):
            for g in range(Gp):
                rows.append((b.Jc[e] * b.PJg_loc[g]
                             + b.Jc[6 + e] * b.PJg_loc[Gp + g]) * fg_obs[g])
        scg_corr = _scg_correction(p, hp, W)
    elif couple_global:
        # Scg rows (6G): Hcg - Hcp Hpp^{-1} Hpg, exact per observation
        Wobs = [[_point_expand(p, W[g][a]) for a in range(3)]
                for g in range(G2)]
        for e in range(6):
            for g in range(G2):
                hcg = b.Jc[e] * b.PJg[g] + b.Jc[6 + e] * b.PJg[G2 + g]
                corr = sum(hp[a][e] * Wobs[g][a] for a in range(3))
                rows.append(hcg - corr)
    red = _image_sum_stack(p, rows)  # [M, 39 (+ 6G | 6Gp)]
    if cam_scatter:
        red = comm.psum_scatter(red)  # this rank's M / D image rows
    else:
        red = _ps(red)

    if compact:
        # rg correction: image sums of the Gp local rows, per camera; T2
        # block-diagonal per camera [C, 2Gp, 2Gp]
        with tracing.span(CAMERA_SUM_SPAN):
            rgm = _ps(_image_sum_stack(p, [b.Jg_loc[g] * u0[0]
                                           + b.Jg_loc[Gp + g] * u0[1]
                                           for g in range(Gp)]))
            rg_corr = _camera_sum(p, rgm).reshape(-1) * fg
            JglM = torch.stack(b.Jg_loc)
            PJglM = torch.stack(b.PJg_loc).T
            T2 = _ps(torch.stack([(JglM * sel[c]) @ PJglM
                                  for c in range(C)]))
    else:
        rg_corr = _ps(torch.stack([
            torch.sum(b.Jg[g] * u0[0] + b.Jg[G2 + g] * u0[1])
            for g in range(G2)]))
        T2 = _ps(torch.stack(b.Jg) @ torch.stack(b.PJg).T)  # [2G, 2G]
    HpgM = torch.stack([hpg[a][g] for a in range(3) for g in range(G2)])
    WM = torch.stack([W[g][a] for a in range(3) for g in range(G2)])
    T3 = _ps(WM @ HpgM.T)                                 # [3G, 3G]
    if scg_corr is not None:
        scg_corr = _ps(scg_corr)
    return finish_reduction(p, b, state, damping, red, rg_corr, T2, T3,
                            couple_global, scg_corr=scg_corr, comm=comm,
                            cam_scatter=cam_scatter)


def _div_chunk(P: int, target: int) -> int:
    """Largest chunk <= target dividing P."""
    best = 1
    for c in range(1, min(P, target) + 1):
        if P % c == 0:
            best = c
    return best


def _scg_correction(p: FMProblem, hp, W):
    """Compact-mode Schur correction of Scg, Hcp Hpp^{-1} Hpg as
    [M, 6, G] (it couples images to every camera's slots through shared
    points): the per-observation products Sum_a Hpc[n, a, e] W[pt(n), a, g]
    summed per image.  The products are formed chunk by chunk of the
    image-sorted blocked layout (the JAX chunk rule: ~3e8 bytes of
    transients at 4 bytes per value), summed per 512-entry block and
    finished by the cumsum-diff of `_image_sum_stack`: no indexed add, so
    the bits do not depend on the order in which atomics land (the CG
    stall rules react to the preconditioner's noise)."""
    V, P_, G2 = p.views, p.num_points, len(W)
    hpc2 = torch.stack([hp[a][e] for a in range(3) for e in range(6)])
    W2 = torch.stack([W[g][a] for a in range(3) for g in range(G2)])
    N = hpc2.shape[1]
    chunk = _div_chunk(P_, min(2048, max(64, int(3.0e8
                                                  / (V * 6 * G2 * 4)))))
    step = max(1, chunk * V // rcs.IMG_BLOCK) * rcs.IMG_BLOCK
    perm = p.img_perm.long()
    blocks = []
    for s0 in range(0, perm.shape[0], step):
        n = perm[s0:s0 + step]
        valid = n < N
        lane = torch.where(valid, n, 0)
        h = (hpc2[:, lane] * valid).reshape(3, 6, -1)
        w = W2[:, lane_points(p, lane)].reshape(3, G2, -1)
        pg = torch.einsum("ael,agl->egl", h, w)           # [6, G, L]
        blocks.append(pg.reshape(6 * G2, -1, rcs.IMG_BLOCK).sum(dim=-1))
    bl = torch.cat(blocks, dim=1).T                       # [Nip / 512, 6G]
    return _blocks_to_images(p, bl).reshape(p.num_images, 6, G2)


def finish_reduction(p: FMProblem, b: FMBlocks, state: ParamState, damping,
                     red, rg_corr, T2, T3, couple_global, scg_corr=None,
                     comm=None, cam_scatter: bool = False):
    """Shared tail of `prepare`: turn the fused per-image reduction ``red``
    [M, 39 (+ 6G)], the global rhs correction ``rg_corr`` [G] and the Sgg
    pieces ``T2`` [2G, 2G] / ``T3`` [3G, 3G] into (blocks, rc, rg,
    Precond).  Used by the plain reduction above and by the K2 path
    (`kernels.prepare_kernels`).  The inverses do not check for
    singularity (as jnp.linalg.inv; no device sync): a singular block gives
    non-finite entries.

    Compact mode (b.Jg is None): ``T2`` is the per-camera stack
    [C, 2Gp, 2Gp] (Hgg is block-diagonal), ``red`` carries 6 Gp local Hcg
    columns and ``scg_corr`` [M, 6, G] is `_scg_correction`'s.

    ``cam_scatter`` (with ``comm``): ``red`` holds rank r's image rows
    [r M / D, (r + 1) M / D) (`reduce_blocks`); the per-image inputs are
    sliced to them, and the coupled preconditioner's sum over images is
    psum-ed (`rcs.finish_coupling`)."""
    G2 = p.free_global.shape[0]
    compact = b.Jg is None
    m_rows = red.shape[0]
    free_eo, de_w, de_val, eo = p.free_eo, p.de_w, p.de_val, state.eo
    if cam_scatter:
        rows = slice(comm.rank * m_rows, (comm.rank + 1) * m_rows)
        free_eo, eo = free_eo[rows], eo[rows]
        if de_w is not None:
            de_w, de_val = de_w[rows], de_val[rows]
        if scg_corr is not None:
            scg_corr = scg_corr[rows]
    bc = red[:, :6]
    extra_c = damping * red[:, 6:12] + (1.0 - free_eo)
    if de_w is not None:
        we = de_w * free_eo
        bc = bc + we * (de_val - eo)
        extra_c = extra_c + we * (1.0 + damping)
    rc = bc - red[:, 12:18]
    tri = red[:, 18:39]
    iu = np.triu_indices(6)
    iu0 = torch.as_tensor(iu[0], device=red.device)
    iu1 = torch.as_tensor(iu[1], device=red.device)
    Scc = red.new_zeros((m_rows, 6, 6))
    Scc[:, iu0, iu1] = tri
    Scc[:, iu1, iu0] = tri
    Scc = Scc + extra_c[:, :, None] * torch.eye(6, dtype=red.dtype,
                                                device=red.device)
    Minv_c = torch.linalg.inv_ex(Scc)[0]
    b = b._replace(bc=bc, extra_c=extra_c)

    rg = b.bg - rg_corr
    if compact:
        # Hgg is block-diagonal per camera (an image has one camera)
        Gp = len(b.Jg_loc) // 2
        fg2 = p.free_global.reshape(-1, Gp)
        Hblk = (T2[:, :Gp, :Gp] + T2[:, Gp:, Gp:]) \
            * fg2[:, :, None] * fg2[:, None, :]           # [C, Gp, Gp]
        Hgg = torch.block_diag(*Hblk.unbind(0)) + torch.diag(b.extra_g)
    else:
        Hgg = T2[:G2, :G2] + T2[G2:, G2:] + torch.diag(b.extra_g)
    corr_g = sum(T3[a * G2:(a + 1) * G2, a * G2:(a + 1) * G2]
                 for a in range(3))
    Sgg = Hgg - corr_g
    Minv_g = torch.linalg.inv_ex(Sgg)[0]
    if not couple_global:
        return b, rc, rg, rcs.Precond(Minv_c=Minv_c, Minv_g=Minv_g)
    if compact:
        # the 6 Gp local Hcg columns at the image's own camera (the
        # image -> camera one-hot), minus the non-local correction
        hcg_loc = red[:, 39:39 + 6 * Gp].reshape(m_rows, 6, Gp)
        oh = _camera_onehot(p, red.dtype).T               # [M, C]
        if cam_scatter:
            oh = oh[rows]
        Scg = torch.einsum("meg,mc->mecg", hcg_loc, oh).reshape(
            m_rows, 6, G2) - scg_corr
    else:
        Scg = red[:, 39:39 + 6 * G2].reshape(m_rows, 6, G2)
    Minv = rcs.finish_coupling(rcs.Precond(Minv_c=Minv_c, Minv_g=Minv_g),
                               Scg, Sgg,
                               comm_cam=comm if cam_scatter else None)
    return b, rc, rg, Minv


def materialize_global_rows(p: FMProblem, b: FMBlocks) -> FMBlocks:
    """Compact (multi-camera) FMBlocks -> the masked global rows Jg / PJg,
    O(C Gp N) memory, for consumers that index the global rows directly
    (`cov_direct`); the solve never calls it.  Single-camera blocks pass
    through."""
    if b.Jg is not None:
        return b
    Gp = len(b.Jg_loc) // 2
    C = p.free_global.shape[0] // Gp
    dt = b.Jp[0].dtype
    Jg, PJg = [], []
    for i in (0, 1):
        for c in range(C):
            s = (b.cam_obs == c).to(dt)
            for g in range(Gp):
                f = p.free_global[c * Gp + g]
                Jg.append(b.Jg_loc[i * Gp + g] * s * f)
                PJg.append(b.PJg_loc[i * Gp + g] * s * f)
    return b._replace(Jg=tuple(Jg), PJg=tuple(PJg))


@tracing.traced("back_substitute")
def back_substitute_points(p: FMProblem, b: FMBlocks, xc, xg,
                           cam_gather=None):
    """dx_p = Hpp^{-1} (bp - Hpx x): returns [P, 3]."""
    t = _t_rows(p, b, xc, xg, cam_gather)
    y = [_point_sum(p, b.Jp[a] * t[0] + b.Jp[3 + a] * t[1]) for a in range(3)]
    dx = _hinv_apply(b.Hpp_inv, b.bp[0] - y[0], b.bp[1] - y[1],
                     b.bp[2] - y[2])
    return torch.stack(dx, dim=1)


def omega_at(p: FMProblem, b: FMBlocks, dxp, dxc, dxg):
    """Omega(dx) at the linearisation point (getOmega semantics,
    BundleAdjustment.java:472-491)."""
    dxp_o = [_point_expand(p, dxp[:, a]) for a in range(3)]
    dxc_o = _gather_rows(p, dxc, 6)
    rows, xs = _global_terms(p, b, dxg, weighted=False)
    Gn = len(xs)
    v = []
    for i in (0, 1):
        jdx = sum(b.Jp[i * 3 + a] * dxp_o[a] for a in range(3))
        jdx = jdx + sum(b.Jc[i * 6 + a] * dxc_o[a] for a in range(6))
        jdx = jdx + sum(rows[i * Gn + g] * xs[g] for g in range(Gn))
        v.append(b.w[i] - jdx)
    pv0 = p.wxx * v[0] + p.wxy * v[1]
    pv1 = p.wxy * v[0] + p.wyy * v[1]
    return torch.sum(v[0] * pv0 + v[1] * pv1)


class PointOps(NamedTuple):
    """Point-block closures of one linearisation (feature-major)."""

    hinv: object     # v [..., P, 3] -> Hpp^{-1} v [..., P, 3]
    hinv_at: object  # idx [k] -> Hpp^{-1} blocks [k, 3, 3]
    hxp: object      # v [P, 3] -> (Hcp v [M, 6], Hgp v [G])
    hpx: object      # (xc [M, 6], xg [G]) -> Hpx x [P, 3]


def point_ops(p: FMProblem, b: FMBlocks, cam_gather=None) -> PointOps:
    """The point-block products that the mixed-precision refinement and
    `freenet` need (port of the JAX `engine.point_ops`, both layouts of the
    global rows).  Every [P, 3] argument and result is indexed by point id
    in either lane layout: `_point_sum` and `_point_expand` map between
    point ids and lanes, and Hpp^{-1} is held per point id.  ``hinv`` also
    takes a leading batch axis.  ``cam_gather``: the K3 wrapper for the
    camera rows of ``hpx``."""

    def hinv(v):
        return torch.stack(_hinv_apply(b.Hpp_inv, v[..., 0], v[..., 1],
                                       v[..., 2]), dim=-1)

    def hinv_at(idx):
        h = [r[idx] for r in b.Hpp_inv]  # 6 sym rows at selected points
        return torch.stack([
            torch.stack([h[0], h[1], h[2]], dim=1),
            torch.stack([h[1], h[3], h[4]], dim=1),
            torch.stack([h[2], h[4], h[5]], dim=1),
        ], dim=1)  # [k, 3, 3]

    def hxp(v):
        vo = [_point_expand(p, v[:, a]) for a in range(3)]
        u = [sum(b.PJp[i * 3 + a] * vo[a] for a in range(3)) for i in (0, 1)]
        qc = [b.Jc[a] * u[0] + b.Jc[6 + a] * u[1] for a in range(6)]
        return _global_out(p, b, u, qc)

    def hpx(xc, xg):
        t = _t_rows(p, b, xc, xg, cam_gather)
        return torch.stack(
            [_point_sum(p, b.Jp[a] * t[0] + b.Jp[3 + a] * t[1])
             for a in range(3)], dim=1)

    return PointOps(hinv=hinv, hinv_at=hinv_at, hxp=hxp, hpx=hpx)


def omega_at_full(p: FMProblem, rp: rcs.RCSProblem, b: FMBlocks, ext,
                  dxp, dxc, dxg, state: ParamState):
    """Omega(dx) including the scale-bar, direct-group (``ext``, a
    `freenet.Extras` or None) and diagonal direct-observation rows.
    ``rp`` is the RCSProblem that ``p`` was made from."""
    from . import freenet

    om = omega_at(p, b, dxp, dxc, dxg)
    if ext is not None:
        om = om + freenet.omega_extras(rp, ext, dxp)
    if p.dp_w is not None:
        v = (p.dp_val - state.points) - dxp
        om = om + torch.sum(p.dp_w * v * v)
    if p.de_w is not None:
        v = (p.de_val - state.eo) - dxc
        om = om + torch.sum(p.de_w * v * v)
    if p.dg_w is not None:
        v = (p.dg_val - _global_vector(state)) - dxg
        om = om + torch.sum(p.dg_w * v * v)
    return om


@tracing.traced("lm_step")
def lm_step_full(p: FMProblem, rp: rcs.RCSProblem, state: ParamState, spec,
                 damping, cg_tol=1e-10, cg_maxiter=200, use_kernels=False,
                 couple_global=True, state_lo: ParamState | None = None,
                 stall_limit=None, choose_precond=None):
    """`lm_step` extended with scale bars, the inner-constraint datum and
    populated direct groups: the exact low-rank corrections of
    `freenet` folded around the same assembly, matvec and
    back-substitution.  ``rp`` is the RCSProblem that ``p`` was made from
    (it carries the sb_* / datum / dpg_* fields).  A problem without such
    extras takes the `lm_step` route.
    Returns (dxp, dxc, dxg, blocks, cg_iterations, Extras or None)."""
    from . import freenet

    if not rp.has_extras:
        return (*lm_step(p, state, spec, damping, cg_tol=cg_tol,
                         cg_maxiter=cg_maxiter, use_kernels=use_kernels,
                         couple_global=couple_global, state_lo=state_lo,
                         stall_limit=stall_limit,
                         choose_precond=choose_precond), None)
    cgf = None
    if use_kernels:
        from . import kernels

        refuse_kernels(p)
        cgf = kernels.make_cam_gather(p)
        b, rc, rg, Minv, pp = kernels.prepare_kernels(
            p, state, spec, damping, couple_global=couple_global,
            state_lo=state_lo, cam_gather=cgf)
        base = kernels.make_matvec(pp, b.extra_c, b.extra_g)
    else:
        b, rc, rg, Minv = prepare(p, state, spec, damping,
                                  couple_global=couple_global,
                                  state_lo=state_lo)

        def base(c, g):
            return schur_matvec(p, b, c, g)
    if choose_precond is not None:
        Minv = choose_precond(Minv)
    ops = point_ops(p, b, cam_gather=cgf)
    ext = freenet.prepare_extras(rp, state, torch.stack(b.bp, dim=1), rc, rg,
                                 ops, b.omega0)
    b = b._replace(omega0=ext.omega0)
    xc, xg, it = rcs.pcg(
        ext.rc, ext.rg, freenet.wrap_precond(rcs.make_apply_M(Minv), ext),
        freenet.wrap_matvec(base, ext), tol=cg_tol, maxiter=cg_maxiter,
        stall_limit=stall_limit)
    dxp, _lam = freenet.back_substitute(rp, ext, ops, xc, xg)
    return dxp, xc, xg, b, it, ext


@tracing.traced("lm_step")
def lm_step(p: FMProblem, state: ParamState, spec, damping,
            cg_tol=1e-10, cg_maxiter=200, use_kernels=False,
            couple_global=True, state_lo: ParamState | None = None,
            stall_limit=None, choose_precond=None):
    """One LM inner solve; returns (dxp, dxc, dxg, blocks, cg_iterations).

    ``use_kernels``: run the assembly through K2 (`kernels.prepare_kernels`,
    one fused pass over the packed rows), every CG matvec through K1 and
    the camera gathers of linearise and back-substitution through K3; the
    rows are packed once per step and shared by K2 and K1.  ``p`` must
    then be view-major (`to_view_major`).  The wrappers launch the CUDA
    kernels for CUDA tensors and take their plain versions for CPU
    tensors.  The kernels take one camera: with C > 1 (the compact rows)
    ``use_kernels=True`` raises ValueError, and the step runs the plain
    path.  ``couple_global``: precondition with the exact camera-global
    blocks, assembled inside the fused reduction.  ``choose_precond``: a
    function of the assembled `rcs.Precond` that returns the one PCG
    takes (`solver.solve` passes `rcs.definite_coupling`, which drops the
    coupling where it is indefinite); None takes the assembled one, as
    the JAX engine does."""
    cgf = None
    if use_kernels:
        from . import kernels

        refuse_kernels(p)
        cgf = kernels.make_cam_gather(p)
        b, rc, rg, Minv, pp = kernels.prepare_kernels(
            p, state, spec, damping, couple_global=couple_global,
            state_lo=state_lo, cam_gather=cgf)
        matvec = kernels.make_matvec(pp, b.extra_c, b.extra_g)
    else:
        b, rc, rg, Minv = prepare(p, state, spec, damping,
                                  couple_global=couple_global,
                                  state_lo=state_lo)

        def matvec(c, g):
            return schur_matvec(p, b, c, g)

        matvec.capturable = True
    if choose_precond is not None:
        Minv = choose_precond(Minv)
    xc, xg, it = rcs.pcg(rc, rg, Minv, matvec, tol=cg_tol,
                         maxiter=cg_maxiter, stall_limit=stall_limit)
    del matvec  # K1's workspace goes before the back-substitution
    dxp = back_substitute_points(p, b, xc, xg, cam_gather=cgf)
    return dxp, xc, xg, b, it
