"""Normal-equation assembly: N = A^T P A, n = A^T P w (port of
`bundle_adjustment_tpu/ops/assembly.py`).

Instead of the reference's per-row scalar scatter-adds
(`derivation/PartialDerivativeFactory.stackNormalEquationSystem`,
PartialDerivativeFactory.java:475-505), local per-observation blocks
H = J^T P J [L, L] and g = J^T P w [L] are computed batched over all image
observations and added into the dense bordered system on its flat view.
Fixed parameters map to a dump row/column that is sliced away: the array
analogue of the reference's ``column == Integer.MAX_VALUE`` skip.  The
sums run in a fixed order, so two assemblies of the same state give the
same bits (an `index_add_` on CUDA adds with atomics, in an order that
changes from run to run): the image observations' static indices are
sorted once (`_FixedSum`) and each entry's terms summed in that order by
`torch.segment_reduce`; the few scale-bar and direct-observation terms go
through an accumulating `index_put_` (which sorts on CUDA).

The bordered system layout matches the reference exactly: rows/cols 0..d-1
hold the (normalised) datum condition rows (`addDatumConditionRows`,
BundleAdjustment.java:493-635), the remaining u columns are the unknowns.

The ``make_*`` functions take the host `BundleProblem` and the device and
dtype to work in; the static index tensors are built there once, and the
returned functions take a `ParamState` of tensors on that device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import EPS
from ..models.problem import BundleProblem, ParamState
from . import analytic
from .residuals import image_point_jacobian, image_weight_2x2, predict_image_point


def _local_cols(problem: BundleProblem) -> np.ndarray:
    """Global column of every local parameter, per observation: [N, 12 + K]
    (order: point xyz, io, eo, distortion), -1 where fixed."""
    p = problem
    cams = p.cam_of_image[p.obs_image]
    return np.concatenate(
        [
            p.col_points[p.obs_point],  # [N, 3]
            p.col_io[cams],  # [N, 3]
            p.col_eo[p.obs_image],  # [N, 6]
            p.col_dist[cams],  # [N, K]
        ],
        axis=1,
    ).astype(np.int32)


def gather_local_params(state: ParamState, obs_point, obs_image, cam_of_image):
    """[N, 12 + K] local parameter vectors."""
    cams = cam_of_image[obs_image]
    return torch.cat([state.points[obs_point], state.io[cams],
                      state.eo[obs_image], state.dist[cams]], dim=1)


def make_image_block_fn(problem: BundleProblem, device, dtype=torch.float64):
    """Returns fn(state) -> (J [N,2,L], w [N,2], P2 [N,2,2]) for all image
    observations: the closed-form rows where `analytic.supports_spec`, else
    forward-mode AD of the collinearity + distortion model."""
    spec = problem.spec

    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    def flt(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device,
                               dtype=dtype)

    obs_point = idx(problem.obs_point)
    obs_image = idx(problem.obs_image)
    cam_of_image = idx(problem.cam_of_image)
    obs_xy = flt(problem.obs_xy)
    r0 = flt(problem.r0)[cam_of_image[obs_image]]
    P2 = image_weight_2x2(flt(problem.obs_var[:, 0]),
                          flt(problem.obs_var[:, 1]), flt(problem.obs_rho),
                          problem.sigma2_apriori)

    def blocks(state: ParamState):
        local = gather_local_params(state, obs_point, obs_image, cam_of_image)
        if analytic.supports_spec(spec):
            J, w = analytic.analytic_image_jacobian_and_residual(
                local, obs_xy, spec, r0)
        else:
            J = image_point_jacobian(local, spec, r0)
            w = obs_xy - predict_image_point(local, spec, r0)
        return J, w, P2

    return blocks


class _Rows:
    """Device tensors of the non-image observation kinds (scale bars,
    direct groups) and the scatter indices of a problem."""

    def __init__(self, p: BundleProblem, device, dtype):
        T = p.total_size
        self.T = T
        self.device = device

        def idx(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        def flt(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=device,
                                   dtype=dtype)

        def dump(cols):
            return torch.where(cols < 0, T, cols)

        self.cols_local = dump(idx(_local_cols(p)))  # [N, L]
        self.S = p.num_scale_bars
        if self.S:
            self.sb_a = idx(p.sb_a)
            self.sb_b = idx(p.sb_b)
            self.sb_len = flt(p.sb_length)
            self.sb_w = flt(p.sigma2_apriori / p.sb_var)
            self.sb_cols = dump(idx(np.concatenate(
                [p.col_points[p.sb_a], p.col_points[p.sb_b]], axis=1)))
        # direct groups: gather index into cat(points, io, dist, eo).ravel()
        offsets = np.cumsum([0, 3 * p.num_points, 3 * p.num_cameras,
                             p.num_cameras * p.spec.num_coefficients])
        self.groups = [(idx(offsets[dg.kind] + dg.flat), flt(dg.values),
                        flt(dg.weight), dump(idx(dg.col)))
                       for dg in p.direct_groups]

    def scale_bar_rows(self, state: ParamState):
        """(A [S, 6], w [S]) of the scale bars at ``state``."""
        pa = state.points[self.sb_a]
        pb = state.points[self.sb_b]
        dvec = pb - pa
        dist = torch.sqrt(torch.sum(dvec * dvec, dim=1))
        unit = dvec / dist[:, None]
        return torch.cat([-unit, unit], dim=1), self.sb_len - dist

    @staticmethod
    def gather_direct(state: ParamState, gidx):
        """Current values of the observed parameters of one direct group."""
        flat = torch.cat([state.points.reshape(-1), state.io.reshape(-1),
                          state.dist.reshape(-1), state.eo.reshape(-1)])
        return flat[gidx]


def make_assembler(problem: BundleProblem, device, dtype=torch.float64):
    """Returns fn(state, damping) -> (N [T,T], n [T], V [T]) building the full
    bordered, damped system plus the Jacobi preconditioner
    (createNormalEquation, BundleAdjustment.java:789-834).

    ``V`` is the diagonal preconditioner: 1/sqrt(diag N) where diag > EPS
    else 1 (:824-828).  Damping scales the diagonal of unknown columns
    multiplicatively: N_ii *= (1 + damping) (:814-822)."""
    p = problem
    T = p.total_size
    rows = _Rows(p, device, dtype)
    blocks_fn = make_image_block_fn(p, device, dtype)
    datum_mask = torch.as_tensor(p.datum_mask, device=device)
    col_datum = torch.as_tensor(np.asarray(p.col_points, np.int64),
                                device=device)
    d = p.defect

    def flat_index(cols):
        """[B, L] columns -> [B*L*L] indices into the flat [(T+1)^2] view."""
        return (cols[:, :, None] * (T + 1) + cols[:, None, :]).reshape(-1)

    img_sum = _FixedSum(flat_index(rows.cols_local))
    g_sum = _FixedSum(rows.cols_local)
    sb_idx = flat_index(rows.sb_cols) if rows.S else None
    dg_idx = [flat_index(c[None, :]) for _, _, _, c in rows.groups]

    def assemble(state: ParamState, damping):
        Nf = torch.zeros((T + 1) * (T + 1), dtype=dtype, device=device)
        n = torch.zeros(T + 1, dtype=dtype, device=device)

        # --- image observations
        J, w, P2 = blocks_fn(state)
        PJ = torch.einsum("nij,njc->nic", P2, J)
        H = torch.einsum("nir,nic->nrc", J, PJ)
        g = torch.einsum("nic,ni->nc", PJ, w)
        img_sum.add(Nf, H)
        g_sum.add(n, g)

        # --- scale bars (unit-vector rows; PartialDerivativeFactory.java:210-283)
        if rows.S:
            A, wsb = rows.scale_bar_rows(state)
            Hs = rows.sb_w[:, None, None] * A[:, :, None] * A[:, None, :]
            gs = rows.sb_w[:, None] * A * wsb[:, None]
            _add(Nf, sb_idx, Hs)
            _add(n, rows.sb_cols, gs)

        # --- directly observed parameters (identity rows)
        for (gidx, values, W, c), fidx in zip(rows.groups, dg_idx):
            wv = values - rows.gather_direct(state, gidx)
            _add(Nf, fidx, W)
            _add(n, c, W @ wv)

        N = Nf.view(T + 1, T + 1)[:T, :T]
        n = n[:T]

        # --- datum condition rows (bordered block, rows 0..d-1)
        if d > 0:
            B = _datum_rows(state.points, datum_mask, col_datum,
                            p.defect_flags, d, T)
            N[:d, :] = B
            N[:, :d] = B.T

        # --- multiplicative LM damping on unknown diagonals (:814-822);
        # constraint rows have zero diagonal, unaffected.
        diag = N.diagonal()
        diag.add_(diag * damping)

        # --- Jacobi preconditioner (:824-828)
        diag = N.diagonal()
        ok = diag > EPS
        V = torch.where(ok, 1.0 / torch.sqrt(torch.where(ok, diag, 1.0)),
                        torch.ones_like(diag))
        return N, n, V

    return assemble


class _FixedSum:
    """flat[idx] += vals for a static index array with repeats, in a fixed
    order: the indices are sorted once (stable), and each target entry's
    terms are summed in that order by `torch.segment_reduce` (one
    sequential sum per entry), then added at the unique indices."""

    def __init__(self, idx):
        idx = idx.reshape(-1)
        self.order = torch.argsort(idx, stable=True)
        self.uniq, self.counts = torch.unique_consecutive(
            idx[self.order], return_counts=True)

    def add(self, flat, vals):
        sums = torch.segment_reduce(vals.reshape(-1)[self.order], "sum",
                                    lengths=self.counts)
        flat[self.uniq] += sums


def _add(flat, idx, vals):
    """flat[idx] += vals (1-D ``flat``; repeated indices add up) by an
    accumulating `index_put_`: a fixed order of the sums on the CPU and on
    CUDA, so the result is the same bits every time."""
    flat.index_put_((idx.reshape(-1),), vals.reshape(-1), accumulate=True)


def _datum_rows(points, datum_mask, col_points, defect_flags, d, T):
    """Helmert inner-constraint rows, normalised to unit length
    (addDatumConditionRows, BundleAdjustment.java:493-635).

    Returns B [d, T]; entries only in datum-point coordinate columns."""
    dtype = points.dtype
    m = datum_mask.to(dtype)
    cnt = torch.sum(m)
    cx = torch.sum(points[:, 0] * m) / cnt
    cy = torch.sum(points[:, 1] * m) / cnt
    cz = torch.sum(points[:, 2] * m) / cnt
    x = (points[:, 0] - cx) * m
    y = (points[:, 1] - cy) * m
    z = (points[:, 2] - cz) * m

    tx, ty, tz, rx, ry, rz, s = defect_flags
    rows = []
    zero = torch.zeros_like(x)
    if tx:
        rows.append(torch.stack([m, zero, zero], dim=1))
    if ty:
        rows.append(torch.stack([zero, m, zero], dim=1))
    if tz:
        rows.append(torch.stack([zero, zero, m], dim=1))
    if rx:
        rows.append(torch.stack([zero, z, -y], dim=1))
    if ry:
        rows.append(torch.stack([-z, zero, x], dim=1))
    if rz:
        rows.append(torch.stack([y, -x, zero], dim=1))
    if s:
        rows.append(torch.stack([x, y, z], dim=1))

    vals = torch.stack(rows).reshape(d, -1)  # [d, 3P]
    vals = vals / torch.sqrt(torch.sum(vals * vals, dim=1, keepdim=True))
    c = torch.where(col_points < 0, T, col_points).reshape(-1)
    B = torch.zeros((d, T + 1), dtype=dtype, device=points.device)
    _add(B.view(-1), (torch.arange(d, device=c.device)[:, None] * (T + 1)
                      + c[None, :]), vals)
    return B[:, :T]


def make_omega_fn(problem: BundleProblem, device, dtype=torch.float64):
    """Returns fn(state, dx_full) -> Omega = sum v^T P v with
    v = w - A dx (getOmega, BundleAdjustment.java:472-491), evaluated at the
    state's linearisation point (a 0-d tensor)."""
    p = problem
    rows = _Rows(p, device, dtype)
    blocks_fn = make_image_block_fn(p, device, dtype)

    def omega(state: ParamState, dx_full):
        dxp = torch.cat([dx_full, dx_full.new_zeros(1)])  # dump = 0

        J, w, P2 = blocks_fn(state)
        v = w - torch.einsum("nic,nc->ni", J, dxp[rows.cols_local])
        om = torch.sum(torch.einsum("ni,nij,nj->n", v, P2, v))

        if rows.S:
            A, wsb = rows.scale_bar_rows(state)
            v = wsb - torch.sum(A * dxp[rows.sb_cols], dim=1)
            om = om + torch.sum(rows.sb_w * v * v)

        for gidx, values, W, c in rows.groups:
            v = values - rows.gather_direct(state, gidx) - dxp[c]
            om = om + v @ W @ v

        return om

    return omega
