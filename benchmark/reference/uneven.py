"""Plain bundle adjustment of a network whose points are seen by
different numbers of images.

`bundle`'s reference with the views of each point wherever they lie in
the observations (file order) and in any number: the unknowns, the model
(`bundle.observe`), the autograd Jacobians, the per-point elimination and
the dense Jacobi-scaled reduced system (u = 6M + 10) solved by LU are
`bundle`'s.  The points are taken in groups of the same view count V, and
each group in chunks so that the per-point [6V + 10]^2 blocks fit
(`bundle.CHUNK_ENTRIES`); a point's views keep their order in the
observations.  On a network whose every point has V views in point-major
order there is one group, its chunks are `bundle`'s, and every operation
is `bundle`'s in the same order: the same optimum, bit for bit.

Everything runs in the dtype of the arrays handed in.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import bundle

NG = bundle.NG
State = bundle.State
GNResult = bundle.GNResult


class Net(NamedTuple):
    """The observations on a device, in the reference's dtype, and the
    points grouped by view count."""

    xy: torch.Tensor         # [N, 2]
    image: torch.Tensor      # [N] int64
    free: torch.Tensor       # [n] 1 = free point, 0 = held fixed
    num_images: int
    r0: float
    # (V, point ids [c] int64, their rows [c, V] int64) of the points seen
    # V times, V ascending
    groups: tuple


def make_net(obs_xy, obs_image, obs_point, free_point, num_points,
             num_images, r0, device, dtype) -> Net:
    """The reference's view of a network of ``num_points`` points in any
    order of its observations (arrays of the generator); a point's rows
    in the order the observations list them."""
    point = np.asarray(obs_point, np.int64)
    counts = np.bincount(point, minlength=num_points)
    order = np.argsort(point, kind="stable")
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    groups = []
    for V in np.unique(counts[counts > 0]):
        ids = np.flatnonzero(counts == V)
        rows = order[first[ids][:, None] + np.arange(V)]
        groups.append((int(V), torch.as_tensor(ids, device=device),
                       torch.as_tensor(rows, device=device)))
    return Net(
        xy=torch.as_tensor(obs_xy, device=device).to(dtype),
        image=torch.as_tensor(obs_image, device=device).long(),
        free=torch.as_tensor(free_point[:num_points, 0],
                             device=device).to(dtype),
        num_images=num_images, r0=float(r0), groups=tuple(groups))


def _chunks(net: Net):
    """(point ids [c], rows [c, V]) of each chunk, group by group."""
    out = []
    for V, ids, rows in net.groups:
        u_pt = 6 * V + NG
        c = max(1, bundle.CHUNK_ENTRIES // (u_pt * u_pt))
        out += [(ids[p0:p0 + c], rows[p0:p0 + c])
                for p0 in range(0, ids.shape[0], c)]
    return out


def _r0(x: State, net: Net):
    return torch.tensor(net.r0, dtype=x.g.dtype, device=x.g.device)


def residuals(net: Net, x: State, ids, rows):
    """Residuals obs - model [c V, 2] of the points ``ids``."""
    r = rows.reshape(-1)
    pts = x.points[ids].repeat_interleave(rows.shape[1], dim=0)
    return net.xy[r] - bundle._obs(pts, x.eo[net.image[r]], x.g,
                                   _r0(x, net))


def omega(net: Net, x: State) -> float:
    """Sum of the squared residuals (unit weights), accumulated in the
    state's dtype."""
    total = torch.zeros((), dtype=x.g.dtype, device=x.g.device)
    for ids, rows in _chunks(net):
        r = residuals(net, x, ids, rows)
        total = total + (r * r).sum()
    return float(total)


def point_blocks(net: Net, x: State, ids, rows) -> bundle.PointBlocks:
    """`bundle.point_blocks` of the points ``ids``, each seen in its
    ``rows`` [c, V]."""
    c, V = rows.shape
    M = net.num_images
    dt, dev = x.g.dtype, x.g.device
    img = net.image[rows.reshape(-1)]
    pts = x.points[ids].repeat_interleave(V, dim=0)
    r = residuals(net, x, ids, rows)
    Jp, Je, Jg = bundle._jac(pts, x.eo[img], x.g, _r0(x, net))
    free = net.free[ids]
    B = Jp.reshape(c, V * 2, 3) * free[:, None, None]
    Ae = Je.reshape(c, V, 2, 6)
    # block-diagonal EO columns: row (v, k) meets columns 6v .. 6v + 5
    Ablk = torch.diag_embed(Ae.permute(0, 2, 3, 1))  # [c, 2, 6, V, V]
    Ablk = Ablk.permute(0, 3, 1, 4, 2).reshape(c, 2 * V, 6 * V)
    A = torch.cat([Ablk, Jg.reshape(c, 2 * V, NG)], dim=2)
    rr = r.reshape(c, 2 * V)
    Hpp = B.transpose(1, 2) @ B
    eye = torch.eye(3, dtype=dt, device=dev)
    Hpp = Hpp + (1 - free)[:, None, None] * eye
    Hinv = torch.linalg.inv(Hpp) * free[:, None, None]
    W = B.transpose(1, 2) @ A
    gp = (B.transpose(1, 2) @ rr[:, :, None])[:, :, 0]
    HW = Hinv @ W
    S = A.transpose(1, 2) @ A - W.transpose(1, 2) @ HW
    bs = (A.transpose(1, 2) @ rr[:, :, None])[:, :, 0] \
        - (HW.transpose(1, 2) @ gp[:, :, None])[:, :, 0]
    im = img.reshape(c, V)
    idx = torch.cat([
        (6 * im[:, :, None] + torch.arange(6, device=dev)).reshape(c, 6 * V),
        (6 * M + torch.arange(NG, device=dev)).expand(c, NG)], dim=1)
    return bundle.PointBlocks(idx=idx, Hinv=Hinv, W=W, gp=gp, S=S, bs=bs)


def reduced_system(net: Net, x: State, keep=False):
    """(S [u, u], bs [u], per-chunk (ids, idx, Hinv, W, gp) when
    ``keep``) at ``x``."""
    u = 6 * net.num_images + NG
    dt, dev = x.g.dtype, x.g.device
    S = torch.zeros((u, u), dtype=dt, device=dev)
    bs = torch.zeros(u, dtype=dt, device=dev)
    kept = []
    for ids, rows in _chunks(net):
        pb = point_blocks(net, x, ids, rows)
        flat = pb.idx[:, :, None] * u + pb.idx[:, None, :]
        S.view(-1).index_add_(0, flat.reshape(-1), pb.S.reshape(-1))
        bs.index_add_(0, pb.idx.reshape(-1), pb.bs.reshape(-1))
        if keep:
            kept.append((ids, pb.idx, pb.Hinv, pb.W, pb.gp))
        del pb, flat
    return S, bs, kept


def gauss_newton(net: Net, x: State, tolerance=1e-10, max_steps=6):
    """Undamped Gauss-Newton from ``x`` until max|dx| <= ``tolerance`` or
    ``max_steps`` steps, every step the full step."""
    M = net.num_images
    history = []
    for _ in range(max_steps):
        S, bs, kept = reduced_system(net, x, keep=True)
        dc = bundle.solve_reduced(S, bs)
        del S
        dp = torch.zeros_like(x.points)
        for ids, idx, Hinv, W, gp in kept:
            rhs = gp - (W @ dc[idx][:, :, None])[:, :, 0]
            dp[ids] = (Hinv @ rhs[:, :, None])[:, :, 0]
        del kept
        x = State(points=x.points + dp,
                  eo=x.eo + dc[:6 * M].reshape(M, 6),
                  g=x.g + dc[6 * M:])
        step = max(float(dp.abs().max()), float(dc.abs().max()))
        history.append(step)
        if not step > tolerance:
            break
    return GNResult(state=x, steps=len(history), max_dx=history,
                    omega=omega(net, x))
