"""Plain bundle adjustment of the one-camera synthetic network.

Unknowns: every free point coordinate (the first three points are held
fixed: the datum), the six EO parameters of every image and the ten
globals (x0, y0, c and the seven distortion coefficients Cx, Cy, Bx, By,
k1, k2, k3).  The model is the collinearity equations with affinity,
tangential and radial distortion about r0; the Jacobian comes from
autograd (`torch.func.jacfwd`), not from closed forms.  The points are
eliminated per point and the reduced camera + global system S (u = 6M +
10) is assembled densely, Jacobi-scaled and solved or inverted by LU, so
that it gives a number in any precision.

Everything runs in the dtype of the arrays handed in, in chunks of points
so that the per-point blocks fit (`CHUNK_ENTRIES`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

#: entries of the per-point [82, 82] blocks held at once (f64: 1 GB, and
#: as much again for their flat indices)
CHUNK_ENTRIES = 1 << 27
#: globals: x0, y0, c, then the distortion coefficients
NG = 10


def observe(pt, eo, g, r0):
    """Image coordinates [2] of one observation of point ``pt`` [3] by an
    image of EO ``eo`` [6] (X0, Y0, Z0, omega, phi, kappa) with globals
    ``g`` [10]."""
    co, so = torch.cos(eo[3]), torch.sin(eo[3])
    cp, sp = torch.cos(eo[4]), torch.sin(eo[4])
    ck, sk = torch.cos(eo[5]), torch.sin(eo[5])
    r11, r12, r13 = cp * ck, -cp * sk, sp
    r21 = co * sk + so * sp * ck
    r22 = co * ck - so * sp * sk
    r23 = -so * cp
    r31 = so * sk - co * sp * ck
    r32 = so * ck + co * sp * sk
    r33 = co * cp
    d = pt - eo[:3]
    kx = r11 * d[0] + r21 * d[1] + r31 * d[2]
    ky = r12 * d[0] + r22 * d[1] + r32 * d[2]
    nd = r13 * d[0] + r23 * d[1] + r33 * d[2]
    x0, y0, c = g[0], g[1], g[2]
    cx, cy, bx, by = g[3], g[4], g[5], g[6]
    xs = -c * kx / nd
    ys = -c * ky / nd
    r2 = xs * xs + ys * ys
    rad = sum(g[6 + k] * (r2 ** k - r0 ** (2 * k)) for k in (1, 2, 3))
    dx = cx * xs + cy * ys + xs * rad \
        + bx * (r2 + 2 * xs * xs) + by * 2 * xs * ys
    dy = ys * rad + by * (r2 + 2 * ys * ys) + bx * 2 * xs * ys
    return torch.stack([x0 + xs + dx, y0 + ys + dy])


_jac = torch.func.vmap(torch.func.jacfwd(observe, argnums=(0, 1, 2)),
                       in_dims=(0, 0, None, None))
_obs = torch.func.vmap(observe, in_dims=(0, 0, None, None))


class Net(NamedTuple):
    """The network's observations of the real points, on a device, in the
    reference's dtype; point-major: row p * V + v."""

    xy: torch.Tensor         # [n V, 2]
    image: torch.Tensor      # [n V] int64
    free: torch.Tensor       # [n] 1 = free point, 0 = held fixed
    views: int
    num_images: int
    r0: float


class State(NamedTuple):
    points: torch.Tensor     # [n, 3]
    eo: torch.Tensor         # [M, 6]
    g: torch.Tensor          # [10]: io then dist


def make_net(obs_xy, obs_image, free_point, real_points, views, num_images,
             r0, device, dtype) -> Net:
    """The reference's view of a network (arrays of the generator):
    the observations of the ``real_points`` points (the dummy points and
    their zero-weight rows dropped)."""
    n = real_points * views
    return Net(
        xy=torch.as_tensor(obs_xy[:n], device=device).to(dtype),
        image=torch.as_tensor(obs_image[:n], device=device).long(),
        free=torch.as_tensor(free_point[:real_points, 0],
                             device=device).to(dtype),
        views=views, num_images=num_images, r0=float(r0))


def make_state(points, eo, io, dist, device, dtype) -> State:
    t = (lambda a: torch.as_tensor(a, device=device).to(dtype))
    return State(points=t(points), eo=t(eo),
                 g=torch.cat([t(io).reshape(-1), t(dist).reshape(-1)]))


def _chunks(net: Net):
    V = net.views
    n = net.free.shape[0]
    u_pt = 6 * V + NG
    c = max(1, CHUNK_ENTRIES // (u_pt * u_pt))
    return [(p0, min(n, p0 + c)) for p0 in range(0, n, c)]


def residuals(net: Net, x: State, p0: int, p1: int):
    """Residuals obs - model [(p1 - p0) V, 2] of points p0 .. p1."""
    V = net.views
    img = net.image[p0 * V:p1 * V]
    pts = x.points[p0:p1].repeat_interleave(V, dim=0)
    return net.xy[p0 * V:p1 * V] - _obs(pts, x.eo[img], x.g,
                                        torch.tensor(net.r0, dtype=x.g.dtype,
                                                     device=x.g.device))


def omega(net: Net, x: State) -> float:
    """Sum of the squared residuals (unit weights), accumulated in the
    state's dtype."""
    total = torch.zeros((), dtype=x.g.dtype, device=x.g.device)
    for p0, p1 in _chunks(net):
        r = residuals(net, x, p0, p1)
        total = total + (r * r).sum()
    return float(total)


class PointBlocks(NamedTuple):
    """Per-point blocks of points p0 .. p1 at one state."""

    idx: torch.Tensor    # [c, 6V + 10] reduced-system columns they meet
    Hinv: torch.Tensor   # [c, 3, 3] Hpp^{-1} (0 for fixed points)
    W: torch.Tensor      # [c, 3, 6V + 10] Hpx
    gp: torch.Tensor     # [c, 3] J_p^T r
    S: torch.Tensor      # [c, u_pt, u_pt] A^T A - W^T Hinv W
    bs: torch.Tensor     # [c, u_pt] A^T r - W^T Hinv gp


def point_blocks(net: Net, x: State, p0: int, p1: int) -> PointBlocks:
    V, M = net.views, net.num_images
    c = p1 - p0
    dt, dev = x.g.dtype, x.g.device
    img = net.image[p0 * V:p1 * V]
    pts = x.points[p0:p1].repeat_interleave(V, dim=0)
    r = residuals(net, x, p0, p1)
    Jp, Je, Jg = _jac(pts, x.eo[img], x.g,
                      torch.tensor(net.r0, dtype=dt, device=dev))
    free = net.free[p0:p1]
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
    return PointBlocks(idx=idx, Hinv=Hinv, W=W, gp=gp, S=S, bs=bs)


def reduced_system(net: Net, x: State, keep=False):
    """(S [u, u], bs [u], per-point (idx, Hinv, W, gp) of every chunk when
    ``keep``) at ``x``."""
    u = 6 * net.num_images + NG
    dt, dev = x.g.dtype, x.g.device
    S = torch.zeros((u, u), dtype=dt, device=dev)
    bs = torch.zeros(u, dtype=dt, device=dev)
    kept = []
    for p0, p1 in _chunks(net):
        pb = point_blocks(net, x, p0, p1)
        flat = pb.idx[:, :, None] * u + pb.idx[:, None, :]
        S.view(-1).index_add_(0, flat.reshape(-1), pb.S.reshape(-1))
        bs.index_add_(0, pb.idx.reshape(-1), pb.bs.reshape(-1))
        if keep:
            kept.append((p0, p1, pb.idx, pb.Hinv, pb.W, pb.gp))
        del pb, flat
    return S, bs, kept


def _scaled(S):
    """Jacobi scaling: (D S D, D) with D = diag(S)^{-1/2}."""
    d = torch.rsqrt(torch.diagonal(S))
    return S * d[:, None] * d[None, :], d


def solve_reduced(S, bs):
    """S^{-1} bs by LU of the Jacobi-scaled S."""
    Ss, d = _scaled(S)
    return d * torch.linalg.solve(Ss, d * bs)


def inverse_reduced(S):
    """S^{-1} by LU of the Jacobi-scaled S."""
    Ss, d = _scaled(S)
    Q = torch.linalg.inv(Ss)
    del Ss
    return Q.mul_(d[:, None]).mul_(d[None, :])


class GNResult(NamedTuple):
    state: State
    steps: int
    max_dx: list     # max|dx| of each step
    omega: float     # at the final state


def gauss_newton(net: Net, x: State, tolerance=1e-10, max_steps=6):
    """Undamped Gauss-Newton from ``x`` until max|dx| <= ``tolerance`` or
    ``max_steps`` steps, every step the full step."""
    M = net.num_images
    history = []
    for _ in range(max_steps):
        S, bs, kept = reduced_system(net, x, keep=True)
        dc = solve_reduced(S, bs)
        del S
        dp = torch.zeros_like(x.points)
        for p0, p1, idx, Hinv, W, gp in kept:
            rhs = gp - (W @ dc[idx][:, :, None])[:, :, 0]
            dp[p0:p1] = (Hinv @ rhs[:, :, None])[:, :, 0]
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


def point_covariances(net: Net, x: State):
    """Every real point's 3x3 posterior cofactor block [n, 3, 3] at ``x``:
    Hpp^{-1} + Hpp^{-1} W S^{-1} W^T Hpp^{-1} (0 for the fixed points)."""
    S, _, kept = reduced_system(net, x, keep=True)
    Q = inverse_reduced(S)
    del S
    out = torch.empty((net.free.shape[0], 3, 3), dtype=x.g.dtype,
                      device=x.g.device)
    for p0, p1, idx, Hinv, W, _ in kept:
        HW = Hinv @ W
        Qc = Q[idx[:, :, None], idx[:, None, :]]
        out[p0:p1] = Hinv + HW @ Qc @ HW.transpose(1, 2)
    return out
