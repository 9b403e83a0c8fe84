"""Plain bundle adjustment of the synthetic network as a camera rig.

`bundle`'s reference with C cameras: every camera has its own ten globals
(x0, y0, c and the seven distortion coefficients), and each observation
takes those of its image's camera.  The unknowns are the free point
coordinates, the six EO parameters of every image and the 10 C globals,
held as `bundle.State` with ``g`` = [io of every camera (C x 3), then the
distortion of every camera (C x 7)], the order in which the adjust job
hands in its answer.  The model is `bundle.observe`; the Jacobian comes
from autograd, the points are eliminated per point, and the reduced
system S (u = 6M + 10 C) is assembled densely, Jacobi-scaled and solved
by LU (`bundle.solve_reduced`).  With one camera it is `bundle`'s
reference.

Everything runs in the dtype of the arrays handed in, in chunks of points
so that the per-point blocks fit (`bundle.CHUNK_ENTRIES`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import bundle

NG = bundle.NG
State = bundle.State
GNResult = bundle.GNResult
#: IO parameters of a camera (x0, y0, c); the rest of NG are distortion
NIO = 3

_jac = torch.func.vmap(torch.func.jacfwd(bundle.observe, argnums=(0, 1, 2)),
                       in_dims=(0, 0, 0, None))
_obs = torch.func.vmap(bundle.observe, in_dims=(0, 0, 0, None))


class Net(NamedTuple):
    """`bundle.Net` with the camera of every image."""

    xy: torch.Tensor         # [n V, 2]
    image: torch.Tensor      # [n V] int64
    camera: torch.Tensor     # [M] int64: the camera of each image
    free: torch.Tensor       # [n] 1 = free point, 0 = held fixed
    views: int
    num_images: int
    num_cameras: int
    r0: float


def make_net(obs_xy, obs_image, cam_of_image, free_point, real_points,
             views, num_images, r0, device, dtype) -> Net:
    """`bundle.make_net` with ``cam_of_image`` [M], the camera of each
    image."""
    b = bundle.make_net(obs_xy, obs_image, free_point, real_points, views,
                        num_images, r0, device, dtype)
    camera = torch.as_tensor(cam_of_image, device=device).long()
    return Net(xy=b.xy, image=b.image, camera=camera, free=b.free,
               views=views, num_images=num_images,
               num_cameras=int(camera.max()) + 1, r0=b.r0)


def global_columns(C: int, device) -> torch.Tensor:
    """[C, NG] the position in ``g`` of each camera's ten globals."""
    c = torch.arange(C, device=device)[:, None]
    k = torch.arange(NG, device=device)[None, :]
    return torch.where(k < NIO, NIO * c + k, NIO * C + (NG - NIO) * c
                       + (k - NIO))


def camera_globals(net: Net, x: State) -> torch.Tensor:
    """[C, NG] each camera's globals in `bundle.observe`'s order."""
    return x.g[global_columns(net.num_cameras, x.g.device)]


def _chunks(net: Net):
    u_pt = 6 * net.views + NG * net.num_cameras
    c = max(1, bundle.CHUNK_ENTRIES // (u_pt * u_pt))
    n = net.free.shape[0]
    return [(p0, min(n, p0 + c)) for p0 in range(0, n, c)]


def _r0(x: State, net: Net):
    return torch.tensor(net.r0, dtype=x.g.dtype, device=x.g.device)


def residuals(net: Net, x: State, p0: int, p1: int):
    """Residuals obs - model [(p1 - p0) V, 2] of points p0 .. p1."""
    V = net.views
    img = net.image[p0 * V:p1 * V]
    pts = x.points[p0:p1].repeat_interleave(V, dim=0)
    g = camera_globals(net, x)[net.camera[img]]
    return net.xy[p0 * V:p1 * V] - _obs(pts, x.eo[img], g, _r0(x, net))


def omega(net: Net, x: State) -> float:
    """Sum of the squared residuals (unit weights), accumulated in the
    state's dtype."""
    total = torch.zeros((), dtype=x.g.dtype, device=x.g.device)
    for p0, p1 in _chunks(net):
        r = residuals(net, x, p0, p1)
        total = total + (r * r).sum()
    return float(total)


def point_blocks(net: Net, x: State, p0: int, p1: int) -> bundle.PointBlocks:
    """`bundle.point_blocks` with every camera's globals: each
    observation's global Jacobian lands in its camera's ten columns."""
    V, M, C = net.views, net.num_images, net.num_cameras
    c = p1 - p0
    dt, dev = x.g.dtype, x.g.device
    img = net.image[p0 * V:p1 * V]
    cam = net.camera[img]
    pts = x.points[p0:p1].repeat_interleave(V, dim=0)
    r = residuals(net, x, p0, p1)
    Jp, Je, Jg = _jac(pts, x.eo[img], camera_globals(net, x)[cam],
                      _r0(x, net))
    free = net.free[p0:p1]
    B = Jp.reshape(c, V * 2, 3) * free[:, None, None]
    Ae = Je.reshape(c, V, 2, 6)
    Ablk = torch.diag_embed(Ae.permute(0, 2, 3, 1))  # [c, 2, 6, V, V]
    Ablk = Ablk.permute(0, 3, 1, 4, 2).reshape(c, 2 * V, 6 * V)
    # [cV, 2, C, NG]: the row's ten columns of its own camera, 0 elsewhere
    onehot = torch.nn.functional.one_hot(cam, C).to(dt)
    Jcam = Jg[:, :, None, :] * onehot[:, None, :, None]
    cols = global_columns(C, dev).reshape(-1)
    Ag = torch.zeros((c * V, 2, NG * C), dtype=dt, device=dev)
    Ag[:, :, cols] = Jcam.reshape(c * V, 2, C * NG)
    A = torch.cat([Ablk, Ag.reshape(c, 2 * V, NG * C)], dim=2)
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
        (6 * M + torch.arange(NG * C, device=dev)).expand(c, NG * C)], dim=1)
    return bundle.PointBlocks(idx=idx, Hinv=Hinv, W=W, gp=gp, S=S, bs=bs)


def reduced_system(net: Net, x: State, keep=False):
    """(S [u, u], bs [u], per-point (idx, Hinv, W, gp) of every chunk when
    ``keep``) at ``x``; u = 6M + 10 C."""
    u = 6 * net.num_images + NG * net.num_cameras
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
