"""Direct (dense factored) posterior covariance: the one-program (fused)
path of `bundle_adjustment_tpu/parallel/cov_direct.py`.

The reduced camera + global system S (u = 6M + G; 3,010 at 500 images,
30,010 at 5,000) is small next to the points, so it is assembled densely
once, factorised, inverted, and every point's 3x3 posterior cofactor
block is recovered from S^{-1}:

    Q_cam   = S^{-1}
    Qpp[p]  = Hpp^{-1}[p] + C_p^T S^{-1} C_p
    C_p     = Hxp[:, p] Hpp^{-1}[p]   (nonzero at p's V image blocks and
                                       the global rows)

`cov_all` runs the path as `bench.py` times it: linearise at damping 0,
`assemble_reduced_dense`, `reduced_inverse`, `point_covariance_dense`.

What the port keeps and drops, and why: the JAX module shapes its data
movement for the TPU (split-bf16 matrix products, one-hot fills, e-major
panel orders, blocked triangular solves against XLA's temporaries, and
for its 1M-point configuration panel chunking, grouped dispatches of the
corrections and the recovery against a watchdog and a 16 GB chip).  Here
every product is a plain `torch.matmul` in exact f32 or f64 (TF32 is off,
see the package's ``__init__``), the corrections are pair blocks (see
`assemble_reduced_dense`), the factorisation and the inverse are one
`torch.linalg` call each, and the recovery gathers the blocks of S^{-1}
each point meets (`_pcd_chunk`); the dense panels (`_pcd_dense_all`) stay
as the recovery it is checked against.  At BASELINE config 5 (1M points,
5,000 images, u = 30,010) in f64 on an H100 80GB HBM3 at 700 W the whole
path takes 2.4 s at a 41 GB peak: corrections 0.27 s, inverse 1.66 s,
recovery 0.26 s (`chip_smoke.py` phase 16; PERF.md), so none of
the TPU's staging is needed.

Every function takes the feature-major `engine.FMProblem` in the uniform
point-major layout (observation n = point * V + view): the chunked passes
slice observations by point.  Multi-camera blocks (the engine's compact
rows) are materialised to the masked global rows first
(`engine.materialize_global_rows`, O(C Gp N): ~1.5 GB in f64 at 100k
points with C = 4), as in the JAX module.  Diagonal direct observations
enter through the lineariser (Hpp, extra_g) and extra_c; scale bars, an inner-constraint datum and populated
direct groups (`FMProblem.has_extras`) have no branch here, as in the JAX
module, and are refused.

Dtype: run it in f64.  At 100k points the Jacobi-scaled S has a condition
number ~1e8, and the S assembled in f32 is indefinite (`PERF.md`); at 1M
points it is 8.0e8 or more: an LU solve of the raw f64 S lies 2.2e-6 (of
each block's largest entry) from the Cholesky route, one of the
Jacobi-scaled S 1.6e-9.
"""

from __future__ import annotations

import numpy as np
import torch

from ..solver import tracing
from . import engine


def _choose_chunk(P: int, target: int = 4096) -> int:
    """Largest chunk <= target dividing P."""
    best = 1
    for c in range(1, min(P, target) + 1):
        if P % c == 0:
            best = c
    return best


def _obs_image(p: engine.FMProblem) -> torch.Tensor:
    """obs_image as [P, V] int64; refuses the view-major layout, whose
    observations are not grouped by point."""
    if p.vm_pb is not None:
        raise ValueError("cov_direct takes the point-major layout (the "
                         "FMProblem before engine.to_view_major)")
    return p.obs_image.long().reshape(p.num_points, p.views)


def _sym3(rows):
    """6 symmetric rows (00, 01, 02, 11, 12, 22) [k] -> [k, 3, 3]."""
    return torch.stack([
        torch.stack([rows[0], rows[1], rows[2]], dim=1),
        torch.stack([rows[1], rows[3], rows[4]], dim=1),
        torch.stack([rows[2], rows[4], rows[5]], dim=1),
    ], dim=1)


def _sym_rows(Q):
    """[k, 3, 3] -> the 6 symmetric rows [6, k]."""
    return torch.stack([Q[:, 0, 0], Q[:, 0, 1], Q[:, 0, 2],
                        Q[:, 1, 1], Q[:, 1, 2], Q[:, 2, 2]])


def _hpc_rows2d(b: engine.FMBlocks):
    """Hpc as 18 rows [18, N], row index a*6 + e."""
    return torch.stack([b.Jp[a] * b.PJc[e] + b.Jp[3 + a] * b.PJc[6 + e]
                        for a in range(3) for e in range(6)])


def _hpg_rows2d(p: engine.FMProblem, b: engine.FMBlocks):
    """Per-point Hpg as rows [3G, P], row index a*G + g."""
    G2 = len(b.Jg) // 2
    return torch.stack([
        engine._point_sum(p, b.Jp[a] * b.PJg[g] + b.Jp[3 + a] * b.PJg[G2 + g])
        for a in range(3) for g in range(G2)])


def _w_rows2d(b: engine.FMBlocks, hpg_rows, G2):
    """W = Hpp^{-1} Hpg as rows [3G, P], row index a*G + g."""
    z = [engine._hinv_apply(b.Hpp_inv, hpg_rows[g], hpg_rows[G2 + g],
                            hpg_rows[2 * G2 + g]) for g in range(G2)]
    return torch.stack([z[g][a] for a in range(3) for g in range(G2)])


def _hinv3(b: engine.FMBlocks):
    """Hpp^{-1} as [P, 3, 3] from the 6 symmetric rows."""
    return _sym3(b.Hpp_inv)


# ---------------------------------------------------------------------------
# the reduced system
# ---------------------------------------------------------------------------

@tracing.traced("cov.assemble_base")
def assemble_reduced_base(p: engine.FMProblem, b: engine.FMBlocks,
                          damping=0.0, extra_c=None):
    """S0 [u, u]: the per-image Hcc (+ extra_c on the diagonal) and Hcg
    blocks and the global Sgg = Hgg - sum_p Hgp Hpp^{-1} Hpg, with the
    camera-camera and camera-global corrections still missing (see
    `assemble_reduced_corrections`).
    Camera-major rows: (image m, component e) -> 6m + e, globals last.
    The per-image sums are the deterministic `engine._image_sum_stack`.
    ``extra_c`` [M, 6]: the diagonal term as `engine.finish_reduction` set
    it (blocks of `engine.prepare`); default: from ``damping``."""
    if p.has_extras:
        raise NotImplementedError(
            "cov_direct has no branch for scale bars, an inner-constraint "
            "datum or a populated direct group")
    b = engine.materialize_global_rows(p, b)
    M, G2 = p.num_images, len(b.Jg) // 2
    K = 6 * M
    dt, dev = b.Jp[0].dtype, b.Jp[0].device
    iu = np.triu_indices(6)
    rows = [b.Jc[e] * b.PJc[f] + b.Jc[6 + e] * b.PJc[6 + f]
            for e, f in zip(*iu)]
    rows += [b.Jc[e] * b.PJg[g] + b.Jc[6 + e] * b.PJg[G2 + g]
             for e in range(6) for g in range(G2)]
    red = engine._image_sum_stack(p, rows)                # [M, 21 + 6G]
    del rows
    iu0 = torch.as_tensor(iu[0], device=dev)
    iu1 = torch.as_tensor(iu[1], device=dev)
    Hcc = red.new_zeros((M, 6, 6))
    Hcc[:, iu0, iu1] = red[:, :21]
    Hcc[:, iu1, iu0] = red[:, :21]
    Hcg = red[:, 21:].reshape(K, G2)

    # extra_c as engine.finish_reduction: damping on the diagonal, unit
    # rows for fixed EO, the weights of directly observed EO
    if extra_c is None:
        extra_c = damping * torch.diagonal(Hcc, dim1=1, dim2=2) \
            + (1.0 - p.free_eo)
        if p.de_w is not None:
            extra_c = extra_c + p.de_w * p.free_eo * (1.0 + damping)
    Hcc = Hcc + torch.diag_embed(extra_c)

    T2 = torch.stack(b.Jg) @ torch.stack(b.PJg).T         # [2G, 2G]
    Hgg = T2[:G2, :G2] + T2[G2:, G2:] + torch.diag(b.extra_g)
    hpg_rows = _hpg_rows2d(p, b)
    T3 = _w_rows2d(b, hpg_rows, G2) @ hpg_rows.T          # [3G, 3G]
    Sgg = Hgg - sum(T3[a * G2:(a + 1) * G2, a * G2:(a + 1) * G2]
                    for a in range(3))

    S0 = torch.zeros((K + G2, K + G2), dtype=dt, device=dev)
    i6 = torch.arange(6, device=dev)
    base = 6 * torch.arange(M, device=dev)[:, None, None]
    S0[(base + i6[None, :, None]).expand(M, 6, 6),
       (base + i6[None, None, :]).expand(M, 6, 6)] = Hcc
    S0[:K, K:] = Hcg
    S0[K:, :K] = Hcg.T
    S0[K:, K:] = Sgg
    return S0


def panel_rows(p: engine.FMProblem, b: engine.FMBlocks):
    """(hpc2 [18, N], brow2 [18, N], W_rows [3G, P]): Hpc as rows, its
    Hpp^{-1}-applied twin (row a*6 + e of Hpp^{-1} Hpc per observation),
    and W = Hpp^{-1} Hpg as rows."""
    b = engine.materialize_global_rows(p, b)
    G2 = len(b.Jg) // 2
    hpc2 = _hpc_rows2d(b)
    hinv_obs = [engine._point_expand(p, h) for h in b.Hpp_inv]
    bro = [engine._hinv_apply(hinv_obs, hpc2[e], hpc2[6 + e], hpc2[12 + e])
           for e in range(6)]
    brow2 = torch.stack([bro[e][a] for a in range(3) for e in range(6)])
    W_rows = _w_rows2d(b, _hpg_rows2d(p, b), G2)
    return hpc2, brow2, W_rows


def _fill_panel(rows2, im, o0, M):
    """Dense panel [c, 3, 6M] of one chunk of c points (images ``im``
    [c, V], first observation ``o0``) from 18 rows [18, N]: entry
    (j, a, 6m + e) is the sum over point j's views with image m of
    rows2[a*6 + e, obs].  One accumulating indexed add, so a point that
    sees an image twice sums both."""
    c, V = im.shape
    dev = rows2.device
    h = rows2[:, o0:o0 + c * V].reshape(3, 6, c, V).permute(2, 3, 0, 1)
    row = torch.arange(3 * c, device=dev).reshape(c, 1, 3, 1)
    col = 6 * im[:, :, None, None] + torch.arange(6, device=dev)
    D = rows2.new_zeros((c, 3, 6 * M))
    D.view(-1).index_put_(((row * (6 * M) + col).reshape(-1),),
                          h.reshape(-1), accumulate=True)
    return D


@tracing.traced("cov.corrections")
def assemble_reduced_corrections(p: engine.FMProblem, b: engine.FMBlocks,
                                 S0=None, chunk: int | None = None,
                                 deterministic: bool = False):
    """Camera-camera and camera-global corrections as sparse pair blocks:
    each point touches only its V image blocks, so its correction is
    [V, V, 6, 6] pair blocks, index-added into Acc.  O(36 P V^2) flops
    (~6e10 at 1M points, against 6 P K^2 ~ 5e15 for dense panel products
    at K = 30,000).

    ``index_add_`` on CUDA accumulates with atomics, so by default the
    result is not reproducible bit for bit (the covariance feeds no stall
    rule).  ``deterministic``: add by an accumulating `index_put_` instead
    (it sorts the indices on CUDA and sums in that fixed order; slower),
    as `tp` needs where every rank factors the same S.  With ``S0``
    returns the corrected S (`apply_corrections`, in place on S0), else
    (Acc [K, K], Acg [K, G])."""
    b = engine.materialize_global_rows(p, b)
    img = _obs_image(p)
    M, V, G2 = p.num_images, p.views, len(b.Jg) // 2
    K = 6 * M
    P_ = p.num_points
    if chunk is None:
        # the [c, V, V, 6, 6] pair tensor: ~300 MB in f64
        chunk = _choose_chunk(P_, min(4096, max(64, int(3.0e8
                                                        / (V * V * 288)))))
    hpc2 = _hpc_rows2d(b)
    W_rows = _w_rows2d(b, _hpg_rows2d(p, b), G2)
    hinv = _hinv3(b)
    dev = hpc2.device
    i6 = torch.arange(6, device=dev)
    Acc = hpc2.new_zeros((K, K))
    Acg = hpc2.new_zeros((K, G2))
    for c0 in range(0, P_, chunk):
        c = min(chunk, P_ - c0)
        hpc_v = hpc2[:, c0 * V:(c0 + c) * V].T.reshape(c, V, 3, 6)
        im6 = 6 * img[c0:c0 + c]                          # [c, V]
        Bv = torch.einsum("cab,cvbe->cvae", hinv[c0:c0 + c], hpc_v)
        pair = torch.einsum("cvae,cwaf->cvwef", hpc_v, Bv)
        I = im6[:, :, None, None, None] + i6[None, None, None, :, None]
        J = im6[:, None, :, None, None] + i6[None, None, None, None, :]
        wc = W_rows[:, c0:c0 + c].reshape(3, G2, c).permute(2, 0, 1)
        pg = torch.einsum("cvae,cag->cveg", hpc_v, wc)    # [c, V, 6, G]
        Ig = (im6[:, :, None] + i6[None, None, :]).reshape(-1)
        if deterministic:
            Acc.view(-1).index_put_(((I * K + J).reshape(-1),),
                                    pair.reshape(-1), accumulate=True)
            Acg.index_put_((Ig,), pg.reshape(-1, G2), accumulate=True)
        else:
            Acc.view(-1).index_add_(0, (I * K + J).reshape(-1),
                                    pair.reshape(-1))
            Acg.index_add_(0, Ig, pg.reshape(-1, G2))
    if S0 is None:
        return Acc, Acg
    return apply_corrections(S0, Acc, Acg)


def apply_corrections(S0, Acc, Acg):
    """S = S0 - [[Acc, Acg], [Acg^T, 0]], in place on S0 (returned)."""
    K = Acc.shape[0]
    S0[:K, :K] -= Acc
    S0[:K, K:] -= Acg
    S0[K:, :K] -= Acg.T
    return S0


def assemble_reduced_dense(p: engine.FMProblem, b: engine.FMBlocks,
                           damping=0.0, extra_c=None,
                           deterministic: bool = False):
    """Dense reduced (Schur) system S [u, u], u = 6M + G, camera-major,
    exact for any visibility (duplicate (point, image) pairs included):
    `assemble_reduced_base` with the pair-block corrections.

    The JAX module also has a dense-panel form of the corrections (its
    choice below 6 P K^2 = 3e13 flops on a TPU).  On an H100 80GB HBM3 at
    700 W the pair blocks take 27 ms at 100k points and 0.27 s at 1M
    points / 5,000 images, where panels would need 6 P K^2 ~ 5e15 flops
    (PERF.md), so the port keeps one form.  ``extra_c``: see
    `assemble_reduced_base`; ``deterministic``: see
    `assemble_reduced_corrections`."""
    S0 = assemble_reduced_base(p, b, damping, extra_c=extra_c)
    return assemble_reduced_corrections(p, b, S0,
                                        deterministic=deterministic)


@tracing.traced("cov.inverse")
def reduced_inverse(S):
    """S^{-1} by Cholesky (the reduced system of a datum-fixed network is
    SPD), inverted in one call (`torch.cholesky_inverse`).  Raises
    RuntimeError, naming the dtype and the pivot, when the factorisation
    fails; the check reads ``info`` on the host (the one sync of the
    covariance path)."""
    L, info = torch.linalg.cholesky_ex(S)
    if int(info) != 0:
        raise RuntimeError(
            f"reduced_inverse: the Cholesky factorisation of S ({S.dtype}, "
            f"u = {S.shape[0]}) failed at pivot {int(info)}: S is not "
            "positive definite in this precision")
    return torch.cholesky_inverse(L)


# ---------------------------------------------------------------------------
# recovery
# ---------------------------------------------------------------------------

def _pcd_dense_all(p, brow2, w_rows, hinv_rows, Qred, G2: int, chunk: int,
                   starts=None):
    """Points' blocks by dense panels: per chunk the coupling panel
    C [c, 3, u] (row (j, b) = C_p's column b of point j: camera columns
    6m + e from the Hpp^{-1}-applied rows ``brow2``, global columns from
    ``w_rows``), Y = C Q^T in one product, and the 6 symmetric rows
    h + sum_u C_b * Y_d.  O(2 u^2 3P) flops, no gathers.  ``starts``: the
    first points of the chunks to recover (default: every chunk, all
    points).  Returns the 6 symmetric rows [6, k] of those points."""
    img = _obs_image(p)
    V = p.views
    u = Qred.shape[0]
    P_ = p.num_points
    parts = []
    for c0 in (range(0, P_, chunk) if starts is None else starts):
        c = min(chunk, P_ - c0)
        w = w_rows[:, c0:c0 + c].reshape(3, G2, c).permute(2, 0, 1)
        Cb = torch.cat([_fill_panel(brow2, img[c0:c0 + c], c0 * V,
                                    p.num_images), w], dim=2)
        Y = (Cb.reshape(3 * c, u) @ Qred.mT).reshape(c, 3, u)
        h = hinv_rows[:, c0:c0 + c]
        parts.append(torch.stack([
            h[k] + (Cb[:, bq] * Y[:, dq]).sum(dim=1)
            for k, (bq, dq) in enumerate(
                ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)))]))
    return torch.cat(parts, dim=1)


def dense_recovery_chunk(P: int, u: int) -> int:
    """Points per `_pcd_dense_all` chunk: its [3c, u] panel and product
    stay near 260 MB each in f64."""
    return _choose_chunk(P, min(4096, max(64, int(1.1e7 / max(u, 1)))))


def point_covariance_panels(p: engine.FMProblem, b: engine.FMBlocks, Qred,
                            starts=None):
    """The dense-panel recovery (`_pcd_dense_all`) of every point, or of
    the chunks of `dense_recovery_chunk` points that begin at ``starts``:
    the reference the block gathers of `point_covariance_dense` are held
    against.  Returns [k, 3, 3].

    Timed by `chip_smoke.py` on an NVIDIA H100 80GB HBM3, 700.00 W, f64:
    at u = 3,010 (100,352 points) the panels take 144.5 ms and the block
    gathers 25.4 ms (phase 7); at u = 30,010 (1,000,448 points) the
    panels take 643 ms for 4,096 points, ~157 s for all, and the block
    gathers 0.26 s for all (phase 16).  The gathers win at both sizes and
    their lead grows with u, so no problem takes the panels."""
    b = engine.materialize_global_rows(p, b)
    _, brow2, W_rows = panel_rows(p, b)
    return _sym3(_pcd_dense_all(
        p, brow2, W_rows, torch.stack(b.Hpp_inv), Qred, len(b.Jg) // 2,
        dense_recovery_chunk(p.num_points, Qred.shape[0]), starts))


def recovery_rows(p: engine.FMProblem, b: engine.FMBlocks):
    """(hpc2 [18, N], hinv_rows [6, P], hpg_rows [3G, P]): the rows the
    block-gather recovery (`_pcd_chunk`) and the pair blocks read."""
    b = engine.materialize_global_rows(p, b)
    return _hpc_rows2d(b), torch.stack(list(b.Hpp_inv)), _hpg_rows2d(p, b)


def recovery_bytes(V: int, G: int, itemsize: int) -> int:
    """Bytes per point of `_pcd_chunk`'s temporaries: the [6V, 6V] blocks
    of S^{-1} at its image pairs, two [6V, G] camera-global row panels,
    the [6V, 3] rows of E and of their product, and its 6V row indices
    (int64)."""
    V6 = 6 * V
    return V6 * (V6 + 2 * G + 6) * itemsize + 8 * V6


def recovery_chunk(k: int, V: int, G: int, dtype: torch.dtype,
                   target_bytes: float = 4.0e8, cap: int = 8192) -> int:
    """Points per `_pcd_chunk` call: as many as keep its temporaries
    (`recovery_bytes` in ``dtype``) within ``target_bytes``, at most
    ``cap`` and ``k``.  The callers take a remainder chunk, so the count
    need not divide ``k``."""
    per = recovery_bytes(V, G, torch.empty((), dtype=dtype).element_size())
    return max(1, min(k, cap, int(target_bytes // per)))


def _coupling(img, hpc2, hinv_rows, hpg_rows, G2, ids):
    """One side of C_p^T S^{-1} C_q for the points ``ids``: (Hpp^{-1}
    [c, 3, 3], E = Hpc^T Hpp^{-1} with rows (view v, component e)
    [c, 6V, 3], C_g = Hpg^T Hpp^{-1} [c, G, 3], the rows 6 m_v + e of
    S^{-1} that E meets [c, 6V])."""
    c, V = ids.shape[0], img.shape[1]
    dev = hpc2.device
    hin = _sym3(hinv_rows[:, ids])
    obs = ids[:, None] * V + torch.arange(V, device=dev)[None, :]
    hpc_v = hpc2[:, obs.reshape(-1)].T.reshape(c, V, 3, 6)
    hpg_c = hpg_rows[:, ids].reshape(3, G2, c).permute(2, 0, 1)
    E = torch.einsum("cvae,cab->cveb", hpc_v, hin).reshape(c, 6 * V, 3)
    Cg = torch.einsum("cag,cab->cgb", hpg_c, hin)
    rows = (6 * img[ids][:, :, None]
            + torch.arange(6, device=dev)[None, None, :]).reshape(c, 6 * V)
    return hin, E, Cg, rows


def _cross_blocks(Qred, G2, side_p, side_q):
    """C_p^T S^{-1} C_q [c, 3, 3] for paired sides (`_coupling`), from the
    blocks of S^{-1} they meet: the [c, 6V, 6V] camera blocks at their
    image pairs, each side's [c, 6V, G] camera-global rows and the global
    block.  A point that sees an image twice has two row groups for it,
    and both enter."""
    _, Ep, Cgp, rp = side_p
    _, Eq, Cgq, rq = side_q
    K = Qred.shape[0] - G2
    Qcg = Qred[:, K:]
    out = Ep.mT @ (Qred[rp[:, :, None], rq[:, None, :]] @ Eq)
    out = out + Ep.mT @ (Qcg[rp] @ Cgq)
    out = out + (Eq.mT @ (Qcg[rq] @ Cgp)).mT
    return out + Cgp.mT @ (Qred[K:, K:] @ Cgq)


def _pcd_chunk(img, hpc2, hinv_rows, hpg_rows, Qred, G2, ids):
    """The blocks of the points ``ids`` by block gathers: Hpp^{-1} +
    C_p^T S^{-1} C_p (`_cross_blocks`), the quantity of the JAX module's
    row-gather `_pcd_chunk`, exact for any visibility.  A point reads
    6V (6V + 2G) values of S^{-1}, against the 6V u of a row panel (~370x
    fewer at u = 30,010).  Returns the 6 symmetric rows [6, c]."""
    side = _coupling(img, hpc2, hinv_rows, hpg_rows, G2, ids)
    return _sym_rows(side[0] + _cross_blocks(Qred, G2, side, side))


@tracing.traced("cov.recovery")
def point_covariance_dense(p: engine.FMProblem, b: engine.FMBlocks, Qred,
                           point_ids=None, chunk: int | None = None):
    """3x3 posterior cofactor blocks Qpp[p] = Hpp^{-1} + C_p^T S^{-1} C_p
    of the selected points (all when ``point_ids`` is None), given
    Qred = S^{-1} (`reduced_inverse`), by block gathers of Qred
    (`_pcd_chunk`), ``chunk`` points at a time (default `recovery_chunk`).
    Returns [k, 3, 3]."""
    b = engine.materialize_global_rows(p, b)
    img = _obs_image(p)
    G2 = len(b.Jg) // 2
    hpc2, hinv_rows, hpg_rows = recovery_rows(p, b)
    if point_ids is None:
        point_ids = torch.arange(p.num_points, device=Qred.device)
    ids = torch.as_tensor(point_ids, device=Qred.device).long()
    k = ids.shape[0]
    if chunk is None:
        chunk = recovery_chunk(k, p.views, G2, Qred.dtype)
    return torch.cat([
        _sym3(_pcd_chunk(img, hpc2, hinv_rows, hpg_rows, Qred, G2,
                         ids[i:i + chunk]))
        for i in range(0, k, chunk)])


def camera_covariance_dense(Qred, image_ids):
    """6x6 cofactor blocks [k, 6, 6] of the selected images' EO: rows and
    columns 6m .. 6m + 5 of S^{-1}."""
    ids = torch.as_tensor(image_ids, device=Qred.device).long()
    idx = 6 * ids[:, None] + torch.arange(6, device=Qred.device)[None, :]
    return Qred[idx[:, :, None], idx[:, None, :]]


def point_pair_covariance_dense(p: engine.FMProblem, b: engine.FMBlocks,
                                Qred, pairs):
    """Cross-point 3x3 cofactor blocks Q[p, q] = C_p^T S^{-1} C_q of the
    given (p, q) pairs [k, 2]: the off-diagonal dispersion structure (for
    p = q this is the block without its direct term Hpp^{-1}, as in the
    JAX module).  Block gathers (`_cross_blocks`), `recovery_chunk` pairs
    at a time.  Returns [k, 3, 3]."""
    b = engine.materialize_global_rows(p, b)
    img = _obs_image(p)
    G2 = len(b.Jg) // 2
    rows = recovery_rows(p, b)
    pairs = torch.as_tensor(np.asarray(pairs), device=Qred.device).long()
    k = pairs.shape[0]
    chunk = recovery_chunk(k, p.views, G2, Qred.dtype)
    return torch.cat([
        _cross_blocks(Qred, G2,
                      _coupling(img, *rows, G2, pairs[i:i + chunk, 0]),
                      _coupling(img, *rows, G2, pairs[i:i + chunk, 1]))
        for i in range(0, k, chunk)])


@tracing.traced("cov_all")
def cov_all(fmp: engine.FMProblem, state, spec, cam_gather=None):
    """Every point's 3x3 posterior cofactor block [P, 3, 3] in the dtype of
    ``fmp``: linearise at damping 0 (``cam_gather``: the K3 wrapper,
    `kernels.make_cam_gather`, f32 only), the dense reduced system, its
    inverse and the recovery (`bench.py`'s fused covariance program)."""
    b = engine.materialize_global_rows(
        fmp, engine.linearize(fmp, state, spec, 0.0, cam_gather=cam_gather))
    S = assemble_reduced_dense(fmp, b)
    Qred = reduced_inverse(S)
    del S
    return point_covariance_dense(fmp, b, Qred)
