"""Batched EO-block Schur complement (port of
`bundle_adjustment_tpu/ops/schur.py`).

The reference eliminates each image's exterior-orientation block sequentially
(`reduceNormalEquationSystem`, BundleAdjustment.java:1197-1342) and
back-substitutes per image (`extractReducedParameters`, :1344-1453).  Because
EO blocks of different images never couple (no observation involves two
images) and each elimination only updates retained x retained entries, the
sequential loop is mathematically one *global* block elimination with a
block-diagonal N22, computed here batched:

    S  = N11 - N12 * blockdiag(inv N22_m) * N21      (one big matmul)
    nr = n1  - N12 * blockdiag(inv N22_m) * n2
    dx2_m = inv(N22_m) (n2_m - N21_m dx1)            (batched back-subst.)

The elimination keeps the points (+ IO + distortion + datum rows) and
removes the cameras, because the fully populated *point* covariance is the
product of interest.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SchurFactors(NamedTuple):
    S: torch.Tensor  # [nR, nR] reduced system
    nr: torch.Tensor  # [nR]
    inv22: torch.Tensor  # [M, 6, 6] per-image inverse EO blocks (masked)
    n2: torch.Tensor  # [M, 6]
    N12: torch.Tensor  # [nR, M, 6] coupling blocks (masked)
    ec: torch.Tensor  # [M, 6] EO column indices (clamped)
    mask: torch.Tensor  # [M, 6] valid-EO mask
    info: torch.Tensor = None  # [M] LAPACK info of the 6x6 inverses (0 = ok)


def reduce_eo(N, n, col_eo, n_reduced: int) -> SchurFactors:
    """Schur-reduce all EO columns out of the bordered system.

    N, n     : preconditioned bordered system ([T, T], [T])
    col_eo   : [M, 6] global EO columns (int tensor), -1 where fixed
    n_reduced: size of the retained leading block
               (d + 3P + free IO + free distortion)
    """
    mask = col_eo >= 0  # [M, 6]
    ec = torch.where(mask, col_eo, 0).long()

    # N22 blocks, masked: identity in fixed slots keeps them invertible and
    # inert (their coupling columns are zeroed below).
    N22 = N[ec[:, :, None], ec[:, None, :]]  # [M, 6, 6]
    m2 = mask[:, :, None] & mask[:, None, :]
    eye = torch.eye(6, dtype=N.dtype, device=N.device)
    N22 = torch.where(m2, N22, eye)
    inv22, info = torch.linalg.inv_ex(N22)
    inv22 = torch.where(m2, inv22, 0.0)

    n2 = torch.where(mask, n[ec], 0.0)  # [M, 6]

    N12 = N[:n_reduced][:, ec.reshape(-1)].reshape(n_reduced, -1, 6)
    N12 = torch.where(mask[None, :, :], N12, 0.0)  # [nR, M, 6]

    W = torch.einsum("rmi,mij->rmj", N12, inv22)  # [nR, M, 6]
    M_ = N12.shape[1]
    S = N[:n_reduced, :n_reduced] - W.reshape(n_reduced, M_ * 6) \
        @ N12.reshape(n_reduced, M_ * 6).T
    nr = n[:n_reduced] - W.reshape(n_reduced, -1) @ n2.reshape(-1)
    return SchurFactors(S=S, nr=nr, inv22=inv22, n2=n2, N12=N12, ec=ec,
                        mask=mask, info=info)


def back_substitute(f: SchurFactors, dx1) -> torch.Tensor:
    """dx2 blocks [M, 6] from the retained solution dx1 [nR]
    (extractReducedParameters, BundleAdjustment.java:1344-1453)."""
    rhs = f.n2 - torch.einsum("rmi,r->mi", f.N12, dx1)
    dx2 = torch.einsum("mij,mj->mi", f.inv22, rhs)
    return torch.where(f.mask, dx2, 0.0)


def assemble_full_dx(f: SchurFactors, dx1, total_size: int) -> torch.Tensor:
    """Scatter (dx1, dx2) into the full bordered solution vector [T]."""
    dx = torch.zeros(total_size, dtype=dx1.dtype, device=dx1.device)
    dx[: dx1.shape[0]] = dx1
    dx2 = back_substitute(f, dx1)
    # accumulating index_put_: fixed order of the sums (index_add_ would
    # add with atomics on CUDA)
    dx.index_put_((f.ec.reshape(-1),),
                  torch.where(f.mask, dx2, 0.0).reshape(-1), accumulate=True)
    return dx
