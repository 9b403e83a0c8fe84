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
product of interest.  The retained system is every column that is not an
EO column, wherever it lies: the JAX package retains a leading block of
d + 3P + IO + distortion columns, which on a network with held-fixed point
coordinates (fewer point columns than 3P) or points seen only by scale
bars (their columns follow the EO block) takes EO columns into the block
it also eliminates.
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
    retained: torch.Tensor  # [nR] the retained columns of the system
    info: torch.Tensor = None  # [M] LAPACK info of the 6x6 inverses (0 = ok)


def retained_columns(col_eo, total_size: int):
    """The columns [nR] of a bordered system of ``total_size`` that are not
    EO columns (``col_eo`` [M, 6], -1 where fixed), ascending: the system
    `reduce_eo` retains."""
    col_eo = torch.as_tensor(col_eo)
    keep = torch.ones(total_size, dtype=torch.bool, device=col_eo.device)
    keep[col_eo[col_eo >= 0].long()] = False
    return torch.nonzero(keep).flatten()


def reduce_eo(N, n, col_eo, retained) -> SchurFactors:
    """Schur-reduce all EO columns out of the bordered system.

    N, n     : preconditioned bordered system ([T, T], [T])
    col_eo   : [M, 6] global EO columns (int tensor), -1 where fixed
    retained : [nR] the columns kept (`retained_columns`: every column
               that is not an EO column)
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

    R = torch.as_tensor(retained, device=N.device).long()
    nR = R.shape[0]
    N12 = N[R[:, None], ec.reshape(1, -1)].reshape(nR, -1, 6)
    N12 = torch.where(mask[None, :, :], N12, 0.0)  # [nR, M, 6]

    W = torch.einsum("rmi,mij->rmj", N12, inv22)  # [nR, M, 6]
    M_ = N12.shape[1]
    S = N[R[:, None], R[None, :]] - W.reshape(nR, M_ * 6) \
        @ N12.reshape(nR, M_ * 6).T
    nr = n[R] - W.reshape(nR, -1) @ n2.reshape(-1)
    return SchurFactors(S=S, nr=nr, inv22=inv22, n2=n2, N12=N12, ec=ec,
                        mask=mask, retained=R, info=info)


def back_substitute(f: SchurFactors, dx1) -> torch.Tensor:
    """dx2 blocks [M, 6] from the retained solution dx1 [nR]
    (extractReducedParameters, BundleAdjustment.java:1344-1453)."""
    rhs = f.n2 - torch.einsum("rmi,r->mi", f.N12, dx1)
    dx2 = torch.einsum("mij,mj->mi", f.inv22, rhs)
    return torch.where(f.mask, dx2, 0.0)


def assemble_full_dx(f: SchurFactors, dx1, total_size: int) -> torch.Tensor:
    """Scatter (dx1, dx2) into the full bordered solution vector [T]."""
    dx = torch.zeros(total_size, dtype=dx1.dtype, device=dx1.device)
    dx[f.retained] = dx1
    dx2 = back_substitute(f, dx1)
    # accumulating index_put_: fixed order of the sums (index_add_ would
    # add with atomics on CUDA)
    dx.index_put_((f.ec.reshape(-1),),
                  torch.where(f.mask, dx2, 0.0).reshape(-1), accumulate=True)
    return dx
