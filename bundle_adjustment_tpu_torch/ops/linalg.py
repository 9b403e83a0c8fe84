"""Dense linear-algebra utilities (port of `bundle_adjustment_tpu/ops/linalg.py`
on `torch.linalg`).

The reference's numerics core (`adjustment/MathExtension.java`, survey A1/A2)
wraps packed LAPACK routines; here the same surface maps onto
`torch.linalg` (LAPACK on the CPU, cuSOLVER / MAGMA on the GPU):

  solve/inv (dppsv/dpptri, dspsv/dsptri)  ->  solve_spd / inv_spd,
                                              solve_symmetric / inv_symmetric
  pinv/cond via SVD (:102-215)            ->  pinv / cond
  dspevx selected eigenpairs (:448-494)   ->  eig_selected
"""

from __future__ import annotations

import torch


def solve_spd(N, n):
    """SPD solve via Cholesky (the dppsv path, MathExtension.java:239-264)."""
    L = torch.linalg.cholesky(N)
    return torch.cholesky_solve(n[..., None], L)[..., 0]


def inv_spd(N):
    """SPD inverse via Cholesky (dpptrf/dpptri, MathExtension.java:297-331)."""
    return torch.cholesky_inverse(torch.linalg.cholesky(N))


def check_factorisation(*infos) -> None:
    """Raise LinAlgError when a factorisation reported a zero pivot in its
    ``info`` (the `_ex` forms neither raise nor wait for the device)."""
    if any(bool((i != 0).any()) for i in infos if i is not None):
        raise torch.linalg.LinAlgError("singular normal-equation matrix")


def solve_symmetric(N, n):
    """Symmetric-indefinite solve (the dspsv/Bunch-Kaufman path,
    MathExtension.java:338-366): LU factorisation gives the identical
    solution for the bordered datum systems.  Raises LinAlgError on a zero
    pivot."""
    x, info = torch.linalg.solve_ex(N, n)
    check_factorisation(info)
    return x


def inv_symmetric(N):
    """Symmetric-indefinite inverse (dsptrf/dsptri,
    MathExtension.java:393-426), by LU.  Raises LinAlgError on a zero
    pivot."""
    Q, info = torch.linalg.inv_ex(N)
    check_factorisation(info)
    return Q


def pinv(A, tol=None):
    """Moore-Penrose pseudo-inverse via SVD (MathExtension.java:139-215)."""
    return torch.linalg.pinv(A, rtol=tol) if tol is not None \
        else torch.linalg.pinv(A)


def cond(A):
    """Spectral condition number via SVD (MathExtension.java:102-110)."""
    s = torch.linalg.svdvals(A)
    return s[..., 0] / s[..., -1]


def eig_selected(N, il: int, iu: int):
    """Selected eigenpairs il..iu (1-based, ascending) of a symmetric matrix
    (the dspevx path, MathExtension.java:448-494): the full decomposition,
    with the requested window sliced out."""
    w, v = torch.linalg.eigh(N)
    return w[..., il - 1:iu], v[..., :, il - 1:iu]
