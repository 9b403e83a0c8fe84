"""Tensor-parallel direct solve of the reduced camera system (port of
`bundle_adjustment_tpu/parallel/tp.py`).

An explicit dense reduced system S [u, u] (u = 6M + G, camera-major) is
assembled once (`cov_direct`'s pair-block assembly, with the damping of
the blocks) and factorised by a distributed blocked right-looking
Cholesky whose block rows live on different ranks: the ScaLAPACK
``pdpotrf`` block-cyclic layout, row block k on rank k % D.  Per block
step k:

* the owner broadcasts its diagonal block A_kk, every rank factors it
  (L_kk = chol(A_kk), the same bits everywhere);
* every rank solves its local panel of the rows still below k against
  L_kk^T (W = A_ik L_kk^{-T});
* one all_gather re-forms the column panel in natural block order;
* the trailing update is a local `torch.matmul` over the rows still left
  (only blocks > k, so the work shrinks with the elimination).

Memory per rank is n^2 / D.  The triangular solves stream block by block:
forward, the owner solves y_k and broadcasts it; backward, the ranks psum
their partial sums L_ik^T x_i and each solves x_k with the diagonal
blocks gathered once.  Every value the ranks compute from a collective is
the same bits on every rank.

What the port leaves out: the JAX module's second factorisation body
(`_chol_local`, a `fori_loop` with masked full-width updates) and its
switch `_MAX_UNROLL` exist only to bound XLA's compile time for a long
unrolled loop; a Python loop here compiles nothing, so the port keeps the
one block-cyclic body.

A factor is held as `DistFactor`: this rank's block rows (local block j =
global block j D + rank) and the sizes.  `gather_factor` re-forms the full
L on every rank (tests).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import cov_direct, engine


class DistFactor(NamedTuple):
    """This rank's block rows of a block-cyclic Cholesky factor: ``rows``
    [n / D, n], local block j = global block row j D + rank."""

    rows: torch.Tensor
    n: int
    block: int
    size: int
    rank: int


# ---------------------------------------------------------------------------
# explicit reduced system
# ---------------------------------------------------------------------------

def reduced_rhs(p: engine.FMProblem, b: engine.FMBlocks):
    """(rc [M, 6], rg [G]): bx - Hxp Hpp^{-1} bp for blocks of
    `engine.prepare` (``b.bc`` set)."""
    if b.bc is None:
        raise ValueError("reduced_rhs takes the blocks of engine.prepare")
    b = engine.materialize_global_rows(p, b)
    z0 = [engine._point_expand(p, z)
          for z in engine._hinv_apply(b.Hpp_inv, *b.bp)]
    u0 = [sum(b.PJp[i * 3 + a] * z0[a] for a in range(3)) for i in (0, 1)]
    rc = b.bc - engine._image_sum_stack(
        p, [b.Jc[a] * u0[0] + b.Jc[6 + a] * u0[1] for a in range(6)])
    G2 = len(b.Jg) // 2
    rg = b.bg - torch.stack([torch.sum(b.Jg[g] * u0[0] + b.Jg[G2 + g] * u0[1])
                             for g in range(G2)])
    return rc, rg


def assemble_reduced_system(p: engine.FMProblem, b: engine.FMBlocks):
    """The damped dense reduced (Schur) system and its rhs, (S [u, u],
    r [u]), u = 6M + G, camera-major, for the point-major FMProblem ``p``
    and its blocks from `engine.prepare` (their extra_c / extra_g carry the
    damping).  S is `cov_direct.assemble_reduced_dense` with the pair-block
    corrections added in a fixed order (``deterministic``), so every rank
    that assembles it holds the same bits."""
    if b.extra_c is None:
        raise ValueError("assemble_reduced_system takes the blocks of "
                         "engine.prepare (extra_c set)")
    S = cov_direct.assemble_reduced_dense(p, b, extra_c=b.extra_c,
                                          deterministic=True)
    rc, rg = reduced_rhs(p, b)
    return S, torch.cat([rc.reshape(-1), rg])


def pad_spd(S, r, n_pad: int):
    """Pad an SPD system to size ``n_pad`` with an identity diagonal (its
    factor is the identity; the padded rhs entries are zero)."""
    n = S.shape[0]
    if n_pad == n:
        return S, r
    Sp = torch.eye(n_pad, dtype=S.dtype, device=S.device)
    Sp[:n, :n] = S
    rp = r.new_zeros((n_pad,) + tuple(r.shape[1:]))
    rp[:n] = r
    return Sp, rp


# ---------------------------------------------------------------------------
# distributed blocked Cholesky
# ---------------------------------------------------------------------------

def _check_dims(n, D, block):
    if n % (D * block) != 0:
        raise ValueError(
            f"matrix size {n} must be a multiple of mesh size {D} x "
            f"block {block} (pad with pad_spd)")


def _cyclic_rows(S, D, rank, block):
    """This rank's block rows of S: global blocks rank, rank + D, ..."""
    n = S.shape[0]
    nb = n // block
    return S.reshape(nb, block, n)[rank::D].reshape(-1, n)


def distributed_cholesky(S, comm, block: int = 8) -> DistFactor:
    """Block-cyclic right-looking Cholesky of the SPD ``S`` [n, n] (every
    rank passes the same S; each keeps only its block rows).  Returns this
    rank's rows of the lower factor L (`DistFactor`; strict upper zero)."""
    D, d = comm.size, comm.rank
    n = S.shape[0]
    _check_dims(n, D, block)
    bs = block
    nb = n // bs
    nbl = nb // D
    Ab = _cyclic_rows(S, D, d, bs).clone().reshape(nbl, bs, n)
    for k in range(nb):
        g0 = k * bs
        owner, jloc = k % D, k // D
        Akk = Ab[jloc, :, g0:g0 + bs] if d == owner \
            else Ab.new_empty((bs, bs))
        Lkk = torch.linalg.cholesky(comm.broadcast(Akk, owner))
        # local blocks that can still lie below k: j >= jsl (the blocks at
        # or above k among them are masked; tb is the same on every rank)
        jsl = (k + 1) // D
        tb = nbl - jsl
        if tb > 0:
            gids = torch.arange(jsl, nbl, device=Ab.device) * D + d
            below = (gids > k).to(Ab.dtype)[:, None, None]
            W = torch.linalg.solve_triangular(
                Lkk, Ab[jsl:, :, g0:g0 + bs].reshape(tb * bs, bs).mT,
                upper=False).mT.reshape(tb, bs, bs) * below
            if k + 1 < nb:
                # natural-order trailing panel: gather, interleave the
                # cyclic blocks back to global order, drop the <= k blocks
                Wall = comm.all_gather(W[None], dim=0)   # [D, tb, bs, bs]
                Wnat = Wall.transpose(0, 1).reshape(tb * D * bs, bs)
                Wtrail = Wnat[(k + 1 - jsl * D) * bs:]
                Ab[jsl:, :, g0 + bs:] -= torch.matmul(
                    W.reshape(tb * bs, bs), Wtrail.mT).reshape(
                        tb, bs, n - g0 - bs)
            Ab[jsl:, :, g0:g0 + bs] = W
        if d == owner:
            Ab[jloc, :, g0:g0 + bs] = Lkk
            Ab[jloc, :, g0 + bs:] = 0.0
    return DistFactor(rows=Ab.reshape(nbl * bs, n), n=n, block=bs, size=D,
                      rank=d)


def gather_factor(L: DistFactor, comm) -> torch.Tensor:
    """The full factor [n, n] in natural row order on every rank."""
    nb, bs = L.n // L.block, L.block
    rows = comm.all_gather(L.rows.reshape(1, nb // L.size, bs, L.n), dim=0)
    return rows.transpose(0, 1).reshape(L.n, L.n)


def _diag_blocks(L: DistFactor, comm):
    """Every diagonal block L_kk [nb, bs, bs] on every rank (one gather)."""
    bs, D = L.block, L.size
    nbl = L.n // bs // D
    loc = L.rows.reshape(nbl, bs, L.n)
    own = torch.stack([loc[j, :, (j * D + L.rank) * bs:
                           (j * D + L.rank + 1) * bs] for j in range(nbl)])
    return comm.all_gather(own[None], dim=0).transpose(0, 1).reshape(
        nbl * D, bs, bs)


def distributed_cholesky_solve(L: DistFactor, r, comm):
    """Solve S x = r with the distributed factor ``L``; ``r`` [n] or
    [n, k] (several right-hand sides), the same on every rank.  Returns x
    with r's shape, the same bits on every rank."""
    squeeze = r.ndim == 1
    if squeeze:
        r = r[:, None]
    bs, D, n = L.block, L.size, L.n
    nb = n // bs
    loc = L.rows.reshape(nb // D, bs, n)
    Lkk = _diag_blocks(L, comm)
    y = torch.zeros_like(r)
    for k in range(nb):
        g0, owner = k * bs, k % D
        yk = r.new_empty((bs, r.shape[1]))
        if L.rank == owner:
            rk = r[g0:g0 + bs] - loc[k // D, :, :g0] @ y[:g0]
            yk = torch.linalg.solve_triangular(Lkk[k], rk, upper=False)
        y[g0:g0 + bs] = comm.broadcast(yk, owner)
    # backward: x_k = L_kk^{-T} (y_k - sum_{i > k} L_ik^T x_i), the sum
    # over this rank's rows below k, then psum-ed
    m = r.shape[1]
    gid = torch.arange(nb // D, device=r.device) * D + L.rank
    x = torch.zeros_like(r)
    for k in reversed(range(nb)):
        g0 = k * bs
        j0 = (k - L.rank) // D + 1 if k >= L.rank else 0  # gid > k from j0
        if j0 < nb // D:
            xb = x.reshape(nb, bs, m)[gid[j0:]].reshape(-1, m)
            part = loc[j0:, :, g0:g0 + bs].reshape(-1, bs).mT @ xb
        else:
            part = r.new_zeros((bs, m))
        c = comm.psum(part)
        x[g0:g0 + bs] = torch.linalg.solve_triangular(
            Lkk[k].mT, y[g0:g0 + bs] - c, upper=True)
    return x[:, 0] if squeeze else x


def solve_reduced_direct(problem: engine.FMProblem, b: engine.FMBlocks,
                         comm, block: int = 8):
    """Direct TP solve of the reduced system: assemble, pad to the ranks,
    factorise, solve.  Returns (xc [M, 6], xg [G]) as `rcs.pcg` does."""
    S, r = assemble_reduced_system(problem, b)
    u = S.shape[0]
    step = comm.size * block
    Sp, rp = pad_spd(S, r, -(-u // step) * step)
    L = distributed_cholesky(Sp, comm, block)
    x = distributed_cholesky_solve(L, rp, comm)[:u]
    M = problem.num_images
    return x[:6 * M].reshape(M, 6), x[6 * M:]


def reduced_cofactor_columns(L: DistFactor, indices, u: int, comm):
    """Selected columns of the reduced block's posterior cofactor S^{-1}
    from the distributed factor: the tolerance-free counterpart of the
    PCG recovery in `covariance.py` (the reference's REDUCED inversion
    mode, BundleAdjustment.java:255-298).  ``indices``: global columns in
    [0, u) (u the unpadded size); returns [u, k]."""
    idx = np.asarray(indices, np.int64).reshape(-1)
    if idx.size and not ((idx >= 0).all() and (idx < u).all()):
        raise ValueError(
            f"cofactor column indices must lie in [0, {u}); got "
            f"min={idx.min()} max={idx.max()} (an index in the padding "
            "would read the identity block)")
    dev = L.rows.device
    E = torch.zeros((L.n, idx.size), dtype=L.rows.dtype, device=dev)
    E[torch.as_tensor(idx, device=dev), torch.arange(idx.size, device=dev)] \
        = 1.0
    return distributed_cholesky_solve(L, E, comm)[:u]
