"""What a kernel must move and compute, from the shapes alone, and the
least time an H100 SXM could take for it: the yardstick of the rooflines.

Copied from the port's `measure.py` (`matvec_cost`'s flops,
`matvec_rows_read`, `k1_work`, `k2_rows_read`, `k2_work`, `bound_ms`, the
peaks) as it stood when the benchmark was written, so that a later change
to the program cannot change the count.  N is the number of packed
observation rows (P x V, the points padded to the kernels' block), P the
padded points, M the images, G the globals (3 + the distortion
coefficients), V the views per point.  Every input byte is counted read
once and every output byte written once, none of a kernel's own
scratch."""

from __future__ import annotations

#: published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
#: device memory rate and the f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def matvec_flops(N, G, V):
    """Flops of one implicit Schur matvec (K1)."""
    flops_per_obs = (
        2 * (2 * 6 + 2 * G)      # s rows: Jc xc + Jg xg (+ W2 recombine)
        + 6
        + 3 * 3 + 3              # jt rows + point reduce
        + 15 / V                 # sym3 Hpp^{-1} apply per point
        + 2 * 6 + 2 + 6          # r rows, W2, tv
        + 6 * 3 + 6              # qc rows + image reduce
        + G * 3 + 2 * G          # qg rows + global reduce
    )
    return flops_per_obs * N


def matvec_rows_read(N, G):
    """Bytes of the lean rows K1 streams: (21 + 2G) rows x 4 B x N."""
    return (21 + 2 * G) * 4 * N


def k1_work(N, P, M, G, V):
    """(bytes, flops) one K1 call needs: the lean rows, the image index and
    the six Hpp^{-1} rows read once, xc / xg and the two diagonals read
    once, (S x)_c and (S x)_g written once."""
    io = matvec_rows_read(N, G) + 4 * N + 6 * 4 * P
    vec = (6 * M + G) * 4
    return io + 3 * vec, matvec_flops(N, G, V)


def k2_rows_read(N, G):
    """Bytes of the packed rows K2 reads: (38 + 4G) rows x 4 B x N."""
    return (38 + 4 * G) * 4 * N


def k2_work(N, P, M, G, V):
    """(bytes, flops) one K2 call needs: its rows and the Hpp^{-1} rows
    read once; red [M, 39 + 6G], rg_corr [G], T2 [2G, 2G] and T3 [3G, 3G]
    written once."""
    F = 39 + 6 * G
    out = (M * F + G + 4 * G * G + 9 * G * G) * 4
    per_obs = (
        (3 + 3 * G) * 3 + (3 + 3 * G)    # view terms, point sums
        + (1 + G) * 15 / V               # Hpp^{-1} applies per point
        + 10                             # u0
        + 18 * 3 + 18 * 3                # bc / Hcc diag / Jc^T u0, Hpc
        + 6 * 15 + 21 * 9                # Scc upper triangle
        + 6 * G * 9                      # Scg
        + 4 * G                          # Jg u0 and its sum
        + 8 * G * G + 18 * G * G / V     # T2, T3
        + F                              # per-image sums
    )
    return k2_rows_read(N, G) + 6 * 4 * P + out, per_obs * N


def bound_ms(work):
    """(ms, "bytes" | "operations"): the least time for ``work`` = (bytes,
    flops), the larger of bytes over the memory rate and flops over the
    f32 rate."""
    nbytes, flops = work
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"
