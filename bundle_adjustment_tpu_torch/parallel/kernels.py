"""Packed-row contract and the three main-path kernels (K1-K3).

Port of `bundle_adjustment_tpu/parallel/kernels.py`.  Every
per-observation quantity is a row of length N in the view-major blocked
order (`engine.to_view_major`): lane = i*pb*V + v*pb + p for point
i*pb + p.  One [F, N] f32 array holds the rows (`pack_fm`): a lean prefix
[Jp(6) Jc(12) Jg(2G) wxx wxy wyy], padded to 8 rows, that the matvec
reads, then the tail [PJp(6) PJc(12) PJg(2G) (Pw 2)] for the assembly.

Each kernel has
  * a plain PyTorch version (``*_plain``) of the same function, on the same
    inputs: the CPU tests compare it with the JAX reference, and the chip
    check compares the kernel with it;
  * a wrapper that takes the plain version only for CPU tensors, and for
    CUDA tensors checks device, dtype, shape and contiguity, launches the
    CUDA kernel on the current stream (or raises), and counts the launch
    in ``<wrapper>.launches``.

  K3 `cam_gather_rows`      csrc/cam_gather.cu        camera-row gather
  K1 `schur_matvec_rows`    csrc/schur_matvec.cu      implicit Schur matvec
  K2 `prepare_reduction`    csrc/prepare_reduction.cu fused assembly
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import engine

#: view-major block threads the CUDA kernels take (one CTA per block of
#: pb points x V views; csrc/common.cuh kMaxBlockThreads)
MAX_BLOCK_THREADS = 512
#: global parameters the CUDA kernels take (csrc/common.cuh kMaxG)
MAX_G = 16
#: chunks of the Gram partials in K2 (two per SM of an H100)
GRAM_CHUNKS = 264


class PackedFM(NamedTuple):
    packed: torch.Tensor   # [f_pad, N] f32 rows (layout above), view-major
    obs_img: torch.Tensor  # [N] int32 (view-major order)
    hppinv: torch.Tensor   # [8, P] f32 (rows 0-5: sym3 inverse 00..22)
    img_perm: torch.Tensor  # [Nip] int32 image-sorted blocked layout
    img_block_starts: torch.Tensor  # [M+1] int32
    num_points: int
    views: int
    num_images: int
    g: int                 # number of global parameters
    f_pad: int
    pb: int                # view-major point-block size (= engine vm_pb)


def _offsets(G, with_pw=False):
    lean = 21 + 2 * G
    lean_pad = ((lean + 7) // 8) * 8
    return dict(Jp=0, Jc=6, Jg=18, W=18 + 2 * G, F_lean=lean,
                F_lean_pad=lean_pad,
                PJp=lean_pad, PJc=lean_pad + 6, PJg=lean_pad + 18,
                Pw=lean_pad + 18 + 2 * G,
                F=lean_pad + 18 + 2 * G + (2 if with_pw else 0))


def choose_pb(P: int, V: int) -> int:
    """Largest point-block size for the CUDA kernels: a multiple of 32
    (coalesced warps) dividing P with V * pb <= MAX_BLOCK_THREADS."""
    best = 0
    for pb in range(32, MAX_BLOCK_THREADS // V + 1, 32):
        if P % pb == 0:
            best = pb
    if best == 0:
        raise ValueError(f"no block size for P={P}, V={V}: pad the problem "
                         "so that 32 divides P, with V <= 16")
    return best


def pack_fm(b, p, dtype=torch.float32, with_pw: bool = False,
            lean_only: bool = False) -> PackedFM:
    """Pack engine.FMBlocks rows into the kernel layout (one [F, N] array).
    ``p`` must be view-major (the rows come out of engine.linearize in that
    lane order).  ``with_pw`` appends the two P w rows the assembly needs;
    ``lean_only`` packs just the matvec prefix."""
    if p.vm_pb is None:
        raise ValueError("pack_fm requires the view-major layout; apply "
                         "engine.to_view_major to the FMProblem first")
    G = len(b.Jg) // 2
    off = _offsets(G, with_pw)
    lean_rows = list(b.Jp) + list(b.Jc) + list(b.Jg) + [p.wxx, p.wxy, p.wyy]
    zero = torch.zeros_like(lean_rows[0])
    if lean_only:
        rows = lean_rows
        F = off["F_lean"]
    else:
        rows = lean_rows + [zero] * (off["F_lean_pad"] - off["F_lean"]) \
            + list(b.PJp) + list(b.PJc) + list(b.PJg)
        if with_pw:
            rows += list(b.Pw)
        F = off["F"]
    f_pad = ((F + 7) // 8) * 8
    rows += [zero] * (f_pad - F)
    packed = torch.stack([r.to(dtype) for r in rows])
    hpp = torch.stack(list(b.Hpp_inv) + [torch.zeros_like(b.Hpp_inv[0])] * 2)
    return PackedFM(
        packed=packed, obs_img=p.obs_image.to(torch.int32).contiguous(),
        hppinv=hpp.to(dtype), img_perm=p.img_perm,
        img_block_starts=p.img_block_starts,
        num_points=p.num_points, views=p.views, num_images=p.num_images,
        g=G, f_pad=f_pad, pb=p.vm_pb)


def _view_sum(x, views, pb):
    """[k, N] -> [k, P]: sum over the V views of each view-major block."""
    k = x.shape[0]
    return x.reshape(k, -1, views, pb).sum(dim=2).reshape(k, -1)


def _view_bcast(z, views, pb):
    """[k, P] -> [k, N]: broadcast back over the V views."""
    k = z.shape[0]
    return z.reshape(k, -1, 1, pb).expand(k, z.shape[1] // pb, views,
                                          pb).reshape(k, -1)


# ---------------------------------------------------------------------------
# kernel launch plumbing
# ---------------------------------------------------------------------------

def _is_cpu(t: torch.Tensor) -> bool:
    """True: take the plain version.  False: launch the CUDA kernel.
    Any other device raises: there is no silent stand-in."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"kernels take CPU or CUDA tensors, not {t.device}")


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _launch(fn_name, *args):
    from .. import kernel_build

    fn = getattr(kernel_build.library(), fn_name)
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc}")


def _ptr(t):
    return t.data_ptr()


def _check_packed(pp: PackedFM, rows: int):
    dev = pp.packed.device
    f32, i32 = torch.float32, torch.int32
    N = pp.num_points * pp.views
    if pp.g > MAX_G:
        raise ValueError(f"G={pp.g} > {MAX_G}")
    if pp.pb % 32 or pp.pb * pp.views > MAX_BLOCK_THREADS:
        raise ValueError(f"pb={pp.pb}, V={pp.views}: the CUDA kernels take "
                         "pb % 32 == 0 and pb * V <= "
                         f"{MAX_BLOCK_THREADS} (kernels.choose_pb)")
    if pp.packed.shape[0] < rows:
        raise ValueError(f"packed has {pp.packed.shape[0]} rows, the kernel "
                         f"reads {rows}")
    _check("packed", pp.packed, f32, (pp.packed.shape[0], N), dev)
    _check("obs_img", pp.obs_img, i32, (N,), dev)
    _check("hppinv", pp.hppinv, f32, (8, pp.num_points), dev)
    _check("img_perm", pp.img_perm, i32, pp.img_perm.shape, dev)
    _check("img_block_starts", pp.img_block_starts, i32,
           (pp.num_images + 1,), dev)
    return dev


# ---------------------------------------------------------------------------
# K3: camera-row gather
# ---------------------------------------------------------------------------

def cam_gather_plain(tbl, obs_img):
    """out[c, n] = tbl[obs_img[n], c] for c < tbl.shape[1]; rows up to 8
    are zero.  [M, c<=8] -> [8, N] in tbl's dtype."""
    rows = tbl[obs_img.long()].T  # [c, N]
    return torch.cat([rows, rows.new_zeros((8 - rows.shape[0],
                                            rows.shape[1]))])


def cam_gather_rows(tbl, obs_img):
    """K3 wrapper: `cam_gather_plain` for CPU tensors, the CUDA kernel
    (f32 table, int32 indices) for CUDA tensors."""
    if _is_cpu(tbl):
        return cam_gather_plain(tbl, obs_img)
    M, c = tbl.shape
    if not 1 <= c <= 8:
        raise ValueError(f"cam_gather takes 1..8 columns, not {c}")
    N = obs_img.shape[0]
    _check("tbl", tbl, torch.float32, (M, c), tbl.device)
    _check("obs_img", obs_img, torch.int32, (N,), tbl.device)
    out = torch.empty((8, N), dtype=torch.float32, device=tbl.device)
    _launch("ba_cam_gather", _ptr(tbl), M, c, _ptr(obs_img), N, _ptr(out))
    cam_gather_rows.launches += 1
    return out


cam_gather_rows.launches = 0


def make_cam_gather(p):
    """fn(tbl [M, c<=8]) -> [8, N] over a view-major FMProblem's images."""
    if p.vm_pb is None:
        raise ValueError("make_cam_gather requires the view-major layout")
    obs_img = p.obs_image.to(torch.int32).contiguous()

    def gather(tbl):
        return cam_gather_rows(tbl.contiguous(), obs_img)

    return gather


# ---------------------------------------------------------------------------
# K1: Schur matvec
# ---------------------------------------------------------------------------

def schur_matvec_plain(pp: PackedFM, extra_c, extra_g, xc, xg):
    """S @ [xc; xg] from the lean packed prefix (see csrc/schur_matvec.cu);
    returns ([M, 6], [G])."""
    G, V, pb = pp.g, pp.views, pp.pb
    off = _offsets(G)
    pk = pp.packed
    Jp, Jc = pk[0:6], pk[off["Jc"]:off["Jc"] + 12]
    Jg = pk[off["Jg"]:off["Jg"] + 2 * G]
    wxx, wxy, wyy = pk[off["W"]], pk[off["W"] + 1], pk[off["W"] + 2]
    xcr = xc[pp.obs_img.long()].T                         # [6, N]
    s0 = (Jc[:6] * xcr).sum(0) + (Jg[:G] * xg[:, None]).sum(0)
    s1 = (Jc[6:] * xcr).sum(0) + (Jg[G:] * xg[:, None]).sum(0)
    t0 = wxx * s0 + wxy * s1
    t1 = wxy * s0 + wyy * s1
    y = _view_sum(Jp[:3] * t0 + Jp[3:] * t1, V, pb)      # [3, P]
    z = torch.stack(engine._hinv_apply(pp.hppinv[:6], y[0], y[1], y[2]))
    zo = _view_bcast(z, V, pb)                            # [3, N]
    r0 = (Jp[:3] * zo).sum(0)
    r1 = (Jp[3:] * zo).sum(0)
    tv0 = t0 - (wxx * r0 + wxy * r1)
    tv1 = t1 - (wxy * r0 + wyy * r1)
    qc = Jc[:6] * tv0 + Jc[6:] * tv1                      # [6, N]
    oc = engine._image_sum_stack(pp, list(qc))
    og = (Jg[:G] * tv0 + Jg[G:] * tv1).sum(1)
    return oc + extra_c * xc, og + extra_g * xg


def schur_matvec_rows(pp: PackedFM, extra_c, extra_g, xc, xg):
    """K1 wrapper: `schur_matvec_plain` for CPU tensors, the CUDA kernel
    for CUDA tensors."""
    if _is_cpu(pp.packed):
        return schur_matvec_plain(pp, extra_c, extra_g, xc, xg)
    G, M = pp.g, pp.num_images
    P, V = pp.num_points, pp.views
    N = P * V
    dev = _check_packed(pp, _offsets(G)["F_lean"])
    f32 = torch.float32
    _check("xc", xc, f32, (M, 6), dev)
    _check("xg", xg, f32, (G,), dev)
    _check("extra_c", extra_c, f32, (M, 6), dev)
    _check("extra_g", extra_g, f32, (G,), dev)
    scratch = torch.empty((N, 8), dtype=f32, device=dev)
    partial_g = torch.empty((P // pp.pb, G), dtype=f32, device=dev)
    out_c = torch.empty((M, 6), dtype=f32, device=dev)
    out_g = torch.empty((G,), dtype=f32, device=dev)
    _launch("ba_schur_matvec", _ptr(pp.packed), N, P, V, pp.pb, G,
            _ptr(pp.obs_img), _ptr(pp.hppinv), _ptr(xc), _ptr(xg),
            _ptr(extra_c), _ptr(extra_g), M, _ptr(pp.img_perm),
            _ptr(pp.img_block_starts), _ptr(scratch), _ptr(partial_g),
            _ptr(out_c), _ptr(out_g))
    schur_matvec_rows.launches += 1
    return out_c, out_g


schur_matvec_rows.launches = 0


def make_matvec(pp: PackedFM, extra_c, extra_g):
    """fn(xc [M, 6], xg [G]) -> ((S@x)_c [M, 6], (S@x)_g [G]) through K1."""
    extra_c = extra_c.contiguous()
    extra_g = extra_g.contiguous()

    def matvec(xc, xg):
        return schur_matvec_rows(pp, extra_c, extra_g, xc.contiguous(),
                                 xg.contiguous())

    return matvec


# ---------------------------------------------------------------------------
# K2: fused assembly reduction
# ---------------------------------------------------------------------------

def prepare_reduction_plain(pp: PackedFM):
    """(red [M, 39+6G], rg_corr [G], T2 [2G, 2G], T3 [3G, 3G]) from the
    full packed rows (pack_fm with_pw=True); see
    csrc/prepare_reduction.cu."""
    G, V, pb = pp.g, pp.views, pp.pb
    off = _offsets(G, with_pw=True)
    pk = pp.packed
    Jp, Jc = pk[0:6], pk[off["Jc"]:off["Jc"] + 12]
    Jg = pk[off["Jg"]:off["Jg"] + 2 * G]
    PJp = pk[off["PJp"]:off["PJp"] + 6]
    PJc = pk[off["PJc"]:off["PJc"] + 12]
    PJg = pk[off["PJg"]:off["PJg"] + 2 * G]
    Pw0, Pw1 = pk[off["Pw"]], pk[off["Pw"] + 1]
    h = pp.hppinv

    # bp -> z0 -> u0 (rhs Schur correction chain)
    bp = _view_sum(Jp[:3] * Pw0 + Jp[3:] * Pw1, V, pb)
    z0 = engine._hinv_apply(h[:6], bp[0], bp[1], bp[2])
    zo = _view_bcast(torch.stack(z0), V, pb)
    u0 = (PJp[:3] * zo).sum(0)
    u1 = (PJp[3:] * zo).sum(0)

    rows = [Jc[a] * Pw0 + Jc[6 + a] * Pw1 for a in range(6)]
    rows += [Jc[a] * PJc[a] + Jc[6 + a] * PJc[6 + a] for a in range(6)]
    rows += [Jc[a] * u0 + Jc[6 + a] * u1 for a in range(6)]
    hp = [[Jp[a] * PJc[e] + Jp[3 + a] * PJc[6 + e] for e in range(6)]
          for a in range(3)]
    hio = _view_bcast(h[:6], V, pb)
    for e in range(6):
        he = engine._hinv_apply(hio, hp[0][e], hp[1][e], hp[2][e])
        for f in range(e, 6):
            jpj = Jc[e] * PJc[f] + Jc[6 + e] * PJc[6 + f]
            rows.append(jpj - sum(he[a] * hp[a][f] for a in range(3)))
    # Hpg per point and W = Hpp^{-1} Hpg (row index a*G + g)
    hpg = _view_sum(torch.stack(
        [Jp[a] * PJg[g] + Jp[3 + a] * PJg[G + g]
         for a in range(3) for g in range(G)]), V, pb)     # [3G, P]
    Wg = [engine._hinv_apply(h[:6], hpg[g], hpg[G + g], hpg[2 * G + g])
          for g in range(G)]
    W_blk = torch.stack([Wg[g][a] for a in range(3) for g in range(G)])
    Wobs = _view_bcast(W_blk, V, pb)
    for e in range(6):
        for g in range(G):
            hcg = Jc[e] * PJg[g] + Jc[6 + e] * PJg[G + g]
            corr = sum(hp[a][e] * Wobs[a * G + g] for a in range(3))
            rows.append(hcg - corr)
    red = engine._image_sum_stack(pp, rows)
    rg_corr = (Jg[:G] * u0 + Jg[G:] * u1).sum(1)
    T2 = Jg @ PJg.T
    T3 = W_blk @ hpg.T
    return red, rg_corr, T2, T3


def prepare_reduction(pp: PackedFM):
    """K2 wrapper: `prepare_reduction_plain` for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    if _is_cpu(pp.packed):
        return prepare_reduction_plain(pp)
    G, M = pp.g, pp.num_images
    P, V = pp.num_points, pp.views
    N = P * V
    dev = _check_packed(pp, _offsets(G, with_pw=True)["F"])
    f32 = torch.float32
    F = 39 + 6 * G
    fs = (F + 3) // 4 * 4
    feat = torch.empty((N, fs), dtype=f32, device=dev)
    pg = torch.empty((6 * G, P), dtype=f32, device=dev)
    partial_rg = torch.empty((P // pp.pb, G), dtype=f32, device=dev)
    partial_t2 = torch.empty((GRAM_CHUNKS, 4 * G * G), dtype=f32, device=dev)
    partial_t3 = torch.empty((GRAM_CHUNKS, 9 * G * G), dtype=f32, device=dev)
    red = torch.empty((M, F), dtype=f32, device=dev)
    rg_corr = torch.empty((G,), dtype=f32, device=dev)
    T2 = torch.empty((2 * G, 2 * G), dtype=f32, device=dev)
    T3 = torch.empty((3 * G, 3 * G), dtype=f32, device=dev)
    _launch("ba_prepare_reduction", _ptr(pp.packed), N, P, V, pp.pb, G, M,
            _ptr(pp.hppinv), _ptr(pp.img_perm), _ptr(pp.img_block_starts),
            _ptr(feat), fs, _ptr(pg), _ptr(partial_rg), _ptr(partial_t2),
            _ptr(partial_t3), GRAM_CHUNKS, _ptr(red), _ptr(rg_corr),
            _ptr(T2), _ptr(T3))
    prepare_reduction.launches += 1
    return red, rg_corr, T2, T3


prepare_reduction.launches = 0


def prepare_kernels(p, state, spec, damping, couple_global: bool = True,
                    state_lo=None, cam_gather=None):
    """engine.prepare on the kernel path: linearise (PyTorch, gathers
    through ``cam_gather``), pack once, fused assembly through K2, finish
    in PyTorch.  Returns (blocks, rc, rg, Precond, PackedFM); the PackedFM
    feeds `make_matvec`, so the LM step packs exactly once.  ``p`` must be
    view-major."""
    b = engine.linearize(p, state, spec, damping, state_lo=state_lo,
                         cam_gather=cam_gather)
    pp = pack_fm(b, p, dtype=b.Jp[0].dtype, with_pw=True)
    red, rg_corr, T2, T3 = prepare_reduction(pp)
    out = engine.finish_reduction(p, b, state, damping, red, rg_corr, T2, T3,
                                  couple_global)
    return (*out, pp)


def launch_counts() -> dict:
    """Launches of each kernel wrapper since the last reset."""
    return {"cam_gather": cam_gather_rows.launches,
            "schur_matvec": schur_matvec_rows.launches,
            "prepare_reduction": prepare_reduction.launches}


def reset_launch_counts() -> None:
    cam_gather_rows.launches = 0
    schur_matvec_rows.launches = 0
    prepare_reduction.launches = 0
