"""Packed-row contract, the three solve kernels (K1-K3), the per-image sum
of feature rows and the two matvec probes (K4 read floor, K1 stages).

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
  K4 `read_floor`           csrc/read_floor.cu        pure-read floor
     `matvec_stage`         csrc/schur_matvec.cu      K1 cut into stages
     `image_sum_rows`       csrc/image_sum.cu         per-image row sums

K1, K2 and K4 share one pipeline (csrc/common.cuh): a persistent grid of
one CTA per SM, tiles of one view-major block brought into a shared-memory
ring by asynchronous bulk copies.  K1 and K2 take their per-image sums by
writing each observation's values at its image-sorted position
(`PackedFM.img_pos`) and streaming over them; `image_sum_rows`, the card's
route of `engine._image_sum_stack` for every other caller, sums any F rows
in the same two-level order (`image_sum_sorted_plain` is the plain model of
that order).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..solver import tracing
from . import engine

#: view-major block threads the CUDA kernels take (one CTA per block of
#: pb points x V views; csrc/common.cuh kMaxBlockThreads)
MAX_BLOCK_THREADS = 512
#: global parameters the CUDA kernels take (csrc/common.cuh kMaxG)
MAX_G = 16
#: chunks of the two-pass column sum that finishes K2's T2 / T3 partials
#: (csrc/common.cuh kColChunks)
COLUMN_SUM_CHUNKS = 32


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
    # inverse of img_perm (engine.image_positions): where K1 and K2 write
    # each observation's values for their streaming per-image pass
    img_pos: torch.Tensor | None = None          # [N] int32
    img_block_valid: torch.Tensor | None = None  # [Nip / 512] int32


def _offsets(G, with_pw=False):
    lean = 21 + 2 * G
    lean_pad = ((lean + 7) // 8) * 8
    return dict(Jp=0, Jc=6, Jg=18, W=18 + 2 * G, F_lean=lean,
                F_lean_pad=lean_pad,
                PJp=lean_pad, PJc=lean_pad + 6, PJg=lean_pad + 18,
                Pw=lean_pad + 18 + 2 * G,
                F=lean_pad + 18 + 2 * G + (2 if with_pw else 0))


#: dynamic shared memory one block may opt in to on the H100 (227 KiB);
#: the kernels read the card's own value when they launch
MAX_SMEM_H100 = 232448
#: K2's shared-memory layout (csrc/prepare_reduction.cu kChunkStep and
#: kRowPad, csrc/common.cuh kRingHeader)
K2_CHUNK_STEP = 8
K2_ROW_PAD = 4
RING_HEADER = 128
#: shape limits of the CUDA kernels, for the errors below
SHAPE_LIMITS = (f"the CUDA kernels take V <= {MAX_BLOCK_THREADS // 32} views "
                f"per point, a point count divisible by 32 (engine."
                f"pad_problem) and G <= {MAX_G} global parameters")


def k2_tile_fits(pb: int, V: int, G: int,
                 max_smem: int = MAX_SMEM_H100) -> bool:
    """Whether K2 launches at this block: one ring stage (its tile of
    38 + 4G rows x V * pb lanes, the img_pos row and six Hpp^{-1} rows of
    pb points) beside the kernel's own shared memory at its narrowest
    feature chunk (csrc/prepare_reduction.cu `prepare_plan`, which the
    library exports as `ba_prepare_fits`; tests/test_torch_cuda.py holds
    this model against it over every block the kernels take).  K1's tile
    (23 + 2G rows) fits wherever K2's does."""
    nthr = V * pb
    stage = ((38 + 4 * G) + 1) * nthr * 4 + 6 * pb * 4
    warps = MAX_BLOCK_THREADS // 32
    user = (nthr * (K2_CHUNK_STEP + K2_ROW_PAD) + (3 + 6 * G) * (pb + 1)
            + warps * MAX_G) * 4
    return RING_HEADER + stage + user <= max_smem


def choose_pb(P: int, V: int, G: int) -> int:
    """Largest point-block size for the CUDA kernels: a multiple of 32
    (coalesced warps) dividing P with V * pb <= MAX_BLOCK_THREADS and, for
    ``G`` global parameters (``FMProblem.free_global.shape[0]``), a K2 tile
    that fits shared memory (`k2_tile_fits`)."""
    best = 0
    for pb in range(32, MAX_BLOCK_THREADS // V + 1, 32):
        if P % pb == 0 and k2_tile_fits(pb, V, G):
            best = pb
    if best == 0:
        raise ValueError(
            f"no block size for P={P}, V={V}, G={G}: {SHAPE_LIMITS}, and "
            "K2's tile of 38 + 4G rows x V*pb lanes must fit shared memory "
            "beside its scratch")
    return best


#: the CUDA kernels each layout's route runs (``use_kernels``)
ROUTE_KERNELS = {"point_major": ("K1", "K2", "K3"), "file": ("K3",)}


def runs_kernels(problem, use_kernels, dtype: torch.dtype,
                 device: torch.device) -> bool:
    """Whether the route of a tensor `rcs.RCSProblem` runs its CUDA kernels
    (`ROUTE_KERNELS`), on tensors of ``dtype`` on ``device``, for
    ``use_kernels`` as `solver.solve`, `refine.Refiner` and
    `spmd.make_spmd_lm_step` take it: None, a bool, or kernel names.

    None runs them for f32 tensors on a card: in file order on any number
    of cameras (K3 gathers any camera's EO), point-major on one camera
    only (K1 and K2 do not read a rig's compact rows).  Names the route
    does not run, or not all of those it runs, raise ValueError that names
    the layout; the kernels on a point-major rig raise ValueError
    (`engine.refuse_kernels`)."""
    layout = "file" if problem.point_uniform is None else "point_major"
    if use_kernels is None:
        on = (device.type == "cuda" and dtype == torch.float32
              and (layout == "file" or engine.num_cameras(problem) == 1))
    elif isinstance(use_kernels, bool):
        on = use_kernels
    else:
        names = set(use_kernels)
        takes = set(ROUTE_KERNELS[layout])
        if names - takes:
            raise ValueError(
                f"{sorted(names - takes)} cannot run on a problem in the "
                f"{layout!r} layout: K1 and K2 read the packed rows of the "
                f"uniform point-major layout, and the file-order route runs "
                f"{ROUTE_KERNELS['file']} only (rcs.to_point_major re-lays "
                f"a network on request)")
        if names and names != takes:
            raise ValueError(f"the {layout!r} route runs {sorted(takes)} "
                             f"together, not {sorted(names)}")
        on = bool(names)
    if on and layout == "point_major":
        engine.refuse_kernels(problem)
    return on


def kernel_layout(p: engine.FMProblem) -> engine.FMProblem:
    """The layout K1 and K2 read, from a single-camera FMProblem: its
    view-major blocked order (`engine.to_view_major`) at the largest block
    the kernels take (`choose_pb`).  A rig raises ValueError
    (`engine.refuse_kernels`)."""
    engine.refuse_kernels(p)
    return engine.to_view_major(p, choose_pb(p.num_points, p.views,
                                             p.free_global.shape[0]))


def pack_fm(b, p, dtype=torch.float32, with_pw: bool = False,
            lean_only: bool = False) -> PackedFM:
    """Pack engine.FMBlocks rows into the kernel layout (one [F, N] array).
    ``p`` must be view-major (the rows come out of engine.linearize in that
    lane order).  ``with_pw`` appends the two P w rows the assembly needs;
    ``lean_only`` packs just the matvec prefix."""
    if p.vm_pb is None:
        raise ValueError("pack_fm requires the view-major layout; apply "
                         "engine.to_view_major to the FMProblem first")
    if b.Jg is None:
        raise ValueError(
            "the CUDA kernels take the single-camera packed rows; the "
            "compact multi-camera rows run the plain path (use_kernels="
            "False)")
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
        g=G, f_pad=f_pad, pb=p.vm_pb, img_pos=p.img_pos,
        img_block_valid=p.img_block_valid)


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


def _launch(fn_name, *args, shape=""):
    """Call one C entry point of the kernel library on the current stream;
    a non-zero return (a refused shape or launch) raises, with ``shape``
    naming the sizes that decide it."""
    from .. import kernel_build

    fn = getattr(kernel_build.library(), fn_name)
    stream = torch.cuda.current_stream().cuda_stream
    if tracing.ACTIVE:
        with tracing.span("kernel." + fn_name):
            rc = fn(*args, stream)
    else:
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc}"
                           + (f" ({shape})" if shape else ""))


def _ptr(t):
    return t.data_ptr()


def _check_packed(pp: PackedFM, rows: int, image_pass: bool = False):
    dev = pp.packed.device
    f32, i32 = torch.float32, torch.int32
    N = pp.num_points * pp.views
    if pp.g > MAX_G:
        raise ValueError(f"G={pp.g} > {MAX_G}: {SHAPE_LIMITS}")
    if pp.pb % 32 or pp.pb * pp.views > MAX_BLOCK_THREADS:
        raise ValueError(f"pb={pp.pb}, V={pp.views}: the CUDA kernels take "
                         "pb % 32 == 0 and pb * V <= "
                         f"{MAX_BLOCK_THREADS} (kernels.choose_pb); "
                         f"{SHAPE_LIMITS}")
    if pp.packed.shape[0] < rows:
        raise ValueError(f"packed has {pp.packed.shape[0]} rows, the kernel "
                         f"reads {rows}")
    _check("packed", pp.packed, f32, (pp.packed.shape[0], N), dev)
    _check("obs_img", pp.obs_img, i32, (N,), dev)
    _check("hppinv", pp.hppinv, f32, (8, pp.num_points), dev)
    if image_pass:
        if pp.img_pos is None or pp.img_block_valid is None:
            raise ValueError("the per-image pass needs img_pos and "
                             "img_block_valid (engine.image_positions)")
        _check("img_pos", pp.img_pos, i32, (N,), dev)
        _check("img_block_valid", pp.img_block_valid, i32,
               pp.img_block_valid.shape, dev)
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
    """fn(tbl [M, c<=8]) -> [8, N] over a problem's observations, in their
    order: an FMProblem in either lane layout or an RCSProblem in either
    layout (`rcs.LAYOUTS`); the gather is an indexed load per
    observation."""
    obs_img = p.obs_image.to(torch.int32).contiguous()

    def gather(tbl):
        return cam_gather_rows(tbl.contiguous(), obs_img)

    return gather


# ---------------------------------------------------------------------------
# per-image sums of feature rows (csrc/image_sum.cu), the two-level order
# they share with the streaming per-image pass of K1 and K2
# ---------------------------------------------------------------------------

#: feature rows one launch of the image-sum kernel takes (csrc/image_sum.cu
#: kMaxRows: its table of row pointers is a kernel parameter); the compact
#: rows' most is 99 (`engine.reduce_blocks`, coupled, Gp = 10)
MAX_IMAGE_SUM_ROWS = 128
#: bytes that an entry of the image-sum kernel's scratch spans a multiple
#: of (csrc/image_sum.cu kSector): the L2 never holds a partly written sector
IMAGE_SUM_SECTOR = 32
#: threads of one block sum and the most entry lanes it takes
#: (csrc/common.cuh kSumThreads, kSumMaxLanes)
SUM_THREADS = 512
SUM_MAX_LANES = 64


def block_sum_lanes(columns: int) -> int:
    """Entry lanes of a block sum over ``columns`` 16-byte columns
    (csrc/common.cuh `block_sum_lanes`)."""
    e = 1
    while 2 * e * columns <= SUM_THREADS and 2 * e <= SUM_MAX_LANES:
        e *= 2
    return e


def image_sum_columns(F: int, dtype) -> int:
    """F rounded up to whole `IMAGE_SUM_SECTOR`-byte sectors of ``dtype``:
    the width of an entry of `image_sum_rows`'s image-sorted scratch and of
    its block sums."""
    w = IMAGE_SUM_SECTOR * 8 // torch.finfo(dtype).bits
    return -(-F // w) * w


def image_sum_sorted_plain(p, x):
    """Per-image sums [..., M, F] of x [..., N, F] in the order the card
    takes them (`image_sum_rows`, whose bits this repeats; K1 and K2 take
    the same order at their own widths): row n goes to entry img_pos[n] of
    the image-sorted blocked layout; each 512-entry block sums its valid
    prefix, entry lane j adding the entries j, j + lanes, ... in order and
    the lanes then joined by a fixed tree (csrc/common.cuh `block_sum`;
    `block_sum_lanes` of the entry's 16-byte columns, per group of
    `MAX_IMAGE_SUM_ROWS` columns); each image adds its blocks in ascending
    order.  Equals `engine._image_sum_plain` up to the order of the
    sums."""
    blk = engine.rcs.IMG_BLOCK
    nb = p.img_block_valid.shape[0]
    *lead, _, F = x.shape
    if F > MAX_IMAGE_SUM_ROWS:   # one launch per group
        return torch.cat([
            image_sum_sorted_plain(p, x[..., f0:f0 + MAX_IMAGE_SUM_ROWS])
            for f0 in range(0, F, MAX_IMAGE_SUM_ROWS)], dim=-1)
    lanes = block_sum_lanes(
        image_sum_columns(F, x.dtype) * x.element_size() // 16)
    scratch = x.new_zeros((*lead, nb * blk, F))  # padding entries add 0
    scratch[..., p.img_pos.long(), :] = x
    sc = scratch.reshape(*lead, nb, blk // lanes, lanes, F)
    acc = torch.zeros_like(sc[..., 0, :, :])
    for r in range(blk // lanes):
        acc = acc + sc[..., r, :, :]
    s = lanes // 2
    while s:
        acc = acc[..., :s, :] + acc[..., s:2 * s, :]
        s //= 2
    bsum = acc[..., 0, :]                                # [..., nb, F]
    bs = p.img_block_starts.long()
    count = bs[1:] - bs[:-1]
    out = x.new_zeros((*lead, p.num_images, F))
    for k in range(int(count.max()) if count.numel() else 0):
        term = bsum[..., (bs[:-1] + k).clamp(max=max(nb - 1, 0)), :]
        out = out + torch.where((k < count)[:, None], term, 0.0)
    return out


def _refuse_row(f, r, shape, dtype, device):
    """Raise ValueError for row ``f`` of an `image_sum_rows` call that is
    not on ``device``, not of ``dtype`` and ``shape``, or strided."""
    name = f"rows[{f}]"
    if r.device != device:
        raise ValueError(f"{name}: on {r.device}, expected {device}")
    if r.dtype != dtype:
        raise ValueError(f"{name}: dtype {r.dtype}, expected {dtype}")
    if r.shape != shape:
        raise ValueError(f"{name}: shape {tuple(r.shape)}, expected "
                         f"{tuple(shape)}")
    raise ValueError(f"{name}: last-dimension stride {r.stride(-1)}, "
                     "expected 1")


def _lead_stride(f, r, L, N) -> int:
    """The stride between the L leading slices of row ``f`` flattened (N
    for one slice); ValueError where they do not flatten to one stride."""
    if L == 1:
        return N
    try:
        return r.view(L, N).stride(0)
    except RuntimeError as exc:
        raise ValueError(f"rows[{f}]: leading dimensions of strides "
                         f"{r.stride()[:-1]} do not flatten to one "
                         "stride") from exc


def image_sum_rows(p, rows):
    """Per-image sums [..., M, F] of the F feature rows ``rows`` (one shape
    [..., N], one dtype) over the image-sorted blocked layout of ``p`` (an
    FMProblem or a PackedFM with ``img_pos``, ``img_block_valid`` and
    ``img_block_starts``): `engine._image_sum_plain` for CPU tensors; for
    CUDA tensors csrc/image_sum.cu, in f32 or f64, on the rows where they lie
    (each with a last-dimension stride of 1 and leading dimensions that
    flatten to one stride), in `image_sum_sorted_plain`'s order, one launch
    per `MAX_IMAGE_SUM_ROWS` rows (the rows of a rig's materialized global
    columns exceed it: 21 + 6G in `cov_direct`).  Allocates its scratch and
    output with ``torch.empty`` and reads nothing back, so a CUDA graph may
    capture it."""
    x0 = rows[0]
    if _is_cpu(x0):
        return engine._image_sum_plain(p, rows)
    F = len(rows)
    dev, dt, shape = x0.device, x0.dtype, x0.shape
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"image_sum: dtype {dt}, expected float32 or "
                         "float64")
    N = shape[-1]
    lead = shape[:-1]
    L = 1
    for d in lead:
        L *= d
    ptrs, strides = [], []
    for f, r in enumerate(rows):
        if (r.shape != shape or r.dtype != dt or r.device != dev
                or (N > 1 and r.stride(-1) != 1)):
            _refuse_row(f, r, shape, dt, dev)
        ptrs.append(r.data_ptr())
        strides.append(_lead_stride(f, r, L, N))
    if p.img_pos is None or p.img_block_valid is None:
        raise ValueError("image_sum needs img_pos and img_block_valid "
                         "(engine.image_positions)")
    i32 = torch.int32
    M = p.num_images
    nb = p.img_block_valid.shape[0]
    nip = nb * engine.rcs.IMG_BLOCK
    _check("img_pos", p.img_pos, i32, (N,), dev)
    _check("img_block_valid", p.img_block_valid, i32, (nb,), dev)
    _check("img_block_starts", p.img_block_starts, i32, (M + 1,), dev)
    fs = image_sum_columns(min(F, MAX_IMAGE_SUM_ROWS), dt)
    scratch = torch.empty((L * (nip + nb) * fs,), dtype=dt, device=dev)
    out = torch.empty((*lead, M, F), dtype=dt, device=dev)
    for f0 in range(0, F, MAX_IMAGE_SUM_ROWS):
        fc = min(F - f0, MAX_IMAGE_SUM_ROWS)
        _launch("ba_image_sum", x0.element_size(),
                (ctypes.c_void_p * fc)(*ptrs[f0:f0 + fc]),
                (ctypes.c_longlong * fc)(*strides[f0:f0 + fc]), fc, L, N, M,
                _ptr(p.img_pos), _ptr(p.img_block_valid),
                _ptr(p.img_block_starts), nb, _ptr(scratch),
                _ptr(out) + f0 * out.element_size(), F,
                shape=f"{fc} rows, leading slices {L}, N={N}, M={M}, {nb} "
                      f"blocks: at most {MAX_IMAGE_SUM_ROWS} rows and 65535 "
                      "slices per launch")
        image_sum_rows.launches += 1
    return out


image_sum_rows.launches = 0


# ---------------------------------------------------------------------------
# K1: Schur matvec
# ---------------------------------------------------------------------------

def _matvec_terms(pp: PackedFM, xcr, xg, point_reduce: bool = True):
    """K1's per-observation terms (qc [6, N], qg [G, N]) from the lean
    packed prefix, given the camera rows ``xcr`` [6, N].  With
    ``point_reduce=False`` each lane applies its point's Hpp^{-1} to its
    own Jp^T t instead of the sum over the point's views (the lane-local
    stand-in of the `matvec_stage` probes)."""
    G, V, pb = pp.g, pp.views, pp.pb
    off = _offsets(G)
    pk = pp.packed
    Jp, Jc = pk[0:6], pk[off["Jc"]:off["Jc"] + 12]
    Jg = pk[off["Jg"]:off["Jg"] + 2 * G]
    wxx, wxy, wyy = pk[off["W"]], pk[off["W"] + 1], pk[off["W"] + 2]
    s0 = (Jc[:6] * xcr).sum(0) + (Jg[:G] * xg[:, None]).sum(0)
    s1 = (Jc[6:] * xcr).sum(0) + (Jg[G:] * xg[:, None]).sum(0)
    t0 = wxx * s0 + wxy * s1
    t1 = wxy * s0 + wyy * s1
    jt = Jp[:3] * t0 + Jp[3:] * t1                        # [3, N]
    if point_reduce:
        y = _view_sum(jt, V, pb)                          # [3, P]
        z = torch.stack(engine._hinv_apply(pp.hppinv[:6], y[0], y[1], y[2]))
        zo = _view_bcast(z, V, pb)                        # [3, N]
    else:
        h = _view_bcast(pp.hppinv[:6], V, pb)             # [6, N]
        zo = torch.stack(engine._hinv_apply(h, jt[0], jt[1], jt[2]))
    r0 = (Jp[:3] * zo).sum(0)
    r1 = (Jp[3:] * zo).sum(0)
    tv0 = t0 - (wxx * r0 + wxy * r1)
    tv1 = t1 - (wxy * r0 + wyy * r1)
    qc = Jc[:6] * tv0 + Jc[6:] * tv1                      # [6, N]
    qg = Jg[:G] * tv0 + Jg[G:] * tv1                      # [G, N]
    return qc, qg


def _matvec_shape(pp: PackedFM) -> str:
    lanes = pp.views * pp.pb
    return (f"G={pp.g}, V*pb={lanes}: one tile of (23 + 2G) rows x V*pb lanes "
            f"x 4 B = {(23 + 2 * pp.g) * lanes * 4} B and the kernel's own "
            "scratch must fit the shared memory of a block")


def schur_matvec_plain(pp: PackedFM, extra_c, extra_g, xc, xg):
    """S @ [xc; xg] from the lean packed prefix (see csrc/schur_matvec.cu);
    returns ([M, 6], [G])."""
    qc, qg = _matvec_terms(pp, xc[pp.obs_img.long()].T, xg)
    oc = engine._image_sum_plain(pp, list(qc))
    og = qg.sum(1)
    return oc + extra_c * xc, og + extra_g * xg


def matvec_workspace(pp: PackedFM):
    """K1's scratch and outputs on the card: (the image-sorted scratch, 8
    floats per entry, then the sums of its 512-entry blocks; the global
    partials [P / pb, G]; out_c [M, 6]; out_g [G])."""
    dev, f32 = pp.packed.device, torch.float32
    nb = pp.img_block_valid.shape[0]
    return (torch.empty((nb * engine.rcs.IMG_BLOCK + nb, 8), dtype=f32,
                        device=dev),
            torch.empty((pp.num_points // pp.pb, pp.g), dtype=f32,
                        device=dev),
            torch.empty((pp.num_images, 6), dtype=f32, device=dev),
            torch.empty((pp.g,), dtype=f32, device=dev))


def schur_matvec_rows(pp: PackedFM, extra_c, extra_g, xc, xg, work=None):
    """K1 wrapper: `schur_matvec_plain` for CPU tensors, the CUDA kernel
    for CUDA tensors.  ``work``: a `matvec_workspace` of ``pp`` to write
    into (the outputs returned are its last two tensors, so the next call
    overwrites them); None allocates a fresh one."""
    if _is_cpu(pp.packed):
        return schur_matvec_plain(pp, extra_c, extra_g, xc, xg)
    G, M = pp.g, pp.num_images
    P, V = pp.num_points, pp.views
    N = P * V
    dev = _check_packed(pp, _offsets(G)["F_lean"], image_pass=True)
    f32 = torch.float32
    _check("xc", xc, f32, (M, 6), dev)
    _check("xg", xg, f32, (G,), dev)
    _check("extra_c", extra_c, f32, (M, 6), dev)
    _check("extra_g", extra_g, f32, (G,), dev)
    nb = pp.img_block_valid.shape[0]
    scratch, partial_g, out_c, out_g = (matvec_workspace(pp) if work is None
                                        else work)
    _launch("ba_schur_matvec", _ptr(pp.packed), N, P, V, pp.pb, G,
            _ptr(pp.obs_img), _ptr(pp.hppinv), _ptr(xc), _ptr(xg),
            _ptr(extra_c), _ptr(extra_g), M, _ptr(pp.img_pos),
            _ptr(pp.img_block_valid), _ptr(pp.img_block_starts), nb,
            _ptr(scratch), _ptr(partial_g), _ptr(out_c), _ptr(out_g),
            shape=_matvec_shape(pp))
    schur_matvec_rows.launches += 1
    return out_c, out_g


schur_matvec_rows.launches = 0


def make_matvec(pp: PackedFM, extra_c, extra_g):
    """fn(xc [M, 6], xg [G]) -> ((S@x)_c [M, 6], (S@x)_g [G]) through K1.
    On the card the kernel's scratch and outputs are one workspace
    (`matvec_workspace`), made at the first call and reused by every
    call: a call's outputs hold until the next call.  The function is
    marked ``capturable``: nothing it does reads the device on the host
    or allocates per call, so `rcs.pcg` may replay it in a CUDA graph."""
    extra_c = extra_c.contiguous()
    extra_g = extra_g.contiguous()
    work = []

    def matvec(xc, xg):
        if not work and not _is_cpu(pp.packed):
            work.append(matvec_workspace(pp))
        return schur_matvec_rows(pp, extra_c, extra_g, xc.contiguous(),
                                 xg.contiguous(),
                                 work=work[0] if work else None)

    matvec.capturable = True
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
    red = engine._image_sum_plain(pp, rows)
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
    dev = _check_packed(pp, _offsets(G, with_pw=True)["F"], image_pass=True)
    f32 = torch.float32
    F = 39 + 6 * G
    fs = (F + 7) // 8 * 8  # whole 32-byte sectors per feature row
    nb = pp.img_block_valid.shape[0]
    nblk = P // pp.pb
    # the image-sorted feature rows (pad entries are never written or
    # read), then the sums of their 512-entry blocks
    feat = torch.empty((nb * engine.rcs.IMG_BLOCK + nb, fs), dtype=f32,
                       device=dev)
    partial_rg = torch.empty((nblk, G), dtype=f32, device=dev)
    # the per-block T2 and T3 sums, then the chunk sums of the column sum
    partial_t = torch.empty((nblk + COLUMN_SUM_CHUNKS, 13 * G * G),
                            dtype=f32, device=dev)
    red = torch.empty((M, F), dtype=f32, device=dev)
    rg_corr = torch.empty((G,), dtype=f32, device=dev)
    t23 = torch.empty((13 * G * G,), dtype=f32, device=dev)
    _launch("ba_prepare_reduction", _ptr(pp.packed), N, P, V, pp.pb, G, M,
            _ptr(pp.hppinv), _ptr(pp.img_pos), _ptr(pp.img_block_valid),
            _ptr(pp.img_block_starts), nb, _ptr(feat), fs, _ptr(partial_rg),
            _ptr(partial_t), _ptr(red), _ptr(rg_corr), _ptr(t23),
            shape=f"G={G}, V*pb={V * pp.pb}: one tile of (38 + 4G) rows x "
                  f"V*pb lanes x 4 B = {(38 + 4 * G) * V * pp.pb * 4} B and "
                  "the kernel's own scratch must fit the shared memory of a "
                  "block")
    T2 = t23[:4 * G * G].view(2 * G, 2 * G)
    T3 = t23[4 * G * G:].view(3 * G, 3 * G)
    prepare_reduction.launches += 1
    return red, rg_corr, T2, T3


prepare_reduction.launches = 0


@tracing.traced("prepare")
def prepare_kernels(p, state, spec, damping, couple_global: bool = True,
                    state_lo=None, cam_gather=None):
    """engine.prepare on the kernel path: linearise (PyTorch, gathers
    through ``cam_gather``), pack once, fused assembly through K2, finish
    in PyTorch.  Returns (blocks, rc, rg, Precond, PackedFM); the PackedFM
    feeds `make_matvec`, so the LM step packs exactly once.  ``p`` must be
    view-major.  Diagonal direct observations reach K2 through its inputs
    (Hpp^{-1} in the rows' point blocks) and `finish_reduction` (extra_c,
    bc, bg); only the point rhs of directly observed points is eliminated
    outside the kernel."""
    b = engine.linearize(p, state, spec, damping, state_lo=state_lo,
                         cam_gather=cam_gather)
    pp = pack_fm(b, p, dtype=b.Jp[0].dtype, with_pw=True)
    red, rg_corr, T2, T3 = prepare_reduction(pp)
    b, rc, rg, Minv = engine.finish_reduction(p, b, state, damping, red,
                                              rg_corr, T2, T3, couple_global)
    if p.dp_w is not None:
        # K2 eliminates the point rhs it sums from its rows (Jp^T P w);
        # the share of directly observed points in bp is not in the rows,
        # so its elimination Hxp Hpp^{-1} (bp - Jp^T P w) follows here
        ops = engine.point_ops(p, b)
        dc, dg = ops.hxp(ops.hinv(
            p.dp_w * p.free_point.T * (p.dp_val - state.points)))
        rc, rg = rc - dc, rg - dg
    return b, rc, rg, Minv, pp


# ---------------------------------------------------------------------------
# K4: read floor
# ---------------------------------------------------------------------------

def read_floor_plain(pp: PackedFM, xin):
    """out[8, 128] = 1e-30 xin + the fold of the lean rows: row r, lane n
    adds into out[r % 8, n % 128] (see csrc/read_floor.cu).  Folds the
    21 + 2G rows K1 reads; the pad rows of the lean prefix are zero by
    `pack_fm`'s contract, so this equals the TPU kernel's fold over the
    padded prefix."""
    rows = _offsets(pp.g)["F_lean"]
    x = pp.packed[:rows]
    x = torch.nn.functional.pad(x, (0, -x.shape[1] % 128, 0, -rows % 8))
    fold = x.reshape(-1, 8, x.shape[1] // 128, 128).sum(dim=(0, 2))
    return 1e-30 * xin + fold


def read_floor(pp: PackedFM, xin):
    """K4 wrapper: `read_floor_plain` for CPU tensors, the CUDA kernel for
    CUDA tensors."""
    if _is_cpu(pp.packed):
        return read_floor_plain(pp, xin)
    P, V = pp.num_points, pp.views
    rows = _offsets(pp.g)["F_lean"]
    dev = _check_packed(pp, rows)
    f32 = torch.float32
    _check("xin", xin, f32, (8, 128), dev)
    # one fold per CTA of the persistent grid: at most one CTA per block
    partial = torch.empty((P // pp.pb, 8, 128), dtype=f32, device=dev)
    out = torch.empty((8, 128), dtype=f32, device=dev)
    _launch("ba_read_floor", _ptr(pp.packed), P * V, P, V, pp.pb, rows,
            _ptr(xin), _ptr(partial), _ptr(out))
    read_floor.launches += 1
    return out


read_floor.launches = 0


# ---------------------------------------------------------------------------
# K1 stage probes
# ---------------------------------------------------------------------------

#: K1 cut into stages, each adding one piece (csrc/schur_matvec.cu):
#: rowmath  - all per-observation row math; stand-ins for the xc gather
#:            (xc[0] + obs_img), the point reduction (each lane applies
#:            its point's Hpp^{-1} to its own Jp^T t) and the per-image
#:            sum (a global sum of the six Jc^T tv rows);
#: pointred - + the sum over views in shared memory and the Hpp^{-1} apply;
#: gather   - + the real xc[obs_img] load;
#: full     - K1 itself.
MATVEC_STAGES = ("rowmath", "pointred", "gather", "full")
_CUT_STAGE_ID = {"rowmath": 0, "pointred": 1, "gather": 2}


def matvec_stage_plain(pp: PackedFM, stage, extra_c, extra_g, xc, xg):
    """The plain version of one stage: ``full`` is `schur_matvec_plain`;
    a cut stage returns (sum over lanes of Jc^T tv [6], of Jg^T tv [G])."""
    if stage == "full":
        return schur_matvec_plain(pp, extra_c, extra_g, xc, xg)
    if stage not in _CUT_STAGE_ID:
        raise ValueError(f"stage {stage!r} is not one of {MATVEC_STAGES}")
    if stage == "gather":
        xcr = xc[pp.obs_img.long()].T
    else:
        xcr = xc[0][:, None] + pp.obs_img.to(xc.dtype)[None]
    qc, qg = _matvec_terms(pp, xcr, xg, point_reduce=stage != "rowmath")
    return qc.sum(1), qg.sum(1)


def matvec_stage(pp: PackedFM, stage, extra_c, extra_g, xc, xg):
    """Stage probe wrapper: ``full`` goes to K1 (`schur_matvec_rows`); a
    cut stage takes `matvec_stage_plain` for CPU tensors and launches its
    instantiation of K1's per-observation kernel for CUDA tensors."""
    if stage == "full":
        return schur_matvec_rows(pp, extra_c, extra_g, xc, xg)
    if stage not in _CUT_STAGE_ID:
        raise ValueError(f"stage {stage!r} is not one of {MATVEC_STAGES}")
    if _is_cpu(pp.packed):
        return matvec_stage_plain(pp, stage, extra_c, extra_g, xc, xg)
    G, M = pp.g, pp.num_images
    P, V = pp.num_points, pp.views
    dev = _check_packed(pp, _offsets(G)["F_lean"])
    f32 = torch.float32
    _check("xc", xc, f32, (M, 6), dev)
    _check("xg", xg, f32, (G,), dev)
    partial = torch.empty((P // pp.pb, G + 6), dtype=f32, device=dev)
    out = torch.empty((G + 6,), dtype=f32, device=dev)
    _launch("ba_matvec_stage", _CUT_STAGE_ID[stage], _ptr(pp.packed), P * V,
            P, V, pp.pb, G, _ptr(pp.obs_img), _ptr(pp.hppinv), _ptr(xc),
            _ptr(xg), _ptr(partial), _ptr(out), shape=_matvec_shape(pp))
    matvec_stage.launches += 1
    return out[G:], out[:G]


matvec_stage.launches = 0

_WRAPPERS = {"cam_gather": cam_gather_rows,
             "schur_matvec": schur_matvec_rows,
             "prepare_reduction": prepare_reduction,
             "read_floor": read_floor,
             "matvec_stage": matvec_stage,
             "image_sum": image_sum_rows}


#: the CUDA kernels (names in csrc/) that one launch of each wrapper
#: runs: `measure.device_ms` holds a profile's device activities against
#: the wrappers' launch counts
DEVICE_KERNELS = {
    "cam_gather": ("cam_gather_kernel",),
    "schur_matvec": ("matvec_kernel", "block_sum_kernel", "finish_kernel"),
    "prepare_reduction": ("prepare_kernel", "block_sum_kernel",
                          "finish_kernel", "column_sum_kernel",
                          "column_sum_kernel"),
    "read_floor": ("read_floor_kernel", "column_sum_kernel"),
    "matvec_stage": ("matvec_kernel", "finish_kernel"),
    "image_sum": ("image_sum_scatter", "image_sum_blocks", "image_sum_finish"),
}


def launch_counts() -> dict:
    """Launches of each kernel wrapper since the last reset."""
    return {name: w.launches for name, w in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for w in _WRAPPERS.values():
        w.launches = 0


def count_replays(before: dict, runs: int) -> None:
    """The launches made since ``before`` (a `launch_counts`) were captured
    into a CUDA graph that then ran ``runs`` times: count each of them
    ``runs`` times, so that the counts stay the kernels' runs."""
    for name, w in _WRAPPERS.items():
        w.launches += (w.launches - before[name]) * (runs - 1)
