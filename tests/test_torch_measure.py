"""The matvec roofline pieces of the port (measure.py, the K4 read floor and
the K1 stage probes) on the CPU.

* `measure.matvec_cost` equals `bench.matvec_cost` exactly (same formula);
  `matvec_rows_read` counts the 41 rows K1 reads at G = 10.
* `read_floor_plain` against the JAX `make_read_floor` run in Pallas
  interpret mode (`pl.pallas_call` patched with ``interpret=True`` for the
  test; the JAX package is unchanged).  Tolerance: each fold entry within
  1e-6 of the sum of |values| it folds (f32 sums in another order).
* The ``full`` stage is K1's plain version, bit for bit.
* Each cut stage's output changes when any input it claims to read is
  perturbed, and does not change when an input it does not read is.
* The timing path refuses CPU tensors: a CPU run gives no device time.
* `device_ms` holds each profile against the launches it must hold (the
  port wrappers' launch counts, or the caller's count): on constructed
  profiles, a short one is taken again and, short every time, raises
  rather than give a time.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from bundle_adjustment_tpu.parallel import kernels as JK
from bundle_adjustment_tpu_torch import measure
from bundle_adjustment_tpu_torch.parallel import kernels as TK
from bundle_adjustment_tpu_torch.parallel import rcs
from _torch_threads import one_torch_thread  # noqa: F401

G = 10
F_LEAN = 21 + 2 * G


def _packed_case(P=64, V=12, pb=32, M=7, seed=0):
    """Random lean rows (pad rows zero, as `pack_fm` makes them), random
    images, Hpp^{-1} rows and probe vectors; a port PackedFM."""
    rng = np.random.default_rng(seed)
    N = P * V
    packed = np.zeros((48, N), np.float32)
    packed[:F_LEAN] = rng.normal(0, 1, (F_LEAN, N))
    hpp = np.zeros((8, P), np.float32)
    hpp[:6] = rng.normal(0, 1, (6, P))
    obs_img = rng.integers(0, M, N).astype(np.int32)
    pp = TK.PackedFM(
        packed=torch.as_tensor(packed), obs_img=torch.as_tensor(obs_img),
        hppinv=torch.as_tensor(hpp), img_perm=None, img_block_starts=None,
        num_points=P, views=V, num_images=M, g=G, f_pad=48, pb=pb)
    xc = torch.as_tensor(rng.normal(0, 1, (M, 6)), dtype=torch.float32)
    xg = torch.as_tensor(rng.normal(0, 1, (G,)), dtype=torch.float32)
    return pp, xc, xg


@pytest.mark.parametrize("N,G_,V", [(1_204_224, 10, 12), (12_000_000, 10, 12),
                                   (3072, 7, 6), (384, 16, 8)])
def test_matvec_cost_matches_bench(N, G_, V):
    assert measure.matvec_cost(N, G_, V) == bench.matvec_cost(N, G_, V)


def test_rows_read_vs_padded_count():
    N = 1_204_224
    assert measure.matvec_rows_read(N, 10) == 41 * 4 * N == 197_492_736
    assert measure.matvec_cost(N, 10, 12)[1] == 48 * 4 * N == 231_211_008


SCALE = dict(N=1_204_224, P=100_352, M=500, G=10, V=12)


@pytest.mark.parametrize("name,work,nbytes,ms", [
    ("K1", measure.k1_work(**SCALE), 204_754_200, 0.0611),
    ("K2", measure.k2_work(**SCALE), 378_329_576, 0.1129),
    ("K3", measure.k3_work(SCALE["N"], SCALE["M"], 6), 43_364_064, 0.0129),
    ("K4", measure.k4_work(SCALE["N"], SCALE["G"]), 197_500_928, 0.0590),
    ("stage", measure.stage_work(**SCALE), 204_730_184, 0.0611),
])
def test_work_and_bound_at_the_scale_shape(name, work, nbytes, ms):
    """The bytes each kernel must move at 100,352 points / 500 images / 12
    views, G = 10, and the bound they give at 3.35 TB/s (4 decimals of a
    ms, as PERF.md prints them)."""
    assert work[0] == nbytes
    t, by = measure.bound_ms(work)
    assert by == "bytes" and round(t, 4) == ms


def test_work_of_a_small_shape_by_hand():
    """P = 64, V = 3, M = 5, G = 2: N = 192."""
    N, P, M, G, V = 192, 64, 5, 2, 3
    rows = 25 * 4 * N                       # 21 + 2G lean rows
    assert measure.matvec_rows_read(N, G) == rows == 19_200
    io = rows + 4 * N + 24 * P              # + obs_img + six Hpp^-1 rows
    assert io == 21_504
    assert measure.k1_work(N, P, M, G, V)[0] == io + 3 * (6 * M + G) * 4
    assert measure.stage_work(N, P, M, G, V)[0] == io + 32 * 4 + 8 * 4
    assert measure.k2_rows_read(N, G) == 46 * 4 * N == 35_328
    out = (M * 51 + G + 16 + 36) * 4        # red, rg_corr, T2, T3
    assert measure.k2_work(N, P, M, G, V)[0] == 35_328 + 24 * P + out
    assert measure.k3_work(N, M, 6) == (4 * N + M * 24 + 32 * N, 0.0)
    assert measure.k4_work(N, G) == (rows + 8192, 25.0 * N)
    # the operations bound takes over when the flops outweigh the bytes
    assert measure.bound_ms((3.35e9, 67e9)) == (1.0, "bytes")
    assert measure.bound_ms((3.35e9, 134e9)) == (2.0, "operations")


def test_read_floor_plain_matches_pallas_interpret(monkeypatch):
    pp, _, _ = _packed_case(P=256, seed=1)
    rng = np.random.default_rng(2)
    xin = rng.normal(0, 1, (8, 128)).astype(np.float32)
    monkeypatch.setattr(JK.pl, "pallas_call",
                        functools.partial(JK.pl.pallas_call, interpret=True))
    ppj = JK.PackedFM(
        packed=jnp.asarray(pp.packed.numpy()),
        obs_img=jnp.asarray(pp.obs_img.numpy()).reshape(1, -1),
        hppinv=jnp.asarray(pp.hppinv.numpy()), num_points=pp.num_points,
        views=pp.views, num_images=pp.num_images, m_pad=128, g=G, f_pad=48,
        pb=pp.pb, h=128)
    ref = np.asarray(JK.make_read_floor(ppj)(jnp.asarray(xin)))
    out = TK.read_floor(pp, torch.as_tensor(xin))
    assert out.shape == (8, 128) and out.dtype == torch.float32
    scale = TK.read_floor_plain(pp._replace(packed=pp.packed.abs()),
                                torch.zeros(8, 128)).numpy()
    assert np.all(np.abs(out.numpy() - ref) <= 1e-6 * scale)


def test_full_stage_is_k1_plain():
    pp, xc, xg = _packed_case()
    perm, bstarts = rcs.build_image_block_layout(
        pp.obs_img.numpy(), pp.num_images)
    pp = pp._replace(img_perm=torch.as_tensor(perm),
                     img_block_starts=torch.as_tensor(bstarts))
    rng = np.random.default_rng(3)
    ec = torch.as_tensor(rng.normal(0, 1, (pp.num_images, 6)),
                         dtype=torch.float32)
    eg = torch.as_tensor(rng.normal(0, 1, (G,)), dtype=torch.float32)
    ref = TK.schur_matvec_plain(pp, ec, eg, xc, xg)
    for out in (TK.matvec_stage_plain(pp, "full", ec, eg, xc, xg),
                TK.matvec_stage(pp, "full", ec, eg, xc, xg)):
        assert all(torch.equal(a, b) for a, b in zip(out, ref))


def _inputs_read(stage):
    """(name, perturb fn) of every input the stage reads."""
    def row(r):
        return (f"row {r}", lambda pp, xc, xg: (pp._replace(
            packed=_bump(pp.packed, r)), xc, xg))

    def hrow(r):
        return (f"hppinv {r}", lambda pp, xc, xg: (pp._replace(
            hppinv=_bump(pp.hppinv, r)), xc, xg))

    out = [row(r) for r in range(F_LEAN)] + [hrow(r) for r in range(6)]
    out.append(("obs_img", lambda pp, xc, xg: (pp._replace(
        obs_img=(pp.obs_img + 1) % pp.num_images), xc, xg)))
    out.append(("xg", lambda pp, xc, xg: (pp, xc, xg * 1.5)))
    # the stand-ins read image 0's row; the gather reads every row
    if stage == "gather":
        out.append(("xc", lambda pp, xc, xg: (pp, xc * 1.5, xg)))
    else:
        out.append(("xc[0]", lambda pp, xc, xg: (pp, _bump(xc, 0), xg)))
    return out


def _inputs_not_read(stage):
    out = [(f"pad row {r}", lambda pp, xc, xg, r=r: (pp._replace(
        packed=_bump(pp.packed, r)), xc, xg)) for r in range(F_LEAN, 48)]
    out += [(f"hppinv pad {r}", lambda pp, xc, xg, r=r: (pp._replace(
        hppinv=_bump(pp.hppinv, r)), xc, xg)) for r in (6, 7)]
    if stage != "gather":
        out.append(("xc[1:]", lambda pp, xc, xg: (pp, torch.cat(
            [xc[:1], xc[1:] * 1.5]), xg)))
    return out


def _bump(t, r):
    t = t.clone()
    t[r] = t[r] + 0.5
    return t


@pytest.mark.parametrize("stage", ["rowmath", "pointred", "gather"])
def test_cut_stage_depends_on_what_it_reads(stage):
    pp, xc, xg = _packed_case()
    base = torch.cat(TK.matvec_stage(pp, stage, None, None, xc, xg))
    assert base.shape == (6 + G,) and bool(torch.isfinite(base).all())
    for name, perturb in _inputs_read(stage):
        p2, xc2, xg2 = perturb(pp, xc, xg)
        out = torch.cat(TK.matvec_stage_plain(p2, stage, None, None, xc2,
                                              xg2))
        assert not torch.equal(out, base), f"{stage} ignores {name}"
    for name, perturb in _inputs_not_read(stage):
        p2, xc2, xg2 = perturb(pp, xc, xg)
        out = torch.cat(TK.matvec_stage_plain(p2, stage, None, None, xc2,
                                              xg2))
        assert torch.equal(out, base), f"{stage} reads {name}"


def test_stages_differ_from_each_other():
    """Each stage adds a piece that changes the result."""
    pp, xc, xg = _packed_case()
    outs = [torch.cat(TK.matvec_stage_plain(pp, s, None, None, xc, xg))
            for s in ("rowmath", "pointred", "gather")]
    assert not torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[1], outs[2])
    with pytest.raises(ValueError, match="stage"):
        TK.matvec_stage(pp, "onehot", None, None, xc, xg)


def test_roofline_refuses_cpu_tensors():
    pp, xc, xg = _packed_case()
    with pytest.raises(RuntimeError, match="CUDA"):
        measure.roofline(pp, None, None, xc, xg)
    assert measure.STAGES == ("dma", "rowmath", "pointred", "gather", "full")


@pytest.mark.parametrize("fn", [measure.device_profile, measure.device_ms])
def test_device_time_refuses_a_cpu_run(fn):
    with pytest.raises(RuntimeError, match="CUDA"):
        fn(lambda: None)


@pytest.mark.parametrize("P", [64, 128])
def test_read_floor_is_one_sum_over_the_padded_prefix(P):
    """The one PyTorch call timed beside K4: the lean prefix with its zero
    pad rows, viewed [6, 8, N / 128, 128] and summed over dims 0 and 2, is
    the fold of `read_floor_plain`."""
    pp, _, _ = _packed_case(P=P)
    N = pp.num_points * pp.views
    one_call = pp.packed[:48].view(6, 8, N // 128, 128).sum(dim=(0, 2))
    ref = TK.read_floor_plain(pp, torch.zeros((8, 128)))
    torch.testing.assert_close(one_call, ref, rtol=0, atol=1e-5)


# ---- device_ms's launch count, on constructed profiles ---------------------

K4_KERNELS = ("void read_floor_kernel<8>(ba::RingPlan, int)",
              "void ba::column_sum_kernel(float const*, int, int, float*)")


def _profiles(monkeypatch, kept):
    """Replace the profiler by constructed profiles: profile i keeps
    kept[i] of every K4 kernel's launches (None: all of them), each launch
    0.5 ms; ``fn`` stands in for one K4 wrapper launch."""
    monkeypatch.setattr(TK.read_floor, "launches", 0)
    taken = []

    def fake(calls):
        n0 = TK.read_floor.launches
        calls()
        n = TK.read_floor.launches - n0
        k = kept[len(taken)]
        taken.append(k)
        c = n if k is None else k
        return 0.0, [(name, c, 0.5 * c) for name in K4_KERNELS]

    def fn():
        TK.read_floor.launches += 1

    monkeypatch.setattr(measure, "_device_activities", fake)
    return fn, taken


def test_missing_launches_counts_by_kernel_name():
    acts = [("void ba::block_sum_kernel(float4 const*)", 18, 1.0),
            ("void (anonymous namespace)::matvec_kernel<3>(x)", 20, 2.0),
            ("void ba::finish_kernel(float const*)", 20, 0.1),
            ("Memset (Device)", 5, 0.0)]
    want = measure.kernel_launches({"schur_matvec": 20})
    assert want == {"matvec_kernel": 20, "block_sum_kernel": 20,
                    "finish_kernel": 20}
    assert measure.missing_launches(acts, want) == {
        "block_sum_kernel": (18, 20)}
    assert measure.missing_launches(acts, {None: 63}) == {}
    assert measure.kernel_launches({"prepare_reduction": 2, "read_floor": 1}
                                   )["column_sum_kernel"] == 5


def test_device_ms_retries_a_short_profile(monkeypatch):
    fn, taken = _profiles(monkeypatch, [7, None])
    ms, by_name = measure.device_ms(fn, reps=10, warm=2)
    assert taken == [7, None]
    assert ms == pytest.approx(1.0) and len(by_name) == 2


def test_device_ms_raises_rather_than_return_a_short_time(monkeypatch):
    fn, taken = _profiles(monkeypatch, [3] * measure.PROFILE_TRIES)
    with pytest.raises(RuntimeError, match="part of the launches"):
        measure.device_ms(fn, reps=10)
    assert len(taken) == measure.PROFILE_TRIES


def test_device_ms_takes_the_callers_count(monkeypatch):
    """A callable of no port kernel gives its activities per call; none
    given is an error, not a guess."""
    fn, _ = _profiles(monkeypatch, [None] * 4)

    def library():
        fn()
        TK.read_floor.launches -= 1     # not a port launch

    with pytest.raises(ValueError, match="launches="):
        measure.device_ms(library, reps=4)
    def one_kernel(calls):
        calls()
        return 0.0, [(K4_KERNELS[0], 4, 2.0)]

    monkeypatch.setattr(measure, "_device_activities", one_kernel)
    assert measure.device_ms(library, reps=4, launches=1)[0] == 0.5
    with pytest.raises(RuntimeError, match="part of the launches"):
        measure.device_ms(library, reps=4, launches=2)
