"""The port's dense covariance path (`parallel/cov_direct.py`) against the
JAX `cov_direct` on the CPU.

One problem, `bench.build_problem(180, 7, 4, seed=3)` padded to 192
points (12 zero-weight dummy points; points 0-2 are the fixed datum), in
the point-major layout, in f64 and in f32.  The module functions get the
JAX linearisation (`blocks_to_torch`), so both sides start from the same
rows; `cov_all` linearises on its own.  Every JAX output is computed once,
in a module fixture.

Tolerances:
  * f64, port vs JAX (S, Acc / Acg against both JAX corrections forms,
    S^{-1}, all-point, selected-point, camera and pair blocks, cov_all,
    and the second assembly route and LU route that `chip_smoke.py`
    checks the port with at full size): rtol 1e-9
    with atol 1e-9 x max|reference|, as tests/test_cov_direct.py scales
    them (same sums in another order; the inverse amplifies the rounding
    by the scaled condition number, ~3e6 here, still far inside).
  * f32, port vs JAX (S, Acc, Acg): rtol 1e-4, atol 1e-5 x max|reference|,
    the JAX tests' f32 tolerance (the JAX side uses split-bf16 products,
    ~2^-16).
  * f32 point blocks (the port's exact f32 and JAX's split-bf16
    `_pcd_dense_all` alike) against the f64 blocks: each free point's
    max|Q32 - Q64| <= kappa x 2^-24 x max|Q64|, kappa the condition number
    of the Jacobi-scaled f64 S.  That is the first-order bound of an
    inverse whose input carries f32 rounding (2^-24 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import CPU, blocks_to_torch, np_
from bundle_adjustment_tpu.parallel import cov_direct as CJ
from bundle_adjustment_tpu.parallel import engine as E
from bundle_adjustment_tpu_torch import convert
from bundle_adjustment_tpu_torch.parallel import cov_direct as CT
from bundle_adjustment_tpu_torch.parallel import engine as TE
from _torch_threads import one_torch_thread  # noqa: F401

P_REAL = 180
IDS = np.arange(0, 192, 7)
PAIRS = np.array([[5, 50], [101, 190], [3, 7]])
CAMS = np.array([0, 3, 6])


def _side(f64):
    import bench

    jdt, tdt = (jnp.float64, torch.float64) if f64 else (jnp.float32,
                                                          torch.float32)
    problem, state, spec = bench.build_problem(P_REAL, 7, 4, jdt, seed=3)
    problem, state, _ = E.pad_problem(problem, state, multiple=64)
    fj = E.fm_problem(problem)
    bj = E.linearize(fj, state, spec, jnp.asarray(0.0, jdt))
    ft = TE.fm_problem(convert.problem_to_torch(problem, CPU, tdt))
    st = convert.state_to_torch(state, CPU, tdt)
    return dict(fj=fj, bj=bj, ft=ft, bt=blocks_to_torch(bj), st=st,
                spec=spec)


@pytest.fixture(scope="module")
def case():
    """Both sides' inputs and every JAX output, computed once."""
    c64, c32 = _side(True), _side(False)
    fj, bj = c64["fj"], c64["bj"]
    S = CJ.assemble_reduced_dense(fj, bj)
    Q = CJ.reduced_inverse(S)
    ref = dict(
        S=S, Q=Q, outer=CJ.assemble_corrections_outer(fj, bj, chunk=64),
        pair=CJ.assemble_reduced_corrections(fj, bj, chunk=64),
        all=CJ.point_covariance_dense(fj, bj, Q),
        sel=CJ.point_covariance_dense(fj, bj, Q, jnp.asarray(IDS, jnp.int32),
                                      chunk=5),
        cams=CJ.camera_covariance_dense(Q, CAMS),
        pairs=CJ.point_pair_covariance_dense(fj, bj, Q, PAIRS))
    fj32, bj32 = c32["fj"], c32["bj"]
    S32 = CJ.assemble_reduced_dense(fj32, bj32)
    ref.update(S32=S32,
               outer32=CJ.assemble_corrections_outer(fj32, bj32, chunk=64),
               all32=CJ.point_covariance_dense(fj32, bj32,
                                               CJ.reduced_inverse(S32)))
    ref = {k: (tuple(np.array(a) for a in v) if isinstance(v, tuple)
               else np.array(v)) for k, v in ref.items()}
    return dict(c64=c64, c32=c32, ref=ref)


def _close(out, ref, rtol=1e-9, atol_scale=1e-9):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np_(out), ref, rtol=rtol,
                               atol=atol_scale * np.abs(ref).max())


def _port(case, f64=True):
    c = case["c64"] if f64 else case["c32"]
    return c["ft"], c["bt"]


def test_assembled_system_matches_jax(case):
    ft, bt = _port(case)
    _close(CT.assemble_reduced_dense(ft, bt), case["ref"]["S"])


@pytest.mark.parametrize("form,chunk", [("outer", 64), ("outer", 50),
                                        ("pair", 64), ("pair", 50)])
def test_corrections_match_jax(case, form, chunk):
    """The port's pair-block corrections, with dividing and non-dividing
    chunks, against both JAX forms (outer-product panels, pair blocks)."""
    ft, bt = _port(case)
    out = CT.assemble_reduced_corrections(ft, bt, chunk=chunk)
    ref = case["ref"][form]
    scale = np.abs(ref[0]).max()
    for o, r in zip(out, ref):
        np.testing.assert_allclose(np_(o), r, rtol=1e-9, atol=1e-9 * scale)


def test_reduced_inverse_matches_jax(case):
    _close(CT.reduced_inverse(torch.as_tensor(case["ref"]["S"])),
           case["ref"]["Q"])


@pytest.mark.parametrize("chunk", [64, 50])
def test_second_assembly_route_matches_jax(case, chunk):
    """chip_smoke's independent S (per-image sums, dense per-point Schur
    products; 50 leaves a remainder chunk) equals JAX's S."""
    import chip_smoke

    ft, bt = _port(case)
    S = chip_smoke.reduced_system_by_sums(ft, chip_smoke.jacobian_rows(bt),
                                          chunk=chunk)
    _close(S, case["ref"]["S"])


@pytest.mark.parametrize("kind,pid", [("datum", 1), ("free", 77),
                                      ("dummy", 185)])
def test_lu_route_matches_jax(case, kind, pid):
    """chip_smoke's LU route for one point's block equals JAX's block."""
    import chip_smoke

    ft, bt = _port(case)
    out = chip_smoke.point_blocks_by_solve(
        ft, chip_smoke.jacobian_rows(bt), torch.as_tensor(case["ref"]["S"]),
        torch.tensor([pid]))
    _close(out, case["ref"]["all"][[pid]])


def test_reduced_inverse_names_dtype_and_pivot():
    S = torch.eye(5, dtype=torch.float32)
    S[3, 3] = -1.0
    with pytest.raises(RuntimeError, match=r"torch\.float32.*pivot 4"):
        CT.reduced_inverse(S)


def test_all_point_blocks_match_jax(case):
    ft, bt = _port(case)
    out = CT.point_covariance_dense(ft, bt, torch.as_tensor(case["ref"]["Q"]))
    assert out.shape == (192, 3, 3)
    _close(out, case["ref"]["all"])


def test_selected_blocks_match_jax(case):
    """Row-gather path, chunk 5 not dividing 28 ids (a remainder chunk)."""
    ft, bt = _port(case)
    out = CT.point_covariance_dense(ft, bt, torch.as_tensor(case["ref"]["Q"]),
                                    point_ids=IDS, chunk=5)
    _close(out, case["ref"]["sel"])
    _close(out, case["ref"]["all"][IDS])


def test_camera_and_pair_blocks_match_jax(case):
    ft, bt = _port(case)
    Q = torch.as_tensor(case["ref"]["Q"])
    _close(CT.camera_covariance_dense(Q, CAMS), case["ref"]["cams"])
    _close(CT.point_pair_covariance_dense(ft, bt, Q, PAIRS),
           case["ref"]["pairs"])


def test_fixed_and_dummy_points_match_jax(case):
    """The datum points 0-2 and the dummy points 180-191 have a unit Hpp
    diagonal: finite blocks, equal to JAX's (no det = 0 in the adjugate)."""
    ft, bt = _port(case)
    out = np_(CT.point_covariance_dense(ft, bt,
                                        torch.as_tensor(case["ref"]["Q"])))
    fixed = np.r_[0:3, P_REAL:192]
    assert np.isfinite(out[fixed]).all()
    np.testing.assert_allclose(out[fixed], case["ref"]["all"][fixed],
                               rtol=1e-12, atol=1e-12)


def test_cov_all_matches_jax(case):
    """cov_all (the port's own linearise) == JAX's linearize ->
    assemble_reduced_dense -> reduced_inverse -> point_covariance_dense."""
    c = case["c64"]
    out = CT.cov_all(c["ft"], c["st"], c["spec"])
    assert out.dtype == torch.float64
    _close(out, case["ref"]["all"])


def test_f32_assembly_matches_jax(case):
    ft, bt = _port(case, f64=False)
    ref = case["ref"]
    _close(CT.assemble_reduced_dense(ft, bt), ref["S32"], rtol=1e-4,
           atol_scale=1e-5)
    scale = np.abs(ref["outer32"][0]).max()
    for o, r in zip(CT.assemble_reduced_corrections(ft, bt, chunk=64),
                    ref["outer32"]):
        np.testing.assert_allclose(np_(o), r, rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.parametrize("side", ["port", "jax"])
def test_f32_point_blocks_within_conditioning_bound(case, side):
    ref = case["ref"]
    S = ref["S"]
    d = np.sqrt(np.diag(S))
    kappa = np.linalg.cond(S / d[:, None] / d[None, :])
    if side == "port":
        ft, bt = _port(case, f64=False)
        S32 = CT.assemble_reduced_dense(ft, bt)
        q32 = np_(CT.point_covariance_dense(ft, bt, CT.reduced_inverse(S32)))
    else:
        q32 = ref["all32"]
    assert q32.dtype == np.float32
    free = np.r_[3:P_REAL]
    q64 = ref["all"][free]
    err = (np.abs(q32[free] - q64).reshape(len(free), -1).max(axis=1)
           / np.abs(q64).reshape(len(free), -1).max(axis=1))
    assert err.max() <= kappa * 2.0 ** -24, (err.max(), kappa)


def test_view_major_layout_refused(case):
    ft, bt = _port(case)
    with pytest.raises(ValueError, match="point-major"):
        CT.assemble_reduced_corrections(ft._replace(vm_pb=64), bt)


def test_direct_observations_match_jax():
    """Diagonal direct observations of points, EO and IO (f64): the
    lineariser's Hpp / extra_g terms and the `de_w` term of extra_c give
    the JAX module's S, S^-1 and point blocks (rtol 1e-9, scaled as
    above); a problem with scale bars is refused."""
    import bench
    from bundle_adjustment_tpu_torch import synthetic

    problem, state, spec = bench.build_problem(P_REAL, 7, 4, jnp.float64,
                                               seed=3)
    problem = synthetic.free_network(
        problem, state, bars=0, datum=False, seed=2,
        direct=dict(dp=12, de=3, dg=True))
    problem, state, _ = E.pad_problem(problem, state, multiple=64)
    fj = E.fm_problem(problem)
    bj = E.linearize(fj, state, spec, jnp.asarray(0.0))
    Sj = CJ.assemble_reduced_dense(fj, bj)
    Qj = CJ.reduced_inverse(Sj)
    pt = convert.problem_to_torch(problem, CPU, torch.float64)
    ft = TE.fm_problem(pt)
    st = convert.state_to_torch(state, CPU, torch.float64)
    assert ft.de_w is not None and float(ft.de_w.sum()) > 0
    bt = TE.linearize(ft, st, spec, 0.0)
    St = CT.assemble_reduced_dense(ft, bt)
    _close(St, Sj)
    # without the de_w term the camera diagonal differs
    S_no = CT.assemble_reduced_dense(ft._replace(de_w=None, de_val=None), bt)
    assert float((St - S_no).abs().max()) > 1e-4
    Qt = CT.reduced_inverse(St)
    _close(Qt, Qj)
    _close(CT.point_covariance_dense(ft, bt, Qt),
          CJ.point_covariance_dense(fj, bj, Qj))
    _close(CT.cov_all(ft, st, spec), CJ.point_covariance_dense(fj, bj, Qj))
    bars = synthetic.free_network(problem, state, bars=2, datum=False)
    with pytest.raises(NotImplementedError, match="scale bars"):
        CT.cov_all(TE.fm_problem(convert.problem_to_torch(
            bars, CPU, torch.float64)), st, spec)
