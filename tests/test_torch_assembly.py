"""The port's dense normal equations (`ops/assembly`, `ops/schur`,
`ops/linalg`) against the JAX package's, float64 on the CPU.

Scenes (tests/test_torch_scene.py, brought across by `convert.scene_from`):
the network with held-fixed coordinates, a scale bar, a populated point
group and a diagonal EO / IO group (no datum border: those fix it); the
Zernike camera (six-defect border); the two-camera network (seven).  Each
is assembled at its start state with damping 1e-3; the Zernike camera also
through the AD Jacobian (both sides' `analytic.supports_spec` switched
off).  The JAX side runs eagerly: under `jax.jit` XLA contracts products
into FMAs, and the misclosures (start residuals ~1e-4 of predictions ~10)
then differ in their last bits by more than 1e-12 of n.

Tolerance 1e-12 in the Jacobi scale: V N V against its largest entry
(|V N V| <= 1 off the border), V entry by entry, Omega relative; V n
within 1e-11 of its largest entry, since each misclosure w = obs - pred
carries ~eps |pred| ~ 1e-14 of rounding against |w| ~ 1e-4..1e-2.
The EO Schur complement and the solution scatter take the same (JAX)
preconditioned system on both sides; `linalg` the same matrices.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_scene import (direct_group_scene, port_scene,
                              two_camera_scene, zernike_scene)
from bundle_adjustment_tpu.models.problem import compile_problem as j_compile
from bundle_adjustment_tpu.ops import analytic as JAn
from bundle_adjustment_tpu.ops import assembly as JA
from bundle_adjustment_tpu.ops import linalg as JL
from bundle_adjustment_tpu.ops import schur as JS
from bundle_adjustment_tpu_torch.models.problem import ParamState
from bundle_adjustment_tpu_torch.models.problem import compile_problem
from bundle_adjustment_tpu_torch.ops import analytic as TAn
from bundle_adjustment_tpu_torch.ops import assembly as TA
from bundle_adjustment_tpu_torch.ops import linalg as TL
from bundle_adjustment_tpu_torch.ops import schur as TS
from _torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
SCENES = {"direct_groups": direct_group_scene, "zernike": zernike_scene,
          "two_cameras": two_camera_scene}


def np_(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.fixture(scope="module", params=[(s, "analytic") for s in sorted(SCENES)]
                + [("zernike", "ad")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def systems(request):
    name, route = request.param
    js = SCENES[name]()
    ts = port_scene(js)
    cj = j_compile(*js[:3])
    ct = compile_problem(ts.cameras, ts.scale_bars, ts.direct_groups)
    sj = type(cj.state)(*(jnp.asarray(a) for a in cj.state))
    st = ParamState(*(torch.as_tensor(a) for a in ct.state))
    mp = pytest.MonkeyPatch()
    if route == "ad":
        mp.setattr(JAn, "supports_spec", lambda spec: False)
        mp.setattr(TAn, "supports_spec", lambda spec: False)
    try:
        out_j = JA.make_assembler(cj.problem)(sj, 1e-3)
        out_t = TA.make_assembler(ct.problem, CPU)(st, 1e-3)
        V = np.asarray(out_j[2])
        rng = np.random.default_rng(1)
        dx = V * rng.normal(0, 1e-3, V.shape)
        om_j = float(JA.make_omega_fn(cj.problem)(sj, jnp.asarray(dx)))
        om_t = float(TA.make_omega_fn(ct.problem, CPU)(st, torch.as_tensor(dx)))
    finally:
        mp.undo()
    return dict(name=name, pj=cj.problem, pt=ct.problem, out_j=out_j,
                out_t=out_t, om_j=om_j, om_t=om_t)


def test_normal_equations_match_jax(systems):
    (Nj, nj, Vj), (Nt, nt, Vt) = systems["out_j"], systems["out_t"]
    Nj, nj, Vj = map(np.asarray, (Nj, nj, Vj))
    Nt, nt, Vt = map(np_, (Nt, nt, Vt))
    np.testing.assert_allclose(Vt, Vj, rtol=1e-12)
    Sj = Vj[:, None] * Nj * Vj[None, :]
    St = Vj[:, None] * Nt * Vj[None, :]
    assert np.abs(St - Sj).max() <= 1e-12 * np.abs(Sj).max()
    assert np.abs(Vj * (nt - nj)).max() <= 1e-11 * np.abs(Vj * nj).max()
    d = systems["pt"].defect
    if systems["name"] != "direct_groups":  # there the datum is held fixed
        np.testing.assert_array_equal(Nt[:d, :d], 0.0)  # the border's corner
        assert d > 0 and np.abs(Nt[:d]).max() > 0


def test_omega_matches_jax(systems):
    np.testing.assert_allclose(systems["om_t"], systems["om_j"], rtol=1e-12)


def test_scene_kinds_reach_the_system(systems):
    p = systems["pt"]
    if systems["name"] == "direct_groups":
        assert p.num_scale_bars == 1 and len(p.direct_groups) == 2
        assert p.defect == 0
    if systems["name"] == "two_cameras":
        assert p.num_cameras == 2


@pytest.fixture(scope="module")
def reduced():
    """The preconditioned system of the direct-group scene, reduced by both
    sides' `reduce_eo`."""
    js = direct_group_scene()
    cj = j_compile(*js[:3])
    sj = type(cj.state)(*(jnp.asarray(a) for a in cj.state))
    N, n, V = (np.asarray(a) for a in JA.make_assembler(cj.problem)(sj, 0.0))
    Np, npre = V[:, None] * N * V[None, :], V * n
    p = cj.problem
    fj = JS.reduce_eo(jnp.asarray(Np), jnp.asarray(npre),
                      jnp.asarray(p.col_eo), p.reduced_size)
    # the JAX leading block of p.reduced_size columns on both sides: the
    # port's own retained set (every non-EO column) is held to FULL in
    # tests/test_torch_adjustment.py
    ft = TS.reduce_eo(torch.as_tensor(Np), torch.as_tensor(npre),
                      torch.as_tensor(p.col_eo), torch.arange(p.reduced_size))
    return dict(p=p, Np=Np, npre=npre, fj=fj, ft=ft)


def test_reduce_eo_matches_jax(reduced):
    fj, ft = reduced["fj"], reduced["ft"]
    for f in ("S", "nr", "inv22", "n2", "N12"):
        a, b = np.asarray(getattr(fj, f)), np_(getattr(ft, f))
        assert np.abs(b - a).max() <= 1e-12 * np.abs(a).max(), f
    np.testing.assert_array_equal(np_(ft.mask), np.asarray(fj.mask))
    assert int(ft.info.abs().max()) == 0


def test_back_substitution_matches_jax(reduced):
    fj, ft, p = reduced["fj"], reduced["ft"], reduced["p"]
    dx1 = np.linalg.solve(np.asarray(fj.S), np.asarray(fj.nr))
    a = np.asarray(JS.assemble_full_dx(fj, jnp.asarray(dx1), p.total_size))
    b = np_(TS.assemble_full_dx(ft, torch.as_tensor(dx1), p.total_size))
    assert np.abs(b - a).max() <= 1e-12 * np.abs(a).max()
    # and the reduced route solves the full system (to its conditioning)
    full = np.linalg.solve(reduced["Np"], reduced["npre"])
    assert np.abs(b - full).max() <= 1e-6 * np.abs(full).max()


def test_linalg_matches_jax(reduced):
    rng = np.random.default_rng(2)
    A = rng.normal(size=(40, 40))
    spd = A @ A.T + 40 * np.eye(40)
    rhs = rng.normal(size=40)
    Np = reduced["Np"]
    nb = rng.normal(size=Np.shape[0])

    def both(fn_j, fn_t, *args):
        return (np.asarray(fn_j(*(jnp.asarray(a) for a in args))),
                np_(fn_t(*(torch.as_tensor(a) for a in args))))

    for a, b in (both(JL.solve_spd, TL.solve_spd, spd, rhs),
                 both(JL.inv_spd, TL.inv_spd, spd),
                 both(JL.solve_symmetric, TL.solve_symmetric, Np, nb),
                 both(JL.inv_symmetric, TL.inv_symmetric, Np),
                 both(JL.pinv, TL.pinv, A[:, :30]),
                 both(JL.cond, TL.cond, spd)):
        assert np.abs(b - a).max() <= 1e-10 * np.abs(a).max()
    wj, vj = JL.eig_selected(jnp.asarray(spd), 3, 7)
    wt, vt = TL.eig_selected(torch.as_tensor(spd), 3, 7)
    np.testing.assert_allclose(np_(wt), np.asarray(wj), rtol=1e-12)
    # eigenvectors up to sign
    dots = np.abs(np.sum(np_(vt) * np.asarray(vj), axis=0))
    np.testing.assert_allclose(dots, 1.0, rtol=1e-10)


@pytest.mark.parametrize("fn", ["solve_symmetric", "inv_symmetric"])
def test_linalg_raises_on_a_zero_pivot(fn):
    """The LU forms report a zero pivot as LinAlgError (the dense solver
    maps it to SINGULAR_MATRIX)."""
    N = torch.ones((4, 4), dtype=torch.float64)
    args = (N, torch.ones(4, dtype=torch.float64))[:2 if fn.startswith("s")
                                                   else 1]
    with pytest.raises(torch.linalg.LinAlgError):
        getattr(TL, fn)(*args)
