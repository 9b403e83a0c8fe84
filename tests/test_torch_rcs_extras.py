"""The block-layout engine's free-network step (`rcs.lm_step_full`,
`rcs.omega_at_full`, `rcs.point_ops` under `freenet`) and its masked
multi-camera rows against the JAX `parallel/rcs.py`, on the CPU in f64.

* The thinned scene of tests/test_torch_rcs_engine.py (3 to 10 views per
  point) as the JAX `rcs_from_problem` gives it (file order, no
  visibility tables), re-dressed as a free network: every coordinate
  free, a six-defect inner-constraint datum over all points and 2 scale
  bars; then again with a populated direct group over 6 coordinates and
  diagonal direct observations of 2 points, 1 image and the principal
  point.  The same host arrays go into both packages (`convert`); the
  port runs them with its image sums both image-sorted (the layout as
  given) and through its blocked image layout.
* A two-camera rig (`test_torch_scene.rig_scene`, each camera its own IO
  and radial term, inner constraints) thinned by the same rule: the
  masked [N, 2, G] global rows, G = 2 (3 + K).

Tolerances: dx rtol 1e-8 / atol 1e-10 at cg_tol 1e-12 and Omega rtol
1e-10 (tests/test_freenet.py, step against the dense bordered step);
|B dxp| <= 1e-10 max|dxp| (the datum rows hold).  The CG count within one
of JAX's: at 1e-12 the free network's residual is at its f64 floor, where
the count follows the summation order (the port's own image-sorted and
blocked image sums stop at 41 and 42 iterations on the first case, JAX at
41); at looser tolerances its residual is flat across several
iterations, so that a count there says even less.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_rcs_engine import CPU, SCENE, drop_views, np_
from test_torch_scene import port_scene, rig_scene
from bundle_adjustment_tpu.models.problem import ParamState as JParamState
from bundle_adjustment_tpu.models.problem import compile_problem as j_compile
from bundle_adjustment_tpu.parallel import rcs as JR
from bundle_adjustment_tpu.testing import make_synthetic_scene as j_scene
from bundle_adjustment_tpu_torch import convert
from bundle_adjustment_tpu_torch.models.problem import compile_problem
from bundle_adjustment_tpu_torch.parallel import freenet, rcs
from _torch_threads import one_torch_thread  # noqa: F401

DAMPING = 1e-3
CG = dict(cg_tol=1e-12, cg_maxiter=1000)
CASES = ("bars_datum", "group")


def redress(rp, state, case):
    """The host RCSProblem ``rp`` as a free network (see the module
    docstring), made with numpy from seed 21."""
    rng = np.random.default_rng(21)
    P, M = rp.num_points, rp.num_images
    pts = np.asarray(state.points, np.float64)
    ends = rng.choice(P, (2, 2), replace=False)
    f = dict(free_point=np.ones((P, 3)), datum_mask_d=np.ones(P),
             defect_flags_d=(True,) * 6 + (False,),
             sb_a=ends[:, 0].astype(np.int32),
             sb_b=ends[:, 1].astype(np.int32),
             sb_length=np.linalg.norm(pts[ends[:, 1]] - pts[ends[:, 0]],
                                      axis=1) + rng.normal(0, 1e-4, 2),
             sb_weight=np.ones(2))
    if case == "group":
        idx = rng.choice(P, 6, replace=False)
        axis = rng.integers(0, 3, 6)
        U = rng.normal(0, 1e-4, (6, 6)) + np.eye(6) * 3e-4
        f.update(dpg_idx=idx.astype(np.int32), dpg_axis=axis.astype(np.int32),
                 dpg_val=pts[idx, axis] + rng.normal(0, 1e-4, 6),
                 dpg_cov=U.T @ U)
        dp_w = np.zeros((P, 3))
        dp_w[rng.choice(P, 2, replace=False)] = 1.0
        de_w = np.zeros((M, 6))
        de_w[rng.integers(0, M)] = [1e-2] * 3 + [1e2] * 3
        G = int(np.asarray(rp.free_global).shape[0])
        dg_w = np.zeros(G)
        dg_w[:3] = 1.0
        eo = np.asarray(state.eo, np.float64)
        g = np.concatenate([np.asarray(state.io), np.asarray(state.dist)],
                           axis=1).reshape(-1)
        f.update(dp_w=dp_w, dp_val=pts + rng.normal(0, 1e-4, pts.shape),
                 de_w=de_w, de_val=eo + rng.normal(0, 1e-5, eo.shape),
                 dg_w=dg_w, dg_val=g + rng.normal(0, 1e-4, g.shape))
    return rp._replace(**f)


def _host(rp):
    """A JAX RCSProblem with numpy leaves (for `convert`)."""
    return rp._replace(**{k: np.asarray(v) for k, v in rp._asdict().items()
                          if hasattr(v, "shape")})


def _jax_step(jp, js, spec):
    dxp, dxc, dxg, b, it, ext = JR.lm_step_full(jp, js, spec, DAMPING, **CG)
    om = JR.omega_at_full(jp, b, ext, 0.75 * dxp, 0.75 * dxc, 0.75 * dxg)
    return tuple(np.asarray(a) for a in (dxp, dxc, dxg)) + (int(it),
                                                              float(om))


def _rig():
    """(JAX bp, JAX state, port bp, port state) of the thinned rig."""
    js_ = rig_scene(2, num_points=40, images_per_camera=5, seed=4)
    drop_views(js_[0], js_[3]["coords"])
    ts = port_scene(js_)
    cj = j_compile(*js_[:3])
    ct = compile_problem(ts.cameras, ts.scale_bars, ts.direct_groups)
    return cj, ct


@pytest.fixture(scope="module")
def jax_side():
    """The JAX steps of every case, computed once."""
    cams, _, truth = j_scene(**SCENE)
    drop_views(cams, truth["coords"])
    cj = j_compile(cams, [], [])
    spec = cj.problem.spec
    rp = _host(JR.rcs_from_problem(cj.problem, build_tables=False))
    js = JParamState(*(jnp.asarray(a, jnp.float64) for a in cj.state))
    out = {"spec": spec, "state": cj.state}
    for case in CASES:
        host = redress(rp, cj.state, case)
        out[case] = (host, _jax_step(host, js, spec))
    rj, rt = _rig()
    jrp = JR.rcs_from_problem(rj.problem)
    jrs = JParamState(*(jnp.asarray(a, jnp.float64) for a in rj.state))
    out["rig"] = (rt, _jax_step(jrp, jrs, rj.problem.spec))
    return out


def _check(got, want):
    dxp, dxc, dxg, it, om = got
    wp, wc, wg, wit, wom = want
    assert abs(it - wit) <= 1
    for a, w in ((dxp, wp), (dxc, wc), (dxg, wg)):
        np.testing.assert_allclose(np_(a), w, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(om, wom, rtol=1e-10)


def _port_step(p, st, spec):
    dxp, dxc, dxg, b, it, ext = rcs.lm_step_full(p, st, spec, DAMPING, **CG)
    om = float(rcs.omega_at_full(p, b, ext, 0.75 * dxp, 0.75 * dxc,
                                 0.75 * dxg))
    return (dxp, dxc, dxg, it, om), ext


@pytest.mark.parametrize("images", ["sorted", "blocked"])
@pytest.mark.parametrize("case", CASES)
def test_lm_step_full_matches_jax(jax_side, case, images):
    host, want = jax_side[case]
    p = convert.problem_to_torch(host, CPU, torch.float64)
    assert p.point_uniform is None and p.img_perm is None
    if images == "blocked":
        perm, bs = rcs.build_image_block_layout(host.obs_image,
                                                host.num_images)
        p = p._replace(img_perm=torch.as_tensor(perm),
                       img_block_starts=torch.as_tensor(bs))
    st = convert.state_to_torch(jax_side["state"], CPU, torch.float64)
    got, ext = _port_step(p, st, jax_side["spec"])
    _check(got, want)
    # the inner constraints hold: B dxp = 0
    B = freenet.datum_rows_dense(st.points, p.datum_mask_d,
                                 p.defect_flags_d)
    Bdx = torch.einsum("kpa,pa->k", B, got[0])
    assert float(Bdx.abs().max()) <= 1e-10 * float(got[0].abs().max())
    if case == "group":
        assert ext.Zc is not None and ext.u_idx.shape[0] == 2 + 6


def test_two_camera_rig_matches_jax(jax_side):
    ct, want = jax_side["rig"]
    p = rcs.rcs_from_problem(ct.problem, CPU, layout="file")
    assert p.free_global.shape[0] == 2 * (3 + ct.problem.spec.num_coefficients)
    st = type(ct.state)(*(torch.as_tensor(np.asarray(a, np.float64))
                          for a in ct.state))
    counts = np.bincount(ct.problem.obs_point)
    assert counts.min() <= 5 < counts.max()
    _check(_port_step(p, st, ct.problem.spec)[0], want)
