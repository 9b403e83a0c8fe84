"""The block-layout engine of the port (`parallel/rcs.py`: `linearize` ..
`lm_step_full`) against the JAX `parallel/rcs.py`, on the CPU in f64.

The scene: `testing.make_synthetic_scene(60, 10)` of each package (the
JAX copy for the JAX side, the port's copy for the port), three points
held fixed (the datum of tests/test_rcs.py), thinned by one seeded rule
applied to both alike (`drop_views`): every tenth point keeps all ten of
its views, every other point 3 to 5, so the views per point range from 3
to 10 and the padded point-major layout would take more than twice the
rows: `rcs_from_problem`'s layout rule picks ``"file"``.  The JAX problem
carries its dense visibility tables (its default), the port's the point
order and the blocked image layout.

Tolerances, from the JAX tests each check mirrors: the linearisation
blocks rtol 1e-12 (tests/test_multi_camera.py, compact vs masked rows),
the global sums rtol 1e-9 / atol 1e-12 and Omega rtol 1e-10 (the same
test); the reductions rtol 1e-6 / atol 1e-10 (tests/test_reductions.py;
they hold at 1e-12 here); a step rtol 1e-8 / atol 1e-10 and its Omega
rtol 1e-10 (tests/test_freenet.py against the dense bordered step).
"""

from contextlib import nullcontext as _nullcontext

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundle_adjustment_tpu.models.problem import ParamState as JParamState
from bundle_adjustment_tpu.models.problem import compile_problem as j_compile
from bundle_adjustment_tpu.parallel import rcs as JR
from bundle_adjustment_tpu.testing import make_synthetic_scene as j_scene
from bundle_adjustment_tpu_torch.models.problem import ParamState
from bundle_adjustment_tpu_torch.models.problem import compile_problem
from bundle_adjustment_tpu_torch.parallel import engine, rcs
from bundle_adjustment_tpu_torch.testing import make_synthetic_scene
from _torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
RAGGED_SEED = 3
SCENE = dict(num_points=60, num_images=10, noise=1e-4, sigma=1e-4,
             perturb=0.01, seed=13, with_scale_bar=False)


def drop_views(cameras, coords, seed=RAGGED_SEED, every=10, low=3, high=5):
    """Thin a scene of either package in place: point i keeps all its views
    where i % every == 0, else a seeded choice of low..high of them (all
    if it has fewer), in image order.  The draws depend only on the
    scene's structure, so two scenes of that structure thin alike."""
    rng = np.random.default_rng(seed)
    images = [img for cam in cameras for img in cam]
    for i, oc in enumerate(coords):
        seen = [img for img in images if oc in img._coordinates]
        keep = int(rng.integers(low, high + 1))
        order = rng.permutation(len(seen))
        if i % every == 0:
            continue
        for j in order[keep:]:
            del seen[j]._coordinates[oc]


def fixed_datum(coords):
    for oc in coords[:3]:
        for par in oc.params:
            par.fixed = True


def ragged_scenes(**kw):
    """((JAX cameras, coords), (port cameras, coords)) of the thinned
    scene."""
    args = {**SCENE, **kw}
    out = []
    for make in (j_scene, make_synthetic_scene):
        cams, _, truth = make(**args)
        drop_views(cams, truth["coords"])
        fixed_datum(truth["coords"])
        out.append((cams, truth["coords"]))
    return tuple(out)


def ragged_problems(**kw):
    """(JAX bp, JAX RCSProblem, JAX state, port bp, port state): the
    compiled thinned scene of each package."""
    (jc, _), (tc, _) = ragged_scenes(**kw)
    cj = j_compile(jc, [], [])
    ct = compile_problem(tc, [], [])
    js = JParamState(*(jnp.asarray(a, jnp.float64) for a in cj.state))
    ts = ParamState(*(torch.as_tensor(np.asarray(a, np.float64))
                      for a in ct.state))
    return cj.problem, JR.rcs_from_problem(cj.problem), js, ct.problem, ts


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX engine on the thinned scene, computed once."""
    bpj, rpj, sj, bpt, st = ragged_problems()
    spec = bpj.spec
    lin = JR.linearize(rpj, sj, spec, 1e-3)
    b, rc, rg, Minv = JR.prepare(rpj, sj, spec, 1e-3)
    rng = np.random.default_rng(5)
    G = int(b.Jg.shape[2])
    xs = [(rng.normal(size=(bpj.num_images, 6)), rng.normal(size=G))
          for _ in range(3)]
    mv = [tuple(np.asarray(a) for a in JR.schur_matvec(
        rpj, b, jnp.asarray(c), jnp.asarray(g))) for c, g in xs]
    step = JR.lm_step(rpj, sj, spec, 1e-3, cg_tol=1e-14, cg_maxiter=500)
    dxp, dxc, dxg, bs, it = step
    om = float(JR.omega_at(rpj, bs, 0.75 * dxp, 0.75 * dxc, 0.75 * dxg))
    it12 = int(JR.lm_step(rpj, sj, spec, 1e-3, cg_tol=1e-12,
                          cg_maxiter=500)[4])
    # the coupled preconditioner and its applies, einsum and exact forms
    applies = {}
    for exact in (False, True):
        with JR.exact_preconditioner() if exact else _nullcontext():
            Mc = JR.couple_preconditioner(
                lambda c, g: JR.schur_matvec(rpj, b, c, g), Minv,
                bpj.num_images, G, jnp.float64)
            for name, M_ in (("block", Minv), ("coupled", Mc)):
                applies[exact, name] = tuple(
                    np.asarray(a) for a in JR.make_apply_M(M_)(rc, rg))
    return dict(bpj=bpj, rpj=rpj, sj=sj, bpt=bpt, st=st, spec=spec,
                lin=lin, b=b, rc=np.asarray(rc), rg=np.asarray(rg),
                Minv=Minv, xs=xs, mv=mv,
                step=(np.asarray(dxp), np.asarray(dxc), np.asarray(dxg),
                      int(it)), omega=om, it12=it12, applies=applies)


@pytest.fixture(scope="module")
def port(jax_side):
    return rcs.rcs_from_problem(jax_side["bpt"], CPU)


def test_scene_is_ragged_and_takes_the_file_layout(jax_side, port):
    counts = np.bincount(np.asarray(jax_side["bpj"].obs_point))
    assert counts.min() == 3 and counts.max() == 10
    assert port.point_uniform is None and port.point_order is not None
    assert rcs.choose_layout(jax_side["bpt"].obs_point,
                             jax_side["bpt"].num_points) == "file"
    # the observations of the two packages, in compile_problem order
    np.testing.assert_array_equal(np_(port.obs_point),
                                  np.asarray(jax_side["rpj"].obs_point))
    np.testing.assert_array_equal(np_(port.obs_image),
                                  np.asarray(jax_side["rpj"].obs_image))
    np.testing.assert_allclose(np_(port.obs_xy),
                               np.asarray(jax_side["rpj"].obs_xy),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("field", ["Jp", "Jc", "Jg", "PJp", "PJc", "PJg",
                                   "w", "Hpp_inv", "bp", "bc", "extra_c"])
def test_linearize_blocks_match_jax(jax_side, port, field):
    b = rcs.linearize(port, jax_side["st"], jax_side["spec"], 1e-3)
    ref = np.asarray(getattr(jax_side["lin"], field))
    np.testing.assert_allclose(np_(getattr(b, field)), ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())


def test_linearize_global_sums_match_jax(jax_side, port):
    b = rcs.linearize(port, jax_side["st"], jax_side["spec"], 1e-3)
    lin = jax_side["lin"]
    for name in ("bg", "extra_g"):
        np.testing.assert_allclose(np_(getattr(b, name)),
                                   np.asarray(getattr(lin, name)),
                                   rtol=1e-9, atol=1e-12, err_msg=name)
    np.testing.assert_allclose(float(b.omega0), float(lin.omega0),
                               rtol=1e-10)


def test_prepare_matches_jax(jax_side, port):
    b, rc, rg, Minv = rcs.prepare(port, jax_side["st"], jax_side["spec"],
                                  1e-3)
    ref = jax_side["b"]
    for name in ("bc", "extra_c", "bg", "extra_g"):
        np.testing.assert_allclose(np_(getattr(b, name)),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-9, atol=1e-12, err_msg=name)
    for got, want in ((rc, jax_side["rc"]), (rg, jax_side["rg"])):
        np.testing.assert_allclose(np_(got), want, rtol=1e-9,
                                   atol=1e-12 * np.abs(want).max())
    for name in ("Minv_c", "Minv_g"):
        want = np.asarray(getattr(jax_side["Minv"], name))
        np.testing.assert_allclose(np_(getattr(Minv, name)), want,
                                   rtol=1e-9, atol=1e-12 * np.abs(want).max(),
                                   err_msg=name)
    # the unfused reduced rhs and camera blocks give the same
    rc2, rg2 = rcs.reduced_rhs(port, b)
    np.testing.assert_allclose(np_(rc2), jax_side["rc"], rtol=1e-9,
                               atol=1e-12 * np.abs(jax_side["rc"]).max())
    np.testing.assert_allclose(np_(rg2), jax_side["rg"], rtol=1e-9,
                               atol=1e-12 * np.abs(jax_side["rg"]).max())
    mc = rcs.camera_block_preconditioner(port, b)
    np.testing.assert_allclose(np_(mc), np_(Minv.Minv_c), rtol=1e-9,
                               atol=1e-12 * float(Minv.Minv_c.abs().max()))


@pytest.mark.parametrize("k", range(3))
def test_schur_matvec_matches_jax(jax_side, port, k):
    b = rcs.prepare(port, jax_side["st"], jax_side["spec"], 1e-3)[0]
    c, g = jax_side["xs"][k]
    oc, og = rcs.schur_matvec(port, b, torch.as_tensor(c), torch.as_tensor(g))
    wc, wg = jax_side["mv"][k]
    np.testing.assert_allclose(np_(oc), wc, rtol=1e-9,
                               atol=1e-12 * np.abs(wc).max())
    np.testing.assert_allclose(np_(og), wg, rtol=1e-9,
                               atol=1e-12 * np.abs(wg).max())


def test_lm_step_matches_jax(jax_side, port):
    """dx at cg_tol 1e-14, and the CG count.  At 1e-14 the relative
    residual sits at the f64 floor of this system: the JAX blocks put
    through the JAX and the port's matvec read 1.1e-14 and 6.0e-15 at the
    same iteration (two summation orders of the same products), so the
    count there may differ by one; at 1e-12 (a factor 5 above the
    residual of the stopping iteration) it must be equal."""
    dxp, dxc, dxg, b, it = rcs.lm_step(port, jax_side["st"],
                                       jax_side["spec"], 1e-3, cg_tol=1e-14,
                                       cg_maxiter=500)
    wp, wc, wg, wit = jax_side["step"]
    assert abs(it - wit) <= 1
    it12 = rcs.lm_step(port, jax_side["st"], jax_side["spec"], 1e-3,
                       cg_tol=1e-12, cg_maxiter=500)[4]
    assert it12 == jax_side["it12"]
    for got, want in ((dxp, wp), (dxc, wc), (dxg, wg)):
        np.testing.assert_allclose(np_(got), want, rtol=1e-8, atol=1e-10)
    om = rcs.omega_at(port, b, 0.75 * dxp, 0.75 * dxc, 0.75 * dxg)
    np.testing.assert_allclose(float(om), jax_side["omega"], rtol=1e-10)


@pytest.mark.parametrize("what", ["point", "image", "expand"])
def test_reductions_equal_jax_segment_sum(jax_side, port, what):
    """The port's sorted segment sums (per point) and blocked image layout
    (per image) against JAX's `segment_sum` on the same rows; and the
    gather back to the observations."""
    import jax

    rng = np.random.default_rng(11)
    rpj = jax_side["rpj"]
    N = int(rpj.obs_point.shape[0])
    if what == "expand":
        z = rng.normal(size=(rpj.num_points, 3))
        want = np.asarray(JR._expand_point(rpj, jnp.asarray(z)))
        got = rcs._expand_point(port, torch.as_tensor(z))
        np.testing.assert_array_equal(np_(got), want)
        return
    x = rng.normal(size=(N, 3, 6))
    ids, num, fn = ((rpj.obs_point, rpj.num_points, rcs._seg_point)
                    if what == "point"
                    else (rpj.obs_image, rpj.num_images, rcs._seg_image))
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(x), ids,
                                          num_segments=num))
    got = np_(fn(port, torch.as_tensor(x)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    # without the stored order / blocked layout: the same bits
    bare = port._replace(point_order=None, point_counts=None, img_perm=None,
                         img_block_starts=None)
    got2 = np_(fn(bare, torch.as_tensor(x)))
    if what == "point":
        np.testing.assert_array_equal(got2, got)
    else:
        np.testing.assert_allclose(got2, want, rtol=1e-12, atol=1e-12)


def test_point_major_and_file_steps_agree(jax_side, port):
    """The port alone: the block-layout step on the file order against the
    feature-major step on the padded layout of the same network
    (`rcs.to_point_major`), within 1e-10 relative."""
    st, spec = jax_side["st"], jax_side["spec"]
    dxp, dxc, dxg, _, _ = rcs.lm_step(port, st, spec, 1e-3, cg_tol=1e-14,
                                      cg_maxiter=500)
    pm = rcs.to_point_major(port)
    assert pm.point_uniform == 10
    assert pm.obs_point.shape[0] == 10 * port.num_points
    fp, fc, fg, _, _ = engine.lm_step(engine.fm_problem(pm), st, spec, 1e-3,
                                      cg_tol=1e-14, cg_maxiter=500)
    for a, b_ in ((dxp, fp), (dxc, fc), (dxg, fg)):
        scale = float(b_.abs().max())
        assert float((a - b_).abs().max()) <= 1e-10 * scale


def test_layout_rule_of_rcs_from_problem(jax_side):
    bp = jax_side["bpt"]
    f = rcs.rcs_from_problem(bp, CPU, layout="file")
    m = rcs.rcs_from_problem(bp, CPU, layout="point_major")
    assert f.point_uniform is None and m.point_uniform == 10
    assert f.obs_point.shape[0] == bp.num_image_obs
    assert m.obs_point.shape[0] == 10 * bp.num_points
    assert rcs.rcs_from_problem(bp, CPU).point_uniform is None
    with pytest.raises(ValueError, match="layout"):
        rcs.rcs_from_problem(bp, CPU, layout="padded")
    # the rule: point-major where P x Vmax <= 2 N
    assert rcs.choose_layout([0, 0, 1, 1], 2) == "point_major"
    assert rcs.choose_layout([0, 0, 0, 0, 0, 1], 3) == "file"
    assert rcs.choose_layout([0, 0, 0, 1, 2], 3) == "point_major"
    # the untouched scene keeps the padded layout it had
    cams, _, _ = make_synthetic_scene(**SCENE)
    full = compile_problem(cams, [], []).problem
    assert rcs.rcs_from_problem(full, CPU).point_uniform is not None


@pytest.mark.parametrize("exact", [False, True], ids=["einsum", "exact"])
@pytest.mark.parametrize("name", ["block", "coupled"])
def test_preconditioner_applies_match_jax(jax_side, port, name, exact):
    """`make_apply_M` of the block and the coupled preconditioner
    (`couple_preconditioner`: G unit matvecs, then `finish_coupling`), in
    the einsum form and inside `exact_preconditioner` (elementwise
    multiply-sums), against the JAX forms; the two forms agree."""
    b, rc, rg, Minv = rcs.prepare(port, jax_side["st"], jax_side["spec"],
                                  1e-3)
    G = b.Jg.shape[2]
    out = {}
    for ex in (False, True):
        with rcs.exact_preconditioner() if ex else _nullcontext():
            M_ = Minv if name == "block" else rcs.couple_preconditioner(
                lambda c, g: rcs.schur_matvec(port, b, c, g), Minv,
                port.num_images, G)
            assert (M_.Scg is not None) == (name == "coupled")
            out[ex] = rcs.make_apply_M(M_)(rc, rg)
    assert not rcs._EXACT_APPLY
    for got, want in zip(out[exact], jax_side["applies"][exact, name]):
        np.testing.assert_allclose(np_(got), want, rtol=1e-9,
                                   atol=1e-12 * np.abs(want).max())
    for a, b_ in zip(out[True], out[False]):
        np.testing.assert_allclose(np_(a), np_(b_), rtol=1e-12,
                                   atol=1e-14 * float(b_.abs().max()))
