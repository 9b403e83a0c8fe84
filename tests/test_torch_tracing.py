"""The port's program spans (`solver.tracing.span` / `recording`) on the
CPU: off by default, nested as the layers call each other, one job id,
the PCG iteration counts equal to the solver's own records (the only
other count: the Refiner's ``rows``), `cov_all`'s
stages in order, the answers bit-equal with recording on and off, and
`device_trace` writing the spans into its Chrome trace on the clock of
the operators it records.  A 500-point network (padded to 512) of 12
images and 6 views: the f32 `solve`, the refinement to 1e-6 and the f64
`cov_all`, ~5 s."""

import json
import os

import pytest
import torch

from bundle_adjustment_tpu_torch import convert, synthetic
from bundle_adjustment_tpu_torch.parallel import (cov_direct, engine, hilo,
                                                  lm, refine, solver)
from bundle_adjustment_tpu_torch.solver import tracing
from _torch_threads import one_torch_thread  # noqa: F401

SOLVE = dict(damping=1e-2, max_iterations=12, tolerance=1e-3)
COV_STAGES = ["linearize", "cov.assemble_base", "cov.corrections",
              "cov.inverse", "cov.recovery"]


@pytest.fixture(scope="module")
def net():
    ph, sh, spec = synthetic.build_problem(500, 12, 6, seed=1)
    return dict(
        spec=spec,
        p32=convert.problem_to_torch(ph, "cpu", torch.float32),
        s32=convert.state_to_torch(sh, "cpu", torch.float32),
        fm64=engine.fm_problem(convert.problem_to_torch(ph, "cpu",
                                                        torch.float64)))


def _adjust(net):
    """The benchmark's adjustment: f32 solve, Refiner, converge."""
    res = solver.solve(net["p32"], net["s32"], net["spec"], **SOLVE)
    refiner = refine.Refiner(net["p32"], net["spec"])
    phase = lm.LMPhase(steps=res.iterations, max_dx=res.max_abs_dx,
                       cg_iterations=[h["cg_it"] for h in res.history],
                       seconds=0.0)
    s, rec = refine.converge(refiner, (res.state, phase), damping=0.0)
    return res, s, rec


def _cov(net, s):
    return cov_direct.cov_all(net["fm64"], hilo.to_f64(s), net["spec"])


@pytest.fixture(scope="module")
def traced(net):
    """(spans, solve result, refined state, Convergence) of one adjustment
    recorded as job 7."""
    with tracing.recording(job=7) as spans:
        res, s, rec = _adjust(net)
    return spans, res, s, rec


def _ancestors(spans, i):
    out = []
    while spans[i].parent >= 0:
        i = spans[i].parent
        out.append(spans[i].name)
    return out


def test_recording_is_off_by_default(net, monkeypatch):
    monkeypatch.setattr(tracing, "_spans", [])
    res, s, rec = _adjust(net)
    assert rec.converged
    assert not tracing.ACTIVE and tracing._spans == []
    assert tracing.span("pcg") is tracing.span("solve")


def test_spans_nest_as_the_layers_call(traced):
    spans, res, _s, rec = traced
    names = {s.name for s in spans}
    assert names == {"solve", "solve.layout", "lm_step", "omega", "prepare",
                     "linearize", "pcg", "back_substitute", "refine.build",
                     "refine.step", "refine.gradient64"}
    assert all(s.job == 7 for s in spans)
    for i, s in enumerate(spans):
        assert s.end_ns is not None and s.end_ns >= s.start_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
            assert s.parent < i
    pcg_in_solve = [i for i, s in enumerate(spans)
                    if s.name == "pcg" and "solve" in _ancestors(spans, i)]
    assert len(pcg_in_solve) == res.iterations
    for i in pcg_in_solve:
        assert _ancestors(spans, i)[:2] == ["lm_step", "solve"]
    steps = [i for i, s in enumerate(spans) if s.name == "refine.step"]
    assert len(steps) == rec.refine_steps
    in_prepare = [i for i, s in enumerate(spans) if s.name == "linearize"
                  and _ancestors(spans, i)[:2] == ["prepare", "refine.step"]]
    in_grad = [i for i, s in enumerate(spans) if s.name == "linearize"
               and _ancestors(spans, i)[:2] == ["refine.gradient64",
                                                "refine.step"]]
    assert len(in_prepare) == len(in_grad) == rec.refine_steps


def test_pcg_iterations_are_the_solvers_counts(traced):
    spans, res, _s, rec = traced
    counted = sum(s.counts.get("iterations", 0) for s in spans
                  if s.name == "pcg")
    assert counted == (sum(h["cg_it"] for h in res.history)
                       + sum(rec.cg_iterations))
    assert all("iterations" in s.counts for s in spans if s.name == "pcg")
    assert not [s for s in spans
                if s.counts and s.name not in ("pcg", "refine.build")]
    # the Refiner counts the observation rows its problems hold: P x V
    assert [s.counts for s in spans if s.name == "refine.build"] \
        == [{"rows": 512 * 6}]


def test_cov_all_stage_spans_in_order(net, traced):
    with tracing.recording(job="cov") as spans:
        _cov(net, traced[2])
    assert spans[0].name == "cov_all" and spans[0].parent == -1
    assert [s.name for s in spans if s.parent == 0] == COV_STAGES
    starts = [s.start_ns for s in spans if s.parent == 0]
    assert starts == sorted(starts)


@pytest.mark.parametrize("part", ["solve", "cov_all"])
def test_answers_bit_equal_with_recording(net, traced, part):
    if part == "solve":
        def run():
            return solver.solve(net["p32"], net["s32"], net["spec"],
                                **SOLVE).state
    else:
        def run():
            return (_cov(net, traced[2]),)
    off = run()
    with tracing.recording():
        on = run()
    assert all(torch.equal(a, b) for a, b in zip(off, on))


def test_device_trace_holds_the_spans_on_its_clock(net, tmp_path):
    logdir = str(tmp_path / "trace")
    with tracing.device_trace(logdir):
        solver.solve(net["p32"], net["s32"], net["spec"], damping=1e-2,
                     max_iterations=2, tolerance=1e-3)
    with open(os.path.join(logdir, tracing.TRACE_FILE)) as fh:
        events = json.load(fh)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "program_span"]
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("name", "").startswith("aten::")]
    assert {e["name"] for e in spans} >= {"solve", "lm_step", "pcg",
                                           "linearize"}
    pcg = [e for e in spans if e["name"] == "pcg"]
    assert len(pcg) == 2 and all(e["args"]["iterations"] > 0 for e in pcg)
    for e in pcg:
        lo, hi = e["ts"], e["ts"] + e["dur"]
        inside = [o for o in ops if lo <= o["ts"] and o["ts"] + o["dur"] <= hi]
        assert inside, "a pcg span holds no operator of its own work"
    solve = [e for e in spans if e["name"] == "solve"]
    assert len(solve) == 1
    lo, hi = solve[0]["ts"], solve[0]["ts"] + solve[0]["dur"]
    assert all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in spans)
    assert not tracing.ACTIVE
