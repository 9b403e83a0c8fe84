"""Job kind ``covariance``: every point's 3x3 posterior cofactor block of
the network in f64, one `parallel.cov_direct.cov_all` per job on the f64
problem as the port's scale example builds it (`engine.fm_problem` of
`convert.problem_to_torch` in float64), linearised at the generator's true
parameters (the configuration's ``assumed`` says why).

The answer stays on the card; a sample of the window's jobs, drawn from
the seed (reservoir sampling, ``sample`` of them), is copied to the host
after each sampled job returns, outside its time.

The check: the reference's blocks at the same state (`reference.bundle.
point_covariances`: autograd Jacobians, the dense reduced system, its LU
inverse, the block recovery), worked out once per run, and each sampled
answer against them: ``cov_gap`` = the largest over the free points of
max|Q - Q_ref| / max|Q_ref| of each point's block.  The held-fixed and
dummy points carry no covariance and are not compared."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness.runner import worst
from benchmark.inputs import network
from benchmark.reference import bundle

#: the staged sequence of `cov_all` (the per-layer readers' split)
STAGES = ("linearise", "assemble_base", "corrections", "inverse",
          "recovery")

#: the key of the sample's random stream, beside the seed
SAMPLE_KEY = 7


class Job:
    def __init__(self, run):
        self.run = run
        self.cfg = run.cell.config
        self.mix = run.cell.traffic

    def inputs(self):
        """The network from the seed (`inputs.network.build`)."""
        cfg = self.cfg
        self.net = network.build(cfg["points"], cfg["images"], cfg["views"],
                                 self.run.seed)

    def setup(self):
        from bundle_adjustment_tpu_torch import convert, synthetic
        from bundle_adjustment_tpu_torch.models.problem import ParamState
        from bundle_adjustment_tpu_torch.parallel import engine
        from bundle_adjustment_tpu_torch.parallel.rcs import RCSProblem

        run = self.run
        self.inputs()
        self.spec = synthetic.scale_spec()
        t = time.perf_counter()
        self.fmp = engine.fm_problem(convert.problem_to_torch(
            RCSProblem(**self.net.problem_fields()), run.device,
            torch.float64))
        self.state = convert.state_to_torch(
            ParamState(**self.net.truth_fields()), run.device, torch.float64)
        run.sync()
        run.spans["to_card_s"] = time.perf_counter() - t
        n = self.net.real_points
        self.sample = [torch.empty((n, 3, 3), dtype=torch.float64,
                                   pin_memory=run.on_card)
                       for _ in range(self.mix["sample"])]
        self.sampled = []       # window job held in each slot
        self.rng = np.random.default_rng([run.seed, SAMPLE_KEY])
        self._cov()             # the warm-up: the cell's own shapes

    def _cov(self):
        from bundle_adjustment_tpu_torch.parallel import cov_direct

        Q = cov_direct.cov_all(self.fmp, self.state, self.spec)
        self.run.sync()
        return Q

    def run_one(self, j):
        t0 = time.perf_counter()
        Q = self._cov()
        t1 = time.perf_counter()
        k = len(self.sample)
        slot = j if j < k else int(self.rng.integers(0, j + 1))
        if slot < k:
            self.sample[slot].copy_(Q[:self.net.real_points])
            if slot < len(self.sampled):
                self.sampled[slot] = j
            else:
                self.sampled.append(j)
        return {"seconds": t1 - t0}

    def profiled(self):
        """One more job, outside the window (the device profile's)."""
        self._cov()

    def stages(self) -> dict:
        """`cov_all`'s calls one by one between CUDA events (on the CPU
        the host clock), as the port's `bench.cov_stages` runs them:
        {stage: seconds}."""
        from bundle_adjustment_tpu_torch.parallel import cov_direct, engine

        marks = []

        def mark():
            if self.run.on_card:
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                marks.append(e)
            else:
                marks.append(time.perf_counter())

        p, run = self.fmp, self.run
        run.sync()
        mark()
        b = engine.materialize_global_rows(
            p, engine.linearize(p, self.state, self.spec, 0.0))
        mark()
        S = cov_direct.assemble_reduced_base(p, b)
        mark()
        S = cov_direct.assemble_reduced_corrections(p, b, S)
        mark()
        Q = cov_direct.reduced_inverse(S)
        del S
        mark()
        cov_direct.point_covariance_dense(p, b, Q)
        mark()
        run.sync()
        if run.on_card:
            sec = [a.elapsed_time(c) / 1e3 for a, c in zip(marks, marks[1:])]
        else:
            sec = [c - a for a, c in zip(marks, marks[1:])]
        return dict(zip(STAGES, sec))

    def release(self):
        self.fmp = self.state = None
        if self.run.on_card:
            torch.cuda.empty_cache()

    # ---- the check ------------------------------------------------------

    def reference(self, dtype=torch.float64):
        """The reference's blocks [n, 3, 3] of the real points in
        ``dtype`` (float32 is the control)."""
        net = self.net
        rnet = bundle.make_net(net.obs_xy, net.obs_image, net.free_point,
                               net.real_points, net.point_uniform,
                               net.num_images, net.r0[0], self.run.device,
                               dtype)
        x = bundle.make_state(net.points_true, net.eo_true, net.io,
                              net.dist, self.run.device, dtype)
        return bundle.point_covariances(rnet, x)

    def compare(self, answers, Q_ref) -> dict:
        scale = Q_ref.abs().amax(dim=(1, 2))
        free = torch.as_tensor(self.net.free_point[:self.net.real_points, 0]
                               > 0, device=scale.device)
        gap = 0.0
        for Q in answers:
            Q = torch.as_tensor(Q, device=scale.device).double()
            gap = worst(gap, float(((Q - Q_ref).abs().amax(dim=(1, 2))[free]
                                    / scale[free]).max()))
        return {"cov_gap": gap}

    def check(self) -> dict:
        answers = self.sample[:len(self.sampled)]
        return self.compare(answers, self.reference())

    def control(self) -> dict:
        """The reference in float32 put in the program's place, judged by
        the same comparison."""
        Q_ref = self.reference()
        return self.compare([self.reference(torch.float32)], Q_ref)
