"""Job kind ``adjust``: one whole adjustment of the network per job, as the
port's scale example runs it (`examples/example_scale_torch.py`,
``point_major``), from job j's own start on the network already on the
card.

    1. `parallel.solver.solve` in f32 (the mix's ``solve`` settings);
    2. `parallel.refine.Refiner` on the f32 problem (kernels on a card;
       the mix's ``refiner`` settings);
    3. `parallel.refine.converge` (the mix's ``refine`` settings).

Every run adjusts the same geometry (the configuration's
``network_seed``) from the same starts; ``--seed`` draws the image
noise, so the seed changes the answer and not the size of the work.  The answer is the
refined state in f64, copied to the host.  A job fails
if it raises or the refinement ends unconverged.  Job j starts from
`inputs.network.job_start` of the geometry's seed for start j mod
``starts`` (drawn in set-up, in a few threads: numpy's draws release the
interpreter lock), the same starts in every run.

The check: the reference's Gauss-Newton optimum, worked out once per run
from the truth on the observations and held coordinates as the port gets
them (rounded to f32: the port's input), and every job's answer against
it: ``state_gap`` = max|x - x_ref| over every parameter (the units of the
port's own max|dx| stop), ``omega_gap`` = |Omega(x) - Omega(x_ref)| /
Omega(x_ref), Omega worked out by the reference at each answer."""

from __future__ import annotations

import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from benchmark.harness.runner import worst
from benchmark.inputs import network
from benchmark.reference import bundle

#: threads that draw the starts in set-up (numpy's draws release the
#: interpreter lock)
START_THREADS = 8


class Job:
    def __init__(self, run):
        self.run = run
        self.cfg = run.cell.config
        self.mix = run.cell.traffic
        self.last_state = None

    # ---- set-up ---------------------------------------------------------

    def inputs(self):
        """The network: the geometry of the configuration's
        ``network_seed``, the image noise of scenario ``seed``
        (`inputs.network.scenario`)."""
        cfg = self.cfg
        self.net = network.scenario(
            network.build(cfg["points"], cfg["images"], cfg["views"],
                          cfg["network_seed"]), self.run.seed)

    def setup(self):
        from bundle_adjustment_tpu_torch import convert, kernel_build
        from bundle_adjustment_tpu_torch import synthetic
        from bundle_adjustment_tpu_torch.parallel.rcs import RCSProblem

        run = self.run
        if run.on_card:
            kernel_build.library()
        self.inputs()
        with ThreadPoolExecutor(START_THREADS) as ex:
            self.starts = list(ex.map(
                lambda j: network.job_start(self.net, self.net.seed, j),
                range(self.mix["starts"])))
        self.spec = synthetic.scale_spec()
        t = time.perf_counter()
        self.problem = convert.problem_to_torch(
            RCSProblem(**self.net.problem_fields()), run.device,
            torch.float32)
        run.sync()
        run.spans["to_card_s"] = time.perf_counter() - t
        self.run_one(0)     # the warm-up: the cell's own shapes

    # ---- one job --------------------------------------------------------

    def run_one(self, j):
        from bundle_adjustment_tpu_torch import convert
        from bundle_adjustment_tpu_torch.models.problem import ParamState
        from bundle_adjustment_tpu_torch.parallel import hilo, lm, refine
        from bundle_adjustment_tpu_torch.parallel import solver

        run, net, mix = self.run, self.net, self.mix
        pts, eo = self.starts[j % len(self.starts)]
        t0 = time.perf_counter()
        s32 = convert.state_to_torch(
            ParamState(points=pts, io=net.io, dist=net.dist, eo=eo),
            run.device, torch.float32)
        t1 = time.perf_counter()
        res = solver.solve(self.problem, s32, self.spec, **mix["solve"])
        t2 = time.perf_counter()
        refiner = refine.Refiner(self.problem, self.spec,
                                 use_kernels=run.on_card, **mix["refiner"])
        phase = lm.LMPhase(steps=res.iterations, max_dx=res.max_abs_dx,
                           cg_iterations=[h["cg_it"] for h in res.history],
                           seconds=t2 - t1)
        s_ref, rec = refine.converge(refiner, (res.state, phase),
                                     **mix["refine"])
        t3 = time.perf_counter()
        st = hilo.to_f64(s_ref)
        n = net.real_points
        out = (st.points[:n].cpu().numpy(), st.eo.cpu().numpy(),
               np.concatenate([st.io.cpu().numpy().reshape(-1),
                               st.dist.cpu().numpy().reshape(-1)]))
        t4 = time.perf_counter()
        self.last_state = res.state
        if not rec.converged:
            raise RuntimeError(
                f"job {j}: the refinement ended unconverged, max|dx| "
                f"{rec.max_dx}")
        cg = [h["cg_it"] for h in res.history]
        print(f"job {j}: {t4 - t0:.4f} s; solve {res.iterations} steps "
              f"{t2 - t1:.4f} s, max|dx| {res.max_abs_dx:.3e}, CG {cg}; "
              f"refinement {rec.refine_steps} steps {t3 - t2:.4f} s, "
              f"max|dx| {['%.2e' % x for x in rec.max_dx]}, CG "
              f"{rec.cg_iterations}", file=sys.stderr)
        return {"seconds": t4 - t0, "solve_s": t2 - t1, "refine_s": t3 - t2,
                "cg": int(sum(cg) + sum(rec.cg_iterations)), "answer": out}

    def profiled(self):
        """One more job, outside the window (the device profile's)."""
        self.run_one(len(self.run.records))

    def program(self):
        """(f32 problem, spec, an f32 state near the optimum) for the
        per-layer readers that drive the port's layers alone."""
        return self.problem, self.spec, self.last_state

    def release(self):
        self.problem = self.last_state = None
        if self.run.on_card:
            torch.cuda.empty_cache()

    # ---- the check ------------------------------------------------------

    def reference_net(self, dtype):
        """The reference's network: the observations as the port gets
        them (f32), in ``dtype``."""
        net = self.net
        xy = net.obs_xy.astype(np.float32).astype(np.float64)
        return bundle.make_net(xy, net.obs_image, net.free_point,
                               net.real_points, net.point_uniform,
                               net.num_images, net.r0[0], self.run.device,
                               dtype)

    def reference_start(self, dtype):
        """The truth, the held-fixed coordinates as the port gets them
        (f32: the start of every job holds them at their true value)."""
        net = self.net
        pts = net.points_true.astype(np.float32).astype(np.float64)
        pts = np.where(net.free_point[:net.real_points] > 0,
                       net.points_true, pts)
        return bundle.make_state(pts, net.eo_true, net.io, net.dist,
                                 self.run.device, dtype)

    def reference(self, dtype=torch.float64):
        """The reference's optimum (GNResult) in ``dtype``; float32 is
        the control."""
        return bundle.gauss_newton(self.reference_net(dtype),
                                   self.reference_start(dtype),
                                   **self.mix["reference"])

    def compare(self, answers, ref) -> dict:
        """The numbers compared, the worst over ``answers`` [(points, eo,
        g)] of host arrays or tensors, against the f64 ``ref``."""
        rnet = self.reference_net(torch.float64)
        x_ref = ref.state
        state_gap = omega_gap = 0.0
        for a in answers:
            x = bundle.State(*(torch.as_tensor(v, device=self.run.device)
                               .double() for v in a))
            for u, v in zip(x, x_ref):
                state_gap = worst(state_gap, float((u - v).abs().max()))
            om = bundle.omega(rnet, x)
            omega_gap = worst(omega_gap, abs(om - ref.omega) / ref.omega)
        return {"state_gap": state_gap, "omega_gap": omega_gap}

    def check(self) -> dict:
        answers = [r["answer"] for r in self.run.completed()]
        return self.compare(answers, self.reference())

    def control(self) -> dict:
        """The reference in float32 put in the program's place, judged by
        the same comparison."""
        ref = self.reference()
        low = self.reference(torch.float32)
        return self.compare([tuple(low.state)], ref)
