"""Job kind ``adjust_rig``: `adjust`'s whole adjustment on a camera rig.

The network is the configuration's ``network_seed`` geometry built as a
rig of ``cameras`` self-calibrated cameras (`inputs.rig`: image m on
camera m % C, each camera with its own IO and distortion, G = 10 C); the
image noise of ``--seed`` and the starts are `adjust`'s.  A job is
`adjust`'s (`solver.solve` in f32, `refine.Refiner`, `refine.converge`
with the mix's settings), except that the Refiner's route is the port's
own choice (``use_kernels=None``): the kernels take one camera, and the
port picks the plain compact rows for a rig.

The check: `reference.rig`'s Gauss-Newton optimum from the truth on the
observations as the port gets them (f32), and every job's answer against
it by `adjust`'s comparison (``state_gap``, ``omega_gap``); the answer's
globals are [io of every camera, then their distortion], as `adjust`
hands them in."""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark.harness.runner import worst
from benchmark.inputs import network
from benchmark.inputs import rig as rig_inputs
from benchmark.jobs import adjust
from benchmark.reference import rig


class Job(adjust.Job):
    def inputs(self):
        """The rig: the geometry of the configuration's ``network_seed``
        with ``cameras`` cameras, the image noise of scenario ``seed``."""
        cfg = self.cfg
        self.net = network.scenario(
            rig_inputs.build(cfg["points"], cfg["images"], cfg["views"],
                             cfg["network_seed"], cfg["cameras"]),
            self.run.seed)

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
        refiner = refine.Refiner(self.problem, self.spec, use_kernels=None,
                                 **mix["refiner"])
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

    # ---- the check ------------------------------------------------------

    def reference_net(self, dtype):
        """The reference's network: the observations as the port gets
        them (f32), in ``dtype``."""
        net = self.net
        xy = net.obs_xy.astype(np.float32).astype(np.float64)
        return rig.make_net(xy, net.obs_image, net.cam_of_image,
                            net.free_point, net.real_points,
                            net.point_uniform, net.num_images, net.r0[0],
                            self.run.device, dtype)

    def reference(self, dtype=torch.float64):
        """The reference's optimum (GNResult) in ``dtype``; float32 is
        the control."""
        return rig.gauss_newton(self.reference_net(dtype),
                                self.reference_start(dtype),
                                **self.mix["reference"])

    def compare(self, answers, ref) -> dict:
        """`adjust.Job.compare` with the rig's Omega."""
        rnet = self.reference_net(torch.float64)
        x_ref = ref.state
        state_gap = omega_gap = 0.0
        for a in answers:
            x = rig.State(*(torch.as_tensor(v, device=self.run.device)
                            .double() for v in a))
            for u, v in zip(x, x_ref):
                state_gap = worst(state_gap, float((u - v).abs().max()))
            om = rig.omega(rnet, x)
            omega_gap = worst(omega_gap, abs(om - ref.omega) / ref.omega)
        return {"state_gap": state_gap, "omega_gap": omega_gap}
