"""Job kind ``adjust_uneven``: `adjust`'s whole adjustment on a network of
uneven visibility, in file order.

The network is the configuration's ``network_seed`` geometry built with
``views`` views per point and cut by `inputs.uneven.thin`: every
``every``-th point keeps them all, the others their first
``kept_views``, the dummy points dropped, the observations grouped by
image as an image-coordinate file lists them.  ``--seed`` draws the
image noise of every row before the cut, and job j starts from
`inputs.uneven.job_start` (`adjust`'s laws on the network before the
cut).  The network goes to the card in that order
(`convert.problem_to_torch`, with its point order), and a job is
`adjust`'s (`solver.solve` in f32, `refine.Refiner`, `refine.converge`
with the mix's settings) on that problem object, never padded: the
layout picks the port's block-layout engine, whose only kernel is K3
(the EO gathers, on the card).

The check: `reference.uneven`'s Gauss-Newton optimum from the truth on
the observations as the port gets them (f32), and every job's answer
against it by `adjust`'s comparison (``state_gap``, ``omega_gap``)."""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from benchmark.harness.runner import worst
from benchmark.inputs import network, uneven as uneven_inputs
from benchmark.jobs import adjust
from benchmark.reference import uneven


class Job(adjust.Job):
    def inputs(self):
        """The network of uneven visibility: the geometry of the
        configuration's ``network_seed`` in ``views`` views, the image
        noise of scenario ``seed``, cut to file order."""
        cfg = self.cfg
        self.full = network.build(cfg["points"], cfg["images"], cfg["views"],
                                  cfg["network_seed"])
        self.net = uneven_inputs.thin(
            network.scenario(self.full, self.run.seed), cfg["kept_views"],
            cfg["every"])

    def setup(self):
        from bundle_adjustment_tpu_torch import convert, kernel_build
        from bundle_adjustment_tpu_torch import synthetic
        from bundle_adjustment_tpu_torch.parallel.rcs import RCSProblem

        run = self.run
        if run.on_card:
            kernel_build.library()
        self.inputs()
        with ThreadPoolExecutor(adjust.START_THREADS) as ex:
            self.starts = list(ex.map(
                lambda j: uneven_inputs.job_start(self.full, self.full.seed,
                                                  j),
                range(self.mix["starts"])))
        self.full = None
        self.spec = synthetic.scale_spec()
        t = time.perf_counter()
        self.problem = convert.problem_to_torch(
            RCSProblem(**self.net.problem_fields()), run.device,
            torch.float32)
        run.sync()
        run.spans["to_card_s"] = time.perf_counter() - t
        self.run_one(0)     # the warm-up: the cell's own shapes

    # ---- the check ------------------------------------------------------

    def reference_net(self, dtype):
        """The reference's network: the observations as the port gets
        them (f32), in ``dtype``."""
        net = self.net
        xy = net.obs_xy.astype(np.float32).astype(np.float64)
        return uneven.make_net(xy, net.obs_image, net.obs_point,
                               net.free_point, net.num_points,
                               net.num_images, net.r0[0], self.run.device,
                               dtype)

    def reference(self, dtype=torch.float64):
        """The reference's optimum (GNResult) in ``dtype``; float32 is
        the control."""
        return uneven.gauss_newton(self.reference_net(dtype),
                                   self.reference_start(dtype),
                                   **self.mix["reference"])

    def compare(self, answers, ref) -> dict:
        """`adjust.Job.compare` with the uneven network's Omega."""
        rnet = self.reference_net(torch.float64)
        x_ref = ref.state
        state_gap = omega_gap = 0.0
        for a in answers:
            x = uneven.State(*(torch.as_tensor(v, device=self.run.device)
                               .double() for v in a))
            for u, v in zip(x, x_ref):
                state_gap = worst(state_gap, float((u - v).abs().max()))
            om = uneven.omega(rnet, x)
            omega_gap = worst(omega_gap, abs(om - ref.omega) / ref.omega)
        return {"state_gap": state_gap, "omega_gap": omega_gap}
