"""PyTorch + CUDA port of `bundle_adjustment_tpu`.

The JAX package stays the reference; this package re-implements its user
API (the scene model, the dense float64 `BundleAdjustment` with its
`MatrixInversion` modes, `ScaleBundleAdjustment`) and its f32 large-scale
Levenberg-Marquardt step (feature-major engine, implicit-Schur PCG) in
plain PyTorch, with the three kernels of the scale path (camera-row
gather, fused assembly reduction, Schur matvec) as hand-written CUDA C++
for Hopper (``csrc/``, built at first use by ``kernel_build``).  The
solvers run on CUDA unless the caller passes ``device="cpu"``.

Layout mirrors the JAX package so every counterpart is easy to find:

    constants.py       numerical constants and defaults
    models/            scene graph, parameters, layout and rank defect,
                       distortion specs (pure Python), BundleProblem,
                       compile_problem, ParamState
    ops/               rotation, collinearity, distortion, residuals,
                       analytic Jacobians, dense assembly, EO Schur
                       complement, linalg (the dense f64 path)
    solver/            BundleAdjustment, checkpoints
    testing.py         synthetic scenes (same draws as the JAX package's)
    ops/fm.py          feature-major forward model + analytic Jacobian rows
    parallel/engine.py feature-major linearise / reduce / matvec / LM step
    parallel/rcs.py    RCSProblem, block layout, preconditioner, PCG
    parallel/kernels.py packed-row contract + kernel wrappers (K1-K3)
    parallel/lm.py     the f32 LM phase (damping schedule, stop rule)
    parallel/freenet.py scale bars, inner-constraint datum, direct groups
    parallel/solver.py the LM loop `solve` (gain schedule, events)
    parallel/hilo.py, refine.py  two-float state, mixed-precision refiner
    parallel/cov_direct.py       dense posterior covariance
    synthetic.py       the synthetic scale network (same draws as bench.py)
    convert.py         host arrays -> tensors on a device; scenes of
                       objects with the reference's attribute names

Importing the package pins full-f32 matrix products: the reference pins
Precision.HIGHEST everywhere, and a reduced-precision default (TF32 here)
silently rounds normal-equation products to ~1e-3 relative.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from .constants import DEFAULT_MAX_ITERATIONS, EPS, SQRT_EPS  # noqa: E402
from .models.distortion import DistortionSpec, DistortionType  # noqa: E402
from .models.scene import (  # noqa: E402
    Camera,
    DirectlyObservedParameterGroup,
    DirectObservation,
    Image,
    ObjectCoordinate,
    Parameter,
    ScaleBar,
)
from .solver.adjustment import (  # noqa: E402
    BundleAdjustment,
    EstimationState,
    EstimationType,
    MatrixInversion,
)

__version__ = "0.1.0"


def __getattr__(name):
    # lazy: the scale driver pulls in the whole parallel package
    if name == "ScaleBundleAdjustment":
        from .parallel.solver import ScaleBundleAdjustment

        return ScaleBundleAdjustment
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "BundleAdjustment",
    "ScaleBundleAdjustment",
    "Camera",
    "DistortionSpec",
    "DistortionType",
    "DirectObservation",
    "DirectlyObservedParameterGroup",
    "EstimationState",
    "EstimationType",
    "Image",
    "MatrixInversion",
    "ObjectCoordinate",
    "Parameter",
    "ScaleBar",
    "EPS",
    "SQRT_EPS",
    "DEFAULT_MAX_ITERATIONS",
]
