"""PyTorch + CUDA port of the scale solver of `bundle_adjustment_tpu`.

The JAX package stays the reference; this package re-implements its f32
large-scale Levenberg-Marquardt step (feature-major engine, implicit-Schur
PCG) in plain PyTorch, with the three kernels of the main path (camera-row
gather, fused assembly reduction, Schur matvec) as hand-written CUDA C++
for Hopper (``csrc/``, built at first use by ``kernel_build``).

Layout mirrors the JAX package so every counterpart is easy to find:

    models/            distortion specs (pure Python), ParamState
    ops/fm.py          feature-major forward model + analytic Jacobian rows
    parallel/engine.py feature-major linearise / reduce / matvec / LM step
    parallel/rcs.py    RCSProblem, block layout, preconditioner, PCG
    parallel/kernels.py packed-row contract + kernel wrappers (K1-K3)
    parallel/lm.py     the f32 LM phase (damping schedule, stop rule)
    synthetic.py       the synthetic scale network (same draws as bench.py)
    convert.py         host arrays -> tensors on a device

Importing the package pins full-f32 matrix products: the reference pins
Precision.HIGHEST everywhere, and a reduced-precision default (TF32 here)
silently rounds normal-equation products to ~1e-3 relative.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
