"""Numerical constants and defaults.

TPU-native re-design of the reference constants
(`JAICOV/src/org/applied_geodesy/adjustment/Constant.java:61-75`,
`DefaultValue.java:25-33`).
"""

from __future__ import annotations

import math

# Relative machine epsilon for IEEE binary64, computed the same way the
# reference does (halving until 1 + eps == 1; Constant.java:67-75).  The loop
# terminates with eps = 2^-53 — note this is *half* of numpy's float64 eps.
EPS: float = 2.0 ** -53

# Convergence criterion of the Gauss-Newton / Levenberg-Marquardt loop:
# max|dx| <= sqrt(EPS) on the Jacobi-preconditioned system
# (BundleAdjustment.java:77,332).
SQRT_EPS: float = math.sqrt(EPS)

# Iteration cap (DefaultValue.java:25,33).
DEFAULT_MAX_ITERATIONS: int = 5000

# Angle-unit conversions (Constant.java:29-53).
RHO_DEG2RAD = math.pi / 180.0
RHO_RAD2DEG = 180.0 / math.pi
RHO_GRAD2RAD = math.pi / 200.0
RHO_RAD2GRAD = 200.0 / math.pi
