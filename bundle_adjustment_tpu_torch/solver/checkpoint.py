"""Checkpoint / resume for the LM loop (port of
`bundle_adjustment_tpu/solver/checkpoint.py`).

The reference has no checkpointing (survey section 5); this wraps the
iteration state: (parameter blocks, damping, iteration index, omega,
centroid).  Format: a single .npz per checkpoint (portable, dependency-free,
the same files the JAX package writes); the state is copied to the host
when saved and loaded as host numpy arrays.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..models.problem import ParamState, _host


@dataclass
class LMCheckpoint:
    state: ParamState
    iteration: int
    adapted_damping: float
    omega: float
    max_abs_dx: float
    centroid: Optional[np.ndarray] = None

    def save(self, path: str) -> None:
        """Atomic write (tmp + rename)."""
        payload = {
            "points": _host(self.state.points),
            "io": _host(self.state.io),
            "dist": _host(self.state.dist),
            "eo": _host(self.state.eo),
            "iteration": np.asarray(self.iteration),
            "adapted_damping": np.asarray(self.adapted_damping),
            "omega": np.asarray(self.omega),
            "max_abs_dx": np.asarray(self.max_abs_dx),
        }
        if self.centroid is not None:
            payload["centroid"] = _host(self.centroid)
        d = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
        try:
            with os.fdopen(fd, "wb") as fh:
                np.savez(fh, **payload)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    @staticmethod
    def load(path: str) -> "LMCheckpoint":
        with np.load(path) as z:
            state = ParamState(points=z["points"], io=z["io"],
                               dist=z["dist"], eo=z["eo"])
            return LMCheckpoint(
                state=state,
                iteration=int(z["iteration"]),
                adapted_damping=float(z["adapted_damping"]),
                omega=float(z["omega"]),
                max_abs_dx=float(z["max_abs_dx"]),
                centroid=z["centroid"] if "centroid" in z.files else None,
            )
