"""Estimable parameter state of a bundle-adjustment problem."""

from __future__ import annotations

from typing import NamedTuple

import torch


class ParamState(NamedTuple):
    """All estimable values, block-structured (tensors on one device)."""

    points: torch.Tensor  # [P, 3]
    io: torch.Tensor      # [C, 3] (x0, y0, c)
    dist: torch.Tensor    # [C, K] spec slot order
    eo: torch.Tensor      # [M, 6] (X0, Y0, Z0, omega, phi, kappa)
