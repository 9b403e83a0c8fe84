"""Typed parameter identifiers.

Mirrors the reference's ParameterType enum with its exact numeric ids
(`parameter/ParameterType.java:24-119`) for API parity — useful when
exchanging results with JAICOV-based tooling.
"""

from __future__ import annotations

import enum


class ParameterType(enum.IntEnum):
    # interior orientation
    PRINCIPAL_POINT_X = 111
    PRINCIPAL_POINT_Y = 112
    PRINCIPAL_DISTANCE = 113

    # radial-symmetric distortion coefficient A_i
    RADIAL_POLYNOMIAL_A = 121

    # tangential distortion
    TANGENTIAL_POLYNOMIAL_B = 131
    TANGENTIAL_DISTORTION_Bx = 132
    TANGENTIAL_DISTORTION_By = 133

    # affinity and shear
    AFFINITY_AND_SHEAR_Cx = 141
    AFFINITY_AND_SHEAR_Cy = 142

    # distance-dependent radial distortion coefficient D_i
    DISTANCE_POLYNOMIAL_D = 151

    # Zernike models
    ZERNIKE_POLYNOMIAL_X = 161
    ZERNIKE_POLYNOMIAL_Y = 162
    ZERNIKE_POLYNOMIAL_Z = 163

    # exterior orientation
    CAMERA_COORDINATE_X = 251
    CAMERA_COORDINATE_Y = 252
    CAMERA_COORDINATE_Z = 253
    CAMERA_OMEGA = 261
    CAMERA_PHI = 262
    CAMERA_KAPPA = 263

    # object point
    OBJECT_COORDINATE_X = 311
    OBJECT_COORDINATE_Y = 312
    OBJECT_COORDINATE_Z = 313

    # image observation
    IMAGE_COORDINATE_X = 411
    IMAGE_COORDINATE_Y = 412

    # scale bar
    SCALE_BAR_LENGTH = 511

    # DLT coefficients
    DIRECT_LINEAR_TRANSFORMATION_B11 = 611
    DIRECT_LINEAR_TRANSFORMATION_B12 = 612
    DIRECT_LINEAR_TRANSFORMATION_B13 = 613
    DIRECT_LINEAR_TRANSFORMATION_B14 = 614
    DIRECT_LINEAR_TRANSFORMATION_B21 = 621
    DIRECT_LINEAR_TRANSFORMATION_B22 = 622
    DIRECT_LINEAR_TRANSFORMATION_B23 = 623
    DIRECT_LINEAR_TRANSFORMATION_B24 = 624
    DIRECT_LINEAR_TRANSFORMATION_B31 = 631
    DIRECT_LINEAR_TRANSFORMATION_B32 = 632
    DIRECT_LINEAR_TRANSFORMATION_B33 = 633
