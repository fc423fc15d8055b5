"""Per-point covariance estimation front-end.

Twin of ``glim_tpu/common/cloud_covariance_estimation.py`` (reference:
src/glim/common/cloud_covariance_estimation.cpp:24-226) with the PLANE /
NORMALIZED_MIN_EIG / FROBENIUS regularization modes, over
``ops/covariance.py``.
"""

from __future__ import annotations

from glim_tpu_torch.ops import covariance as cov_ops


class CloudCovarianceEstimation:
    PLANE = cov_ops.PLANE
    NORMALIZED_MIN_EIG = cov_ops.NORMALIZED_MIN_EIG
    FROBENIUS = cov_ops.FROBENIUS

    def __init__(self, regularization: str = cov_ops.PLANE):
        self.regularization = regularization

    def estimate(self, points, mask, neighbors):
        """Returns (covs (C, 3, 3), normals (C, 3)) on the points' device."""
        return cov_ops.estimate_covariances(points, mask, neighbors, self.regularization)
