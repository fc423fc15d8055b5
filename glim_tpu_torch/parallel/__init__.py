"""Device-mesh sharding of the registration hot path (``sharded.py``)."""

from glim_tpu_torch.parallel.sharded import (make_mesh, sharded_vgicp_linearize,  # noqa: F401
                                             sharded_gicp_linearize, sharded_odometry_step,
                                             sharded_factor_linearize)
