"""Mean host ms of `profile_scope("ct_scan_step")` over the window: the CT
odometry's scan step (four model lookups, eight damped Gauss-Newton solves,
the model update) as the host dispatches it, inside the `odometry` span
(glim_tpu_torch/odometry/odometry_estimation_ct.py). Nothing to read in a
program without the span."""

from benchmark.readers import scope_mean_ms


def read(run):
    return scope_mean_ms(run, "ct_scan_step")
