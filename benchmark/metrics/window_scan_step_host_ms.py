"""Mean host ms of `profile_scope("window_scan_step")` over the window: the
odometry's window step (matching, linearization, GN) as the host dispatches it,
inside the `odometry` span."""

from benchmark.readers import scope_mean_ms


def read(run):
    return scope_mean_ms(run, "window_scan_step")
