"""Mean host ms of `profile_scope("odometry")` a scan over the window: the
odometry worker busy with one scan (its insert_frame, window_scan_step inside)."""

from benchmark.readers import scope_mean_ms


def read(run):
    return scope_mean_ms(run, "odometry")
