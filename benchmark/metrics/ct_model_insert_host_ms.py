"""Mean host ms of `profile_scope("ct/model_insert")` over the window: the CT
odometry's update of its bounded point model (`pointmap_insert`: sub-voxel
dedup, LRU expiry, the newest 65,536 kept) inside the scan step. Nothing to
read in a program without the span."""

from benchmark.readers import scope_mean_ms


def read(run):
    return scope_mean_ms(run, "ct/model_insert")
