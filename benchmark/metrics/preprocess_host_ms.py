"""Mean host ms of `profile_scope("preprocess")` a scan over the window
(GlimTorch.insert_frame on the feeding thread)."""

from benchmark.readers import scope_mean_ms


def read(run):
    return scope_mean_ms(run, "preprocess")
