"""Mean host ms of `profile_scope("global/optimize")` over the window: one
global optimize (global_gn and its correspondence refreshes), pipeline cells."""

from benchmark.readers import scope_mean_ms


def read(run):
    return scope_mean_ms(run, "global/optimize")
