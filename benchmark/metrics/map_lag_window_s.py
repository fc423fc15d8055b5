"""Mean s over the window of the program's `map_lag/window` entry
(glim_tpu_torch/mapping/global_mapping_base.py `record_map_lag`), one of the
five stages of a submap's map lag, recorded as the first optimize that covers
the submap ends: the estimate made until the frame is marginalized out of the
smoother window."""

from benchmark.readers import scope_mean_ms


def read(run):
    ms = scope_mean_ms(run, "map_lag/window")
    return None if ms is None else ms / 1e3
