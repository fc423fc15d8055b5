"""Mean s over the window of the program's `map_lag/sub_mapping` entry
(glim_tpu_torch/mapping/global_mapping_base.py `record_map_lag`), one of the
five stages of a submap's map lag, recorded as the first optimize that covers
the submap ends: the frame marginalized until its submap leaves sub-mapping:
the pump, the queue, sub-mapping until the submap closes."""

from benchmark.readers import scope_mean_ms


def read(run):
    ms = scope_mean_ms(run, "map_lag/sub_mapping")
    return None if ms is None else ms / 1e3
