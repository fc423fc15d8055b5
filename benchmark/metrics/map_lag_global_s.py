"""Mean s over the window of the program's `map_lag/global` entry
(glim_tpu_torch/mapping/global_mapping_base.py `record_map_lag`), one of the
five stages of a submap's map lag, recorded as the first optimize that covers
the submap ends: the submap leaving sub-mapping until global mapping's insert
of it ends (before an optimize the insert runs): the wait for
`GlimTorch._pump`, the global queue, the insert."""

from benchmark.readers import scope_mean_ms


def read(run):
    ms = scope_mean_ms(run, "map_lag/global")
    return None if ms is None else ms / 1e3
