"""100 x the replays of the CT odometry's captured scan step
(`profile_scope("ct_graph/replay")`, glim_tpu_torch/odometry/ct_graph.py)
over its scan steps (`profile_scope("ct_scan_step")`) in the window: the
share of the steps that ran from a CUDA graph rather than dispatched op by
op. Nothing to read where the program has no such span (the CPU, or a
program without the graph)."""


def read(run):
    scopes = run.get("scopes") or {}
    replay, step = scopes.get("ct_graph/replay"), scopes.get("ct_scan_step")
    if not replay or not step or replay["n"] <= 0 or step["n"] <= 0:
        return None
    return 100.0 * replay["n"] / step["n"]
