"""100 x the window's replays of the odometry's captured window step
(`profile_scope("window_graph/replay")`, glim_tpu_torch/odometry/window_graph.py)
over its window steps (`profile_scope("window_scan_step")`): the share of the
steps that ran from a CUDA graph rather than dispatched op by op. Nothing to
read where the program has no such span (the CPU, or a program without the
graph)."""


def read(run):
    scopes = run.get("scopes") or {}
    replay, step = scopes.get("window_graph/replay"), scopes.get("window_scan_step")
    if not replay or not step or replay["n"] <= 0 or step["n"] <= 0:
        return None
    return 100.0 * replay["n"] / step["n"]
