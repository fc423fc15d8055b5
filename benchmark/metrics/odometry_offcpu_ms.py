"""Mean ms a scan, over the window, that the odometry worker spent inside
`profile_scope("odometry")` off its CPU: the span's wall time less its
thread CPU time (waiting for the GIL, a lock or the scheduler)."""


def read(run):
    s = (run.get("scopes") or {}).get("odometry")
    return float(s["offcpu_ms"]) if s and s["n"] > 0 and "offcpu_ms" in s else None
