"""Kernel events in the traced slice over the scans whose estimates it emitted."""


def read(run):
    tr = run.get("trace")
    if not tr or not tr.get("scans") or not tr["n_kernels"]:
        return None
    return tr["n_kernels"] / tr["scans"]
