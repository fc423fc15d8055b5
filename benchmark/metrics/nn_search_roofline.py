"""nn_search (csrc/nn_search.cu) against its roofline over the traced slice:
the least time its calls need (benchmark/roofline.py, from each call's Q, N and
valid counts) over the device time of its kernels (pack, split search, merge)."""

from benchmark import roofline


def read(run):
    tr = run.get("trace")
    calls = run.get("nn_calls") or []
    if not tr or not calls:
        return None
    k = tr["kernels"]
    dev_s = sum(k[n][1] for n in roofline.NN_KERNELS if n in k)
    n_search = k.get("search_split_kernel", (0, 0.0))[0]
    if dev_s <= 0 or n_search == 0:
        return None
    bound_s = sum(roofline.nn_bound_s(*c) for c in calls)
    # Calls and kernel events are recorded separately: scale the bound to
    # the events when a call at the slice's edge fell on one side only.
    bound_s *= n_search / len(calls)
    return 100.0 * bound_s / dev_s
