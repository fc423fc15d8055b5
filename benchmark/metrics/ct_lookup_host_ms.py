"""Host ms a CT scan step spends in its model lookups over the window: the
total of the `profile_scope("ct/lookup")` spans (the nearest model point of
every scan point, `nn_search` on the card, 4 a step at lm_max_iterations 8)
over the number of `ct_scan_step` spans. Nothing to read in a program
without the spans."""


def read(run):
    scopes = run.get("scopes") or {}
    lookup, step = scopes.get("ct/lookup"), scopes.get("ct_scan_step")
    if not lookup or not step or lookup["n"] <= 0 or step["n"] <= 0:
        return None
    return 1e3 * float(lookup["total_s"]) / step["n"]
