"""Mean host ms of `profile_scope("sub_mapping")` a frame over the window: the
sub-mapping worker busy with one marginalized frame."""

from benchmark.readers import scope_mean_ms


def read(run):
    return scope_mean_ms(run, "sub_mapping")
