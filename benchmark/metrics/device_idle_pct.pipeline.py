"""Share of the traced slice of a pipeline cell in which nothing ran on the card."""

from benchmark.readers import device_idle_pct


def read(run):
    return device_idle_pct(run)
