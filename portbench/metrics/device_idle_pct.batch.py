"""device_idle_pct: the share of the profiled stretch in which no device
operation ran."""

from portbench.harness.readings import idle_pct


def read(rec):
    return idle_pct(rec)
