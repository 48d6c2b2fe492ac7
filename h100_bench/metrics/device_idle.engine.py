"""Share of the traced window in which no operation ran on the device."""

from h100_bench.benchlib.metrics_common import idle_pct as read  # noqa: F401
