from h100_bench.benchlib.metrics_common import idle_pct as read  # noqa: F401
