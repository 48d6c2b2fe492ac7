"""Seconds of the stages after device inference that ``run`` times
(``RunMetricsSummary``: ``hard_filters``, which holds the phaser and the
haplotype filter, ``verdict_counts``, ``merge``, ``pon_tagging``,
``verdict``, ``tabix``), summed over the window's runs, per 1,000
candidates."""

from h100_bench.benchlib.metrics_common import POSTCALL, s_per_kcand


def read(ctx):
    return s_per_kcand(ctx, POSTCALL)
