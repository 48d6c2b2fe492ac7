#!/usr/bin/env python3
"""``calibrate.py`` for the Illumina cell, whose faults are its own
(``benchlib/faults_ilmn.py``):

    python3 h100_bench/calibrate_ilmn.py --workload ilmn_flagship.genome_call \
        --seeds 1,2,3 --seconds 3 [--control] [--fault ilmn.realign_skipped]

The benchmark's runs never run this."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from h100_bench import calibrate  # noqa: E402
from h100_bench.benchlib import faults_ilmn  # noqa: E402

if __name__ == "__main__":
    calibrate.faults = faults_ilmn
    calibrate.main()
