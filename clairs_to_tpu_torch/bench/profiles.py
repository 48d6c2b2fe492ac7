# Port copy of clairs_to_tpu/bench/profiles.py.
"""Per-platform-family simulation profiles for held-out evaluation.

Read shape (length / per-base error / coverage) follows the reference demo
datasets (reference docs/*_quick_demo.md headers: ONT Q20+ ~70x, Illumina
~50x 150 bp, PacBio Revio HiFi ~60x).  The ``eval_profile`` sub-dict adds
error STRUCTURE (homopolymer context, strand asymmetry, quality decay,
bursts — bamio/simulate.py::_apply_eval_errors) that the training tensor
synthesizer (bench/synth.py) does not model, so evaluation is decoupled
from the training noise process and measures generalization, not
memorization.  All numbers derived from these sims are simulation-local,
NOT comparable to the reference's HCC1395 tables.
"""

PROFILES = {
    "ont": dict(read_length=500, error_rate=0.002, coverage=65,
                eval_profile=dict(hp_error_mult=4.0, strand_err_mult=1.6,
                                  qual_decay=6.0, burst_rate=0.08,
                                  burst_len=40, burst_qual=8)),
    "ilmn": dict(read_length=150, error_rate=0.001, coverage=50,
                 eval_profile=dict(hp_error_mult=1.5, strand_err_mult=2.0,
                                   qual_decay=10.0, burst_rate=0.02,
                                   burst_len=20, burst_qual=6)),
    "hifi": dict(read_length=1500, error_rate=0.001, coverage=60,
                 eval_profile=dict(hp_error_mult=3.0, strand_err_mult=1.2,
                                   qual_decay=2.0, burst_rate=0.03,
                                   burst_len=60, burst_qual=10)),
}
