# Port copy of clairs_to_tpu/config.py.
"""Global configuration constants for the PyTorch/CUDA ClairS-TO engine.

Behavioral parity with the reference's ``shared/param.py``; the engine's own
settings are in the section at the bottom.
"""

from itertools import accumulate

CALLER_NAME = "clairs_to_tpu"
VERSION = "0.1.0"
REFERENCE_VERSION = "0.4.4"  # upstream version we track for parity

# --- model-name aliases (shared/param.py:9-15) ---------------------------------
MODEL_NAME_PLATFORM_DICT = {
    "r1041_e82_400bps_sup_v420": "ont_r10_dorado_sup_5khz",
    "r1041_e82_400bps_sup_v410": "ont_r10_dorado_sup_4khz",
    "r1041_e82_400bps_hac_v410": "ont_r10_dorado_hac_4khz",
    "r1041_e82_400bps_sup_g615": "ont_r10_guppy_sup_4khz",
    "r1041_e82_400bps_hac_g657": "ont_r10_guppy_hac_5khz",
}

# --- pileup / candidate constants (shared/param.py:17-48) ----------------------
MIN_MQ = 20
ONT_MIN_BQ = 20
MIN_BQ = 0
MIN_COVERAGE = 4
SPLIT_BED_SIZE = 10000            # candidate shard size
SNV_MIN_AF = 0.05
INDEL_MIN_AF = 0.05
TENSOR_MAX_DEPTH = 168
CENTER_PADDING_DEPTH = 2
MIN_RESCALE_COV = 50              # depth-rescale threshold (predict.py:177-197)
SAMTOOLS_VIEW_FILTER_FLAG = 2316  # UNMAP|MUNMAP|SECONDARY|SUPPLEMENTARY
EXTEND_BP = 100
ALTERNATIVE_BASE_NUM = 3          # == min_tumor_support_read_num
MAX_DEPTH = TENSOR_MAX_DEPTH + CENTER_PADDING_DEPTH
MAX_TUMOR_DEPTH = 84
ONT_TENSOR_MAX_DEPTH = 128
ONT_MAX_DEPTH = ONT_TENSOR_MAX_DEPTH + CENTER_PADDING_DEPTH
ONT_MAX_TUMOR_DEPTH = 75

MIN_BQ_DICT = {
    "ont": 20,
    "ont_r10_dorado_sup_4khz": 20,
    "ont_r10_dorado_hac_4khz": 15,
    "ont_r10_dorado_sup_5khz": 20,
    "ont_r10_dorado_sup_5khz_ss": 20,
    "ont_r10_dorado_sup_5khz_ssrs": 20,
    "ont_r10_guppy_sup_4khz": 20,
    "ont_r10_guppy_hac_5khz": 15,
    "ont_r10_dorado_4khz": 20,
    "ont_r10_dorado_5khz": 20,
    "ont_r10_guppy": 20,
    "ont_r10_guppy_4khz": 20,
    "ont_r10_guppy_5khz": 15,
    "ilmn": 0,
    "ilmn_ss": 0,
    "ilmn_ssrs": 0,
    "hifi": 0,
    "hifi_ss": 0,
    "hifi_ssrs": 0,
    "hifi_revio": 0,
    "hifi_revio_ss": 0,
    "hifi_revio_ssrs": 0,
}

# qual cutoffs (shared/param.py:35-40)
MIN_THRED_QUAL = {"ont": 8, "ilmn": 4, "hifi": 8, "hifi_revio": 8}
MIN_PHASEABLE_THRED_QUAL = {"ont": 8, "ilmn": 4, "hifi": 8, "hifi_revio": 8}
MIN_UNPHASEABLE_THRED_QUAL = {"ont": 12, "ilmn": 6, "hifi": 12, "hifi_revio": 12}
MIN_THRED_QUAL_INDEL = {"ont": 8, "ilmn": 4, "hifi": 8, "hifi_revio": 8}
MIN_PHASEABLE_THRED_QUAL_INDEL = {"ont": 8, "ilmn": 4, "hifi": 8, "hifi_revio": 8}
MIN_UNPHASEABLE_THRED_QUAL_INDEL = {"ont": 12, "ilmn": 6, "hifi": 12, "hifi_revio": 12}

MATRIX_DEPTH_DICT = {"ont": ONT_MAX_DEPTH, "ilmn": MAX_DEPTH, "hifi": 130}
TUMOR_MATRIX_DEPTH_DICT = {"ont": ONT_MAX_TUMOR_DEPTH, "ilmn": MAX_TUMOR_DEPTH, "hifi": 64}
PHASE_TUMOR = {"ont": True, "ilmn": False, "hifi": True}
QUAL_DICT = {"ont": 8, "ilmn": 8, "hifi": 8}
AF_DICT = {"ont": 0.05, "ilmn": 0.05, "hifi": 0.05}

# --- pileup tensor channel layout (shared/param.py:50-53) ----------------------
PILEUP_CHANNELS = [
    "A", "C", "G", "T", "I", "I1", "D", "D1", "*",
    "a", "c", "g", "t", "i", "i1", "d", "d1", "#",
    "ALMQ", "CLMQ", "GLMQ", "TLMQ", "aLMQ", "cLMQ", "gLMQ", "tLMQ",
    "ALBQ", "CLBQ", "GLBQ", "TLBQ", "aLBQ", "cLBQ", "gLBQ", "tLBQ",
]
PILEUP_CHANNEL_SIZE = len(PILEUP_CHANNELS)          # 34
CHANNEL_INDEX = {c: i for i, c in enumerate(PILEUP_CHANNELS)}
PHASE_CHANNELS = [
    "AHP1", "CHP1", "GHP1", "THP1", "aHP1", "cHP1", "gHP1", "tHP1",
    "AHP2", "CHP2", "GHP2", "THP2", "aHP2", "cHP2", "gHP2", "tHP2",
]

FLANKING_BASE_NUM = 16
NO_OF_POSITIONS = 2 * FLANKING_BASE_NUM + 1         # 33

# low-MQ / low-BQ channel thresholds (create_tensor_pileup_calling.py:147-149)
LOW_MQ_THRESHOLD = 20
LOW_BQ_THRESHOLD = {"ont": 30, "ilmn": 10, "hifi": 10}

# --- inference (shared/param.py:85-101) ----------------------------------------
PREDICT_BATCH_SIZE = 250
TRAIN_BATCH_SIZE = 800
EXPAND_REFERENCE_REGION = 1000
MAX_INDEL_LENGTH = 60
CHUNK_SIZE = 5000000  # genome chunk size, run_clairs_to:907-908

# --- training hyperparameters (shared/param.py:69-97) --------------------------
INITIAL_LEARNING_RATE = 5e-4
L2_REGULARIZATION_LAMBDA = 1e-4
WEIGHT_DECAY = 1e-6
MAX_EPOCH = 30
GRAD_NORM_CLIP = 1.0
LABEL_SHAPE = [3]
LABEL_SHAPE_CUM = list(accumulate(LABEL_SHAPE))

# --- engine configuration -----------------------------------------------------
# Rows per padded device batch of the dual-network forward.  At 8192 the
# largest activation (gru2's input gates, 33 x 8192 x 576 fp32) is ~0.62 GB.
DEVICE_BATCH = 8192


def platform_family(platform: str) -> str:
    """Collapse a platform string to its family (run_clairs_to:1089-1096)."""
    if platform.startswith("ont"):
        return "ont"
    if platform.startswith("hifi"):
        return "hifi"
    if platform.startswith("ilmn"):
        return "ilmn"
    return platform


# Training-time coverage subsampling distribution (shared/param.py:98-115).
# The reference ships a discretized Beta CDF (`beta_acc_per`) gated by
# `use_beta_subsampling`; no shipped module consumes it (the training code is
# not in the release), so here we keep the equivalent knob as an analytic
# sampler instead of a 100-entry table: draw a coverage fraction from
# Beta(a, b) whose CDF matches the reference's discretization (the best fit
# a=2.08, b=5.08 reproduces the table to max |dCDF| = 2e-3).  bench/synth.py
# uses uniform depth
# ranges by default; pass `beta_subsample=True` to DualTrainer fit-data
# generation to enable this instead.
USE_BETA_SUBSAMPLING = True


def beta_subsample_fraction(rng, a: float = 2.08, b: float = 5.08) -> float:
    """Sample a coverage-subsampling fraction from the Beta(a,b) family the
    reference's `beta_acc_per` table discretizes (shared/param.py:104-115)."""
    return float(rng.beta(a, b))
