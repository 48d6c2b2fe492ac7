from clairs_to_tpu_torch.models import bigru, cvt


def mode_configs(mode):
    """The flagship ``(CvTConfig, BiGRUConfig)`` of a variant type, "snv" or
    "indel"."""
    if mode == "snv":
        return cvt.SNV_CVT_CONFIG, bigru.SNV_BIGRU_CONFIG
    if mode == "indel":
        return cvt.INDEL_CVT_CONFIG, bigru.INDEL_BIGRU_CONFIG
    raise ValueError(f"mode must be snv or indel, not {mode!r}")
