# Port copy of clairs_to_tpu/infer/calling.py.
"""Posterior probabilities → VCF rows.

Faithful behavioral port of the decision logic in
ClairS-TO clairs/call_variants.py:111-618 (alt-info decoding, alt
ranking, SNV alt-consistency downgrade, indel REF/ALT construction including
the '#'-anchored insertion edge case, genotype/AF/AD assembly), operating on
the vectorized posterior from infer/engine.py.  The per-row work here is
string handling only — all numeric heavy lifting already happened on device.
"""

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from clairs_to_tpu_torch.ops.posterior import quality_score_np

ACGT = "ACGT"


@dataclass
class CandidateRecord:
    chrom: str
    pos: int
    ref_base: str       # single uppercase base at the candidate position
    alt_info: str       # "<depth>-<k1 c1 k2 c2 ...>-" grammar


def decode_alt_info(alt_info: str):
    """call_variants.py:135-148: parse the alt_info string.

    Returns (ordered dict key->count, read_depth)."""
    parts = alt_info.rstrip().split("-")
    read_depth = int(parts[0])
    indel_str = parts[1] if len(parts) > 1 else ""
    seqs = indel_str.split(" ")
    alt_dict = {}
    for k, v in zip(seqs[::2], seqs[1::2]):
        if k:
            alt_dict[k] = int(v)
    if read_depth == 0 and len(alt_dict) == 1:
        for k, v in alt_dict.items():
            if k[0] in "DI":
                read_depth = int(v)
    return alt_dict, read_depth


def rank_variant_alt(alt_dict, read_depth):
    """call_variants.py:306-324: alts ranked by AF descending (stable)."""
    support = {}
    for alt, count in alt_dict.items():
        if alt[0] == "R":
            continue
        af = count / float(read_depth)
        if af > 0:
            support[alt] = af
    if not support:
        return "", 0
    ranked = sorted(support.items(), key=lambda x: x[1], reverse=True)
    alts = [k for k, _ in ranked]
    counts = [alt_dict[k] for k in alts]
    return alts, counts


def summarize_alt_types(alt_dict):
    """call_variants.py:382-399: split counts into SNP/INS/DEL + ref."""
    ref_num = snp_num = ins_num = del_num = 0
    for alt_type, count in alt_dict.items():
        count = int(count)
        if alt_type[0] == "X":
            snp_num += count
        elif alt_type[0] == "I":
            ins_num += count
        elif alt_type[0] == "D":
            del_num += count
        elif alt_type[0] == "R":
            ref_num = count
    return ref_num, snp_num, ins_num, del_num


def call_from_posterior(
    record: CandidateRecord,
    posterior: np.ndarray,        # (n_alleles,) float64
    forward_acgt,                 # (4,) ints FAU..FTU
    reverse_acgt,                 # (4,) ints RAU..RTU
    mode: str = "snv",
    show_ref: bool = False,
    qual_cutoff: Optional[float] = 0,
    best_idx: Optional[int] = None,
    best_p: Optional[float] = None,
    quality: Optional[float] = None,
):
    """Decide the call for one candidate; returns a VcfWriter row dict or None.

    mode='snv' corresponds to the reference's disable_indel_calling=True run
    (call_variants.py:167-224); mode='indel' to the 6-allele run (:226-304).

    best_idx/best_p/quality: batch-vectorized argmax/max/QUAL precomputed by
    the caller (identical values to the per-row computation — same argmax
    tie order, same quality_score_np rounding); left None they are derived
    here.
    """
    alt_dict, read_depth = decode_alt_info(record.alt_info)
    reference_base = record.ref_base
    alternate_base = reference_base

    if best_idx is None:
        best_idx = int(np.argmax(posterior))
        best_p = float(np.max(posterior))

    if mode == "snv":
        is_variant = ACGT[best_idx] != reference_base
    else:
        is_variant = best_idx >= 4  # I or D
    is_reference = not is_variant

    tumor_supported_reads_count = 0
    if is_variant:
        if read_depth <= 0:
            return None
        alts, counts = rank_variant_alt(alt_dict, read_depth)
        if alts == "":
            return None
        best_match_alt = alts[0]
        tumor_supported_reads_count = counts[0]
        alternate_base_list = [a[1] for a in alts if a[0] == "X"]
        if best_match_alt == "":
            return None
        if best_match_alt[0] == "X":
            alternate_base = best_match_alt[1]
            if mode == "snv":
                # call_variants.py:350-358: the argmax allele must be among
                # the observed alt bases, else downgrade to reference call
                if ACGT[best_idx] not in alternate_base_list:
                    is_variant = False
                    is_reference = True
        elif best_match_alt[0] == "I":
            # call_variants.py:359-361 incl. the '#' anchor edge case (v0.4.1)
            alternate_base = (
                best_match_alt[1:]
                if best_match_alt[1] != "#"
                else reference_base + best_match_alt[2:]
            )
        elif best_match_alt[0] == "D":
            alternate_base = reference_base
            reference_base = reference_base + best_match_alt[2:]

    # output gating (call_variants.py:367-380)
    if (not show_ref and is_reference) or (
        not is_reference and reference_base == alternate_base
    ):
        return None
    if reference_base is None or alternate_base is None:
        return None
    if (len(reference_base) > 1 or len(alternate_base) > 1) and mode == "snv":
        return None
    if mode == "indel":
        if len(reference_base) == 1 and len(alternate_base) == 1 and not show_ref:
            return None

    ref_num, _, _, _ = summarize_alt_types(alt_dict)

    if is_reference:
        tumor_supported_reads_count = ref_num
        alternate_base = "."

    af = min(
        (tumor_supported_reads_count / read_depth) if read_depth != 0 else 0.0, 1.0
    )
    if is_reference:
        genotype = "0/0"
    else:
        genotype = "0/1" if af < 1.0 else "1/1"

    # quality (call_variants.py:417-586: every reachable branch scores the
    # argmax posterior)
    quality_score = float(quality_score_np(best_p)) if quality is None \
        else quality
    if is_reference:
        filtration = "RefCall"
    elif qual_cutoff is None or quality_score >= float(qual_cutoff):
        filtration = "PASS"
    else:
        filtration = "LowQual"

    fau, fcu, fgu, ftu = (int(x) for x in forward_acgt)
    rau, rcu, rgu, rtu = (int(x) for x in reverse_acgt)
    info = "FAU={};FCU={};FGU={};FTU={};RAU={};RCU={};RGU={};RTU={}".format(
        fau, fcu, fgu, ftu, rau, rcu, rgu, rtu
    )
    ad = (
        str(tumor_supported_reads_count)
        if is_reference
        else str(ref_num) + "," + str(tumor_supported_reads_count)
    )

    return dict(
        CHROM=record.chrom,
        POS=record.pos,
        REF=reference_base,
        ALT=alternate_base,
        QUAL=quality_score,
        FILTER=filtration,
        INFO=info,
        GT=genotype,
        DP=read_depth,
        AF=af,
        AD=ad,
        AU=fau + rau,
        CU=fcu + rcu,
        GU=fgu + rgu,
        TU=ftu + rtu,
    )


def emit_calls(
    records: List[CandidateRecord],
    batch_result,
    vcf_writer,
    mode: str = "snv",
    show_ref: bool = False,
    qual_cutoff: Optional[float] = 0,
):
    """Write VCF rows for a batch of candidates; returns #rows written."""
    written = 0
    for i, rec in enumerate(records):
        row = call_from_posterior(
            rec,
            batch_result.posterior[i],
            batch_result.forward_acgt[i],
            batch_result.reverse_acgt[i],
            mode=mode,
            show_ref=show_ref,
            qual_cutoff=qual_cutoff,
        )
        if row is not None:
            vcf_writer.write_row(**row)
            written += 1
    return written
