# Port copy of clairs_to_tpu/verdict/pipeline.py.
"""Verdict orchestration: allele counts -> LogR/BAF -> [correction] ->
germline genotypes -> ASPCF -> ASCAT -> binomial tagging.

In-memory port of ClairS-TO src/cna_germline_tagging.py:56-199 (the
7-step sub-pipeline).  The reference runs on chr1-22,X against the G1000
loci resource; here loci can come from any source (the CLI uses the het
candidates from calling when no loci resource is given, which is the only
option without the downloadable CNA resource bundle).  GC/replication-timing
correction runs when track arrays are supplied.
"""

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from clairs_to_tpu_torch.verdict.allele_counter import allele_counts_at
from clairs_to_tpu_torch.verdict.aspcf import aspcf_segment
from clairs_to_tpu_torch.verdict.ascat import run_ascat, AscatResult
from clairs_to_tpu_torch.verdict.logr_baf import (
    correct_logr,
    logr_baf,
    predict_germline_genotypes,
)
from clairs_to_tpu_torch.verdict.tagging import tag_vcf_rows


@dataclass
class VerdictResult:
    purity: Optional[float]
    ploidy: Optional[float]
    segments: List[Tuple]          # (ctg, start1, end1, cn_major, cn_minor)
    n_tagged: int
    applied: bool
    reason: str = ""


def write_cna_outputs(out_dir, sample_name, ctg_order, chrom, pos, logr, baf,
                      hom, logr_seg, result):
    """Write the reference's cna_output/ file layout (SURVEY.md Appendix A):
    Tumor_LogR/BAF/GG/LogR_PCFed/Purity_Ploidy/CNA tab files."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    header = f"Chromosome\tPosition\t{sample_name}\n"

    def dump(name, values, fmt="{}"):
        with open(os.path.join(out_dir, f"{sample_name}_{name}.txt"), "w") as f:
            f.write(header)
            for ci, p, v in zip(chrom, pos, values):
                f.write(f"{ctg_order[int(ci)]}\t{int(p) + 1}\t" + fmt.format(v) + "\n")

    dump("Tumor_LogR", logr)
    dump("Tumor_BAF", baf)
    dump("Tumor_GG", ["True" if h else "False" for h in hom])
    if logr_seg is not None:
        dump("Tumor_LogR_PCFed", logr_seg)
    if result is not None and result.purity is not None:
        with open(os.path.join(out_dir, f"{sample_name}_Tumor_Purity_Ploidy.txt"), "w") as f:
            f.write("Purity\tPloidy\n")
            f.write(f"{result.purity}\t{result.ploidy}\n")
        with open(os.path.join(out_dir, f"{sample_name}_Tumor_CNA.txt"), "w") as f:
            f.write("\tchr\tstartpos\tendpos\tnMajor\tnMinor\n")
            for i, (ctg, s, e, na, nb) in enumerate(result.segments):
                f.write(f"{i + 1}\t{ctg}\t{s}\t{e}\t{na}\t{nb}\n")


def run_verdict(
    pileup_engines,       # {ctg: PileupEngine} over the loci regions
    loci,                 # {ctg: (positions0, ref_idx, alt_idx)} candidate het loci
    rows,                 # VCF row dicts to tag (PASS rows considered)
    gamma=1.0,
    penalty=1000,  # src/cna_germline_tagging.py:137 --penalty 1000
    gc_content=None,
    replication_timing=None,
    gc_lookup=None,        # {(ctg, pos0): row} — aligned internally to kept loci
    rt_lookup=None,
    counts_by_ctg=None,    # {ctg: (positions0, ref_counts, alt_counts)}:
                           # allele counts accumulated during the chunk loop
                           # (supersedes pileup_engines/loci)
    rng=None,
    cna_output_dir=None,
    sample_name="SAMPLE",
) -> VerdictResult:
    rng = rng or np.random.default_rng(0)
    all_logr, all_baf, all_chrom, all_pos = [], [], [], []
    ctg_order = sorted(
        counts_by_ctg.keys() if counts_by_ctg is not None else loci.keys()
    )
    for ci, ctg in enumerate(ctg_order):
        if counts_by_ctg is not None:
            # counts accumulated during the main chunk loop (the in-process
            # analog of the reference's per-contig alleleCounter pass,
            # src/cna_germline_tagging.py:56-69)
            positions, ref_counts, alt_counts = counts_by_ctg[ctg]
        else:
            positions, ref_idx, alt_idx = loci[ctg]
            counts = allele_counts_at(pileup_engines[ctg], positions)
            ref_counts = counts[np.arange(len(positions)), ref_idx]
            alt_counts = counts[np.arange(len(positions)), alt_idx]
        lr, baf, keep = logr_baf(ref_counts, alt_counts, rng=rng)
        kept_pos = np.asarray(positions)[keep]
        all_logr.append(lr)
        all_baf.append(baf)
        all_chrom.append(np.full(len(lr), ci))
        all_pos.append(kept_pos)
    if not all_logr or sum(len(x) for x in all_logr) < 12:
        return VerdictResult(None, None, [], 0, False, "too few usable loci")

    logr = np.concatenate(all_logr)
    baf = np.concatenate(all_baf)
    chrom = np.concatenate(all_chrom)
    pos = np.concatenate(all_pos)

    if gc_lookup is not None and rt_lookup is not None:
        # align track rows to the kept loci; drop loci without both tracks
        keys = [(ctg_order[int(c)], int(p)) for c, p in zip(chrom, pos)]
        have = np.array(
            [k in gc_lookup and k in rt_lookup for k in keys], dtype=bool
        )
        if have.sum() >= 12:
            logr, baf = logr[have], baf[have]
            chrom, pos = chrom[have], pos[have]
            gc_content = np.stack([gc_lookup[k] for k, h in zip(keys, have) if h])
            replication_timing = np.stack(
                [rt_lookup[k] for k, h in zip(keys, have) if h]
            )
    if gc_content is not None and replication_timing is not None:
        logr = correct_logr(logr, gc_content, replication_timing)

    hom = predict_germline_genotypes(baf, chrom)
    logr_seg, baf_seg, het_mask = aspcf_segment(logr, baf, hom, chrom, penalty=penalty)
    if logr_seg is None:
        if cna_output_dir:
            write_cna_outputs(cna_output_dir, sample_name, ctg_order, chrom,
                              pos, logr, baf, hom, None, None)
        return VerdictResult(None, None, [], 0, False, "no heterozygous loci")

    res: Optional[AscatResult] = run_ascat(logr_seg, baf_seg, het_mask, baf, gamma=gamma)
    if res is None:
        if cna_output_dir:
            write_cna_outputs(cna_output_dir, sample_name, ctg_order, chrom,
                              pos, logr, baf, hom, logr_seg, None)
        return VerdictResult(None, None, [], 0, False, "no ASCAT optimum")

    segments = []
    for (start, end, n_major, n_minor) in res.segments:
        ctg = ctg_order[int(chrom[start])]
        segments.append(
            (ctg, int(pos[start]) + 1, int(pos[end]) + 1, int(n_major), int(n_minor))
        )

    result_for_files = VerdictResult(
        purity=res.purity, ploidy=res.ploidy, segments=segments,
        n_tagged=0, applied=True,
    )
    if cna_output_dir:
        write_cna_outputs(cna_output_dir, sample_name, ctg_order, chrom, pos,
                          logr, baf, hom, logr_seg, result_for_files)
    n_tagged = tag_vcf_rows(rows, res.purity, segments)
    applied = res.purity <= 0.6
    return VerdictResult(
        purity=res.purity,
        ploidy=res.ploidy,
        segments=segments,
        n_tagged=n_tagged,
        applied=applied,
        reason="" if applied else "purity > 0.6",
    )
