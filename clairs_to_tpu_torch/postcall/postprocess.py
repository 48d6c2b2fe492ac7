# Port copy of clairs_to_tpu/postcall/postprocess.py.
"""Final VCF post-processing: qual/AF gating, GQ update, header rewrite.

Port of ClairS-TO src/postprocess_vcf.py:61-199 (merge_vcf +
mark_low_qual + update_GQ): PASS rows below the AF cutoff are dropped; PASS
rows below the platform qual cutoff (or the phaseable/unphaseable cutoffs
when INFO carries 'H' and the platform is not ilmn) become LowQual; non-PASS
rows are carried through with QUAL zeroed (except NonSomatic/RefCall); GQ is
set to the phred QUAL; the header is truncated after the TU FORMAT line and
rebuilt with contigs + ##cmdline.
"""

import os
from collections import defaultdict

from clairs_to_tpu_torch import config as cfg
from clairs_to_tpu_torch.vcf.sort import contig_sort_key
from clairs_to_tpu_torch.vcf.writer import VcfWriter
from clairs_to_tpu_torch.bamio.bam_writer import bgzf_compress

LAST_FORMAT_LINE = '##FORMAT=<ID=TU,Number=1,Type=Integer,Description="Count of T in the tumor BAM">'


def update_gq(columns):
    fmt = columns[8].split(":")
    vals = columns[9].split(":")
    gq_index = fmt.index("GQ")
    qual = float(columns[5])
    vals[gq_index] = str(int(qual)) if qual > 0.0 else str(int(float(vals[gq_index])))
    columns[9] = ":".join(vals)
    return columns


def mark_low_qual(row, platform, q_pass, q_phaseable, q_unphaseable):
    if row == "" or "RefCall" in row or "LowQual" in row:
        return row
    columns = row.split("\t")
    qual = float(columns[5])
    if q_pass and qual < float(q_pass):
        if "NonSomatic" in row:
            columns[6] = "LowQual;NonSomatic"
            columns[5] = "0.0000"
        else:
            columns[6] = "LowQual"
    if platform != "ilmn":
        phaseable = "H" in columns[7].split(";")
        if "PASS" in row and phaseable:
            if q_phaseable and qual < float(q_phaseable):
                columns[6] = "LowQual"
        if "PASS" in row and not phaseable:
            if q_unphaseable and qual < float(q_unphaseable):
                columns[6] = "LowQual"
    return "\t".join(columns)


def _truncate_header_after(header, delimiter):
    lines = header.split("\n")
    index = 0
    for i, line in enumerate(lines):
        if delimiter in line:
            index = i
            break
    return "\n".join(lines[: index + 1]) + "\n"


def postprocess_vcf(
    pileup_vcf_fn,
    output_fn,
    platform,
    ref_fn=None,
    sample_name="SAMPLE",
    qual=None,
    qual_cutoff_phaseable_region=None,
    qual_cutoff_unphaseable_region=None,
    af=None,
    cmdline=None,
    is_indel=False,
    compress_vcf=False,
):
    fam = cfg.platform_family(platform)
    qd = cfg.MIN_THRED_QUAL_INDEL if is_indel else cfg.MIN_THRED_QUAL
    pd = cfg.MIN_PHASEABLE_THRED_QUAL_INDEL if is_indel else cfg.MIN_PHASEABLE_THRED_QUAL
    ud = cfg.MIN_UNPHASEABLE_THRED_QUAL_INDEL if is_indel else cfg.MIN_UNPHASEABLE_THRED_QUAL
    q_pass = qual if qual is not None else qd[fam]
    q_ph = (
        qual_cutoff_phaseable_region
        if qual_cutoff_phaseable_region is not None
        else pd[fam]
    )
    q_un = (
        qual_cutoff_unphaseable_region
        if qual_cutoff_unphaseable_region is not None
        else ud[fam]
    )
    af_cut_off = af if af is not None else cfg.AF_DICT[fam]

    header = ""
    contig_dict = defaultdict(dict)
    nonpass_rows = {}
    af_filter_count = 0
    with open(pileup_vcf_fn) as f:
        for row in f:
            if row.startswith("#"):
                header += row
                continue
            columns = row.strip().split("\t")
            ctg, pos = columns[0], int(columns[1])
            if columns[6] != "PASS":
                nonpass_rows[(ctg, pos)] = row
                continue
            if af_cut_off is not None:
                tag_list = columns[8].split(":")
                af_idx = tag_list.index("AF") if "AF" in tag_list else tag_list.index("VAF")
                row_af = float(columns[9].split(":")[af_idx])
                if row_af < af_cut_off:
                    af_filter_count += 1
                    continue
            columns = update_gq(columns)
            contig_dict[ctg][pos] = "\t".join(columns) + "\n"

    for (ctg, pos), row in nonpass_rows.items():
        if pos in contig_dict.get(ctg, {}):
            continue
        columns = row.strip().split("\t")
        if columns[6] != "NonSomatic" and columns[6] != "RefCall":
            columns[5] = "0.0000"
        columns = update_gq(columns)
        contig_dict[ctg][pos] = "\t".join(columns) + "\n"

    out_header = _truncate_header_after(header, LAST_FORMAT_LINE) if header else None
    writer = VcfWriter(
        output_fn,
        ctg_name=",".join(contig_dict.keys()) if contig_dict else None,
        ref_fn=ref_fn,
        sample_name=sample_name,
        cmdline=cmdline,
        header=out_header,
        show_ref_calls=True,
    )
    for ctg in sorted(contig_dict.keys(), key=contig_sort_key):
        for pos in sorted(contig_dict[ctg].keys()):
            row = mark_low_qual(contig_dict[ctg][pos], fam, q_pass, q_ph, q_un)
            writer.vcf_writer.write(row)
    writer.close()

    if compress_vcf:
        from clairs_to_tpu_torch.vcf.tabix import write_tabix_vcf

        write_tabix_vcf(output_fn)  # .gz + .tbi alongside
    return {"af_filtered": af_filter_count}
