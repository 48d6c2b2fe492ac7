# Port copy of clairs_to_tpu/postcall/addback.py.
"""Genotyping add-back: re-insert requested sites missing from the output.

Port of ClairS-TO src/add_back_missing_variants_in_genotyping.py
(-G/-H modes): any site requested via the genotyping/hybrid VCF that did not
make it into the final VCF (window bounds, zero coverage, ...) is appended
as a 0/0 reference row so downstream consumers see every requested site.
"""

from clairs_to_tpu_torch.vcf.reader import VcfReader
from clairs_to_tpu_torch.vcf.sort import contig_sort_key


def add_back_missing(output_vcf, genotyping_vcf, fasta, sample_name="SAMPLE"):
    """Append 0/0 rows for requested sites absent from output_vcf (in place).

    Returns the number of rows added."""
    req = VcfReader(genotyping_vcf, show_ref=True, skip_genotype=True)
    req.read_vcf()

    present = set()
    header = []
    body = []
    with open(output_vcf) as f:
        for line in f:
            if line.startswith("#"):
                header.append(line)
                continue
            cols = line.split("\t", 2)
            present.add((cols[0], int(cols[1])))
            body.append(line)

    added = 0
    for key, rec in req.variant_dict.items():
        ctg, pos = (rec.ctg_name, rec.pos)
        if (ctg, pos) in present:
            continue
        ref_base = rec.ref_base
        if fasta is not None and ctg in fasta.index:
            fetched = fasta.fetch(ctg, pos - 1, pos)
            if fetched:
                ref_base = fetched
        body.append(
            f"{ctg}\t{pos}\t.\t{ref_base}\t{rec.alt_base}\t0.0000\tRefCall\t.\t"
            f"GT:GQ:DP:AF\t0/0:0:0:0.0000\n"
        )
        added += 1

    if added:
        rows = []
        for line in body:
            cols = line.split("\t", 2)
            rows.append((cols[0], int(cols[1]), line))
        rows.sort(key=lambda r: (contig_sort_key(r[0]), r[1]))
        with open(output_vcf, "w") as f:
            f.writelines(header)
            for _, _, line in rows:
                f.write(line)
    return added
