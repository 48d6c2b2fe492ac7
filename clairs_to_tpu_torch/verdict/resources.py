# Port copy of clairs_to_tpu/verdict/resources.py.
"""CNA resource-bundle loader (the reference's clairs-to_cna_data layout).

The reference's Verdict consumes a downloadable resource directory
(run_clairs_to:988-1005, src/cna_germline_tagging.py:56-108):

  loci_files/G1000_loci_hg38_<chr>.txt      alleleCounter -l input
  allele_files/G1000_alleles_hg38_<chr>.txt header + "pos\tref\talt" rows,
                                            alleles coded 1-4 = ACGT
                                            (src/verdict/get_logr_and_baf.py:15-38)
  GC_G1000_hg38.txt                         header + "idx\tchr\tpos\tgc..." rows
  RT_G1000_hg38.txt                         same layout, replication timing
                                            (src/verdict/correct_logr.py:33-52)

When present these define the germline-SNP loci (instead of het-like calls
from the VCF) and enable the GC/replication-timing LogR correction.
"""

import os

import numpy as np

_ALLELE_CODE = {"1": 0, "2": 1, "3": 2, "4": 3}


def load_allele_loci(resource_dir, contigs):
    """{ctg: (positions0 int64, ref_idx, alt_idx)} from allele_files/."""
    out = {}
    for ctg in contigs:
        path = os.path.join(
            resource_dir, "allele_files", f"G1000_alleles_hg38_{ctg}.txt"
        )
        if not os.path.exists(path):
            continue
        pos, ref_idx, alt_idx = [], [], []
        with open(path) as f:
            for i, line in enumerate(f):
                if i == 0:
                    continue
                cols = line.strip().split("\t")
                if len(cols) < 3 or cols[1] not in _ALLELE_CODE \
                        or cols[2] not in _ALLELE_CODE:
                    continue
                pos.append(int(cols[0]) - 1)  # file is 1-based
                ref_idx.append(_ALLELE_CODE[cols[1]])
                alt_idx.append(_ALLELE_CODE[cols[2]])
        if pos:
            out[ctg] = (
                np.asarray(pos, np.int64),
                np.asarray(ref_idx, np.int64),
                np.asarray(alt_idx, np.int64),
            )
    return out


def _load_track(path):
    """{(ctg, pos0): float row} from a GC/RT track file."""
    if not os.path.exists(path):
        return None
    track = {}
    with open(path) as f:
        for i, line in enumerate(f):
            if i == 0:
                continue
            cols = line.strip().split("\t")
            if len(cols) < 4:
                continue
            ctg = cols[1] if cols[1].startswith("chr") else "chr" + cols[1]
            try:
                key = (ctg, int(cols[2]) - 1)
                track[key] = np.asarray(cols[3:], np.float64)
            except ValueError:
                continue
    return track or None


def load_cna_resources(resource_dir, contigs):
    """Returns (loci, gc_lookup, rt_lookup); empty/None pieces when absent."""
    loci = load_allele_loci(resource_dir, contigs)
    gc = _load_track(os.path.join(resource_dir, "GC_G1000_hg38.txt"))
    rt = _load_track(os.path.join(resource_dir, "RT_G1000_hg38.txt"))
    return loci, gc, rt
