# Port copy of clairs_to_tpu/vcf/reader.py.
"""VCF reading.

Behavioral model: ClairS-TO shared/vcf.py:185-363 (VcfReader) and
shared/utils.py:245-298 (Position).  Re-designed as a plain dataclass record +
a streaming parser; gzip handled in-process (no subprocess fan-out).
"""

import gzip
import os
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class VcfRecord:
    ctg_name: str
    pos: int
    ref_base: str
    alt_base: str
    genotype1: int = -1
    genotype2: int = -1
    qual: Optional[str] = None
    filter: Optional[str] = None
    af: Optional[float] = None
    row_str: Optional[str] = None
    extra_infos: str = ""

    @property
    def reference_bases(self):
        return self.ref_base

    @property
    def alternate_bases(self):
        return self.alt_base.split(",")

    @property
    def genotype(self):
        return [self.genotype1, self.genotype2]


def open_maybe_gzip(path, mode="rt"):
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, mode)
    return open(path, mode)


class VcfReader:
    """Reads a VCF into a dict keyed by pos (single contig) or (ctg, pos).

    Mirrors the filtering semantics of shared/vcf.py:185-353: contig/region
    filters, FILTER-tag selection, qual bounds, snv/indel discards, genotype
    normalisation (gt1<=gt2, '*'-allele cleanup), 0/0 skip unless show_ref.
    """

    def __init__(
        self,
        vcf_fn,
        ctg_name=None,
        ctg_start=None,
        ctg_end=None,
        show_ref=True,
        keep_row_str=False,
        skip_genotype=False,
        filter_tag=None,
        save_header=False,
        min_qual=None,
        max_qual=None,
        discard_snv=False,
        discard_indel=False,
        keep_af=False,
    ):
        self.vcf_fn = vcf_fn
        self.ctg_name = ctg_name
        self.ctg_start = ctg_start
        self.ctg_end = ctg_end
        self.show_ref = show_ref
        self.keep_row_str = keep_row_str
        self.skip_genotype = skip_genotype
        self.filter_tag = filter_tag
        self.save_header = save_header
        self.min_qual = min_qual
        self.max_qual = max_qual
        self.discard_snv = discard_snv
        self.discard_indel = discard_indel
        self.keep_af = keep_af
        self.header = ""
        self.variant_dict = {}
        if ctg_name is None:
            self._ctg_filter_set = None
            self._tuple_keys = True
        elif "," in ctg_name:
            self._ctg_filter_set = frozenset(x.strip() for x in ctg_name.split(",") if x.strip())
            self._tuple_keys = True
        else:
            self._ctg_filter_set = frozenset([ctg_name])
            self._tuple_keys = False

    def read_vcf(self):
        if self.vcf_fn is None or not os.path.exists(self.vcf_fn):
            return
        region_given = self.ctg_start is not None and self.ctg_end is not None
        filter_list = self.filter_tag.split(",") if self.filter_tag is not None else None
        header_last_column = []

        with open_maybe_gzip(self.vcf_fn) as fo:
            for row in fo:
                columns = row.strip().split()
                if not columns:
                    continue
                if columns[0][0] == "#":
                    if self.save_header:
                        self.header += row
                    header_last_column = columns
                    continue
                tumor_in_last = bool(header_last_column) and header_last_column[-1].rstrip().lower() == "tumor"
                chromosome, position = columns[0], columns[1]
                if self._ctg_filter_set is not None and chromosome not in self._ctg_filter_set:
                    continue
                if region_given and not (self.ctg_start <= int(position) <= self.ctg_end):
                    continue
                FILTER = columns[6] if len(columns) >= 7 else None
                if filter_list is not None and FILTER not in filter_list:
                    continue
                reference, alternate = columns[3], columns[4]
                if self.discard_snv and (len(reference) == 1 and len(alternate) == 1):
                    continue
                if self.discard_indel and (len(reference) > 1 or len(alternate) > 1):
                    continue
                try:
                    qual = columns[5] if len(columns) > 5 else None
                    if self.min_qual is not None and float(qual) < self.min_qual:
                        continue
                    if self.max_qual is not None and float(qual) > self.max_qual:
                        continue
                except (TypeError, ValueError):
                    qual = None

                last_column = columns[-1] if not tumor_in_last else columns[-2]
                genotype = last_column.split(":")[0].replace("/", "|").replace(".", "0").split("|")
                try:
                    genotype_1, genotype_2 = genotype
                    if int(genotype_1) > int(genotype_2):
                        genotype_1, genotype_2 = genotype_2, genotype_1
                    if "*" in alternate:
                        alt_list = alternate.split(",")
                        if int(genotype_1) + int(genotype_2) != 3 or len(alt_list) != 2:
                            continue
                        alternate = "".join(a for a in alt_list if a != "*")
                        genotype_1, genotype_2 = "0", "1"
                except ValueError:
                    genotype_1 = -1
                    genotype_2 = -1

                taf = None
                if self.keep_af and len(columns) >= 10:
                    tag_list = columns[8].split(":")
                    for tag in ("AF", "VAF"):
                        if tag in tag_list:
                            taf = float(columns[9].split(":")[tag_list.index(tag)])
                            break

                position = int(position)
                if (
                    genotype_1 == "0"
                    and genotype_2 == "0"
                    and not self.show_ref
                    and not self.skip_genotype
                ):
                    continue
                key = (chromosome, position) if self._tuple_keys else position
                self.variant_dict[key] = VcfRecord(
                    ctg_name=chromosome,
                    pos=position,
                    ref_base=reference,
                    alt_base=alternate,
                    genotype1=int(genotype_1),
                    genotype2=int(genotype_2),
                    qual=qual,
                    filter=FILTER,
                    af=taf,
                    row_str=row if self.keep_row_str else None,
                )
