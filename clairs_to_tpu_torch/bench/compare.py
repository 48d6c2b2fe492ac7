# Port copy of clairs_to_tpu/bench/compare.py.
"""som.py-semantics VCF comparison (P/R/F1).

Port of the essential logic in the reference's src/compare_vcf.py:60-430:
query/truth keyed by position (single contig) or (ctg,pos); TP requires
ref+alt match (and genotype unless skip_genotyping); mismatched pairs count
as FP and FN; metrics restricted to a high-confidence BED; integer-QUAL
sweep for the best-F1 cutoff (compare_vcf.py:64-80).
"""

from dataclasses import dataclass, field
from typing import Optional

from clairs_to_tpu_torch.genome.bed import bed_tree_from
from clairs_to_tpu_torch.vcf.reader import VcfReader


@dataclass
class CompareResult:
    tp: int = 0
    fp: int = 0
    fn: int = 0
    precision: float = 0.0
    recall: float = 0.0
    f1: float = 0.0
    best_cutoff: Optional[float] = None
    best_f1: Optional[float] = None
    tp_set: set = field(default_factory=set)
    fp_set: set = field(default_factory=set)
    fn_set: set = field(default_factory=set)


def _metrics(tp, fp, fn):
    precision = tp / (tp + fp) if (tp + fp) > 0 else 0.0
    recall = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    f1 = (
        2 * precision * recall / (precision + recall)
        if precision + recall > 0
        else 0.0
    )
    return round(precision, 4), round(recall, 4), round(f1, 4)


def best_cutoff(fp_qual, tp_qual, fn_count):
    """Integer-qual sweep (compare_vcf.py:64-80); returns rows sorted by F1."""
    quals = set(int(q) for q in list(fp_qual.values()) + list(tp_qual.values()) if q is not None)
    results = []
    for q in quals:
        fp_n = sum(1 for v in fp_qual.values() if v is not None and v >= q)
        tp_n = sum(1 for v in tp_qual.values() if v is not None and v >= q)
        fn_n = fn_count + len(tp_qual) - tp_n
        pre, rec, f1 = _metrics(tp_n, fp_n, fn_n)
        results.append((q, pre, rec, f1, tp_n, fp_n, fn_n))
    return sorted(results, key=lambda x: x[3], reverse=True)


def compare_vcf(
    truth_vcf_fn,
    input_vcf_fn,
    ctg_name=None,
    bed_fn=None,
    input_filter_tag="PASS",
    truth_filter_tag=None,
    skip_genotyping=True,
    benchmark_indel=False,
    ctg_start=None,
    ctg_end=None,
    qual_sweep=True,
    strat_bed_fns=None,
    min_af=None,
    min_alt_coverage=2,
    tumor_bam_fn=None,
    fasta=None,
    platform="ont",
) -> CompareResult:
    """som.py-style comparison.

    strat_bed_fns: list of stratification BEDs — both truth and query are
    restricted to their intersection (compare_vcf.py:104-109, 225-246).
    min_af (+ tumor_bam_fn + fasta): AF-aware FN exclusion — truth sites
    whose observed tumor support is below min_af / min_alt_coverage are
    removed from the FN pool (compare_vcf.py:146-172 + cal_af_distribution).
    """
    truth = VcfReader(
        truth_vcf_fn, ctg_name=ctg_name, ctg_start=ctg_start, ctg_end=ctg_end,
        show_ref=False, skip_genotype=skip_genotyping, filter_tag=truth_filter_tag,
    )
    truth.read_vcf()
    query = VcfReader(
        input_vcf_fn, ctg_name=ctg_name, ctg_start=ctg_start, ctg_end=ctg_end,
        show_ref=False, skip_genotype=skip_genotyping, filter_tag=input_filter_tag,
        discard_indel=not benchmark_indel,
    )
    query.read_vcf()

    bed = bed_tree_from(bed_fn, contig_name=ctg_name) if bed_fn else None
    strat_trees = [
        bed_tree_from(f, contig_name=ctg_name) for f in (strat_bed_fns or [])
    ]

    def in_bed(key):
        pos = key if not isinstance(key, tuple) else key[1]
        ctg = ctg_name if not isinstance(key, tuple) else key[0]
        if bed is not None and len(bed) and not bed.is_region_in(ctg, pos - 1, pos):
            return False
        for tree in strat_trees:
            if len(tree) and not tree.is_region_in(ctg, pos - 1, pos):
                return False
        return True

    truth_dict = {k: v for k, v in truth.variant_dict.items() if in_bed(k)}
    query_dict = {k: v for k, v in query.variant_dict.items() if in_bed(k)}

    if min_af is not None and tumor_bam_fn is not None and fasta is not None:
        from clairs_to_tpu_torch.bench.af_distribution import cal_af

        sites = []
        for k, v in truth_dict.items():
            ctg = v.ctg_name
            sites.append((ctg, v.pos, v.reference_bases, v.alternate_bases[0]))
        support = cal_af(tumor_bam_fn, fasta, sites, platform=platform)
        drop = set()
        for k, v in truth_dict.items():
            cov, alt_n = support.get((v.ctg_name, v.pos), (0, 0))
            if alt_n == 0 or cov == 0 or alt_n / cov < min_af or alt_n <= min_alt_coverage:
                drop.add(k)
        truth_dict = {k: v for k, v in truth_dict.items() if k not in drop}

    if benchmark_indel:
        query_dict = {
            k: v
            for k, v in query_dict.items()
            if not (len(v.reference_bases) == 1 and len(v.alternate_bases[0]) == 1)
        }
        truth_dict = {
            k: v
            for k, v in truth_dict.items()
            if not (len(v.reference_bases) == 1 and len(v.alternate_bases[0]) == 1)
        }

    res = CompareResult()
    fp_qual, tp_qual = {}, {}
    for key, v in query_dict.items():
        qual = None
        try:
            qual = float(v.qual) if v.qual is not None else None
        except (TypeError, ValueError):
            pass
        if key not in truth_dict:
            res.fp_set.add(key)
            fp_qual[key] = qual
            continue
        t = truth_dict[key]
        gt_match = skip_genotyping or (t.genotype == v.genotype)
        if (
            t.reference_bases == v.reference_bases
            and t.alternate_bases[0] == v.alternate_bases[0]
            and gt_match
        ):
            res.tp_set.add(key)
            tp_qual[key] = qual
        else:
            res.fp_set.add(key)
            res.fn_set.add(key)
            fp_qual[key] = qual

    for key in truth_dict:
        if key not in res.tp_set and key not in res.fn_set:
            res.fn_set.add(key)

    res.tp = len(res.tp_set)
    res.fp = len(res.fp_set)
    res.fn = len(res.fn_set)
    res.precision, res.recall, res.f1 = _metrics(res.tp, res.fp, res.fn)
    if qual_sweep and (fp_qual or tp_qual):
        sweep = best_cutoff(fp_qual, tp_qual, len(res.fn_set))
        if sweep:
            res.best_cutoff = sweep[0][0]
            res.best_f1 = sweep[0][3]
    return res


def format_report(res: CompareResult) -> str:
    lines = [
        "Type     Precision  Recall  F1-score  TP    FP    FN",
        f"SNV      {res.precision:<10.4f} {res.recall:<7.4f} {res.f1:<9.4f} {res.tp:<5d} {res.fp:<5d} {res.fn:<5d}",
    ]
    if res.best_cutoff is not None:
        lines.append(f"best-F1 qual cutoff: {res.best_cutoff} (F1={res.best_f1})")
    return "\n".join(lines)
