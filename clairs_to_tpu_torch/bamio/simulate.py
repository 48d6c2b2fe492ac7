# Port copy of clairs_to_tpu/bamio/simulate.py.
"""Synthetic tumor-BAM simulation for tests, demos, and benchmarks.

The reference's acceptance harness downloads HCC1395 chr17 data (demo/*.sh);
this environment has no network, so the framework ships a read simulator:
a random genome, somatic SNVs/indels spiked at chosen AFs, germline
heterozygous SNPs, and error-bearing reads — written as spec-conformant
BAM + FASTA + truth VCF.  Covers the same role as
src/gen_contaminated_bam.py (purity series via ``tumor_purity``).
"""

import numpy as np

from clairs_to_tpu_torch.bamio import bam_writer
from clairs_to_tpu_torch.genome.fasta import write_fasta

BASES = "ACGT"


def random_genome(rng, length, gc=0.41):
    p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    return "".join(rng.choice(list(BASES), size=length, p=p))


class Variant:
    def __init__(self, pos, ref, alt, af, kind, germline=False):
        self.pos = pos      # 0-based
        self.ref = ref
        self.alt = alt
        self.af = af
        self.kind = kind    # 'snv' | 'ins' | 'del'
        self.germline = germline


def plan_variants(rng, genome, n_snv=20, n_indel=0, n_germline=10,
                  af_choices=(0.1, 0.2, 0.3, 0.5), margin=200, min_gap=50):
    """Place non-overlapping variants away from contig ends."""
    L = len(genome)
    taken = []
    out = []

    def place():
        for _ in range(1000):
            p = int(rng.integers(margin, L - margin))
            if all(abs(p - t) >= min_gap for t in taken):
                taken.append(p)
                return p
        raise RuntimeError("genome too small for requested variants")

    for _ in range(n_snv):
        p = place()
        ref = genome[p]
        alt = rng.choice([b for b in BASES if b != ref])
        out.append(Variant(p, ref, alt, float(rng.choice(af_choices)), "snv"))
    for i in range(n_indel):
        p = place()
        if i % 2 == 0:
            ins = "".join(rng.choice(list(BASES), size=int(rng.integers(1, 4))))
            out.append(
                Variant(p, genome[p], genome[p] + ins, float(rng.choice(af_choices)), "ins")
            )
        else:
            dl = int(rng.integers(1, 4))
            out.append(
                Variant(p, genome[p : p + dl + 1], genome[p], float(rng.choice(af_choices)), "del")
            )
    for _ in range(n_germline):
        p = place()
        ref = genome[p]
        alt = rng.choice([b for b in BASES if b != ref])
        out.append(Variant(p, ref, alt, 0.5, "snv", germline=True))
    out.sort(key=lambda v: v.pos)
    return out


def simulate_reads(
    rng,
    genome,
    variants,
    coverage=60,
    read_length=500,
    error_rate=0.002,
    base_qual=30,
    mapq=60,
    tumor_purity=1.0,
    paired=False,
    lowbq_rate=0.0,
    lowbq_qual=10,
    lowbq_error_mult=10.0,
    somatic_hap_aware=False,
    eval_profile=None,
    hap_in_name=False,
):
    """Generate (name, flag, pos, cigar, seq, qual) tuples, sorted by pos.

    ``lowbq_rate`` > 0 marks that fraction of bases as low-quality
    (``lowbq_qual``, error rate x ``lowbq_error_mult``) — exercises the
    AFF/NEG dual-BQ view asymmetry (run_clairs_to:1237 vs :1264): the AFF
    tensor drops these bases, the NEG tensor sees them.

    ``somatic_hap_aware`` places each somatic variant on ONE haplotype (as
    real somatic mutations are): only reads of that haplotype can carry it,
    with per-read probability min(2*af, 1) — the marginal AF is preserved
    for af <= 0.5 and caps at 0.5 above that (a hap-restricted variant
    cannot exceed the haplotype's read share).  Off by default (legacy
    behavior: per-read iid at ``af``); required for the long-read haplotype
    verdicts (MultiHap, NoAncestry — reference
    src/haplotype_filtering.py:375-468) to see realistic co-segregation.

    ``eval_profile`` (dict or None) switches on a richer, evaluation-grade
    error process that the training tensor synthesizer (bench/synth.py)
    deliberately does NOT model — keeping held-out evaluation decoupled
    from the training distribution:
      hp_error_mult:   substitution-error multiplier inside homopolymer
                       runs >= 3 bp (ONT-like context dependence)
      strand_err_mult: error multiplier applied to reverse-strand reads
                       only (strand-asymmetric artifacts)
      qual_decay:      linear base-quality decline toward the read 3' end
      burst_rate/burst_len/burst_qual/burst_err_mult:
                       per-read chance of a low-quality, high-error segment
    """
    L = len(genome)
    n_reads = int(L * coverage / read_length)
    var_by_pos = {v.pos: v for v in variants}
    som_hap = {}
    if somatic_hap_aware:
        for v in variants:
            if not v.germline:
                som_hap[v.pos] = int(rng.integers(0, 2))
    reads = []
    for ridx in range(n_reads):
        start = int(rng.integers(0, max(L - read_length, 1)))
        end = min(start + read_length, L)
        is_tumor_read = rng.random() < tumor_purity
        # decide per-variant inclusion for this read (germline applies to all)
        frag = []
        cigar = []
        p = start
        # haplotype for germline phasing: 0 or 1
        hap = int(rng.integers(0, 2))
        while p < end:
            v = var_by_pos.get(p)
            take = False
            if v is not None:
                if v.germline:
                    take = hap == 0  # het on hap0
                elif is_tumor_read:
                    if somatic_hap_aware:
                        take = (hap == som_hap[v.pos]
                                and rng.random() < min(2.0 * v.af, 1.0))
                    else:
                        take = rng.random() < v.af
            if v is None or not take:
                frag.append(genome[p])
                _extend_cigar(cigar, "M", 1)
                p += 1
            elif v.kind == "snv":
                frag.append(v.alt)
                _extend_cigar(cigar, "M", 1)
                p += 1
            elif v.kind == "ins":
                frag.append(v.alt)  # anchor + inserted seq
                _extend_cigar(cigar, "M", 1)
                _extend_cigar(cigar, "I", len(v.alt) - 1)
                p += 1
            else:  # del
                frag.append(v.alt)  # anchor base
                _extend_cigar(cigar, "M", 1)
                _extend_cigar(cigar, "D", len(v.ref) - 1)
                p += len(v.ref)
        seq = list("".join(frag))
        qual = [base_qual] * len(seq)
        if lowbq_rate > 0:
            low_mask = rng.random(len(seq)) < lowbq_rate
            for i in np.nonzero(low_mask)[0]:
                qual[int(i)] = lowbq_qual
                if rng.random() < error_rate * lowbq_error_mult:
                    seq[int(i)] = rng.choice([b for b in BASES if b != seq[int(i)]])
        flag = 16 if rng.random() < 0.5 else 0
        if eval_profile is None:
            # sequencing errors (legacy iid-uniform process)
            n_err = rng.binomial(len(seq), error_rate)
            for _ in range(n_err):
                i = int(rng.integers(0, len(seq)))
                seq[i] = rng.choice([b for b in BASES if b != seq[i]])
        else:
            _apply_eval_errors(rng, seq, qual, error_rate, flag, eval_profile)
        seq = "".join(seq)
        name = f"read{ridx:06d}_h{hap}" if hap_in_name else f"read{ridx:06d}"
        reads.append((name, flag, start, cigar, seq, qual))
    reads.sort(key=lambda r: r[2])
    return reads


def _apply_eval_errors(rng, seq, qual, error_rate, flag, profile):
    """Evaluation-grade error process (see simulate_reads docstring).

    Mutates seq (list of chars) and qual (list of ints) in place.  Errors
    are context-dependent (homopolymers), strand-asymmetric, and bursty —
    structure the training synthesizer does not model, so models cannot
    score well here by memorizing the training noise process."""
    L = len(seq)
    if L == 0:
        return
    err = np.full(L, error_rate)
    if flag & 16:
        err *= profile.get("strand_err_mult", 1.0)
    hp_mult = profile.get("hp_error_mult", 1.0)
    if hp_mult != 1.0:
        run = 1
        for i in range(1, L + 1):
            if i < L and seq[i] == seq[i - 1]:
                run += 1
                continue
            if run >= 3:
                err[i - run : i] *= hp_mult
            run = 1
    decay = profile.get("qual_decay", 0.0)
    if decay > 0:
        for i in range(L):
            qual[i] = max(2, int(qual[i] - decay * i / L))
    if rng.random() < profile.get("burst_rate", 0.0):
        blen = min(int(profile.get("burst_len", 30)), L)
        b0 = int(rng.integers(0, L - blen + 1))
        bq = int(profile.get("burst_qual", 7))
        err[b0 : b0 + blen] *= profile.get("burst_err_mult", 8.0)
        for i in range(b0, b0 + blen):
            qual[i] = min(qual[i], bq)
    hits = np.nonzero(rng.random(L) < np.minimum(err, 0.5))[0]
    for i in hits:
        seq[int(i)] = rng.choice([b for b in BASES if b != seq[int(i)]])


def _extend_cigar(cigar, op, ln):
    if ln <= 0:
        return
    if cigar and cigar[-1][0] == op:
        cigar[-1] = (op, cigar[-1][1] + ln)
    else:
        cigar.append((op, ln))


def write_truth_vcf(path, ctg, variants, somatic_only=True, kinds=None):
    """kinds: restrict to {'snv'} or {'ins','del'} etc.; None = all."""
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write('##FILTER=<ID=PASS,Description="All filters passed">\n')
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSAMPLE\n")
        for v in variants:
            if somatic_only and v.germline:
                continue
            if kinds is not None and v.kind not in kinds:
                continue
            gt = "0/1" if v.af < 0.95 else "1/1"
            f.write(
                f"{ctg}\t{v.pos + 1}\t.\t{v.ref}\t{v.alt}\t60\tPASS\t.\tGT:AF\t{gt}:{v.af:.3f}\n"
            )
    return path


def make_multi_contig_dataset(out_dir, n_contigs=2, seed=0, **kw):
    """Multi-contig dataset: one BAM/FASTA/truth covering n_contigs."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    genome_len = kw.pop("genome_len", 40_000)
    names = [f"chr{i + 1}" for i in range(n_contigs)]
    genomes = {}
    all_variants = {}
    all_records = []
    rng_master = np.random.default_rng(seed)
    for i, ctg in enumerate(names):
        rng = np.random.default_rng(seed * 1000 + i)
        genome = random_genome(rng, genome_len)
        variants = plan_variants(
            rng, genome,
            n_snv=kw.get("n_snv", 10), n_indel=kw.get("n_indel", 0),
            n_germline=kw.get("n_germline", 5),
            af_choices=kw.get("af_choices", (0.1, 0.15, 0.2, 0.3)),
            margin=max(200, kw.get("read_length", 500)),
        )
        reads = simulate_reads(
            rng, genome, variants,
            coverage=kw.get("coverage", 50),
            read_length=kw.get("read_length", 500),
            error_rate=kw.get("error_rate", 0.002),
            base_qual=kw.get("base_qual", 30),
        )
        genomes[ctg] = genome
        all_variants[ctg] = variants
        for (name, flag, pos, cigar, seq, qual) in reads:
            all_records.append(
                bam_writer.encode_record(f"{ctg}_{name}", flag, i, pos, 60,
                                         cigar, seq, qual)
            )
    fasta_path = os.path.join(out_dir, "ref.fa")
    write_fasta(fasta_path, genomes)
    bam_path = os.path.join(out_dir, "tumor.bam")
    bam_writer.write_bam(bam_path, names, [genome_len] * n_contigs, all_records)
    truth_path = os.path.join(out_dir, "truth.vcf")
    with open(truth_path, "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n")
        for ctg in names:
            for v in all_variants[ctg]:
                if v.germline:
                    continue
                gt = "0/1" if v.af < 0.95 else "1/1"
                f.write(f"{ctg}\t{v.pos + 1}\t.\t{v.ref}\t{v.alt}\t60\tPASS\t.\tGT:AF\t{gt}:{v.af:.3f}\n")
    # per-type truths (the reference benchmarks snv/indel against
    # type-split truth files)
    for kind, fname in (("snv", "truth_snv.vcf"), ("indel", "truth_indel.vcf")):
        with open(os.path.join(out_dir, fname), "w") as f:
            f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL"
                    "\tFILTER\tINFO\tFORMAT\tS\n")
            for ctg in names:
                for v in all_variants[ctg]:
                    if v.germline:
                        continue
                    is_snv = len(v.ref) == 1 and len(v.alt) == 1
                    if (kind == "snv") != is_snv:
                        continue
                    gt = "0/1" if v.af < 0.95 else "1/1"
                    f.write(f"{ctg}\t{v.pos + 1}\t.\t{v.ref}\t{v.alt}\t60"
                            f"\tPASS\t.\tGT:AF\t{gt}:{v.af:.3f}\n")
    # population-variant truth: the sim's germline sites play the role of a
    # PoN database (gnomAD/dbSNP analog) for --panel_of_normals runs
    germline_path = os.path.join(out_dir, "germline.vcf")
    with open(germline_path, "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL"
                "\tFILTER\tINFO\n")
        for ctg in names:
            for v in all_variants[ctg]:
                if v.germline:
                    f.write(f"{ctg}\t{v.pos + 1}\t.\t{v.ref}\t{v.alt}"
                            f"\t60\tPASS\t.\n")
    return dict(fasta=fasta_path, bam=bam_path, truth=truth_path,
                truth_snv=os.path.join(out_dir, "truth_snv.vcf"),
                truth_indel=os.path.join(out_dir, "truth_indel.vcf"),
                germline=germline_path,
                genomes=genomes, variants=all_variants, ctgs=names)


def make_dataset(
    out_dir,
    seed=0,
    genome_len=100_000,
    coverage=60,
    read_length=500,
    n_snv=20,
    n_indel=0,
    n_germline=10,
    error_rate=0.002,
    tumor_purity=1.0,
    ctg="chrS",
    base_qual=30,
    af_choices=(0.1, 0.15, 0.2, 0.3),
    lowbq_rate=0.0,
    lowbq_error_mult=10.0,
    somatic_hap_aware=False,
    eval_profile=None,
):
    """Write ref.fa(.fai), tumor.bam, truth.vcf under out_dir; return paths.

    Somatic AFs default to sub-0.5 values: a tumor-only caller cannot
    distinguish an AF-0.5 somatic variant from a het germline SNP without a
    PoN, so 0.5 in the somatic AF pool is irreducible label noise.
    """
    import os

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    genome = random_genome(rng, genome_len)
    # keep variants out of the contig-edge coverage ramp (reads start uniform
    # in [0, L-read_length], so the first/last read_length bp are shallow)
    variants = plan_variants(rng, genome, n_snv=n_snv, n_indel=n_indel,
                             n_germline=n_germline, af_choices=af_choices,
                             margin=max(200, read_length))
    reads = simulate_reads(
        rng, genome, variants, coverage=coverage, read_length=read_length,
        error_rate=error_rate, tumor_purity=tumor_purity, base_qual=base_qual,
        lowbq_rate=lowbq_rate, lowbq_error_mult=lowbq_error_mult,
        somatic_hap_aware=somatic_hap_aware, eval_profile=eval_profile,
    )
    fasta_path = os.path.join(out_dir, "ref.fa")
    write_fasta(fasta_path, {ctg: genome})
    records = [
        bam_writer.encode_record(name, flag, 0, pos, 60, cigar, seq, qual)
        for (name, flag, pos, cigar, seq, qual) in reads
    ]
    bam_path = os.path.join(out_dir, "tumor.bam")
    bam_writer.write_bam(bam_path, [ctg], [genome_len], records)
    truth_path = os.path.join(out_dir, "truth.vcf")
    write_truth_vcf(truth_path, ctg, variants)
    truth_snv = os.path.join(out_dir, "truth_snv.vcf")
    write_truth_vcf(truth_snv, ctg, variants, kinds={"snv"})
    truth_indel = os.path.join(out_dir, "truth_indel.vcf")
    write_truth_vcf(truth_indel, ctg, variants, kinds={"ins", "del"})
    return dict(
        fasta=fasta_path,
        bam=bam_path,
        truth=truth_path,
        truth_snv=truth_snv,
        truth_indel=truth_indel,
        genome=genome,
        variants=variants,
        ctg=ctg,
    )
