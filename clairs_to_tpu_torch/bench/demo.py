# Port of clairs_to_tpu/bench/demo.py.
"""Self-contained acceptance demo: simulate -> train -> calibrate -> call -> F1.

Counterpart of clairs_to_tpu/bench/demo.py.  Fills the role of the
reference's quick demos (demo/*.sh + docs tables): with the committed
``assets/demo_ont_snv/`` networks it loads them; without them it trains the
dual networks on simulated tensors (bench/synth.py).  Either way it calls a
held-out simulated genome through the port's calling pipeline on
``device`` and scores it against the simulated truth with som.py-semantics
compare_vcf.
"""

import os
from dataclasses import dataclass

import numpy as np

from clairs_to_tpu_torch import config as cfg
from clairs_to_tpu_torch.bamio import simulate
from clairs_to_tpu_torch.bamio.bam import BamFile
from clairs_to_tpu_torch.bamio.pileup import PileupEngine
from clairs_to_tpu_torch.bench.compare import compare_vcf, format_report
from clairs_to_tpu_torch.genome.chunks import plan_chunks
from clairs_to_tpu_torch.genome.fasta import FastaFile
from clairs_to_tpu_torch.infer.engine import InferenceEngine
from clairs_to_tpu_torch.infer.pipeline import CallingPipeline, PipelineOptions
from clairs_to_tpu_torch.models import bigru as bigru_mod
from clairs_to_tpu_torch.models import cvt as cvt_mod
from clairs_to_tpu_torch.models.bigru import BiGRUConfig
from clairs_to_tpu_torch.models.checkpoint import load_checkpoint
from clairs_to_tpu_torch.models.cvt import CvTConfig
from clairs_to_tpu_torch.ops.posterior import load_likelihood_matrix
from clairs_to_tpu_torch.train import DualTrainer, TrainConfig, calibrate_likelihood
from clairs_to_tpu_torch.vcf.sort import merge_vcf_files
from clairs_to_tpu_torch.vcf.writer import VcfWriter

FLANK = cfg.FLANKING_BASE_NUM

# Reduced-size architectures for fast demo training (flagship sizes are the
# defaults in models/cvt.py and models/bigru.py).
TINY_CVT = CvTConfig(emb_dims=(16, 32, 64), heads=(1, 2, 2), depths=(1, 1, 1))
TINY_BIGRU = BiGRUConfig(hidden1=48, hidden2=64)


def _pileup(ds, platform):
    genome = ds["genome"]
    bam = BamFile(ds["bam"])
    pe = PileupEngine(genome, 0, platform=platform)
    for read in bam.fetch(ds["ctg"], 0, len(genome), excl_flags=cfg.SAMTOOLS_VIEW_FILTER_FLAG):
        pe.add_read(read)
    return pe


def build_labeled_tensors(ds, platform="ont", max_ref_sites=400, seed=0):
    """Pileup a simulated dataset; return (x, cov, somatic_allele, positions).

    Sites: all AF/depth-passing candidates labeled by truth (somatic alt
    allele index, or -1 for germline/noise), plus random reference sites as
    extra negatives.
    """
    L = len(ds["genome"])
    pe = _pileup(ds, platform)
    min_bq = cfg.MIN_BQ_DICT.get(cfg.platform_family(platform), 0)
    counts, depth = pe.channel_counts(min_bq, 0, L)
    pe.apply_reference_encoding(counts, 0)

    snv_pos, _, infos = pe.find_candidates(0, L, min_bq=min_bq)
    rng = np.random.default_rng(seed)
    ref_sites = [
        int(p)
        for p in rng.integers(FLANK + 1, L - FLANK - 1, size=max_ref_sites)
        if p not in infos
    ]
    positions = sorted(set(snv_pos) | set(ref_sites))
    positions = [p for p in positions if FLANK <= p < L - FLANK - 1]

    truth = {
        v.pos: "ACGT".index(v.alt)
        for v in ds["variants"]
        if v.kind == "snv" and not v.germline
    }
    x = np.stack(
        [counts[p - FLANK : p + FLANK + 1, : cfg.PILEUP_CHANNEL_SIZE] for p in positions]
    ).astype(np.float32)
    cov = np.array([depth[p] for p in positions], np.float32)
    som = np.array([truth.get(p, -1) for p in positions], np.int32)
    return x, cov, som, positions


def build_labeled_tensors_dual(ds, platform="ont", mode="snv",
                               max_ref_sites=400, seed=0):
    """BAM-derived labeled tensors through the production pileup, in the
    dual-BQ views the calling pipeline feeds the nets: AFF at platform
    min_bq, NEG at min_bq=0 (run_clairs_to:1237 vs :1264).  For min_bq==0
    platform families the two views are the same array, matching the
    reference's symlinked negational tensor dir (run_clairs_to:1248-1252).

    Returns (x_aff, x_neg, cov, som, positions).  Labels use the 6-allele
    semantics in indel mode: som = somatic allele index (0-3 base for a
    somatic SNV, 4 insertion, 5 deletion, -1 negative); SNV mode labels
    only somatic SNVs (0-3, -1 negative).
    """
    L = len(ds["genome"])
    pe = _pileup(ds, platform)
    fam = cfg.platform_family(platform)
    aff_bq = cfg.MIN_BQ_DICT.get(platform, cfg.MIN_BQ_DICT.get(fam, 0))
    counts_aff, depth = pe.channel_counts(aff_bq, 0, L)
    pe.apply_reference_encoding(counts_aff, 0)
    if aff_bq != 0:
        counts_neg, _ = pe.channel_counts(0, 0, L)
        pe.apply_reference_encoding(counts_neg, 0)
    else:
        counts_neg = counts_aff

    snv_pos, indel_pos, infos = pe.find_candidates(
        0, L, min_bq=aff_bq, select_indel_candidates=(mode == "indel"))
    rng = np.random.default_rng(seed)
    ref_sites = [
        int(p)
        for p in rng.integers(FLANK + 1, L - FLANK - 1, size=max_ref_sites)
        if p not in infos
    ]
    pool = set(snv_pos) | set(ref_sites)
    if mode == "indel":
        pool |= set(indel_pos)
    positions = [p for p in sorted(pool) if FLANK <= p < L - FLANK - 1]

    truth = {}
    for v in ds["variants"]:
        if v.germline:
            continue
        if v.kind == "snv":
            truth[v.pos] = "ACGT".index(v.alt)
        elif mode == "indel" and v.kind in ("ins", "del"):
            truth[v.pos] = 4 if v.kind == "ins" else 5

    def windows(counts):
        return np.stack(
            [counts[p - FLANK : p + FLANK + 1, : cfg.PILEUP_CHANNEL_SIZE]
             for p in positions]
        ).astype(np.float32)

    x_aff = windows(counts_aff)
    x_neg = x_aff if counts_neg is counts_aff else windows(counts_neg)
    cov = np.array([depth[p] for p in positions], np.float32)
    som = np.array([truth.get(p, -1) for p in positions], np.int32)
    return x_aff, x_neg, cov, som, positions


@dataclass
class DemoResult:
    f1: float
    precision: float
    recall: float
    tp: int
    fp: int
    fn: int
    vcf_path: str
    report: str


DEFAULT_ASSET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "assets", "demo_ont_snv",
)


def run_demo(
    out_dir,
    quick=True,
    platform="ont",
    train_seeds=(101, 102, 103, 104),
    calib_seed=201,
    eval_seed=301,
    genome_len=None,
    coverage=55,
    epochs=None,
    use_tiny=True,
    device_batch=512,
    model_dir=DEFAULT_ASSET_DIR,
    device="cuda",
):
    """Run the full self-contained demo on ``device``; returns DemoResult.

    With ``model_dir`` containing trained assets (aff.npz/neg.npz/
    likelihood_matrix.txt) the demo loads them; otherwise the networks are
    trained from scratch on synthesized tensors (bench/synth.py — redrawn
    reference context per sample prevents genome-context memorization, and
    the eval pass runs on BAM-derived tensors, so train->eval crosses the
    synthesis/pileup boundary).
    """
    os.makedirs(out_dir, exist_ok=True)
    genome_len = genome_len or (60_000 if quick else 400_000)
    epochs = epochs or (70 if quick else 100)
    n_snv = max(genome_len // 1200, 12)
    n_germ = max(genome_len // 4000, 6)

    def sim(seed, sub):
        return simulate.make_dataset(
            os.path.join(out_dir, sub), seed=seed, genome_len=genome_len,
            coverage=coverage, n_snv=n_snv, n_germline=n_germ,
        )

    cvt_config = TINY_CVT if use_tiny else cvt_mod.SNV_CVT_CONFIG
    bigru_config = TINY_BIGRU if use_tiny else bigru_mod.SNV_BIGRU_CONFIG

    have_assets = model_dir and os.path.exists(os.path.join(model_dir, "aff.npz"))
    if have_assets:
        aff = load_checkpoint(os.path.join(model_dir, "aff.npz"), cvt_mod.CvT(cvt_config))
        neg = load_checkpoint(os.path.join(model_dir, "neg.npz"), bigru_mod.BiGRU(bigru_config))
        lik = load_likelihood_matrix(
            os.path.join(model_dir, "likelihood_matrix.txt"), n_alleles=4
        )
    else:
        from clairs_to_tpu_torch.bench.synth import synthesize_batch

        rng = np.random.default_rng(train_seeds[0])
        n_train = 6000 if quick else 20000
        x, cov, som = synthesize_batch(
            rng, n_train, depth_range=(25, 95), somatic_af_range=(0.08, 0.35)
        )
        trainer = DualTrainer(
            mode="snv",
            tc=TrainConfig(batch_size=min(len(x), 256), epochs=epochs,
                           learning_rate=1e-3),
            cvt_config=cvt_config,
            bigru_config=bigru_config,
            device=device,
        )
        trainer.fit(x, som, rescale_cov=cov)
        aff, neg = trainer.models["aff"], trainer.models["neg"]
        ds_cal = sim(calib_seed, "calib")
        xc, covc, somc, _ = build_labeled_tensors(ds_cal, platform=platform, seed=calib_seed)
        p_aff, p_neg = trainer.predict_probs(xc, rescale_cov=covc)
        lik = calibrate_likelihood(p_aff, p_neg, somc)

    # --- call ------------------------------------------------------------
    ds_eval = sim(eval_seed, "eval")
    fasta = FastaFile(ds_eval["fasta"])
    engine = InferenceEngine(
        aff, neg, lik, mode="snv",
        device_batch=device_batch,
        cvt_config=cvt_config, bigru_config=bigru_config,
        device=device,
    )
    pipe = CallingPipeline(
        fasta, ds_eval["bam"], snv_engine=engine,
        options=PipelineOptions(platform=platform, qual_cutoff=8),
    )
    chunk_paths = []
    for ch in plan_chunks(fasta, chunk_size=max(genome_len // 3, 10_000)):
        res = pipe.call_chunk(ch)
        p = os.path.join(out_dir, f"p_{ch.chunk_id}.vcf")
        w = VcfWriter(p, ctg_name=ds_eval["ctg"], ref_fn=ds_eval["fasta"])
        for row in res.snv_rows:
            w.write_row(**row)
        w.close()
        chunk_paths.append(p)
    vcf_path = os.path.join(out_dir, "snv.vcf")
    merge_vcf_files(chunk_paths, vcf_path)

    # --- benchmark -------------------------------------------------------
    res = compare_vcf(ds_eval["truth"], vcf_path, input_filter_tag="PASS")
    return DemoResult(
        f1=res.f1, precision=res.precision, recall=res.recall,
        tp=res.tp, fp=res.fp, fn=res.fn, vcf_path=vcf_path,
        report=format_report(res),
    )
