"""run_clairs_to-compatible driver for the PyTorch/CUDA port.

Counterpart of clairs_to_tpu/cli/run.py with the same parser plus
``--device``.  One run does everything the original does on one device: the
calling stage (decode -> dual-network forward on the device -> host
posterior -> VCF rows), the per-chunk filters (phasing and the haplotype
filter for long reads, realignment and the postfilter for Illumina), the
merge, PoN tagging, the QUAL postprocess, genotyping/hybrid add-back,
Verdict, and the bgzip + tabix copies of both outputs.  The stages after the
forward are numpy and C++ on the host, as in the original.  With several
GPUs the engines hold one replica per device (``--device_count``); with
``--coordinator_address`` the run is one rank of several processes that
split the chunks and meet at a barrier, and rank 0 writes the output
(parallel/scheduler.py).
"""

import argparse
import os
import sys
import time

import numpy as np

from clairs_to_tpu_torch import config as cfg


def build_parser():
    p = argparse.ArgumentParser(
        prog="run_clairs_to_tpu_torch",
        description="ClairS-TO-compatible tumor-only somatic variant caller (PyTorch/CUDA)",
    )
    req = p.add_argument_group("Required parameters")
    req.add_argument("-T", "--tumor_bam_fn", required=True, help="Tumor BAM file input.")
    req.add_argument("-R", "--ref_fn", required=True, help="FASTA reference file input.")
    req.add_argument("-o", "--output_dir", required=True, help="VCF output directory.")
    req.add_argument("-t", "--threads", type=int, default=4, help="Max #threads for host stages.")
    req.add_argument("-p", "--platform", required=True, help="Sequencing platform.")

    opt = p.add_argument_group("Commonly used parameters")
    opt.add_argument("-s", "--sample_name", default="SAMPLE")
    opt.add_argument("-c", "--ctg_name", default=None)
    opt.add_argument("--include_all_ctgs", action="store_true")
    opt.add_argument("-r", "--region", default=None, help="ctg:start-end (1-based)")
    opt.add_argument("-b", "--bed_fn", default=None)
    opt.add_argument("-G", "--genotyping_mode_vcf_fn", default=None)
    opt.add_argument("-H", "--hybrid_mode_vcf_fn", default=None)
    opt.add_argument("--print_ref_calls", action="store_true")
    opt.add_argument("--disable_indel_calling", type=str, default="False")
    opt.add_argument("--snv_min_af", type=float, default=None)
    opt.add_argument("--indel_min_af", type=float, default=None)
    opt.add_argument("--min_coverage", type=int, default=cfg.MIN_COVERAGE)
    opt.add_argument("-q", "--qual", type=float, default=None)
    opt.add_argument("--qual_indel", type=float, default=None)
    opt.add_argument("--snv_output_prefix", default="snv")
    opt.add_argument("--indel_output_prefix", default="indel")

    model = p.add_argument_group("Model parameters")
    model.add_argument("--model_dir", default=None,
                       help="Directory with aff.npz/neg.npz/likelihood_matrix.txt (+ indel/).")
    model.add_argument("--snv_pileup_affirmative_model_path", default=None)
    model.add_argument("--snv_pileup_negational_model_path", default=None)
    model.add_argument("--indel_pileup_affirmative_model_path", default=None)
    model.add_argument("--indel_pileup_negational_model_path", default=None)
    model.add_argument("--snv_likelihood_matrix_data", default=None)
    model.add_argument("--indel_likelihood_matrix_data", default=None)

    adv = p.add_argument_group("Advanced parameters")
    adv.add_argument("--chunk_size", type=int, default=cfg.CHUNK_SIZE)
    adv.add_argument("--max_indel_length", type=int, default=cfg.MAX_INDEL_LENGTH)
    adv.add_argument("--min_bq", type=int, default=None)
    adv.add_argument("--call_indels_only_in_these_regions", default=None)
    adv.add_argument("--panel_of_normals", default=None)
    adv.add_argument("--panel_of_normals_require_allele_matching", default=None)
    adv.add_argument("--pon_resource_dir", default=None,
                     help="Directory with the 4 default PoN databases "
                          "(run_clairs_to:821-878 analog; default: "
                          "$CLAIRS_TO_TPU_PON_DIR or assets/clairs-to_databases).")
    adv.add_argument("--aspcf_penalty", type=float, default=1000.0,
                     help="ASPCF segmentation penalty (reference: --penalty "
                          "1000, src/cna_germline_tagging.py:137).")
    adv.add_argument("--disable_nonsomatic_tagging", action="store_true")
    adv.add_argument("--do_not_print_nonsomatic_calls", action="store_true")
    adv.add_argument("--disable_intermediate_phasing", action="store_true")
    adv.add_argument("--apply_haplotype_filtering", type=str, default=None)
    adv.add_argument("--enable_postfilter", type=str, default=None)
    adv.add_argument("--enable_realignment", type=str, default=None)
    adv.add_argument("--disable_verdict", action="store_true")
    adv.add_argument("--qual_cutoff_phaseable_region", type=float, default=None)
    adv.add_argument("--qual_cutoff_unphaseable_region", type=float, default=None)
    adv.add_argument("--qual_indel_cutoff_phaseable_region", type=float, default=None)
    adv.add_argument("--qual_indel_cutoff_unphaseable_region", type=float, default=None)
    adv.add_argument("--phase_tumor", type=str, default=None,
                     help="Phase+haplotag the tumor for haplotype filtering "
                          "(default: true for long reads, false for ilmn; "
                          "run_clairs_to:960-973).")
    adv.add_argument("--chunk_num", type=int, default=None,
                     help="Chunks per contig (overrides --chunk_size; "
                          "run_clairs_to:557).")
    adv.add_argument("--disable_read_start_end_filtering", action="store_true",
                     help="Skip the read-start/end hard filter verdict.")
    adv.add_argument("--longphase", default=None,
                     help="Path to the longphase binary (default: $PATH "
                          "lookup when --use_longphase_* is set).")
    adv.add_argument("--whatshap", default=None,
                     help="Path to the whatshap binary (default: $PATH "
                          "lookup when --use_whatshap_* is set).")
    adv.add_argument("--use_longphase_for_intermediate_phasing", default=None,
                     help="Phase the het-SNP set with longphase (subprocess, "
                          "run_clairs_to:1377-1393) instead of the internal "
                          "read-graph phaser; graceful fallback with a "
                          "warning when the binary is absent.")
    adv.add_argument("--use_whatshap_for_intermediate_phasing", default=None,
                     help="Phase the het-SNP set with whatshap (subprocess, "
                          "run_clairs_to:1395-1405); graceful fallback when "
                          "absent.")
    adv.add_argument("--exact_reference_fisher", action="store_true",
                     help="Strand-bias Fisher test with bit-exact "
                          "reference-recurrence arithmetic (PASS-set parity "
                          "mode; the default always includes exactly-tied "
                          "tables, scipy semantics).")
    adv.add_argument("--cna_resource_dir", default=None,
                     help="Verdict CNA resource dir (G1000 loci/GC/RT "
                          "tracks). Without it, het-like calls serve as "
                          "loci.")
    adv.add_argument("--device_batch", type=int, default=cfg.DEVICE_BATCH)
    adv.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                     help="Device of the dual-network forward (default: cuda; "
                          "the run fails when no GPU is present).")
    adv.add_argument("--device_count", type=int, default=None,
                     help="Engine replicas, one per GPU (default: every "
                          "visible GPU, cut to those present; with --device "
                          "cpu: replicas on the CPU, default 1).")
    adv.add_argument("--coordinator_address", default=None,
                     help="host:port of rank 0 for a multi-process run "
                          "(torch.distributed, gloo); the ranks share "
                          "--output_dir.")
    adv.add_argument("--num_processes", type=int, default=None,
                     help="Number of processes of a multi-process run.")
    adv.add_argument("--process_id", type=int, default=None,
                     help="This process's rank, 0 .. num_processes - 1; rank "
                          "0 merges and writes the output.")
    adv.add_argument(
        "--matmul_precision", default="highest", choices=["highest", "default"],
        help="'highest': full fp32 with TF32 off for matmuls and cuDNN "
             "convolutions (parity with the reference); 'default' allows TF32.")
    adv.add_argument("--dry_run", action="store_true")
    adv.add_argument("--remove_intermediate_dir", action="store_true")
    adv.add_argument("--resume", action="store_true",
                     help="Skip chunks whose per-chunk VCFs already exist under "
                          "<output_dir>/tmp (the in-process analog of the "
                          "reference's --skip_steps resume).")
    adv.add_argument("--skip_steps", default=None,
                     help="Comma-separated 1-based step indices to skip "
                          "(reference run_clairs_to:1862-1896). The in-process "
                          "pipeline has no shell-step boundaries, so any valid "
                          "value enables per-chunk resume (same effect as "
                          "--resume); indices are validated as in the "
                          "reference (run_clairs_to:190-205).")
    adv.add_argument("--alt_fn", default=None,
                     help="DEBUG: dump passing candidate sites to this path "
                          "(extract_candidates_calling.py --alt_fn).")
    adv.add_argument("--output_depth", type=str, default="False",
                     help="Include depth column in the --alt_fn dump.")
    adv.add_argument("--output_alt_info", type=str, default="False",
                     help="Include alt-info columns in the --alt_fn dump.")
    adv.add_argument("--apply_baq", action="store_true",
                     help="EXPERIMENTAL: probabilistic-realignment base "
                          "quality capping (samtools BAQ; see bamio/baq.py). "
                          "Decodes through the Python pileup, not the C++ one.")
    adv.add_argument("--predict_fn", default=None,
                     help="DEBUG: dump raw network probabilities to this path "
                          "(reference predict --predict_fn TSV format).")
    adv.add_argument("--trace_dir", default=None,
                     help="Write a torch.profiler trace of the calling loop here.")

    p.add_argument("-v", "--version", action="version",
                   version=f"clairs_to_tpu_torch {cfg.VERSION} "
                           f"(ClairS-TO {cfg.REFERENCE_VERSION} compatible)")

    compat = p.add_argument_group("Compatibility (accepted, unused)")
    for flag in ("--samtools", "--pypy", "--python", "--parallel",
                 "--conda_prefix", "--tee", "--cmdline",
                 "--output_path", "--chunk_list", "--allele_counter_dir",
                 "--bam_mplp_set_maxcnt", "--haplotype_chunk_max_sites",
                 "--haplotype_chunk_max_span", "--haplotype_chunk_mpileup_bed",
                 "--haplotype_filtering_chunk_mode",
                 "--haplotype_input_filter_tag",
                 "--postfilter_variants_chunk_mode",
                 "--use_longphase_for_intermediate_haplotagging"):
        compat.add_argument(flag, default=None, help=argparse.SUPPRESS)
    for flag in ("--use_gpu", "--debug", "--prefer_recall", "--prefer_balance"):
        # --prefer_recall/--prefer_balance are parsed-but-unused in the
        # reference too (run_clairs_to:2379-2389, postprocess_vcf.py:254)
        compat.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
    return p


def _str2bool(v):
    return str(v).lower() in ("1", "true", "yes", "t")


def default_model_dir(platform, warn=True):
    """Per-platform default model resolution, the analog of the reference's
    model-path defaulting (run_clairs_to:612-819): prefer the committed
    assets/flagship_<family>_snv bundle, fall back to the ONT flagship
    (cross-platform, with a loud warning), None when no assets ship."""
    assets = os.path.normpath(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
        "assets"))
    fam = cfg.platform_family(platform)
    for name in (f"flagship_{fam}_snv", "flagship_ont_snv"):
        p = os.path.join(assets, name)
        if os.path.isdir(p):
            if warn and fam != "ont" and name == "flagship_ont_snv":
                print(f"[WARNING] No trained model bundle ships for platform "
                      f"family '{fam}' — falling back to ONT-trained flagship "
                      f"weights ({p}). Cross-platform weights degrade calling "
                      f"accuracy on real {fam} data; pass --model_dir or the "
                      f"per-network --*_model_path flags to use proper "
                      f"weights.")
            return p
    return None


def run_devices(args):
    """The devices of this run's engines, from --device and --device_count."""
    import torch

    from clairs_to_tpu_torch.infer.engine import local_devices

    devices = local_devices(args.device, args.device_count)
    if args.device_count and args.device_count > len(devices):
        print(f"[INFO] --device_count {args.device_count}: {torch.cuda.device_count()} "
              f"GPU(s) visible, using {len(devices)}")
    if len(devices) > 1:
        print(f"[INFO] Data-parallel engine replicas on {len(devices)} "
              f"{devices[0].type} devices")
    return devices


def load_engines(args, devices=None):
    """Load trained checkpoints + likelihood matrices into engines with one
    replica on each of ``devices`` (default: ``args.device`` alone)."""
    import torch

    from clairs_to_tpu_torch.infer.engine import InferenceEngine, resolve_device
    from clairs_to_tpu_torch.models import bigru, cvt, mode_configs
    from clairs_to_tpu_torch.models.checkpoint import load_checkpoint_auto
    from clairs_to_tpu_torch.ops.posterior import (
        load_likelihood_matrix,
        uniform_likelihood_data,
    )

    devices = list(devices) if devices else [resolve_device(args.device)]
    device = devices[0]
    # default the model dir whenever it is unset; resolve() fills only the
    # per-network paths not given explicitly (run_clairs_to:612-819)
    if not args.model_dir:
        args.model_dir = default_model_dir(args.platform)
        if args.model_dir:
            print(f"[INFO] Using default model assets: {args.model_dir}")

    def resolve(explicit, sub):
        if explicit:
            return explicit
        if args.model_dir:
            path = os.path.join(args.model_dir, sub)
            if os.path.exists(path):
                return path
        return None

    def build(mode, seed):
        prefix = "" if mode == "snv" else "indel/"
        aff_path = resolve(
            args.snv_pileup_affirmative_model_path if mode == "snv"
            else args.indel_pileup_affirmative_model_path, prefix + "aff.npz")
        neg_path = resolve(
            args.snv_pileup_negational_model_path if mode == "snv"
            else args.indel_pileup_negational_model_path, prefix + "neg.npz")
        lik_path = resolve(
            args.snv_likelihood_matrix_data if mode == "snv"
            else args.indel_likelihood_matrix_data, prefix + "likelihood_matrix.txt")
        gen = torch.Generator().manual_seed(seed)
        cvt_cfg, gru_cfg = mode_configs(mode)
        if aff_path:
            aff, cvt_cfg = load_checkpoint_auto(aff_path, mode=mode, kind="cvt", device=device)
        else:
            aff = cvt.CvT(cvt_cfg).reset_parameters(gen)
        if neg_path:
            neg, gru_cfg = load_checkpoint_auto(neg_path, mode=mode, kind="bigru",
                                                device=device)
        else:
            neg = bigru.BiGRU(gru_cfg).reset_parameters(gen)
        n_alleles = len(cvt_cfg.alleles)
        if not aff_path or not neg_path:
            print(f"[WARNING] No trained {mode} checkpoints found — using random weights.")
        lik = (
            load_likelihood_matrix(lik_path, n_alleles=n_alleles)
            if lik_path
            else uniform_likelihood_data(n_alleles)
        )
        device_batch = args.device_batch
        if device_batch == cfg.DEVICE_BATCH and device.type == "cpu":
            # on the CPU the 8192 default only costs memory: cap unless asked
            device_batch = min(device_batch, 1024)
        return InferenceEngine(
            aff, neg, lik, mode=mode, device_batch=device_batch,
            cvt_config=cvt_cfg, bigru_config=gru_cfg,
            matmul_precision=args.matmul_precision, devices=devices,
        )

    snv_engine = build("snv", 0)
    indel_engine = None
    if not _str2bool(args.disable_indel_calling):
        indel_engine = build("indel", 1)
    return snv_engine, indel_engine


def warm_engines(engines):
    """A one-row zero batch through each engine: the first forward builds
    the kernels and cuDNN's plans."""
    z = np.zeros((1, 33, 34), np.int16)
    c = np.ones(1, np.float32)
    for eng in engines:
        if eng is not None:
            eng.run_batch(z, z, c, c)


# The reference's 4 default PoNs and their allele-matching modes
# (run_clairs_to:821-878: gnomAD + dbSNP match by (pos, ref, alt); the
# 1000G PoN and CoLoRSdb match by position only).
DEFAULT_PON_FILES = (
    ("gnomad.r2.1.af-ge-0.001.sites.vcf.gz", True),
    ("dbsnp.b138.non-somatic.sites.vcf.gz", True),
    ("1000g-pon.sites.vcf.gz", False),
    ("CoLoRSdb.GRCh38.v1.1.0.deepvariant.glnexus.af-ge-0.001.vcf.gz", False),
)


def default_pon_dir():
    return os.environ.get(
        "CLAIRS_TO_TPU_PON_DIR",
        os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "assets", "clairs-to_databases"),
    )


def resolve_af_defaults(args):
    """Per-platform AF-cutoff defaulting (run_clairs_to:895-904): SNV 0.05;
    indel 0.1 for ONT, 0.05 for ilmn/hifi, 1.0 when indel calling is off."""
    if args.snv_min_af is None:
        args.snv_min_af = cfg.SNV_MIN_AF
    if args.indel_min_af is None:
        if _str2bool(args.disable_indel_calling):
            args.indel_min_af = 1.0
        elif "ont" in args.platform:
            args.indel_min_af = 0.1
        else:
            args.indel_min_af = 0.05


def resolve_pon_defaults(args):
    """Default panel-of-normals resolution (run_clairs_to:821-878).

    Explicit 'None'/'Null'/' ' disables tagging; an explicit list is
    validated file-by-file (fail loud); otherwise the 4 default databases
    are resolved from --pon_resource_dir with the reference's matching-mode
    table.  Divergence (documented): when the resource directory itself is
    absent the stage is skipped with a notice instead of aborting — the
    multi-GB bundles are downloads, not repo assets; the reference
    hard-exits (file_path_from(exit_on_not_found=True))."""
    if args.panel_of_normals in ("None", "Null", " "):
        args.disable_nonsomatic_tagging = True
        args.panel_of_normals = None
        return
    if args.panel_of_normals is not None:
        pons = args.panel_of_normals.split(",")
        missing = [p for p in pons if not os.path.exists(p)]
        if missing:
            sys.exit("[ERROR] file {} not found".format(", ".join(missing)))
        mm = args.panel_of_normals_require_allele_matching
        if mm in (None, "None", "Null", " "):
            args.panel_of_normals_require_allele_matching = ",".join(
                ["True"] * len(pons))
        elif len(mm.split(",")) != len(pons):
            print("[WARNING] Please use "
                  "`--panel_of_normals_require_allele_matching` together "
                  "with `--panel_of_normals`.")
        return
    pon_dir = args.pon_resource_dir or default_pon_dir()
    if not os.path.isdir(pon_dir):
        if not args.disable_nonsomatic_tagging:
            print(f"[INFO] Default PoN databases not installed ({pon_dir}); "
                  "nonsomatic tagging runs only when --panel_of_normals is "
                  "given.")
        return
    files, modes, missing = [], [], []
    for fname, allele in DEFAULT_PON_FILES:
        path = os.path.join(pon_dir, fname)
        (files if os.path.exists(path) else missing).append(path)
        modes.append(str(allele))
    if missing:
        sys.exit("[ERROR] file {} not found".format(", ".join(missing)))
    args.panel_of_normals = ",".join(files)
    args.panel_of_normals_require_allele_matching = ",".join(modes)


def default_qual(args):
    """Qual-cutoff defaulting incl. the --qual supersede rule
    (run_clairs_to:920-956): an explicit --qual overrides qual_indel and all
    four phaseable/unphaseable cutoffs."""
    fam = cfg.platform_family(args.platform)
    if args.qual is not None:
        if (args.qual_cutoff_phaseable_region is not None
                or args.qual_cutoff_unphaseable_region is not None):
            print("[WARNING] `--qual` will supersede "
                  "`--qual_cutoff_phaseable_region` and "
                  "`--qual_cutoff_unphaseable_region`.")
        args.qual_cutoff_phaseable_region = args.qual
        args.qual_cutoff_unphaseable_region = args.qual
        args.qual_indel = args.qual
        args.qual_indel_cutoff_phaseable_region = args.qual
        args.qual_indel_cutoff_unphaseable_region = args.qual
        return args.qual, args.qual
    snv_q = cfg.MIN_THRED_QUAL.get(fam, 8)
    indel_q = (
        args.qual_indel
        if args.qual_indel is not None
        else cfg.MIN_THRED_QUAL_INDEL.get(fam, 8)
    )
    return snv_q, indel_q


def _filter_stages(args):
    """(apply_hap_filter, apply_postfilter) with the reference's defaulting
    (run_clairs_to:960-973): explicit values win; genotyping mode disables
    phasing by default; ilmn never phases."""
    fam = cfg.platform_family(args.platform)
    phase_tumor = (
        _str2bool(args.phase_tumor) if args.phase_tumor is not None else None
    )
    if args.disable_intermediate_phasing:
        phase_tumor = False
    if phase_tumor is None:
        if args.genotyping_mode_vcf_fn is not None:
            print("[WARNING] HET SNPs based phasing is disabled if "
                  "`--genotyping_mode_vcf_fn` is provided, add "
                  "`--phase_tumor True` if phasing the tumor is still needed.")
            phase_tumor = False
        else:
            phase_tumor = fam != "ilmn"
    if fam == "ilmn" and phase_tumor:
        print("[WARNING] Intermediate phasing/haplotagging is not used for "
              "Illumina (ilmn) platform; ignoring --phase_tumor.")
        phase_tumor = False
    apply_hap_filter = (
        _str2bool(args.apply_haplotype_filtering)
        if args.apply_haplotype_filtering is not None
        else phase_tumor
    )
    apply_postfilter = (
        _str2bool(args.enable_postfilter)
        if args.enable_postfilter is not None
        else fam == "ilmn"
    )
    return apply_hap_filter, apply_postfilter


def _apply_chunk_filters(pipe, chunk, res, apply_hap_filter, apply_postfilter, args):
    """Run hard filters against the chunk's entry table (STEP 4 equivalents).

    Long-read: internal phasing (phasing/phaser.py replaces longphase/
    whatshap) + the 9-verdict haplotype filter; Illumina: the no-phasing
    postfilter family."""
    pe, aff_counts, neg_counts, region_start, region_end = pipe.build_chunk_views(chunk)
    pass_rows = [r for r in res.snv_rows if r["FILTER"] == "PASS"]
    if not pass_rows:
        return

    from clairs_to_tpu_torch.postcall.hardfilter import (
        fisher_exact,
        fisher_exact_reference,
    )

    fisher = (fisher_exact_reference if args.exact_reference_fisher
              else fisher_exact)
    if apply_hap_filter:
        from clairs_to_tpu_torch.phasing.phaser import phase_and_tag
        from clairs_to_tpu_torch.postcall.haplotype import (
            HaplotypeFilterEngine,
            apply_haplotype_filters,
        )

        # Germline sets from this chunk's calling output, mirroring the
        # reference's germline_vcf_fn = snv_pileup.vcf: PASS 0/1 rows feed
        # the het set, PASS 1/1 rows the hom set (haplotype_filtering.py:
        # 910-916).  Phasing anchors additionally require a germline-like
        # AF band — the analog of select_hetero_snp's qual-percentile drop.
        het_rows = [
            r for r in res.snv_rows
            if r["GT"] == "0/1" and len(r["REF"]) == 1 and len(r["ALT"]) == 1
        ]
        hom_rows = [
            r for r in res.snv_rows
            if r["GT"] == "1/1" and len(r["REF"]) == 1 and len(r["ALT"]) == 1
        ]
        anchors = [
            (r["POS"] - 1, r["REF"], r["ALT"])
            for r in het_rows if r["AF"] >= 0.35
        ]
        tagged = False
        ext_tool = None
        if _str2bool(args.use_longphase_for_intermediate_phasing or ""):
            ext_tool = "longphase"
        elif _str2bool(args.use_whatshap_for_intermediate_phasing or ""):
            ext_tool = "whatshap"
        if ext_tool and anchors:
            from clairs_to_tpu_torch.phasing import external as extph

            binary = extph.resolve_binary(
                args.longphase if ext_tool == "longphase" else args.whatshap,
                ext_tool)
            if binary is None:
                if not getattr(args, "_ext_phaser_warned", False):
                    print(f"[WARNING] --use_{ext_tool}_for_intermediate_"
                          f"phasing requested but no {ext_tool} binary found"
                          " — falling back to the internal phaser.")
                    args._ext_phaser_warned = True
            else:
                ph_dir = os.path.join(args.output_dir, "tmp",
                                      "phasing_output")
                os.makedirs(ph_dir, exist_ok=True)
                tag = f"{chunk.ctg_name}_{chunk.chunk_id}"
                het_vcf = extph.write_het_vcf(
                    os.path.join(ph_dir, f"het_{tag}.vcf"),
                    chunk.ctg_name, anchors, sample=args.sample_name)
                phased = extph.run_external_phase(
                    ext_tool, binary, het_vcf, pipe.bam_path, args.ref_fn,
                    os.path.join(ph_dir, f"tumor_phased_{tag}"),
                    chunk.ctg_name, platform=cfg.platform_family(args.platform),
                    threads=args.threads)
                if phased is None:
                    print(f"[WARNING] {ext_tool} phase failed for chunk "
                          f"{tag} — falling back to the internal phaser.")
                else:
                    orients = extph.load_phase_orientations(phased, anchors)
                    hp = extph.phase_and_tag_with_orientations(pe, anchors, orients)
                    tagged = True
        if not tagged:
            hp = phase_and_tag(pe, anchors)
        if pipe.metrics is not None:
            pipe.metrics.count("phasing_anchors", len(anchors))
            pipe.metrics.count("reads_haplotagged", int(np.count_nonzero(hp)))
            pipe.metrics.count("reads_phasing_input", len(hp))
        engine = HaplotypeFilterEngine(
            pe,
            hetero_germline=[(r["POS"] - 1, r["ALT"]) for r in het_rows],
            homo_germline=[(r["POS"] - 1, r["ALT"]) for r in hom_rows],
            disable_read_start_end_filtering=args.disable_read_start_end_filtering,
            site_positions=[r["POS"] - 1 for r in pass_rows],
            fisher=fisher,
        )
        batch = engine.verdict_batch(
            (row["POS"] - 1, row["REF"], row["ALT"], row["AF"])
            for row in pass_rows
        )
        verdicts = {
            (row["CHROM"], row["POS"]): batch[row["POS"] - 1]
            for row in pass_rows
        }
        apply_haplotype_filters(res.snv_rows, verdicts)
    elif apply_postfilter:
        # The reference always runs the realignment filter for ilmn before
        # the postfilter (run_clairs_to:1449-1482); --enable_realignment
        # defaults on for the short-read family.
        enable_realign = (
            args.enable_realignment is None
            or _str2bool(args.enable_realignment)
        )
        if enable_realign:
            from clairs_to_tpu_torch.postcall.realignment import realign_filter

            with pipe._stage("realign_filter", chunk):
                n_re = realign_filter(pipe.bam_path, pipe.fasta, pass_rows,
                                      window=getattr(pe, "_win", None),
                                      metrics=pipe.metrics)
            if n_re:
                print(f"[INFO] Realignment filter failed {n_re} call(s)")
            pass_rows = [r for r in pass_rows if r["FILTER"] == "PASS"]
            if not pass_rows:
                return

        from clairs_to_tpu_torch.postcall.hardfilter import (
            HardFilterEngine,
            apply_hard_filters,
        )

        engine = HardFilterEngine(
            pe,
            disable_read_start_end_filtering=args.disable_read_start_end_filtering,
            site_positions=[r["POS"] - 1 for r in pass_rows],
            fisher=fisher,
        )
        batch = engine.verdict_batch(
            (row["POS"] - 1, row["REF"], row["ALT"]) for row in pass_rows
        )
        verdicts = {
            (row["CHROM"], row["POS"]): batch[row["POS"] - 1]
            for row in pass_rows
        }
        apply_hard_filters(res.snv_rows, verdicts)


def _load_verdict_resources(args, chunks):
    """(resource_loci, gc_lookup, rt_lookup) from --cna_resource_dir."""
    if not (args.cna_resource_dir and os.path.isdir(args.cna_resource_dir)):
        return None, None, None
    from clairs_to_tpu_torch.verdict.resources import load_cna_resources

    ctgs_present = sorted({c.ctg_name for c in chunks})
    loci, gc_lookup, rt_lookup = load_cna_resources(
        args.cna_resource_dir, ctgs_present
    )
    if loci:
        print(f"[INFO] Verdict: G1000 loci from {args.cna_resource_dir} "
              f"({sum(len(v[0]) for v in loci.values())} loci, "
              f"GC={'yes' if gc_lookup else 'no'} "
              f"RT={'yes' if rt_lookup else 'no'})")
    return loci or None, gc_lookup, rt_lookup


def _accumulate_verdict_counts(pipe, chunk, res, resource_loci, acc):
    """Count verdict alleles at this chunk's loci while its views are live.

    The in-process analog of the reference's per-contig alleleCounter pass
    (src/cna_germline_tagging.py:56-69): resource loci when provided, else
    het-like calls (0/1 single-base, AF in [0.3, 0.7]) from this chunk.
    """
    from clairs_to_tpu_torch.verdict.allele_counter import allele_counts_at

    ctg = chunk.ctg_name
    if resource_loci is not None:
        if ctg not in resource_loci:
            return
        pos_all, ref_idx_all, alt_idx_all = resource_loci[ctg]
        m = (pos_all >= chunk.ctg_start) & (pos_all < chunk.ctg_end)
        if not m.any():
            return
        positions, ref_idx, alt_idx = pos_all[m], ref_idx_all[m], alt_idx_all[m]
    else:
        het = [
            r for r in res.snv_rows
            if r["GT"] == "0/1" and len(r["REF"]) == 1 and len(r["ALT"]) == 1
            and 0.3 <= r["AF"] <= 0.7
        ]
        if not het:
            return
        positions = np.array([r["POS"] - 1 for r in het])
        ref_idx = np.array(["ACGT".index(r["REF"]) for r in het])
        alt_idx = np.array(["ACGT".index(r["ALT"]) for r in het])
    pe, *_ = pipe.build_chunk_views(chunk)
    counts = allele_counts_at(pe, positions)
    rows_i = np.arange(len(positions))
    entry = acc.setdefault(ctg, {"pos": [], "refc": [], "altc": []})
    entry["pos"].append(positions)
    entry["refc"].append(counts[rows_i, ref_idx])
    entry["altc"].append(counts[rows_i, alt_idx])


def _run_verdict_stage(args, verdict_acc, snv_vcf_path, gc_lookup, rt_lookup):
    """Verdict (CNA/purity germline separation) on the final SNV VCF.

    Consumes allele counts accumulated during the chunk loop; without a
    --cna_resource_dir the het-like calls served as loci — enough to
    estimate purity/ploidy when the genome carries CNA signal.
    """
    from clairs_to_tpu_torch.verdict.pipeline import run_verdict

    rows = []
    header = []
    with open(snv_vcf_path) as f:
        for line in f:
            if line.startswith("#"):
                header.append(line)
                continue
            cols = line.rstrip("\n").split("\t")
            fmt = cols[8].split(":")
            vals = cols[9].split(":")
            info = dict(zip(fmt, vals))
            rows.append(
                dict(
                    CHROM=cols[0], POS=int(cols[1]), REF=cols[3], ALT=cols[4],
                    QUAL=float(cols[5]), FILTER=cols[6], INFO=cols[7],
                    AF=float(info.get("AF", 0)), DP=int(info.get("DP", 0)),
                    _cols=cols,
                )
            )
    counts_by_ctg = {
        ctg: (
            np.concatenate(e["pos"]),
            np.concatenate(e["refc"]),
            np.concatenate(e["altc"]),
        )
        for ctg, e in verdict_acc.items()
        if e["pos"]
    }
    n_loci = sum(len(v[0]) for v in counts_by_ctg.values())
    if n_loci < 12:
        print("[INFO] Verdict skipped: too few usable loci")
        return
    cna_dir = os.path.join(args.output_dir, "tmp", "cna_output")
    result = run_verdict(None, None, rows, cna_output_dir=cna_dir,
                         sample_name=args.sample_name,
                         penalty=args.aspcf_penalty,
                         gc_lookup=gc_lookup, rt_lookup=rt_lookup,
                         counts_by_ctg=counts_by_ctg)
    if result.applied and result.n_tagged:
        with open(snv_vcf_path, "w") as out:
            out.writelines(header)
            for r in rows:
                cols = r["_cols"]
                cols[6] = r["FILTER"]
                cols[7] = r["INFO"]
                out.write("\t".join(cols) + "\n")
    print(
        f"[INFO] Verdict: purity={result.purity} ploidy={result.ploidy} "
        f"tagged={result.n_tagged} ({result.reason or 'applied'})"
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    from clairs_to_tpu_torch.parallel.scheduler import shutdown_distributed

    try:
        return _main_impl(args)
    except MemoryError:
        sys.stderr.write(
            "[ERROR] Out of memory. Consider: smaller --chunk_size, smaller "
            "--device_batch, --skip_pon_md5-style options, or per-contig runs "
            "(-c).\n"
        )
        return 1
    except OSError as e:
        if "Cannot allocate memory" in str(e):
            sys.stderr.write(
                "[ERROR] Out of memory (OS): {}. Consider smaller --chunk_size "
                "or --device_batch.\n".format(e)
            )
            return 1
        raise
    finally:
        shutdown_distributed()


def _main_impl(args, engines=None):
    t0 = time.time()

    resolve_af_defaults(args)
    resolve_pon_defaults(args)
    os.makedirs(args.output_dir, exist_ok=True)
    tmp_dir = os.path.join(args.output_dir, "tmp")
    os.makedirs(os.path.join(tmp_dir, "vcf_output"), exist_ok=True)

    from clairs_to_tpu_torch.utils.metrics import RunMetrics, Tee

    metrics = RunMetrics()
    tee = Tee(os.path.join(args.output_dir, "run_clairs_to_tpu_torch.log"))
    _stdout = sys.stdout
    sys.stdout = tee
    try:
        return _pipeline_body(args, metrics, t0, tee, engines=engines)
    finally:
        sys.stdout = _stdout
        tee.close()


def _pipeline_body(args, metrics, t0, tee, engines=None):
    """engines: optional preloaded (snv_engine, indel_engine)."""
    from clairs_to_tpu_torch.genome.bed import bed_tree_from
    from clairs_to_tpu_torch.genome.chunks import plan_chunks
    from clairs_to_tpu_torch.genome.fasta import FastaFile
    from clairs_to_tpu_torch.infer.pipeline import CallingPipeline, PipelineOptions, chunk_id
    from clairs_to_tpu_torch.ops.dwproj import dwproj
    from clairs_to_tpu_torch.ops.gru import gru_direction
    from clairs_to_tpu_torch.parallel.scheduler import (
        all_hosts_barrier,
        init_distributed,
        owned_chunks,
    )
    from clairs_to_tpu_torch.postcall.postprocess import postprocess_vcf
    from clairs_to_tpu_torch.utils.metrics import device_trace
    from clairs_to_tpu_torch.vcf.sort import merge_vcf_files
    from clairs_to_tpu_torch.vcf.tabix import write_tabix_vcf
    from clairs_to_tpu_torch.vcf.writer import VcfWriter

    tmp_dir = os.path.join(args.output_dir, "tmp")
    vcf_out = os.path.join(tmp_dir, "vcf_output")

    fasta = FastaFile(args.ref_fn)
    ctg_names = args.ctg_name.split(",") if args.ctg_name else None
    region = None
    if args.region:
        try:
            ctg, span = args.region.split(":")
            start, end = (int(x) for x in span.split("-"))
        except ValueError:
            sys.exit("[ERROR] Please use the correct format for --region: "
                     f"ctg_name:start-end, your input is {args.region}")
        if end < start or start < 1:
            sys.exit(f"[ERROR] Invalid region input: {args.region}")
        ctg_names = [ctg]
        region = (start - 1, end)
        # the region becomes tmp/region.bed so candidates (not just chunks)
        # are gated precisely (run_clairs_to:371-397)
        region_bed = os.path.join(tmp_dir, "region.bed")
        with open(region_bed, "w") as f:
            f.write(f"{ctg}\t{start - 1}\t{end}\n")
        args.bed_fn = region_bed

    if args.skip_steps is not None:
        steps = [s for s in args.skip_steps.rstrip().split(",") if s]
        if not steps or not all(s.strip().isdigit() and int(s) >= 1 for s in steps):
            sys.exit("[ERROR] --skip_steps option provided but contains "
                     "invalid skip steps index, should be 1-index")
        args.resume = True
    chunks = plan_chunks(
        fasta, ctg_names=ctg_names, chunk_size=args.chunk_size,
        include_all_ctgs=args.include_all_ctgs, chunk_num=args.chunk_num,
    )
    if region:
        chunks = [
            c for c in chunks if c.ctg_end > region[0] and c.ctg_start < region[1]
        ]

    if args.dry_run:
        print(f"[DRY RUN] {len(chunks)} chunks:")
        for c in chunks:
            print(f"  {c.ctg_name}:{c.ctg_start + 1}-{c.ctg_end}")
        return 0

    default_qual(args)

    # Processes own disjoint chunk subsets (the reference's CHUNK_LIST static
    # split, run_clairs_to:553-561); each runs its chunks on its own GPUs,
    # so nothing crosses processes but the end barrier.
    try:
        process_count, process_index = init_distributed(
            args.coordinator_address, args.num_processes, args.process_id)
    except ValueError as e:
        sys.exit(f"[ERROR] {e}")
    all_chunks = chunks
    if process_count > 1:
        chunks = owned_chunks(all_chunks, process_index, process_count)
        print(f"[INFO] Host {process_index}/{process_count}: owns "
              f"{len(chunks)}/{len(all_chunks)} chunks")
    launches_before = gru_direction.launches, dwproj.launches
    call_indels = not _str2bool(args.disable_indel_calling)

    genotyping_sites = None
    genotyping_mode = None
    genotyping_vcf = args.genotyping_mode_vcf_fn or args.hybrid_mode_vcf_fn
    if genotyping_vcf:
        from clairs_to_tpu_torch.vcf.reader import VcfReader

        genotyping_mode = "genotyping" if args.genotyping_mode_vcf_fn else "hybrid"
        reader = VcfReader(genotyping_vcf, show_ref=True, skip_genotype=True)
        reader.read_vcf()
        genotyping_sites = {}
        for rec in reader.variant_dict.values():
            genotyping_sites.setdefault(rec.ctg_name, []).append(rec.pos - 1)
        genotyping_sites = {c: sorted(p) for c, p in genotyping_sites.items()}

    bed_tree = bed_tree_from(args.bed_fn) if args.bed_fn else None
    indel_bed_tree = (
        bed_tree_from(args.call_indels_only_in_these_regions)
        if args.call_indels_only_in_these_regions else None
    )
    options = PipelineOptions(
        platform=args.platform,
        snv_min_af=args.snv_min_af,
        indel_min_af=args.indel_min_af,
        min_coverage=args.min_coverage,
        # the reference's call_variants runs with --qual 0: every variant row
        # is PASS at the call stage; postprocess applies the real QUAL gate
        qual_cutoff=0,
        show_ref=args.print_ref_calls,
        select_indel_candidates=call_indels,
        max_indel_length=args.max_indel_length,
        genotyping_sites=genotyping_sites,
        genotyping_mode=genotyping_mode,
        apply_baq=args.apply_baq,
        predict_fn=args.predict_fn,
        bed_tree=bed_tree,
        indel_bed_tree=indel_bed_tree,
        alt_fn=args.alt_fn,
        output_depth=_str2bool(args.output_depth),
        output_alt_info=_str2bool(args.output_alt_info),
    )
    apply_hap_filter, apply_postfilter = _filter_stages(args)
    # the decode-ahead workers assemble the filters' site-independent data
    options.precompute_filter_assembly = apply_hap_filter or apply_postfilter
    # decode-ahead workers: up to one per core, capped at 4
    options.decode_workers = max(1, min(args.threads - 1, (os.cpu_count() or 2), 4))
    pipe = CallingPipeline(fasta, args.tumor_bam_fn, None, None, options,
                           metrics=metrics)
    if args.min_bq is not None:
        # explicit --min_bq overrides the platform AFF-view base quality
        pipe.aff_min_bq = args.min_bq

    snv_paths, indel_paths = [], []
    n_cand = 0
    verdict_acc = {}
    resource_loci, gc_lookup, rt_lookup = (
        _load_verdict_resources(args, chunks)
        if not args.disable_verdict else (None, None, None)
    )
    todo = []
    for ch in chunks:
        sp_path = os.path.join(vcf_out, f"p_snv_{ch.ctg_name}_{ch.chunk_id}.vcf")
        ip_path = os.path.join(vcf_out, f"p_indel_{ch.ctg_name}_{ch.chunk_id}.vcf")
        if args.resume and os.path.exists(sp_path) and (
            not call_indels or os.path.exists(ip_path)
        ):
            snv_paths.append(sp_path)
            if call_indels:
                indel_paths.append(ip_path)
            print(f"[INFO] {ch.ctg_name} chunk {ch.chunk_id + 1}/{ch.chunk_num}: "
                  f"resumed from existing output")
            continue
        todo.append(ch)

    # -t >= 2: decode-ahead workers overlap host pileup with device compute
    if args.threads >= 2 and todo:
        chunk_iter = (ch for (ch, _views) in pipe.iter_chunks(todo))
    else:
        chunk_iter = iter(todo)

    # the engines load while the first chunks decode
    if engines is None:
        with metrics.stage("load_engines"):
            engines = load_engines(args, devices=run_devices(args))
        with metrics.stage("engine_warmup"):
            warm_engines(engines)
    pipe.snv_engine, pipe.indel_engine = engines
    call_indels = pipe.indel_engine is not None

    _last_done = [time.time()]

    def _finalize_chunk(ch, pending):
        nonlocal n_cand
        res = pipe.finish_chunk(pending)
        n_cand += res.n_candidates

        # long-read: internal phasing + 9-verdict haplotype filtering; ilmn:
        # realignment + no-phasing postfilter (run_clairs_to STEP 4,
        # :1450-1514).  Both read the chunk's decoded views: before evict_views
        if res.snv_rows and (apply_hap_filter or apply_postfilter):
            with metrics.stage("hard_filters", chunk_id(ch)):
                _apply_chunk_filters(
                    pipe, ch, res, apply_hap_filter, apply_postfilter, args
                )

        sp = os.path.join(vcf_out, f"p_snv_{ch.ctg_name}_{ch.chunk_id}.vcf")
        w = VcfWriter(sp, ctg_name=ch.ctg_name, ref_fn=args.ref_fn,
                      sample_name=args.sample_name, show_ref_calls=args.print_ref_calls)
        for row in res.snv_rows:
            w.write_row(**row)
        w.close()
        snv_paths.append(sp)
        if call_indels:
            ip = os.path.join(vcf_out, f"p_indel_{ch.ctg_name}_{ch.chunk_id}.vcf")
            w = VcfWriter(ip, ctg_name=ch.ctg_name, ref_fn=args.ref_fn,
                          sample_name=args.sample_name, show_ref_calls=args.print_ref_calls)
            for row in res.indel_rows:
                w.write_row(**row)
            w.close()
            indel_paths.append(ip)
        metrics.count("candidates", res.n_candidates)
        metrics.count("snv_rows", len(res.snv_rows))
        metrics.count("indel_rows", len(res.indel_rows))
        if not args.disable_verdict:
            with metrics.stage("verdict_counts", chunk_id(ch)):
                _accumulate_verdict_counts(pipe, ch, res, resource_loci, verdict_acc)
        pipe.evict_views(ch)
        now = time.time()
        print(f"[INFO] {ch.ctg_name} chunk {ch.chunk_id + 1}/{ch.chunk_num}: "
              f"{len(res.snv_rows)} SNV rows, {len(res.indel_rows)} Indel rows "
              f"({res.n_candidates} candidates, {now - _last_done[0]:.2f}s)")
        _last_done[0] = now

    # two chunks in flight: chunk N's device work overlaps chunk N+1's
    # host-side candidate prep and dispatch
    from collections import deque

    depth_ahead = 2
    inflight = deque()
    with metrics.stage("calling"), device_trace(args.trace_dir):
        for ch in chunk_iter:
            inflight.append((ch, pipe.dispatch_chunk(ch)))
            if len(inflight) > depth_ahead:
                _finalize_chunk(*inflight.popleft())
        while inflight:
            _finalize_chunk(*inflight.popleft())
    # launches of the GRU and depthwise projection forward kernels by this
    # run: above 0 whenever a batch ran on a GPU
    metrics.count("gru_launches", gru_direction.launches - launches_before[0])
    metrics.count("dwproj_launches", dwproj.launches - launches_before[1])

    # --- multi-process join: every rank finished its owned chunks ---------
    if process_count > 1:
        # spill this rank's Verdict allele counts for rank 0 to gather
        if not args.disable_verdict and verdict_acc:
            np.savez(
                os.path.join(tmp_dir, f"verdict_counts_{process_index}.npz"),
                **{
                    f"{ctg}|{k}": np.concatenate(e[k])
                    for ctg, e in verdict_acc.items()
                    for k in ("pos", "refc", "altc")
                    if e["pos"]
                },
            )
        all_hosts_barrier("chunks_done")
        if process_index != 0:
            print(f"[INFO] Host {process_index}: chunk work done "
                  f"({n_cand} candidates); host 0 merges the output.")
            metrics.report(out=tee)
            return 0
        # rank 0 gathers every rank's per-chunk shards (shared filesystem,
        # deterministic path naming)
        snv_paths = [
            os.path.join(vcf_out, f"p_snv_{c.ctg_name}_{c.chunk_id}.vcf")
            for c in all_chunks
        ]
        indel_paths = [
            os.path.join(vcf_out, f"p_indel_{c.ctg_name}_{c.chunk_id}.vcf")
            for c in all_chunks
        ] if call_indels else []
        missing = [p for p in snv_paths + indel_paths if not os.path.exists(p)]
        if missing:
            sys.exit(f"[ERROR] {len(missing)} chunk shards missing after the "
                     f"host barrier (is --output_dir shared?): {missing[:3]}")
        if not args.disable_verdict:
            for pi in range(1, process_count):
                spill = os.path.join(tmp_dir, f"verdict_counts_{pi}.npz")
                if not os.path.exists(spill):
                    continue
                with np.load(spill) as z:
                    for key in z.files:
                        ctg, k = key.rsplit("|", 1)
                        entry = verdict_acc.setdefault(
                            ctg, {"pos": [], "refc": [], "altc": []}
                        )
                        entry[k].append(z[key])

    # --- merge + postcall (sort_vcf -> PoN -> postprocess, run_clairs_to
    # STEPs 3/5) ----------------------------------------------------------
    snv_merged = os.path.join(vcf_out, "snv_pileup.vcf")
    with metrics.stage("merge"):
        merge_vcf_files(snv_paths, snv_merged)

    if args.panel_of_normals and not args.disable_nonsomatic_tagging:
        from clairs_to_tpu_torch.postcall.nonsomatic import tag_nonsomatic_file

        with metrics.stage("pon_tagging"):
            tag_nonsomatic_file(
                snv_merged, snv_merged,
                args.panel_of_normals.split(","),
                require_allele_matching=(
                    [_str2bool(x) for x in
                     args.panel_of_normals_require_allele_matching.split(",")]
                    if args.panel_of_normals_require_allele_matching
                    else None
                ),
                print_nonsomatic_calls=not args.do_not_print_nonsomatic_calls,
                drop_nonpass=False,
            )

    snv_final = os.path.join(args.output_dir, f"{args.snv_output_prefix}.vcf")
    postprocess_vcf(
        snv_merged, snv_final, platform=args.platform, ref_fn=args.ref_fn,
        sample_name=args.sample_name, qual=args.qual,
        qual_cutoff_phaseable_region=args.qual_cutoff_phaseable_region,
        qual_cutoff_unphaseable_region=args.qual_cutoff_unphaseable_region,
    )

    if genotyping_vcf:
        from clairs_to_tpu_torch.postcall.addback import add_back_missing

        n_added = add_back_missing(snv_final, genotyping_vcf, fasta,
                                   sample_name=args.sample_name)
        if n_added:
            print(f"[INFO] Added back {n_added} missing genotyping sites")

    if not args.disable_verdict:
        with metrics.stage("verdict"):
            _run_verdict_stage(args, verdict_acc, snv_final, gc_lookup, rt_lookup)

    with metrics.stage("tabix"):
        write_tabix_vcf(snv_final)  # snv.vcf.gz + .tbi (final output contract)
    print(f"[INFO] SNV output: {snv_final}")
    if call_indels:
        indel_merged = os.path.join(vcf_out, "indel_pileup.vcf")
        merge_vcf_files(indel_paths, indel_merged)
        indel_final = os.path.join(args.output_dir, f"{args.indel_output_prefix}.vcf")
        postprocess_vcf(
            indel_merged, indel_final, platform=args.platform, ref_fn=args.ref_fn,
            sample_name=args.sample_name, qual=args.qual_indel, is_indel=True,
            qual_cutoff_phaseable_region=args.qual_indel_cutoff_phaseable_region,
            qual_cutoff_unphaseable_region=args.qual_indel_cutoff_unphaseable_region,
        )
        with metrics.stage("tabix"):
            write_tabix_vcf(indel_final)
        print(f"[INFO] Indel output: {indel_final}")
    print(f"[INFO] {n_cand} candidates, total time {time.time() - t0:.1f}s")
    metrics.report(out=tee)
    if args.remove_intermediate_dir:
        import shutil

        shutil.rmtree(tmp_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
