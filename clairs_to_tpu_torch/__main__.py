"""Submodule dispatcher: ``python -m clairs_to_tpu_torch <submodule> [options]``.

Counterpart of clairs_to_tpu/__main__.py, with the same argument surfaces:
``run``, ``serve``, ``train``, ``convert_checkpoint`` and the host stages
that can be called on their own (``sort_vcf``, ``nonsomatic_tagging``,
``postprocess_vcf``, ``gen_contaminated_bam``, ``compare_vcf``).  ``train``
runs on ``cuda`` unless given ``--device cpu``.
"""

import sys

SUBMODULES = {}


def register(name):
    def deco(fn):
        SUBMODULES[name] = fn
        return fn
    return deco


@register("run")
def _run(argv):
    from clairs_to_tpu_torch.cli.run import main
    return main(argv)


@register("serve")
def _serve(argv):
    """Resident warm-engine calling server (clairs_to_tpu_torch/serve.py)."""
    from clairs_to_tpu_torch.serve import main as serve_main

    return serve_main(argv)


@register("compare_vcf")
def _compare_vcf(argv):
    import argparse

    from clairs_to_tpu_torch.bench.compare import compare_vcf, format_report

    p = argparse.ArgumentParser(prog="compare_vcf")
    p.add_argument("--truth_vcf_fn", required=True)
    p.add_argument("--input_vcf_fn", required=True)
    p.add_argument("--ctg_name", default=None)
    p.add_argument("--bed_fn", default=None)
    p.add_argument("--input_filter_tag", default="PASS")
    p.add_argument("--truth_filter_tag", default=None)
    p.add_argument("--skip_genotyping", default="True")
    p.add_argument("--benchmark_indel", action="store_true")
    p.add_argument("--ctg_start", type=int, default=None)
    p.add_argument("--ctg_end", type=int, default=None)
    a = p.parse_args(argv)
    res = compare_vcf(
        a.truth_vcf_fn, a.input_vcf_fn, ctg_name=a.ctg_name, bed_fn=a.bed_fn,
        input_filter_tag=a.input_filter_tag, truth_filter_tag=a.truth_filter_tag,
        skip_genotyping=a.skip_genotyping.lower() in ("1", "true", "yes"),
        benchmark_indel=a.benchmark_indel, ctg_start=a.ctg_start, ctg_end=a.ctg_end,
    )
    print(format_report(res))
    return 0


@register("sort_vcf")
def _sort_vcf(argv):
    import argparse
    import glob
    import os

    from clairs_to_tpu_torch.vcf.sort import merge_vcf_files

    p = argparse.ArgumentParser(prog="sort_vcf")
    p.add_argument("--input_dir", required=True)
    p.add_argument("--vcf_fn_prefix", default="")
    p.add_argument("--vcf_fn_suffix", default=".vcf")
    p.add_argument("--output_fn", required=True)
    a = p.parse_args(argv)
    inputs = sorted(
        glob.glob(os.path.join(a.input_dir, f"{a.vcf_fn_prefix}*{a.vcf_fn_suffix}"))
    )
    n = merge_vcf_files(inputs, a.output_fn)
    print(f"[INFO] {n} rows merged into {a.output_fn}")
    return 0


@register("nonsomatic_tagging")
def _nonsomatic(argv):
    import argparse

    from clairs_to_tpu_torch.postcall.nonsomatic import tag_nonsomatic_file

    p = argparse.ArgumentParser(prog="nonsomatic_tagging")
    p.add_argument("--pileup_vcf_fn", required=True)
    p.add_argument("--output_vcf_fn", required=True)
    p.add_argument("--panel_of_normals", required=True)
    p.add_argument("--panel_of_normals_require_allele_matching", default=None)
    p.add_argument("--skip_pon_md5", action="store_true")
    a = p.parse_args(argv)
    pons = a.panel_of_normals.split(",")
    require = (
        [x.lower() in ("1", "true") for x in a.panel_of_normals_require_allele_matching.split(",")]
        if a.panel_of_normals_require_allele_matching
        else None
    )
    summary = tag_nonsomatic_file(
        a.pileup_vcf_fn, a.output_vcf_fn, pons,
        require_allele_matching=require, skip_md5=a.skip_pon_md5,
    )
    print(f"[INFO] NonSomaticTaggingSummary: total={summary['total']} "
          f"tagged={summary['tagged']} per_pon={summary['per_pon']}")
    return 0


@register("postprocess_vcf")
def _postprocess(argv):
    import argparse

    from clairs_to_tpu_torch.postcall.postprocess import postprocess_vcf

    p = argparse.ArgumentParser(prog="postprocess_vcf")
    p.add_argument("--pileup_vcf_fn", required=True)
    p.add_argument("--output_fn", required=True)
    p.add_argument("--platform", required=True)
    p.add_argument("--ref_fn", default=None)
    p.add_argument("--sample_name", default="SAMPLE")
    p.add_argument("--qual", type=float, default=None)
    p.add_argument("--af", type=float, default=None)
    p.add_argument("--is_indel", action="store_true")
    p.add_argument("--compress_vcf", action="store_true")
    a = p.parse_args(argv)
    postprocess_vcf(
        a.pileup_vcf_fn, a.output_fn, a.platform, ref_fn=a.ref_fn,
        sample_name=a.sample_name, qual=a.qual, af=a.af, is_indel=a.is_indel,
        compress_vcf=a.compress_vcf,
    )
    return 0


@register("gen_contaminated_bam")
def _gen_contaminated(argv):
    import argparse

    from clairs_to_tpu_torch.bamio.simulate import make_dataset

    p = argparse.ArgumentParser(
        prog="gen_contaminated_bam",
        description="Simulate a tumor BAM at a target purity "
                    "(role of src/gen_contaminated_bam.py)",
    )
    p.add_argument("--output_dir", required=True)
    p.add_argument("--purity", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--genome_len", type=int, default=100_000)
    p.add_argument("--coverage", type=int, default=60)
    p.add_argument("--n_snv", type=int, default=20)
    p.add_argument("--n_indel", type=int, default=0)
    p.add_argument("--n_germline", type=int, default=0)
    a = p.parse_args(argv)
    ds = make_dataset(
        a.output_dir, seed=a.seed, genome_len=a.genome_len, coverage=a.coverage,
        n_snv=a.n_snv, n_indel=a.n_indel, n_germline=a.n_germline,
        tumor_purity=a.purity,
    )
    print(f"[INFO] dataset at purity {a.purity}: {ds['bam']}")
    return 0


@register("train")
def _train(argv):
    import argparse

    p = argparse.ArgumentParser(prog="train")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--mode", default="snv", choices=["snv", "indel"])
    p.add_argument("--epochs", type=int, default=70)
    p.add_argument("--n_train", type=int, default=8000)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--dual_view", action="store_true",
                   help="Train with platform-asymmetric AFF/NEG tensor views "
                        "(the reference's dual-BQ design).")
    p.add_argument("--platform", default="ont")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="Where the networks train (default: cuda).")
    a = p.parse_args(argv)
    import os
    from dataclasses import asdict, replace

    import numpy as np

    from clairs_to_tpu_torch.bench.demo import TINY_BIGRU, TINY_CVT
    from clairs_to_tpu_torch.bench.synth import synthesize_batch, synthesize_dual_batch
    from clairs_to_tpu_torch.models.cvt import INDEL_ALLELES
    from clairs_to_tpu_torch.train import (
        DualTrainer, TrainConfig, calibrate_likelihood,
        save_checkpoint, save_likelihood_matrix,
    )

    if a.tiny and a.mode == "indel":
        tiny_cvt = replace(TINY_CVT, alleles=INDEL_ALLELES)
        tiny_gru = replace(TINY_BIGRU, alleles=INDEL_ALLELES)
    else:
        tiny_cvt, tiny_gru = TINY_CVT, TINY_BIGRU

    os.makedirs(a.output_dir, exist_ok=True)
    rng = np.random.default_rng(7)
    kw = dict(depth_range=(25, 95), somatic_af_range=(0.08, 0.35), mode=a.mode)
    if a.dual_view:
        x, x_neg, cov, _covn, som = synthesize_dual_batch(
            rng, a.n_train, platform=a.platform, **kw)
    else:
        x, cov, som = synthesize_batch(rng, a.n_train, **kw)
        x_neg = None
    tr = DualTrainer(
        mode=a.mode,
        tc=TrainConfig(batch_size=256, epochs=a.epochs, learning_rate=a.learning_rate),
        cvt_config=tiny_cvt if a.tiny else None,
        bigru_config=tiny_gru if a.tiny else None,
        device=a.device,
    )
    tr.fit(x, som, rescale_cov=cov, log_every=10, x_neg=x_neg)
    save_checkpoint(os.path.join(a.output_dir, "aff.npz"), tr.models["aff"],
                    arch=asdict(tr.cvt_config))
    save_checkpoint(os.path.join(a.output_dir, "neg.npz"), tr.models["neg"],
                    arch=asdict(tr.bigru_config))
    if a.dual_view:
        xc, xnc, covc, _cn, somc = synthesize_dual_batch(
            np.random.default_rng(55), 3000, platform=a.platform, **kw)
        pa, pn = tr.predict_probs(xc, rescale_cov=covc, x_neg=xnc)
    else:
        xc, covc, somc = synthesize_batch(np.random.default_rng(55), 3000, **kw)
        pa, pn = tr.predict_probs(xc, rescale_cov=covc)
    lik = calibrate_likelihood(pa, pn, somc, n_alleles=len(tr.cvt_config.alleles))
    save_likelihood_matrix(os.path.join(a.output_dir, "likelihood_matrix.txt"), lik)
    print(f"[INFO] checkpoints written to {a.output_dir}")
    return 0


@register("convert_checkpoint")
def _convert(argv):
    from clairs_to_tpu_torch.models.convert import main as convert_main

    return convert_main(argv)


def main():
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print("Usage: python -m clairs_to_tpu_torch <submodule> [options]")
        print("Available submodules:\n  " + "\n  ".join(sorted(SUBMODULES)))
        return 0 if len(sys.argv) >= 2 else 1
    name = sys.argv[1]
    if name not in SUBMODULES:
        print(f"[ERROR] Unknown submodule {name!r}. Available: {sorted(SUBMODULES)}")
        return 1
    return SUBMODULES[name](sys.argv[2:]) or 0


if __name__ == "__main__":
    sys.exit(main())
