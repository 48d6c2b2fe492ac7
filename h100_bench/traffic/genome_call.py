"""Whole tumor-only ``run``s of one simulated genome, closed loop, through
``cli/run.py::_main_impl`` with the engines loaded and warmed once.

Cell parameters (``workloads/<cell>.json``): ``genome``, the simulated
contig's recipe (``benchlib/genome_sim.py``), and ``run_args``, the run's
flags beside its inputs (``--panel_of_normals`` is the simulated PoN).
Set-up draws the genome from the seed (its files are written once a seed
under ``build/h100_bench/data/genome_call/``), loads and warms the engines
(``load_engines``, ``warm_engines``) and makes one whole warm-up run.  The
window runs whole runs back to back, each into a new output directory,
until ``--seconds`` have passed; the run in progress then finishes and
counts.  ``call_cand_per_s`` is the candidates that the runs handed to the
SNV and indel engines (their ``RunMetricsSummary`` counter ``candidates``)
over the time from the window's start to the end of its last run.

``correct``: every run's SNV and indel VCFs, at the calling stage
(``tmp/vcf_output/*_pileup.vcf``, after the hard filters and the PoN) and
final (``snv.vcf``, ``indel.vcf``), row by row against the plain reference
(``reference/genome.py``), which rebuilds the pileup, the candidates, both
networks, the posterior, the call, the hard filters that need no
haplotags, the PoN and the final gates from the simulator's arrays; and
each run's four VCFs byte for byte against the warm-up run's.
"""

import contextlib
import os
import re
import shutil
import time

import torch

from h100_bench.benchlib import genome_sim
from h100_bench.reference import genome as ref_genome

VCFS = {"snv_pileup": "tmp/vcf_output/snv_pileup.vcf",
        "indel_pileup": "tmp/vcf_output/indel_pileup.vcf",
        "snv": "snv.vcf", "indel": "indel.vcf"}


def _cli():
    from clairs_to_tpu_torch.cli import run as cli

    return cli


def _args(ctx, files, out_dir):
    cfg, spec = ctx.config, ctx.spec
    argv = ["-T", files["bam"], "-R", files["fasta"], "-o", out_dir,
            "--panel_of_normals", files["pon"], "--device", ctx.device.type,
            "--model_dir", ctx.path(cfg["model_dir"]),
            "--matmul_precision", cfg["matmul_precision"], *spec["run_args"]]
    if "device_batch" in spec:
        argv += ["--device_batch", str(spec["device_batch"])]
    return _cli().build_parser().parse_args(argv)


def _flag(argv, name):
    """The integer value of ``name`` in ``argv``, or None."""
    return int(argv[argv.index(name) + 1]) if name in argv else None


def _summary(out_dir):
    with open(os.path.join(out_dir, "run_clairs_to_tpu_torch.log")) as f:
        text = f.read()
    import json

    return json.loads(re.findall(r"RunMetricsSummary: (\{.*\})", text)[-1])


def parse_vcf(data):
    """The body rows of a VCF's bytes, as dicts."""
    rows = []
    for line in data.decode().splitlines():
        if line.startswith("#"):
            continue
        c = line.split("\t")
        fmt = dict(zip(c[8].split(":"), c[9].split(":")))
        rows.append(dict(CHROM=c[0], POS=int(c[1]), REF=c[3], ALT=c[4], QUAL=float(c[5]),
                         FILTER=c[6], INFO=c[7], FMT=fmt))
    return rows


def _runs_dir(ctx):
    """This process's output directories (two processes may share a
    checkout, as the benchmark's tests do)."""
    return os.path.join(ctx.cache, "genome_call", f"runs.{os.getpid()}")


def one_run(ctx, state, name):
    """A whole run into a new directory: its exit code, summary and the
    bytes of its four VCFs (parsed after the window); the directory is
    removed after."""
    out = os.path.join(_runs_dir(ctx), name)
    shutil.rmtree(out, ignore_errors=True)
    args = _args(ctx, state["files"], out)
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        try:
            rc = _cli()._main_impl(args, engines=state["engines"])
        except Exception as e:  # a run that fails counts as failed, not as a crash
            rc = repr(e)
    res = {"name": name, "rc": rc}
    if rc == 0:
        res["summary"] = _summary(out)
        res["bytes"] = {}
        for key, rel in VCFS.items():
            with open(os.path.join(out, rel), "rb") as f:
                res["bytes"][key] = f.read()
    shutil.rmtree(out, ignore_errors=True)
    return res


def setup(ctx):
    g, files = genome_sim.load_or_make(ctx.seed, ctx.spec["genome"],
                                       os.path.join(ctx.cache, "data", "genome_call"))
    ctx.phase("genome")
    cli = _cli()
    args = _args(ctx, files, os.path.join(_runs_dir(ctx), "engines"))
    engines = cli.load_engines(args)
    cli.warm_engines(engines)
    ctx.phase("engines")
    state = {"genome": g, "files": files, "engines": engines}
    state["warm"] = one_run(ctx, state, "warm-up")
    if state["warm"]["rc"] != 0:
        raise RuntimeError(f"the warm-up run failed: {state['warm']['rc']}")
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
        torch.cuda.reset_peak_memory_stats(ctx.device)
    ctx.phase("warm-up run")
    return state


def _counters():
    from clairs_to_tpu_torch.utils import metrics

    return metrics.RECORDER.counters()


def window(ctx, state):
    runs = []
    before = _counters() if ctx.trace else {}
    ctx.start_window()
    k = 0
    while True:
        with ctx.spans.span("genome.run"):
            runs.append(one_run(ctx, state, f"run{k}"))
        k += 1
        if time.perf_counter() - ctx.t_window >= ctx.seconds:
            break
    window_s = ctx.stop_window()
    if ctx.trace:
        after = _counters()
        ctx.counters["program"] = {n: after.get(n, 0) - before.get(n, 0) for n in after}
        # name the device's idle gaps by the run's stages on this thread
        from clairs_to_tpu_torch.utils import metrics

        t0 = ctx.t_window
        for s in metrics.RECORDER.spans(t0, t0 + window_s):
            ctx.spans.items.append((s.name, s.start, s.end))
    ok = [r for r in runs if r["rc"] == 0]
    cand = sum(r["summary"]["counters"].get("candidates", 0) for r in ok)
    ctx.counters.update(window_s=window_s, runs=[
        {"rc": r["rc"], **({"stages": r["summary"]["stages"],
                            "counters": r["summary"]["counters"]} if r["rc"] == 0 else {})}
        for r in runs])
    state["runs"] = runs
    return {"e2e": {"call_cand_per_s": cand / window_s}, "attempted": len(runs),
            "failed": len(runs) - len(ok)}


def release(ctx, state):
    """Frees the engines before the reference runs."""
    state.pop("engines", None)
    shutil.rmtree(_runs_dir(ctx), ignore_errors=True)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return state


def _expected(ctx, state, tf32=False, delta=None):
    cfg = ctx.config
    model_dir = ctx.path(cfg["model_dir"])
    liks = {m: os.path.join(model_dir, ("" if m == "snv" else "indel/") + "likelihood_matrix.txt")
            for m in ("snv", "indel")}
    g = state["genome"]
    pon = set()
    for i in g.pon.tolist():
        ref, alt = genome_sim.variant_strings(g, i)
        pon.add((int(g.var_pos[i]) + 1, ref, alt))
    pile = ref_genome.Pileup(g, ctx.device)
    ref_genome.nets.set_tf32(tf32)
    try:
        return ref_genome.Expected(pile, cfg, model_dir, liks, pon,
                                   ctx.spec["prob_delta"] if delta is None else delta,
                                   chunk_size=_flag(ctx.spec["run_args"], "--chunk_size"))
    finally:
        ref_genome.nets.set_tf32(False)


def readings(ctx, state, exp=None):
    """The compared numbers of the window's runs, as (name, value)."""
    exp = exp or _expected(ctx, state)
    warm = state["warm"]
    n_wrong = cand_gap = runs_differ = 0
    qual_x = sb_gap = 0.0
    for r in [warm] + state["runs"]:
        if r["rc"] != 0:
            continue
        cand_gap = max(cand_gap, abs(r["summary"]["counters"].get("candidates", 0)
                                     - exp.n_candidates))
        v = judge(exp, {k: parse_vcf(b) for k, b in r["bytes"].items()})
        n_wrong += v["rows_wrong"]
        qual_x, sb_gap = max(qual_x, v["qual_excess"]), max(sb_gap, v["sb_gap"])
        if r is not warm and r["bytes"] != warm["bytes"]:
            runs_differ += 1
    return [("rows_wrong", n_wrong), ("candidates_gap", cand_gap), ("qual_excess", qual_x),
            ("sb_gap", sb_gap), ("runs_unlike_warmup", runs_differ)]


def check(ctx, state):
    lim = ctx.spec["limits"]
    return [(n, v, lim[n]) for n, v in readings(ctx, state)]


def control(ctx, state):
    """The control's readings: the reference with TF32 on in the program's
    place (its calls, made by the reference's calling code) against the
    reference."""
    exp = _expected(ctx, state)
    low = _expected(ctx, state, tf32=True, delta=0.0)
    wrong, qx = 0, 0.0
    for mode in ("snv", "indel"):
        for pos, acc in exp.outcomes[mode].items():
            got = low.outcomes[mode][pos]
            key = next(iter(got))             # its posteriors are points: one call
            row, (q, _q) = got[key]
            if key not in acc or row != acc[key][0]:
                wrong += 1
            elif row is not None:
                a, b = acc[key][1]
                qx = max(qx, a - q, q - b)
    return [("rows_wrong", wrong), ("qual_excess", max(qx, 0.0))]


# ------------------------------------------------------------- judging ---
def _info(info):
    out = {}
    for tok in info.split(";"):
        k, _, v = tok.partition("=")
        out[k] = v
    return out


def _strands(info):
    return tuple(int(info[k]) for k in ("FAU", "FCU", "FGU", "FTU", "RAU", "RCU", "RGU", "RTU"))


def judge(exp, vcfs):
    """{rows_wrong, qual_excess, sb_gap} of one run's four VCFs."""
    wrong, qx, sbg = 0, 0.0, 0.0
    pileup = {}
    for mode in ("snv", "indel"):
        seen, good = set(), []
        for r in vcfs[f"{mode}_pileup"]:
            acc = exp.outcomes[mode].get(r["POS"])
            key = (r["REF"], r["ALT"])
            if acc is None or key not in acc or r["POS"] in seen:
                wrong += 1
                continue
            seen.add(r["POS"])
            want, q = acc[key]
            info, fmt = _info(r["INFO"]), r["FMT"]
            if (fmt.get("GT"), int(fmt.get("DP", -1)), fmt.get("AF"), fmt.get("AD"),
                    _strands(info)) != (want["GT"], want["DP"], want["AF"], want["AD"],
                                        want["STRANDS"]):
                wrong += 1
                continue
            good.append((r, want, q, info))
        for pos, acc in exp.outcomes[mode].items():
            if None not in acc and pos not in seen:
                wrong += 1
        # the chunk's phaser and filters, rebuilt from its judged calls
        filters = _filters(exp, [w for _r, w, _q, _i in good]) if mode == "snv" else {}
        for r, want, (qlo, qhi), info in good:
            tags = set(r["FILTER"].split(";")) - {"LowQual", "PASS", "NonSomatic"}
            if mode == "snv":
                failed, phaseable, pv = filters[r["POS"]]
                same = tags == failed & set(ref_genome.HAP_TAGS)
                same &= ("H" in info) == phaseable
                sbg = max(sbg, abs(float(info.get("SB", "nan")) - round(pv, 5))
                          if "SB" in info else 1.0)
            else:
                failed, same = set(), not tags
            if failed:
                same &= r["FILTER"].split(";")[0] == "LowQual" and r["QUAL"] == 0.0
            else:
                in_pon = mode == "snv" and (r["POS"], r["REF"], r["ALT"]) in exp.pon
                same &= r["FILTER"] == ("NonSomatic" if in_pon else "PASS")
                same &= ("PoN_1" in info) == in_pon
                qx = max(qx, qlo - r["QUAL"], r["QUAL"] - qhi)
            wrong += 0 if same else 1
            pileup[(mode, r["POS"])] = r
    wrong += _judge_final(exp, vcfs, pileup)
    return {"rows_wrong": wrong, "qual_excess": max(qx, 0.0), "sb_gap": sbg}


def _filters(exp, calls):
    """{POS: (failed, phaseable, strand p)} of the judged SNV calls, each
    chunk's rebuilt from that chunk's calls."""
    by_chunk = {}
    for w in sorted(calls, key=lambda w: w["POS"]):
        by_chunk.setdefault(exp.chunk_of(w["POS"]), []).append(
            (w["POS"], w["REF"], w["ALT"], w["GT"], w["AFV"]))
    out = {}
    for c, rows in by_chunk.items():
        out.update(exp.filters(c, rows))
    return out


def _final_filter(r, qual, R, is_indel):
    """postprocess: the QUAL gates of a row that stays."""
    filt = r["FILTER"]
    if "RefCall" in filt or "LowQual" in filt:
        return filt, qual
    if qual < R.qual_pass:
        if "NonSomatic" in filt:
            return "LowQual;NonSomatic", 0.0
        filt = "LowQual"
    phaseable = "H" in r["INFO"].split(";") and not is_indel
    if r["FILTER"] == "PASS":
        cut = R.qual_phaseable if phaseable else R.qual_unphaseable
        if qual < cut:
            filt = "LowQual"
    return filt, qual


def _judge_final(exp, vcfs, pileup):
    """The final VCFs against the calling-stage rows through the final gates:
    PASS rows under the AF cutoff dropped, other non-PASS rows' QUAL zeroed
    (NonSomatic kept), the QUAL gates by the row's phaseable flag.  A row
    that Verdict tagged keeps its FILTER unjudged."""
    R = exp.pile.rules
    wrong = 0
    for mode in ("snv", "indel"):
        want = {}
        for (m, pos), r in pileup.items():
            if m != mode:
                continue
            if r["FILTER"] == "PASS" and float(r["FMT"]["AF"]) < R.final_min_af:
                continue
            qual = r["QUAL"] if r["FILTER"] in ("PASS", "NonSomatic", "RefCall") else 0.0
            want[pos] = (r,) + _final_filter(r, qual, R, mode == "indel")
        got = {r["POS"]: r for r in vcfs[mode]}
        wrong += len(set(got) ^ set(want))
        for pos in set(got) & set(want):
            r, (src, filt, qual) = got[pos], want[pos]
            same = (r["REF"], r["ALT"], r["QUAL"]) == (src["REF"], src["ALT"], qual)
            same &= all(r["FMT"].get(k) == src["FMT"].get(k) for k in ("GT", "DP", "AF", "AD"))
            if "Verdict_" not in r["INFO"]:
                same &= r["FILTER"] == filt and r["INFO"] == src["INFO"]
            wrong += 0 if same else 1
    return wrong
