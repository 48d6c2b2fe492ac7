"""Whole tumor-only Illumina ``run``s (``-p ilmn``) of one simulated
genome, closed loop: ``traffic/genome_call.py``'s set-up, window, release
and runs, with this cell's check and control on the Illumina reference
(``reference/genome_ilmn.py``).

Set-up builds the reference's expected outcomes before the engines load,
and holds the cell to a genome with a call certain to fail the
realignment filter (one whose every accepted QUAL is under 8 and whose
realignment fails), so that the cell cannot stop driving the filter
unseen: the genome is drawn from the seed, or, where that genome holds no
such call, from ``seed + k * 2**48`` for the least ``k`` up to
``REDRAWS`` that gives one; set-up raises where none does.  The same seed
gives the same genome.

``correct``: every run's four VCFs row by row against the reference, the
``Realignment`` tag and every postfilter tag and ``SB`` included, and each
run's VCFs byte for byte against the warm-up run's.  A row's own QUAL
says whether the program ran the realignment filter on it; where the
filter zeroed QUAL, the reference's QUAL interval says whether it could
have.
"""

import os

import torch

from h100_bench.benchlib import genome_sim
from h100_bench.reference import genome_ilmn as ref_ilmn
from h100_bench.traffic import genome_call as base
from h100_bench.traffic.genome_call import one_run, release, window  # noqa: F401

REALIGN = "Realignment"
REDRAWS = 8


def setup(ctx):
    cache = os.path.join(ctx.cache, "data", "genome_call")
    for k in range(REDRAWS + 1):
        seed = ctx.seed + (k << 48)
        g, files = genome_sim.load_or_make(seed, ctx.spec["genome"], cache)
        state = {"genome": g, "files": files, "genome_seed": seed}
        state["exp"] = _expected(ctx, state)
        if certain_realignment(state["exp"]) is not None:
            break
    else:
        raise RuntimeError(f"seed {ctx.seed}: no genome of {REDRAWS + 1} drawn holds a call "
                           "certain to fail the realignment filter")
    ctx.phase("genome and reference")
    cli = base._cli()
    args = base._args(ctx, files, os.path.join(base._runs_dir(ctx), "engines"))
    state["engines"] = cli.load_engines(args)
    cli.warm_engines(state["engines"])
    ctx.phase("engines")
    state["warm"] = one_run(ctx, state, "warm-up")
    if state["warm"]["rc"] != 0:
        raise RuntimeError(f"the warm-up run failed: {state['warm']['rc']}")
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
        torch.cuda.reset_peak_memory_stats(ctx.device)
    ctx.phase("warm-up run")
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
    pile = ref_ilmn.base.Pileup(g, ctx.device, rules=ref_ilmn.Rules)
    ref_ilmn.base.nets.set_tf32(tf32)
    try:
        return ref_ilmn.Expected(pile, cfg, model_dir, liks, pon,
                                 ctx.spec["prob_delta"] if delta is None else delta,
                                 chunk_size=base._flag(ctx.spec["run_args"], "--chunk_size"))
    finally:
        ref_ilmn.base.nets.set_tf32(False)


def certain_realignment(exp):
    """The first 1-based position whose one accepted SNV call has every
    QUAL under 8 and fails the realignment filter, or None."""
    R = exp.pile.rules
    for pos, acc in sorted(exp.outcomes["snv"].items()):
        if len(acc) != 1 or None in acc:
            continue
        (row, (_qlo, qhi)), = acc.values()
        if qhi < R.realign_below:
            re = exp.realigned(exp.chunk_of(pos), pos, row["ALT"])
            if re is not None and re["fail"]:
                return pos
    return None


def readings(ctx, state, exp=None):
    """The compared numbers of the window's runs, as (name, value)."""
    exp = exp or state["exp"]
    warm = state["warm"]
    n_wrong = cand_gap = runs_differ = 0
    qual_x = sb_gap = 0.0
    for r in [warm] + state["runs"]:
        if r["rc"] != 0:
            continue
        cand_gap = max(cand_gap, abs(r["summary"]["counters"].get("candidates", 0)
                                     - exp.n_candidates))
        v = judge(exp, {k: base.parse_vcf(b) for k, b in r["bytes"].items()})
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
    exp = state["exp"]
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
def judge(exp, vcfs):
    """{rows_wrong, qual_excess, sb_gap} of one run's four VCFs."""
    R = exp.pile.rules
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
            info, fmt = base._info(r["INFO"]), r["FMT"]
            if (fmt.get("GT"), int(fmt.get("DP", -1)), fmt.get("AF"), fmt.get("AD"),
                    base._strands(info)) != (want["GT"], want["DP"], want["AF"], want["AD"],
                                             want["STRANDS"]):
                wrong += 1
                continue
            good.append((r, q, info))
        for pos, acc in exp.outcomes[mode].items():
            if None not in acc and pos not in seen:
                wrong += 1
        for r, (qlo, qhi), info in good:
            tags = set(r["FILTER"].split(";")) - {"LowQual", "PASS", "NonSomatic"}
            same = "H" not in info
            if mode == "indel":
                same &= not tags and "SB" not in info
                failed = set()
            elif REALIGN in tags:
                re = exp.realigned(exp.chunk_of(r["POS"]), r["POS"], r["ALT"])
                same &= qlo < R.realign_below and re is not None and re["fail"]
                same &= r["FILTER"] == "LowQual;" + REALIGN and "SB" not in info
                failed = {REALIGN}
            else:
                # the filter ran where QUAL was under 8; where the postfilter
                # zeroed QUAL, it ran unless every accepted QUAL is 8 or more
                failed, pv = exp.postfilter(exp.chunk_of(r["POS"]), r["POS"], r["ALT"])
                ran = (qhi < R.realign_below) if failed else (r["QUAL"] < R.realign_below)
                if ran:
                    re = exp.realigned(exp.chunk_of(r["POS"]), r["POS"], r["ALT"])
                    same &= re is None or not re["fail"]
                same &= tags == failed
                sbg = max(sbg, abs(float(info["SB"]) - round(pv, 5)) if "SB" in info else 1.0)
            if failed:
                same &= r["FILTER"].split(";")[0] == "LowQual" and r["QUAL"] == 0.0
            else:
                in_pon = mode == "snv" and (r["POS"], r["REF"], r["ALT"]) in exp.pon
                same &= r["FILTER"] == ("NonSomatic" if in_pon else "PASS")
                same &= ("PoN_1" in info) == in_pon
                qx = max(qx, qlo - r["QUAL"], r["QUAL"] - qhi)
            wrong += 0 if same else 1
            pileup[(mode, r["POS"])] = r
    wrong += base._judge_final(exp, vcfs, pileup)
    return {"rows_wrong": wrong, "qual_excess": max(qx, 0.0), "sb_gap": sbg}
