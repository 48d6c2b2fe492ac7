# Port copy of clairs_to_tpu/phasing/phaser.py.
"""Internal read-backed phasing + haplotagging.

The reference shells out to longphase/whatshap for intermediate phasing and
haplotagging (run_clairs_to:1362-1445) — external C++ tools that are not
part of its codebase.  This module makes the framework self-contained: a
greedy read-graph phaser over het germline SNPs (HapCUT-style objective:
orient each het site to maximize agreement with reads already assigned) and
a majority-vote read haplotagger, both operating on the shared entry table.

* ``select_hetero_snps`` mirrors src/select_hetero_snp_for_phasing.py:40-103:
  keep 0/1 SNVs from the germline/pileup VCF and drop the lowest-qual 30%.
* ``phase_het_snps`` returns per-site phase orientation (0: ref->hap1,
  1: alt->hap1) over connected components.
* ``haplotag_reads`` assigns HP in {0,1,2} per read (0 = untagged) and can
  write the assignment back into the entry table's ``hp`` column, after
  which tensor HP channels and the 9-verdict haplotype filter behave exactly
  as with an externally haplotagged BAM.
"""

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np


def select_hetero_snps(records, var_pct_full=0.3):
    """Pick 0/1 SNVs for phasing, dropping the lowest-qual fraction.

    records: iterable of VcfRecord-like (ref_base, alt_base, genotype, qual,
    pos).  Returns sorted list of (pos, ref, alt).
    (select_hetero_snp_for_phasing.py:40-103)
    """
    hets = []
    for rec in records:
        if len(rec.ref_base) != 1 or len(rec.alt_base) != 1:
            continue
        if sorted(rec.genotype) != [0, 1]:
            continue
        try:
            qual = float(rec.qual) if rec.qual is not None else 0.0
        except (TypeError, ValueError):
            qual = 0.0
        hets.append((qual, rec.pos, rec.ref_base, rec.alt_base))
    if not hets:
        return []
    hets.sort()
    cut = int(len(hets) * var_pct_full)
    kept = hets[cut:]
    return sorted((pos, ref, alt) for (_q, pos, ref, alt) in kept)


def _site_read_alleles(pileup_engine, het_sites, min_bq=0, min_mq=20):
    """For each het site: {read_id: allele} with allele 0=ref,1=alt.

    Selects only the entries AT the het sites (via a position mask) before
    sorting — the full entry table can hold 10⁷-10⁸ rows and a whole-table
    argsort would dominate this stage."""
    from clairs_to_tpu_torch.bamio import native

    want = np.unique(np.asarray([p for (p, _r, _a) in het_sites], np.int64))
    if hasattr(pileup_engine, "ensure_sites"):
        pileup_engine.ensure_sites(want, 0)
    a = pileup_engine._finalize()
    groups = native.group_entries_at(a["pos"], want)
    # vectorized entry filter + base decode over ALL het columns at once
    # (instead of a per-entry numpy-scalar loop);
    # per-site dicts are then built from plain-int lists.  A read holds at
    # most one entry per column, so dict insertion order/overwrites match
    # the original loop exactly.
    parts = [np.asarray(groups.get(int(p), ()), np.int64)
             for (p, _r, _a) in het_sites]
    if parts:
        bounds = np.cumsum([0] + [len(x) for x in parts])
        js = (np.concatenate(parts) if bounds[-1] else
              np.zeros(0, np.int64))
        ok = ((a["mq"][js] >= min_mq) & (a["bq"][js] >= min_bq)
              & (a["code"][js] < 8) & (a["ikind"][js] == 0))
        base = (a["code"][js] % 4).astype(np.int8)
        rid = a["read_id"][js]
    out = []
    for k, (p, ref, alt) in enumerate(het_sites):
        ref_code = "ACGT".index(ref)
        alt_code = "ACGT".index(alt)
        s, e = bounds[k], bounds[k + 1]
        m = ok[s:e] & ((base[s:e] == ref_code) | (base[s:e] == alt_code))
        rids = rid[s:e][m].tolist()
        als = (base[s:e][m] == alt_code).astype(np.int8).tolist()
        out.append(dict(zip(rids, als)))
    return out


def phase_het_snps(pileup_engine, het_sites, min_bq=0, min_mq=20):
    """Greedy read-consistency phasing.

    Returns (orientations: list[int] aligned with het_sites, site_alleles).
    orientation o for a site means: allele o goes to haplotype 1.
    """
    site_alleles = _site_read_alleles(pileup_engine, het_sites, min_bq, min_mq)
    orientations = [0] * len(het_sites)
    # read -> accumulated hap1-vote weight (+1 if read looks hap1)
    read_vote: Dict[int, int] = defaultdict(int)
    for k, alleles in enumerate(site_alleles):
        if not alleles:
            continue
        # score orientation 0: ref-carrying reads on hap1
        score0 = 0
        for rid, al in alleles.items():
            v = read_vote.get(rid, 0)
            if v == 0:
                continue
            hap1ish = v > 0
            # orientation 0: allele 0 => hap1
            score0 += 1 if (al == 0) == hap1ish else -1
        o = 0 if score0 >= 0 else 1
        orientations[k] = o
        for rid, al in alleles.items():
            read_vote[rid] += 1 if al == o else -1
    return orientations, site_alleles


def haplotag_reads(n_reads, orientations, site_alleles):
    """Majority-vote HP per read: 1 if most phased sites say hap1, 2 if hap2,
    0 if no information or tie."""
    votes = np.zeros(n_reads, dtype=np.int32)
    for o, alleles in zip(orientations, site_alleles):
        if not alleles:
            continue
        rids = np.fromiter(alleles.keys(), np.int64, len(alleles))
        als = np.fromiter(alleles.values(), np.int64, len(alleles))
        np.add.at(votes, rids, np.where(als == o, 1, -1))
    hp = np.zeros(n_reads, dtype=np.int8)
    hp[votes > 0] = 1
    hp[votes < 0] = 2
    return hp


def apply_haplotags(pileup_engine, hp_per_read):
    """Overwrite the entry table's hp column from a per-read HP array."""
    a = pileup_engine._finalize()
    hp_per_read = np.asarray(hp_per_read, np.int8)
    # single gather pass (int8 source -> int8 result; an astype here would
    # add a full extra copy of a 10^8-entry column)
    a["hp"] = hp_per_read[a["read_id"]]
    pileup_engine._hp = a["hp"]
    # lazy fused-window engines may fetch more entry columns later —
    # remember the per-read tags so re-merges re-apply them
    if getattr(pileup_engine, "_win", None) is not None:
        pileup_engine._hp_per_read = hp_per_read
    return pileup_engine


def phase_and_tag(pileup_engine, het_sites, min_bq=0, min_mq=20):
    """Convenience: phase + haplotag + apply to the entry table.

    Returns the per-read HP array."""
    if getattr(pileup_engine, "_win", None) is not None:
        n_reads = pileup_engine.n_reads  # stable window read count
    else:
        a = pileup_engine._finalize()
        n_reads = int(a["read_id"].max()) + 1 if len(a["read_id"]) else 0
    if not het_sites or n_reads == 0:
        return np.zeros(n_reads, dtype=np.int8)
    orientations, site_alleles = phase_het_snps(
        pileup_engine, het_sites, min_bq, min_mq
    )
    hp = haplotag_reads(n_reads, orientations, site_alleles)
    apply_haplotags(pileup_engine, hp)
    return hp


def phase_het_snps_mst(pileup_engine, het_sites, min_bq=0, min_mq=20):
    """Independent phasing algorithm: exact on a maximum-spanning forest.

    Cross-validation partner for the greedy sequential phaser
    (``phase_het_snps``): a deliberately DIFFERENT formulation so the two
    can check each other (the greedy phaser alone is validated only
    against the simulator's truth).  For any read covering het sites i, j
    with alleles a_i, a_j, the orientations satisfy
    ``o_i XOR o_j == a_i XOR a_j`` on a chimera-free read — so each
    consecutive-site pair accumulates a link weight
    (#equal-allele reads - #opposite-allele reads), and the orientation
    assignment that is EXACT on the maximum-|weight| spanning forest
    follows by propagating signs from each component root.

    Returns (orientations, site_alleles) like phase_het_snps.
    """
    site_alleles = _site_read_alleles(pileup_engine, het_sites, min_bq, min_mq)
    n = len(het_sites)
    orientations = [0] * n
    if n == 0:
        return orientations, site_alleles
    # per-read covered sites -> consecutive-pair link weights
    read_sites = defaultdict(list)
    for k, alleles in enumerate(site_alleles):
        for rid, al in alleles.items():
            read_sites[rid].append((k, al))
    weights = defaultdict(int)   # (i, j) i<j -> agree - disagree
    for sites in read_sites.values():
        sites.sort()
        for (i, ai), (j, aj) in zip(sites, sites[1:]):
            if i == j:
                continue
            weights[(i, j)] += 1 if ai == aj else -1
    # maximum-|w| spanning forest (Kruskal, union-find)
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    edges = sorted(weights.items(), key=lambda kv: -abs(kv[1]))
    adj = defaultdict(list)
    for (i, j), w in edges:
        if w == 0:
            continue
        ri, rj = find(i), find(j)
        if ri == rj:
            continue
        parent[ri] = rj
        adj[i].append((j, w))
        adj[j].append((i, w))
    # propagate orientations from each component root
    seen = [False] * n
    for root in range(n):
        if seen[root]:
            continue
        stack = [root]
        seen[root] = True
        while stack:
            u = stack.pop()
            for (v, w) in adj[u]:
                if seen[v]:
                    continue
                # w > 0: same-allele majority -> equal orientations
                orientations[v] = orientations[u] if w > 0 \
                    else 1 - orientations[u]
                seen[v] = True
                stack.append(v)
    return orientations, site_alleles


def orientation_agreement(o_a, o_b, site_alleles=None):
    """Swap-invariant per-adjacent-pair agreement of two phase solutions:
    the fraction of consecutive site pairs whose RELATIVE orientation
    matches (global hap labels are arbitrary)."""
    n = min(len(o_a), len(o_b))
    if n < 2:
        return 1.0
    same = sum(
        1 for k in range(n - 1)
        if (o_a[k] ^ o_a[k + 1]) == (o_b[k] ^ o_b[k + 1])
    )
    return same / (n - 1)
