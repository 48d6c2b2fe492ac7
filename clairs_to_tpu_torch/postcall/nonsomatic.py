# Port copy of clairs_to_tpu/postcall/nonsomatic.py.
"""Panel-of-normals (PoN) non-somatic tagging.

Port of ClairS-TO src/nonsomatic_tagging.py semantics: stream each PoN
VCF (gzip, with on-the-fly md5 for provenance), match input PASS calls by
(pos, ref, alt) when allele matching is required for that PoN, else by pos
alone; any hit re-tags the row FILTER=NonSomatic and appends ';PoN_k' flags
to INFO (k = 1-based PoN index); per-PoN ##INFO header lines (file, md5,
allele_matching) are inserted after the RefCall FILTER line
(nonsomatic_tagging.py:436-445, 502-521).
"""

import gzip
import hashlib
import os
from collections import defaultdict


def _file_md5(path):
    md5 = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            md5.update(chunk)
    return md5.hexdigest()


def _open_stream(path, md5_obj=None):
    raw = open(path, "rb")
    data = raw  # md5 over the compressed file bytes

    class _Tee:
        def __init__(self, fp):
            self.fp = fp

        def read(self, n=-1):
            chunk = self.fp.read(n)
            if md5_obj is not None and chunk:
                md5_obj.update(chunk)
            return chunk

        def readable(self):
            return True

    tee = _Tee(raw) if md5_obj is not None else raw
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        import io

        return gzip.GzipFile(fileobj=tee if md5_obj else raw)
    return tee if md5_obj else raw


def iter_pon_records(path, md5_obj=None):
    """Yield (ctg, pos, ref, alt_field) from a PoN VCF (.vcf or .vcf.gz)."""
    stream = _open_stream(path, md5_obj)
    buf = b""
    while True:
        chunk = stream.read(1 << 20)
        if not chunk:
            break
        buf += chunk
        *lines, buf = buf.split(b"\n")
        for line in lines:
            if not line or line.startswith(b"#"):
                continue
            cols = line.split(b"\t", 5)
            if len(cols) < 5:
                continue
            yield (
                cols[0].decode(),
                int(cols[1]),
                cols[3].decode(),
                cols[4].decode(),
            )
    if buf and not buf.startswith(b"#"):
        cols = buf.split(b"\t", 5)
        if len(cols) >= 5:
            yield (cols[0].decode(), int(cols[1]), cols[3].decode(), cols[4].decode())


def tag_nonsomatic_file(
    input_vcf,
    output_vcf,
    pon_paths,
    require_allele_matching=None,
    skip_md5=False,
    print_nonsomatic_calls=True,
    pass_only=True,
    drop_nonpass=True,
):
    """Tag input VCF rows found in any PoN; returns summary dict."""
    if require_allele_matching is None:
        require_allele_matching = [True] * len(pon_paths)

    header_lines = []
    rows = []  # (ctg, pos, columns list, row line)
    opener = gzip.open if input_vcf.endswith(".gz") else open
    with opener(input_vcf, "rt") as f:
        for line in f:
            if line.startswith("#"):
                header_lines.append(line)
                continue
            cols = line.rstrip("\n").split("\t")
            if pass_only and len(cols) >= 7 and cols[6] not in ("PASS",):
                rows.append((cols[0], int(cols[1]), cols, line, False))
                continue
            rows.append((cols[0], int(cols[1]), cols, line, True))

    # candidate keys
    allele_keys = defaultdict(set)   # (ctg,pos,ref,alt) -> row indices
    pos_keys = defaultdict(set)      # (ctg,pos) -> row indices
    for i, (ctg, pos, cols, _line, is_pass) in enumerate(rows):
        if not is_pass:
            continue
        pos_keys[(ctg, pos)].add(i)
        allele_keys[(ctg, pos, cols[3], cols[4])].add(i)

    input_ctgs = sorted({ctg for (ctg, _p) in pos_keys})
    pos_by_ctg = defaultdict(list)
    for (ctg, p) in pos_keys:
        pos_by_ctg[ctg].append(p)

    hits_per_pon = [set() for _ in pon_paths]
    md5s = []
    for k, pon in enumerate(pon_paths):
        require = require_allele_matching[k]

        def apply_one(ctg, pos, ref, alt_field):
            if require:
                for alt in alt_field.split(","):
                    key = (ctg, pos, ref, alt)
                    if key in allele_keys:
                        hits_per_pon[k] |= allele_keys[key]
            else:
                key = (ctg, pos)
                if key in pos_keys:
                    hits_per_pon[k] |= pos_keys[key]

        use_tabix = os.path.exists(pon + ".tbi")
        if use_tabix:
            # tabix fast path (nonsomatic_tagging.py:280-307): fetch only the
            # windows around input calls per contig
            from clairs_to_tpu_torch.vcf.tabix import TabixReader

            try:
                rd = TabixReader(pon)
                for ctg in input_ctgs:
                    if ctg not in rd.name_id:
                        continue
                    positions = sorted(pos_by_ctg[ctg])
                    lo, hi = positions[0] - 1, positions[-1] + 1
                    for line in rd.fetch(ctg, max(lo - 1, 0), hi):
                        cols = line.split("\t", 5)
                        if len(cols) >= 5:
                            apply_one(cols[0], int(cols[1]), cols[3], cols[4])
                md5s.append(
                    "skipped" if skip_md5 else _file_md5(pon)
                )
                continue
            except Exception:
                pass  # fall back to full stream
        md5_obj = None if skip_md5 else hashlib.md5()
        for ctg, pos, ref, alt_field in iter_pon_records(pon, md5_obj):
            apply_one(ctg, pos, ref, alt_field)
        md5s.append("skipped" if skip_md5 else md5_obj.hexdigest())

    tagged = set().union(*hits_per_pon) if hits_per_pon else set()

    # header: insert PoN INFO lines after the RefCall FILTER line
    pon_info_lines = [
        '##INFO=<ID=PoN_{},Number=0,Type=Flag,Description="file={},md5={},'
        'allele_matching={},non-somatic variant tagged by panel of normals">\n'.format(
            k + 1, pon_paths[k], md5s[k], require_allele_matching[k]
        )
        for k in range(len(pon_paths))
    ]
    out_header = []
    inserted = False
    for line in header_lines:
        out_header.append(line)
        if line.startswith('##FILTER=<ID=RefCall'):
            out_header.extend(pon_info_lines)
            inserted = True
    if not inserted and out_header:
        out_header = out_header[:-1] + pon_info_lines + out_header[-1:]

    # By default only candidate rows are written (the reference drops
    # non-PASS rows unless --show_ref; nonsomatic_tagging.py:374-392,
    # 497-529), ordered major contigs first then input-encounter order,
    # positions sorted.  drop_nonpass=False keeps non-candidate rows for
    # pipelines whose hard filters already ran (this framework's CLI tags
    # after the in-memory filter stage, not before like run_clairs_to).
    ctg_rank = {}
    for i, c in enumerate([f"chr{x}" for x in list(range(1, 23)) + ["X", "Y"]]
                          + [str(x) for x in list(range(1, 23)) + ["X", "Y"]]):
        ctg_rank[c] = i
    seen_ctgs = []
    for (ctg, _p, _c, _l, is_pass) in rows:
        if ctg not in ctg_rank and ctg not in seen_ctgs:
            seen_ctgs.append(ctg)
    for j, c in enumerate(seen_ctgs):
        ctg_rank[c] = len(ctg_rank) + j
    order = sorted(
        (i for i, r in enumerate(rows) if r[4] or not drop_nonpass),
        key=lambda i: (ctg_rank.get(rows[i][0], 1 << 30), rows[i][1]),
    )
    n_tagged = 0
    with open(output_vcf + ".tmp", "w") as out:
        out.writelines(out_header)
        for i in order:
            ctg, pos, cols, line, _is_pass = rows[i]
            if i in tagged:
                n_tagged += 1
                if not print_nonsomatic_calls:
                    continue
                cols = list(cols)
                cols[6] = "NonSomatic"
                flags = ";".join(
                    f"PoN_{k + 1}" for k in range(len(pon_paths)) if i in hits_per_pon[k]
                )
                cols[7] = cols[7] + ";" + flags
                out.write("\t".join(cols) + "\n")
            else:
                out.write(line)
    os.replace(output_vcf + ".tmp", output_vcf)
    return {
        "total": sum(1 for r in rows if r[4]),
        "tagged": n_tagged,
        "per_pon": [len(h) for h in hits_per_pon],
        "md5s": md5s,
    }
