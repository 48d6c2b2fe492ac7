"""The port's VCF I/O and file-level post-calling stages against the JAX
package's, on the same seeded inputs: bgzip + tabix writing and reading,
``VcfReader``, PoN tagging (streaming and tabix-indexed), genotyping add-back
and BAQ.  These are host code in both packages, so outputs are held equal to
the byte (files) or to the last bit (arrays)."""

import dataclasses
import gzip
import importlib
import os

import numpy as np
import pytest

PKGS = ("clairs_to_tpu", "clairs_to_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _both(name):
    return tuple(_mod(p, name) for p in PKGS)


HEADER = (
    "##fileformat=VCFv4.2\n"
    '##FILTER=<ID=PASS,Description="All filters passed">\n'
    "##contig=<ID=chr1,length=900000>\n"
    "##contig=<ID=chr2,length=900000>\n"
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSAMPLE\n"
)


def _write_vcf(path, seed, n=400, ctgs=("chr1", "chr2"), span=800_000, indels=True):
    """A sorted VCF of n seeded rows per contig: SNVs, indels, PASS and
    LowQual rows, 0/1 and 1/1 genotypes."""
    rng = np.random.default_rng(seed)
    rows = []
    with open(path, "w") as f:
        f.write(HEADER)
        for ctg in ctgs:
            for pos in np.sort(rng.choice(np.arange(1, span), size=n, replace=False)):
                ref = "ACGT"[int(rng.integers(4))]
                kind = int(rng.integers(6)) if indels else 0
                if kind == 4:
                    alt = ref + "".join(rng.choice(list("ACGT"), size=int(rng.integers(1, 5))))
                elif kind == 5:
                    ref, alt = ref + "".join(rng.choice(list("ACGT"), size=2)), ref
                else:
                    alt = "ACGT"[("ACGT".index(ref) + 1 + int(rng.integers(3))) % 4]
                qual = float(np.round(rng.uniform(0, 40), 4))
                filt = "PASS" if rng.random() < 0.7 else "LowQual"
                gt = "0/1" if rng.random() < 0.8 else "1/1"
                af = float(np.round(rng.uniform(0.05, 1.0), 4))
                f.write(f"{ctg}\t{int(pos)}\t.\t{ref}\t{alt}\t{qual:.4f}\t{filt}\t.\t"
                        f"GT:GQ:DP:AF\t{gt}:{int(qual)}:50:{af:.4f}\n")
                rows.append((ctg, int(pos), ref, alt, filt))
    return rows


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def vcf(tmp_path_factory):
    d = tmp_path_factory.mktemp("vcfio")
    path = str(d / "calls.vcf")
    return path, _write_vcf(path, seed=11)


# --- tabix ---------------------------------------------------------------

def test_write_tabix_vcf_bytes_equal(vcf, tmp_path):
    path, _ = vcf
    outs = []
    for pkg in PKGS:
        out = str(tmp_path / f"{pkg}.vcf.gz")
        _mod(pkg, "vcf.tabix").write_tabix_vcf(path, out)
        outs.append(out)
    assert _read(outs[0]) == _read(outs[1])
    assert _read(outs[0] + ".tbi") == _read(outs[1] + ".tbi")
    # a real gzip stream that holds the input
    with gzip.open(outs[1], "rb") as f:
        assert f.read() == _read(path)


@pytest.mark.parametrize("writer,reader", [(PKGS[0], PKGS[1]), (PKGS[1], PKGS[0]),
                                           (PKGS[1], PKGS[1])])
def test_tabix_reader_reads_other_packages_files(vcf, tmp_path, writer, reader):
    path, rows = vcf
    out = str(tmp_path / "x.vcf.gz")
    _mod(writer, "vcf.tabix").write_tabix_vcf(path, out)
    tr = _mod(reader, "vcf.tabix").TabixReader(out)
    rng = np.random.default_rng(3)
    for _ in range(40):
        ctg = ("chr1", "chr2")[int(rng.integers(2))]
        lo = int(rng.integers(0, 790_000))
        hi = lo + int(rng.integers(1, 60_000))
        got = [(c[0], int(c[1])) for c in
               (line.split("\t") for line in tr.fetch(ctg, lo, hi))]
        want = [(c, p) for (c, p, *_rest) in rows if c == ctg and lo < p <= hi]
        assert got == want, (ctg, lo, hi)
    assert list(tr.fetch("chrNone", 0, 1000)) == []


def test_bgzf_writer_virtual_offsets_equal():
    import io

    rng = np.random.default_rng(5)
    chunks = [bytes(rng.integers(65, 91, size=int(n), dtype=np.uint8))
              for n in rng.integers(1, 90_000, size=12)]
    results = []
    for mod in _both("vcf.tabix"):
        buf = io.BytesIO()
        w = mod.BgzfWriter(buf)
        offs = []
        for c in chunks:
            w.write(c)
            offs.append(w.tell_virtual)
        w.close()
        results.append((buf.getvalue(), offs))
    assert results[0] == results[1]
    assert gzip.decompress(results[1][0]) == b"".join(chunks)


def test_bam_writer_uses_the_ports_bgzf(tmp_path):
    """write_bam goes through the port's vcf/tabix.py BgzfWriter: same bytes
    as the JAX package's BAM and index."""
    outs = []
    for pkg in PKGS:
        bw = _mod(pkg, "bamio.bam_writer")
        recs = [bw.encode_record(f"r{i}", 0, 0, 10 * i, 60, [("M", 50)], "ACGTA" * 10,
                                 [30] * 50) for i in range(200)]
        path = str(tmp_path / f"{pkg}.bam")
        bw.write_bam(path, ["c"], [5000], recs)
        outs.append(path)
    assert _read(outs[0]) == _read(outs[1])
    assert _read(outs[0] + ".bai") == _read(outs[1] + ".bai")


# --- VcfReader -----------------------------------------------------------

READER_KW = [
    dict(),
    dict(ctg_name="chr1"),
    dict(ctg_name="chr1,chr2", filter_tag="PASS"),
    dict(ctg_name="chr2", ctg_start=100_000, ctg_end=400_000, keep_af=True),
    dict(show_ref=True, skip_genotype=True),
    dict(discard_indel=True, min_qual=8.0),
    dict(discard_snv=True, max_qual=30.0, keep_row_str=True, save_header=True),
]


@pytest.mark.parametrize("kw", READER_KW, ids=[",".join(k) or "default" for k in READER_KW])
@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
def test_vcf_reader_same_records(vcf, tmp_path, kw, gz):
    path, _ = vcf
    if gz:
        out = str(tmp_path / "in.vcf.gz")
        _mod(PKGS[0], "vcf.tabix").write_tabix_vcf(path, out)  # the other package's file
        path = out
    got = []
    for mod in _both("vcf.reader"):
        r = mod.VcfReader(path, **kw)
        r.read_vcf()
        got.append((r.header, {k: dataclasses.asdict(v) for k, v in r.variant_dict.items()}))
    assert got[0][1], "reader kept no record"
    assert got[0] == got[1]


# --- PoN tagging ---------------------------------------------------------

@pytest.fixture(scope="module")
def pon(tmp_path_factory, vcf):
    """A PoN sharing sites with the calls: some with the same alleles, some
    by position only; written plain, and bgzipped + indexed by the port."""
    from clairs_to_tpu_torch.vcf.tabix import write_tabix_vcf

    _, rows = vcf
    d = tmp_path_factory.mktemp("pon")
    rng = np.random.default_rng(17)
    path = str(d / "pon.vcf")
    with open(path, "w") as f:
        f.write(HEADER)
        for (ctg, pos, ref, alt, _filt) in rows:
            u = rng.random()
            if u < 0.25:
                f.write(f"{ctg}\t{pos}\t.\t{ref}\t{alt}\t.\t.\t.\n")
            elif u < 0.4:
                f.write(f"{ctg}\t{pos}\t.\t{ref}\tN\t.\t.\t.\n")
            elif u < 0.5:
                f.write(f"{ctg}\t{pos + 1}\t.\tA\tC\t.\t.\t.\n")
    gz = str(d / "pon_indexed.vcf.gz")
    write_tabix_vcf(path, gz)
    assert os.path.exists(gz + ".tbi")
    return path, gz


@pytest.mark.parametrize("allele_matching", [True, False], ids=["alleles", "position"])
@pytest.mark.parametrize("indexed", [False, True], ids=["streamed", "tabix"])
@pytest.mark.parametrize("print_calls", [True, False], ids=["print", "drop"])
def test_tag_nonsomatic_file_bytes_equal(vcf, pon, tmp_path, allele_matching, indexed,
                                         print_calls):
    path, _ = vcf
    pon_path = pon[1] if indexed else pon[0]
    outs, summaries = [], []
    for pkg in PKGS:
        out = str(tmp_path / f"{pkg}.vcf")
        summaries.append(_mod(pkg, "postcall.nonsomatic").tag_nonsomatic_file(
            path, out, [pon_path], require_allele_matching=[allele_matching],
            print_nonsomatic_calls=print_calls, drop_nonpass=False))
        outs.append(out)
    assert _read(outs[0]) == _read(outs[1])
    assert summaries[0] == summaries[1]
    body = _read(outs[1]).decode()
    if print_calls:
        assert "NonSomatic" in body and "PoN_1" in body
    else:
        assert body.count("\n") < _read(path).decode().count("\n")


def test_tag_nonsomatic_two_pons_mixed_modes(vcf, pon, tmp_path):
    path, _ = vcf
    outs = []
    for pkg in PKGS:
        out = str(tmp_path / f"{pkg}.vcf")
        _mod(pkg, "postcall.nonsomatic").tag_nonsomatic_file(
            path, out, [pon[0], pon[1]], require_allele_matching=[True, False],
            drop_nonpass=False)
        outs.append(out)
    assert _read(outs[0]) == _read(outs[1])
    assert "PoN_2" in _read(outs[1]).decode()


# --- genotyping add-back -------------------------------------------------

def test_add_back_missing_equal(tmp_path):
    rng = np.random.default_rng(23)
    seq = "".join(rng.choice(list("ACGT"), size=5000))
    fa = str(tmp_path / "ref.fa")
    with open(fa, "w") as f:
        f.write(">chr1\n")
        for i in range(0, len(seq), 60):
            f.write(seq[i:i + 60] + "\n")
    sites = str(tmp_path / "sites.vcf")
    _write_vcf(sites, seed=31, n=60, ctgs=("chr1",), span=5000, indels=False)
    called = str(tmp_path / "called.vcf")
    with open(sites) as f, open(called, "w") as g:
        body = 0
        for line in f:
            if line.startswith("#"):
                g.write(line)
            else:
                body += 1
                if body % 3:
                    g.write(line)
    outs = []
    for pkg in PKGS:
        out = str(tmp_path / f"{pkg}.vcf")
        with open(called) as f, open(out, "w") as g:
            g.write(f.read())
        fasta = _mod(pkg, "genome.fasta").FastaFile(fa)
        n = _mod(pkg, "postcall.addback").add_back_missing(out, sites, fasta,
                                                           sample_name="S")
        assert n == 20
        outs.append(out)
    assert _read(outs[0]) == _read(outs[1])
    lines = [l for l in _read(outs[1]).decode().splitlines() if not l.startswith("#")]
    assert len(lines) == 60 and sum("RefCall" in l for l in lines) == 20
    for l in lines:
        c = l.split("\t")
        if c[6] == "RefCall":
            assert c[3] == seq[int(c[1]) - 1]


# --- BAQ -----------------------------------------------------------------

def _baq_case(seed):
    rng = np.random.default_rng(seed)
    ref = "".join(rng.choice(list("ACGT"), size=180))
    lo = int(rng.integers(0, 40))
    read = list(ref[lo:lo + 110])
    for i in rng.choice(len(read), size=int(rng.integers(0, 6)), replace=False):
        read[i] = "ACGT"[int(rng.integers(4))]
    if seed % 3 == 0:
        del read[50:54]
    if seed % 4 == 0:
        read[30:30] = list("TTG")
    quals = rng.integers(2, 41, size=len(read))
    return ref, "".join(read), quals


@pytest.mark.parametrize("seed", range(8))
def test_baq_equal(seed):
    ref, read, quals = _baq_case(seed)
    j, t = _both("bamio.baq")
    np.testing.assert_array_equal(j.baq_glocal(ref, read, quals), t.baq_glocal(ref, read, quals))
    a, b = j.apply_baq(ref, read, quals), t.apply_baq(ref, read, quals)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == b.dtype and (b <= quals).all()
