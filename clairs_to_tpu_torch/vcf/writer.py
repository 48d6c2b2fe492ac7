# Port copy of clairs_to_tpu/vcf/writer.py.
"""VCF writing with the exact output contract of the reference.

Header/FILTER/INFO/FORMAT definitions and row formatting mirror
ClairS-TO shared/vcf.py:14-182 (same text, same %-formatting) so that
downstream consumers (and byte-level comparisons against reference outputs)
see an identical surface.
"""

import os
from textwrap import dedent

from clairs_to_tpu_torch import config

VCF_HEADER = dedent(
    """\
    ##fileformat=VCFv4.2
    ##source=ClairS-TO
    ##{}_version={}
    ##FILTER=<ID=PASS,Description="All filters passed">
    ##FILTER=<ID=NonSomatic,Description="Non-somatic variant tagged by panel of normals">
    ##FILTER=<ID=LowQual,Description="Low-quality variant">
    ##FILTER=<ID=LowAltBQ,Description="Average alt allele base quality <20">
    ##FILTER=<ID=LowAltMQ,Description="Average alt allele read mapping quality <20">
    ##FILTER=<ID=ReadStartEnd,Description=">30% of the supporting alt alleles are within 100bp of the start or end of a read">
    ##FILTER=<ID=VariantCluster,Description="Three or more variants clustered within 200bp">
    ##FILTER=<ID=NoAncestry,Description="Variant without an ancestral haplotype support">
    ##FILTER=<ID=MultiHap,Description="Alt alleles existed in multiple haplotypes">
    ##FILTER=<ID=StrandBias,Description="Strand bias p-value <0.001">
    ##FILTER=<ID=LowSeqEntropy,Description="Sequence entropy <0.9">
    ##FILTER=<ID=Realignment,Description="For short-read, both the count of supporting alt alleles and AF decreased after realignment">
    ##FILTER=<ID=RefCall,Description="Reference call">
    ##INFO=<ID=Verdict_Germline,Number=0,Type=Flag,Description="Variant tagged by verdict as Germline">
    ##INFO=<ID=Verdict_Somatic,Number=0,Type=Flag,Description="Variant tagged by verdict as Somatic">
    ##INFO=<ID=Verdict_SubclonalSomatic,Number=0,Type=Flag,Description="Variant tagged by verdict as Subclonal Somatic">
    ##INFO=<ID=H,Number=0,Type=Flag,Description="Variant found only in one haplotype in the phased reads">
    ##INFO=<ID=FAU,Number=1,Type=Integer,Description="Count of A in forward strand in the tumor BAM">
    ##INFO=<ID=FCU,Number=1,Type=Integer,Description="Count of C in forward strand in the tumor BAM">
    ##INFO=<ID=FGU,Number=1,Type=Integer,Description="Count of G in forward strand in the tumor BAM">
    ##INFO=<ID=FTU,Number=1,Type=Integer,Description="Count of T in forward strand in the tumor BAM">
    ##INFO=<ID=RAU,Number=1,Type=Integer,Description="Count of A in reverse strand in the tumor BAM">
    ##INFO=<ID=RCU,Number=1,Type=Integer,Description="Count of C in reverse strand in the tumor BAM">
    ##INFO=<ID=RGU,Number=1,Type=Integer,Description="Count of G in reverse strand in the tumor BAM">
    ##INFO=<ID=RTU,Number=1,Type=Integer,Description="Count of T in reverse strand in the tumor BAM">
    ##INFO=<ID=SB,Number=1,Type=Float,Description="The p-value of Fisher’s exact test on strand bias">
    ##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">
    ##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality">
    ##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read depth">
    ##FORMAT=<ID=AF,Number=1,Type=Float,Description="Estimated allele frequency">
    ##FORMAT=<ID=AD,Number=R,Type=Integer,Description="Allelic depths for the ref and alt alleles in the order listed in the ALT column">
    ##FORMAT=<ID=AU,Number=1,Type=Integer,Description="Count of A in the tumor BAM">
    ##FORMAT=<ID=CU,Number=1,Type=Integer,Description="Count of C in the tumor BAM">
    ##FORMAT=<ID=GU,Number=1,Type=Integer,Description="Count of G in the tumor BAM">
    ##FORMAT=<ID=TU,Number=1,Type=Integer,Description="Count of T in the tumor BAM">
    """
).format("clairs_to", config.REFERENCE_VERSION)


class VcfWriter:
    """Streaming VCF writer (contract of shared/vcf.py:65-182)."""

    def __init__(
        self,
        vcf_fn,
        ctg_name=None,
        ref_fn=None,
        sample_name="SAMPLE",
        write_header=True,
        header=None,
        cmdline=None,
        show_ref_calls=False,
    ):
        self.vcf_fn = vcf_fn
        self.show_ref_calls = show_ref_calls
        vcf_folder = os.path.dirname(self.vcf_fn)
        if vcf_folder and not os.path.exists(vcf_folder):
            os.makedirs(vcf_folder, exist_ok=True)
        self.vcf_writer = open(self.vcf_fn, "w")
        self.ref_fn = ref_fn
        self.ctg_name = ctg_name
        if ctg_name is not None:
            self.ctg_name_list = ctg_name.split(",") if "," in ctg_name else [ctg_name]
        else:
            self.ctg_name_list = None
        self.sample_name = sample_name
        if write_header:
            self.write_header(ref_fn=ref_fn, header=header, cmdline=cmdline)

    def close(self):
        try:
            self.vcf_writer.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def write_header(self, ctg_name=None, ref_fn=None, header=None, cmdline=None):
        header = VCF_HEADER if header is None else header
        if cmdline is not None and cmdline != "":
            header_list = header.rstrip("\n").split("\n")
            insert_index = 3 if len(header_list) >= 3 else len(header_list) - 1
            header_list.insert(insert_index, "##cmdline={}".format(cmdline))
            header = "\n".join(header_list) + "\n"
        if self.ref_fn is not None:
            fai_path = self.ref_fn + ".fai"
            if os.path.exists(fai_path):
                with open(fai_path, "r") as fai_fp:
                    for row in fai_fp:
                        columns = row.strip().split("\t")
                        contig_name, contig_size = columns[0], columns[1]
                        if self.ctg_name_list is not None and contig_name not in self.ctg_name_list:
                            continue
                        header += "##contig=<ID=%s,length=%s>\n" % (contig_name, contig_size)
        header += "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t%s\n" % (self.sample_name)
        self.vcf_writer.write(header)

    def write_row(
        self,
        POS=None,
        REF=None,
        ALT=None,
        QUAL=0,
        GT="0/0",
        DP=0,
        AF=0,
        AD=None,
        CHROM=None,
        GQ=None,
        ID=".",
        FILTER=".",
        INFO=".",
        TAF=None,
        VT=None,
        TDP=None,
        AU=None,
        CU=None,
        GU=None,
        TU=None,
        row_str=None,
    ):
        if row_str is not None:
            self.vcf_writer.write(row_str)
            return
        GQ = GQ if GQ else int(float(QUAL))
        CHROM = CHROM if CHROM else self.ctg_name
        if not self.show_ref_calls and (GT == "0/0" or GT == "./."):
            return
        FORMAT = "GT:GQ:DP:AF"
        FORMAT_V = "%s:%d:%d:%.4f" % (GT, GQ, DP, AF)
        basic_vcf_format = "%s\t%d\t%s\t%s\t%s\t%.4f\t%s\t%s" % (
            CHROM,
            int(POS),
            ID,
            REF,
            ALT,
            QUAL,
            FILTER,
            INFO,
        )
        if AD is not None and AD != "":
            FORMAT += ":AD"
            FORMAT_V += ":%s" % (AD)
        if TAF is not None:
            FORMAT += ":TAF"
            FORMAT_V += ":%.4f" % (TAF)
        if TDP is not None:
            FORMAT += ":TDP"
            FORMAT_V += ":%d" % (TDP)
        if AU is not None and CU is not None and GU is not None and TU is not None:
            FORMAT += ":AU:CU:GU:TU"
            FORMAT_V += ":%d:%d:%d:%d" % (AU, CU, GU, TU)
        if VT is not None:
            FORMAT += ":VT"
            FORMAT_V += ":%s" % (VT)
        self.vcf_writer.write("\t".join([basic_vcf_format, FORMAT, FORMAT_V]) + "\n")
