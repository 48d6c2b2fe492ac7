# Port copy of clairs_to_tpu/infer/pipeline.py.
"""End-to-end per-chunk somatic calling pipeline.

Reference call path (run_clairs_to:1181-1317 STEPs 1-2): per (contig, chunk),
extract_candidates -> create_tensor (AFF + NEG mpileup passes) -> predict ->
call_variants -> per-chunk VCF, all as separate GNU-parallel processes with
file handoff.  Here it is one resident process per host: BAM decoded once per
chunk, both tensor views derived from the same event table (bamio/pileup.py),
candidates batched into the GPU engine, VCF rows written directly.

The dual-view asymmetry (SURVEY.md §2.2): the AFF tensor uses the platform
min_bq, the NEG tensor min_bq=0 (run_clairs_to:1237 vs :1264); for Illumina
and HiFi (min_bq 0) the views coincide and are computed once.
"""

import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from clairs_to_tpu_torch import config as cfg
from clairs_to_tpu_torch.bamio.bam import BamFile
from clairs_to_tpu_torch.bamio.pileup import PileupEngine
from clairs_to_tpu_torch.genome.chunks import Chunk
from clairs_to_tpu_torch.infer.calling import CandidateRecord, emit_calls
from clairs_to_tpu_torch.infer.engine import InferenceEngine
from clairs_to_tpu_torch.utils import metrics as tracing

FLANK = cfg.FLANKING_BASE_NUM
WIN = cfg.NO_OF_POSITIONS


def chunk_id(chunk: Chunk) -> str:
    """The id that a chunk's spans carry, unique within a run."""
    return f"{chunk.ctg_name}:{chunk.chunk_id}"


@dataclass
class PipelineOptions:
    platform: str = "ont"
    snv_min_af: float = cfg.SNV_MIN_AF
    indel_min_af: float = cfg.INDEL_MIN_AF
    min_coverage: int = cfg.MIN_COVERAGE
    alternative_base_num: int = cfg.ALTERNATIVE_BASE_NUM
    qual_cutoff: Optional[float] = 0
    show_ref: bool = False
    select_indel_candidates: bool = False
    max_indel_length: int = cfg.MAX_INDEL_LENGTH
    handle_overlaps: bool = True
    phase_tensor: bool = False
    use_native: bool = True   # C++ decoder when available (bamio/native)
    # genotyping (-G) / hybrid (-H) modes (extract_candidates:225-237,347-380):
    # {ctg: sorted positions (0-based)} of requested sites; 'genotyping'
    # restricts candidates to these sites, 'hybrid' unions with discovery
    genotyping_sites: Optional[dict] = None
    genotyping_mode: Optional[str] = None  # 'genotyping' | 'hybrid' | None
    # EXPERIMENTAL: probabilistic realignment base-quality capping
    # (samtools mpileup's default-on BAQ; see bamio/baq.py for status)
    apply_baq: bool = False
    # region restriction (run_clairs_to -b/--bed_fn): BedTree or None
    bed_tree: object = None
    # indel candidates only inside these regions
    # (--call_indels_only_in_these_regions, extract_candidates:391-404)
    indel_bed_tree: object = None
    # DEBUG: dump network probabilities as the reference's predict --predict_fn
    # 15/19-column TSV (predict.py:114-152); path template gets .snv/.indel
    predict_fn: Optional[str] = None
    # DEBUG: dump passing candidate sites as the reference's --alt_fn file
    # (extract_candidates_calling.py:314-355): ctg pos ref [depth] [alt infos]
    alt_fn: Optional[str] = None
    output_depth: bool = False
    output_alt_info: bool = False
    # precompute the window filter-index assembly during build_chunk_views
    # (i.e. on the decode-ahead worker) so the verdict stage starts from
    # ready state; set by the CLI when a filter stage will run
    precompute_filter_assembly: bool = False
    # decode-ahead worker threads (CLI: min(threads-1, 4)).  Each worker
    # keeps its own native stream; a worker whose next window regresses
    # reopens a fresh stream (BAI fast-seek), so dynamic chunk assignment
    # across workers stays cheap on many-core hosts
    decode_workers: int = 1


@dataclass
class ChunkResult:
    chunk: Chunk
    snv_rows: List[dict] = field(default_factory=list)
    indel_rows: List[dict] = field(default_factory=list)
    n_candidates: int = 0


@dataclass
class PendingChunkCall:
    """A dispatched chunk: device batches in flight, host state retained.

    Produced by ``dispatch_chunk``; ``finish_chunk`` consumes it.  The
    split lets the CLI overlap chunk N's device round trip with chunk
    N+1's host-side candidate prep."""

    chunk: Chunk
    n_candidates: int = 0
    snv_job: Optional[dict] = None     # _dispatch_positions output
    indel_job: Optional[dict] = None


class _Resolved:
    """Pre-resolved PendingBatch stand-in for synchronous engines."""

    def __init__(self, res):
        self._res = res

    def result(self):
        return self._res


class CallingPipeline:
    """Single-host pipeline: BAM chunk -> candidates -> tensors -> calls."""

    def __init__(
        self,
        fasta,                      # genome.fasta.FastaFile
        bam_path: str,
        snv_engine: InferenceEngine,
        indel_engine: Optional[InferenceEngine] = None,
        options: PipelineOptions = None,
        metrics=None,
    ):
        self.fasta = fasta
        self.bam_path = bam_path
        self.snv_engine = snv_engine
        self.indel_engine = indel_engine
        self.opt = options or PipelineOptions()
        self.metrics = metrics  # optional RunMetrics for sub-stage timing
        import threading as _threading

        # per decode worker: its native stream, its pure-Python fallback reader
        self._tls = _threading.local()
        self._streams = []               # every stream opened (for close)
        self._views_memo = {}     # chunk -> views: calling/filters/prefetch share decodes
        self.platform = cfg.platform_family(self.opt.platform)
        self.aff_min_bq = cfg.MIN_BQ_DICT.get(self.opt.platform,
                                              cfg.MIN_BQ_DICT.get(self.platform, 0))

    # ------------------------------------------------------------------
    def build_chunk_views(self, chunk: Chunk):
        """Decode reads once; return (engine, aff_counts, neg_counts,
        aff_depth, neg_depth, region_start) with ref encoding applied.

        Region spans [ctg_start - 33, ctg_end + 33) 0-based like the
        reference's extended mpileup region (create_tensor:405-412).
        """
        if chunk in self._views_memo:
            return self._views_memo[chunk]
        # decode runs on the prefetch worker, overlapping device compute and
        # engine load: its own (concurrent) stage
        with self._stage("decode_tensor_build(worker)", chunk):
            views = self._decode_views(chunk)
        self._views_memo[chunk] = views
        return views

    def _decode_views(self, chunk: Chunk):
        ctg = chunk.ctg_name
        ctg_len = self.fasta.contig_length(ctg)
        region_start = max(chunk.ctg_start - WIN, 0)
        region_end = min(chunk.ctg_end + WIN, ctg_len)
        ref_start = max(region_start - cfg.EXPAND_REFERENCE_REGION, 0)
        ref_end = min(region_end + cfg.EXPAND_REFERENCE_REGION, ctg_len)
        ref_seq = self.fasta.fetch(ctg, ref_start, ref_end)

        pe = None
        if self.opt.use_native and not self.opt.apply_baq:
            from clairs_to_tpu_torch.bamio import native

            if native.available():
                stream = getattr(self._tls, "stream", None)
                if stream is None:
                    stream = native.BamStreamReader(self.bam_path)
                    self._tls.stream = stream
                    self._streams.append(stream)
                # fused decode+reduce (round 4): dense dual-BQ channel
                # counts + candidate stats in ONE pass, entry columns
                # fetched lazily per site window — the full entry table
                # (7.7GB first-touch per 4Mb@60x chunk) is never built
                # filter-view stats accumulate in the same pass so the
                # hard/haplotype filter stage needs no entry fetch at all
                f_lo = region_start - native.FILT_MARGIN
                f_hi = region_end + native.FILT_MARGIN
                ref_tok = np.full(f_hi - f_lo, 10, np.int16)
                ref_u8 = np.frombuffer(
                    ref_seq.upper().encode("latin-1"), np.uint8)
                s_lo = max(f_lo - ref_start, 0)
                s_hi = min(f_hi - ref_start, len(ref_u8))
                if s_hi > s_lo:
                    from clairs_to_tpu_torch.postcall.hardfilter import _REF_TOK

                    ref_tok[s_lo + ref_start - f_lo : s_hi + ref_start - f_lo] = \
                        _REF_TOK[ref_u8[s_lo:s_hi]]
                def _reduced(stream_):
                    return stream_.load_window_reduced(
                        ctg, region_start, region_end,
                        excl_flags=cfg.SAMTOOLS_VIEW_FILTER_FLAG,
                        handle_overlaps=self.opt.handle_overlaps,
                        aff_min_bq=self.aff_min_bq,
                        low_mq_thresh=cfg.LOW_MQ_THRESHOLD,
                        low_bq_thresh=cfg.LOW_BQ_THRESHOLD.get(
                            self.platform, 10),
                        max_indel_length=self.opt.max_indel_length,
                        with_phasing=self.opt.phase_tensor,
                        cand_min_mq=cfg.MIN_MQ,
                        filter_view=(ref_tok, cfg.MIN_BQ, cfg.MIN_MQ),
                    )

                win = _reduced(stream)
                if win is None:
                    # regressed window (dynamic multi-worker assignment):
                    # reopen — the fresh stream BAI-seeks to the window;
                    # the dense-arena pool moves over so no re-fault
                    pool = stream._flat_pool
                    stream._flat_pool = []
                    stream.close()
                    try:
                        self._streams.remove(stream)
                    except ValueError:
                        pass
                    stream = native.BamStreamReader(self.bam_path)
                    stream._flat_pool = pool
                    self._tls.stream = stream
                    self._streams.append(stream)
                    win = _reduced(stream)
                if win is not None:
                    pe = PileupEngine.from_native_window(
                        win, ref_seq, ref_start,
                        platform=self.opt.platform,
                        max_indel_length=self.opt.max_indel_length,
                    )
                else:
                    table = stream.load_window(
                        ctg, region_start, region_end,
                        excl_flags=cfg.SAMTOOLS_VIEW_FILTER_FLAG,
                        handle_overlaps=self.opt.handle_overlaps,
                    )
                    pe = PileupEngine.from_entry_table(
                        table, ref_seq, ref_start,
                        platform=self.opt.platform,
                        max_indel_length=self.opt.max_indel_length,
                    )
        if pe is None:
            bam = getattr(self._tls, "bam", None)
            if bam is None:
                bam = self._tls.bam = BamFile(self.bam_path)
            pe = PileupEngine(
                ref_seq,
                ref_start,
                platform=self.opt.platform,
                max_indel_length=self.opt.max_indel_length,
                handle_overlaps=self.opt.handle_overlaps,
            )
            for read in bam.fetch(
                ctg, region_start, region_end, excl_flags=cfg.SAMTOOLS_VIEW_FILTER_FLAG
            ):
                if self.opt.apply_baq:
                    from clairs_to_tpu_torch.bamio.baq import apply_baq

                    span_lo = max(read.pos - 7, ref_start)
                    span_hi = min(read.reference_end() + 7, ref_start + len(ref_seq))
                    window = ref_seq[span_lo - ref_start : span_hi - ref_start]
                    read.qual = apply_baq(window, read.seq, read.qual).astype(
                        read.qual.dtype
                    )
                pe.add_read(read)

        aff_counts, aff_depth = pe.channel_counts(
            self.aff_min_bq, region_start, region_end,
            with_phasing=self.opt.phase_tensor,
        )
        if self.aff_min_bq == 0:
            neg_counts, neg_depth = aff_counts, aff_depth
        else:
            neg_counts, neg_depth = pe.channel_counts(
                0, region_start, region_end, with_phasing=self.opt.phase_tensor
            )
        pe.apply_reference_encoding(aff_counts, region_start)
        if neg_counts is not aff_counts:
            pe.apply_reference_encoding(neg_counts, region_start)
        if (self.opt.precompute_filter_assembly
                and getattr(pe, "_win", None) is not None
                and pe._win.has_filter_data):
            pe._win.filter_assembly()
        return (pe, aff_counts, neg_counts, region_start, region_end)

    def _window(self, counts, center, region_start):
        i = center - region_start
        return counts[i - FLANK : i + FLANK + 1, : cfg.PILEUP_CHANNEL_SIZE]

    def _dump_probabilities(self, chunk, positions, pe, aff_alt, batch, mode):
        """predict.py print_output_message TSV: ctg pos ref alt_info fwd rev
        then per-allele 'p0 p1' pairs for AFF and NEG."""
        import os

        path = f"{self.opt.predict_fn}.{mode}"
        new = not os.path.exists(path)
        with open(path, "a") as f:
            for i, p in enumerate(positions):
                cols = [
                    chunk.ctg_name, str(p + 1), pe._ref_base(p), aff_alt[p][0],
                    str([float(v) for v in batch.forward_acgt[i]]),
                    str([float(v) for v in batch.reverse_acgt[i]]),
                ]
                for k in range(batch.p_aff.shape[1]):
                    cols.append("{:0.8f} {:0.8f}".format(
                        1.0 - batch.p_aff[i, k], batch.p_aff[i, k]))
                for k in range(batch.p_neg.shape[1]):
                    cols.append("{:0.8f} {:0.8f}".format(
                        1.0 - batch.p_neg[i, k], batch.p_neg[i, k]))
                f.write("\t".join(cols) + "\n")

    def _dump_alt_fn(self, chunk, positions, infos):
        """extract_candidates_calling.py:352-355 --alt_fn debug dump,
        byte-compatible: per passing candidate
        ``ctg<TAB>pos<TAB>ref[<TAB>depth][<TAB>af_infos<TAB>pileup_infos
        <TAB>tumor_pileup_infos]`` — af_infos is the comma-joined rounded
        AF of every non-ref pileup_list key, pileup_infos the space-joined
        ``KEY:af`` of the uppercased alt entries, tumor_pileup_infos empty
        outside tumor-labelled paths (so the row keeps its trailing tab,
        as the reference's '\t'.join of the 3-element list does).
        Positions are 1-based mpileup coordinates."""
        with open(self.opt.alt_fn, "a") as f:
            for p in positions:
                info = infos.get(p)
                if info is None:
                    continue
                rb = self._ref_base_of(chunk, p)
                denom = info.depth if info.depth > 0 else 1
                cols = [chunk.ctg_name, str(p + 1), rb]
                if self.opt.output_depth:
                    cols.append(str(info.depth))
                if self.opt.output_alt_info:
                    af_infos = ",".join(
                        str(round(c / denom, 3))
                        for (k, c) in (info.pileup_list or [])
                        if k != rb)
                    pileup_infos = " ".join(
                        f"{k}:{round(c / denom, 3)}"
                        for (k, c) in info.alt_list)
                    cols += [af_infos, pileup_infos, ""]
                f.write("\t".join(cols) + "\n")

    def _ref_base_of(self, chunk, pos):
        views = self._views_memo.get(chunk)
        if views is not None:
            return views[0]._ref_base(pos)
        return self.fasta.fetch(chunk.ctg_name, pos, pos + 1)

    def evict_views(self, chunk):
        views = self._views_memo.pop(chunk, None)
        if views is not None:
            win = getattr(views[0], "_win", None)
            if win is not None:
                # release the C++ record retention and pool the dense arena
                # (back to the stream that created the window)
                win.close()
                return
            table = getattr(views[0], "_table", None)
            if table is not None and self._streams:
                # all views into the entry table are dropped with the memo;
                # hand the arena back for the next window's decode
                self._streams[-1].recycle(table)

    def iter_chunks(self, chunks, prefetch_depth=2):
        """Yield (chunk, views) with decode-ahead on a worker thread.

        The host decode of chunk N+1 (BGZF inflate + entry expansion + C++
        reductions, which release the GIL) overlaps the device compute of
        chunk N — the in-process analog of the reference's loader/compute
        thread pair (clairs/predict.py:610-718).  A single worker keeps the
        streaming BAM reader strictly sequential."""
        from clairs_to_tpu_torch.parallel.scheduler import PrefetchPipeline

        workers = max(1, int(self.opt.decode_workers))
        return PrefetchPipeline(
            self.build_chunk_views, chunks,
            depth=max(prefetch_depth, workers + 1), workers=workers,
        )

    # ------------------------------------------------------------------
    def _stage(self, name, chunk):
        """A stage of ``metrics``, or a bare span without them; either
        carries the chunk's id."""
        cid = chunk_id(chunk)
        if self.metrics is not None:
            return self.metrics.stage(name, cid)
        return tracing.span(name, cid)

    def call_chunk(self, chunk: Chunk) -> ChunkResult:
        return self.finish_chunk(self.dispatch_chunk(chunk))

    def dispatch_chunk(self, chunk: Chunk) -> PendingChunkCall:
        opt = self.opt
        with self._stage("decode_tensor_build", chunk):
            pe, aff_counts, neg_counts, region_start, region_end = \
                self.build_chunk_views(chunk)

        requested = []
        if opt.genotyping_mode and opt.genotyping_sites:
            requested = [
                p for p in opt.genotyping_sites.get(chunk.ctg_name, [])
                if chunk.ctg_start <= p < chunk.ctg_end
                and pe._ref_base(p) in "ACGT"
            ]
        if opt.genotyping_mode == "genotyping":
            snv_pos, indel_pos = requested, []
        else:
            with self._stage("find_candidates", chunk):
                snv_pos, indel_pos, infos = pe.find_candidates(
                    chunk.ctg_start, chunk.ctg_end,
                    min_bq=self.aff_min_bq,
                    min_coverage=opt.min_coverage,
                    snv_min_af=opt.snv_min_af,
                    indel_min_af=opt.indel_min_af,
                    alternative_base_num=opt.alternative_base_num,
                    select_indel_candidates=opt.select_indel_candidates,
                    # CandidateInfo bookkeeping feeds only the --alt_fn
                    # debug dump; skipping it selects the C++ gate
                    with_infos=bool(opt.alt_fn),
                )
            if opt.genotyping_mode == "hybrid":
                snv_pos = sorted(set(snv_pos) | set(requested))
        if opt.bed_tree is not None and len(opt.bed_tree):
            snv_pos = [
                p for p in snv_pos
                if opt.bed_tree.is_region_in(chunk.ctg_name, p, p + 1)
            ]
            indel_pos = [
                p for p in indel_pos
                if opt.bed_tree.is_region_in(chunk.ctg_name, p, p + 1)
            ]
        if opt.indel_bed_tree is not None and len(opt.indel_bed_tree):
            indel_pos = [
                p for p in indel_pos
                if opt.indel_bed_tree.is_region_in(chunk.ctg_name, p, p + 1)
            ]
        if opt.alt_fn and opt.genotyping_mode != "genotyping":
            # the reference writes EVERY pass_af position — including ones
            # the candidate sets later drop for lacking a matching alt
            # entry (extract_candidates_calling.py:352-363)
            self._dump_alt_fn(chunk, sorted(infos), infos)

        pending = PendingChunkCall(
            chunk=chunk, n_candidates=len(snv_pos) + len(indel_pos))
        pending.snv_job = self._dispatch_positions(
            pe, chunk, snv_pos, aff_counts, neg_counts, region_start, region_end,
            self.snv_engine, mode="snv", show_ref_at=set(requested),
        )
        if opt.select_indel_candidates and self.indel_engine is not None:
            pending.indel_job = self._dispatch_positions(
                pe, chunk, indel_pos, aff_counts, neg_counts, region_start, region_end,
                self.indel_engine, mode="indel",
            )
        return pending

    def finish_chunk(self, pending: PendingChunkCall) -> ChunkResult:
        result = ChunkResult(chunk=pending.chunk,
                             n_candidates=pending.n_candidates)
        result.snv_rows = self._finish_positions(pending.snv_job)
        result.indel_rows = self._finish_positions(pending.indel_job)
        return result

    def _dispatch_positions(
        self, pe, chunk, positions, aff_counts, neg_counts, region_start,
        region_end, engine, mode, show_ref_at=frozenset(),
    ):
        if not positions:
            return None
        # windows fully inside the computed region only (create_tensor:540-543)
        positions = [
            p for p in positions
            if p - FLANK >= region_start and p + FLANK + 1 <= region_end
        ]
        if not positions:
            return None
        with self._stage("alt_info", chunk):
            aff_alt = pe.alt_info_at(positions, min_bq=self.aff_min_bq)
            if neg_counts is aff_counts:
                neg_alt = aff_alt
            else:
                neg_alt = pe.alt_info_at(positions, min_bq=0)

        # keep the windows in their integer count dtype — the engine ships
        # int16 AFF + int16 NEG-delta over the wire (2-2.7x fewer bytes than
        # the f32 encoding) and reconstructs/rescales on device.  One fancy-
        # index gather replaces the per-site np.stack loop (0.6s -> ~0.05s
        # per 9.5k-site chunk; rows are contiguous so the take is C-speed)
        rel = np.asarray(positions, np.int64) - region_start
        rows = rel[:, None] + np.arange(-FLANK, FLANK + 1)[None, :]
        x_aff = aff_counts[rows, : cfg.PILEUP_CHANNEL_SIZE]
        if neg_counts is aff_counts:
            x_neg = x_aff   # identical views: ONE transfer (ilmn/hifi)
        else:
            x_neg = neg_counts[rows, : cfg.PILEUP_CHANNEL_SIZE]
        cov_aff = np.array([aff_alt[p][1] for p in positions], np.float32)
        cov_neg = (cov_aff if neg_alt is aff_alt else
                   np.array([neg_alt[p][1] for p in positions], np.float32))

        with self._stage("device_infer", chunk):
            run_async = getattr(engine, "run_batch_async", None)
            if run_async is not None:
                pending = run_async(x_aff, x_neg, cov_aff, cov_neg)
            else:
                # engine stubs (tests' torch oracle) expose only run_batch
                res = engine.run_batch(x_aff, x_neg, cov_aff, cov_neg)
                pending = _Resolved(res)
        return dict(
            pending=pending, positions=positions, aff_alt=aff_alt,
            pe=pe, chunk=chunk, mode=mode, show_ref_at=show_ref_at,
        )

    def _finish_positions(self, job):
        if job is None:
            return []
        positions = job["positions"]
        pe = job["pe"]
        aff_alt = job["aff_alt"]
        mode = job["mode"]
        show_ref_at = job["show_ref_at"]
        with self._stage("device_infer", job["chunk"]):
            batch = job["pending"].result()
        if self.opt.predict_fn:
            self._dump_probabilities(
                job["chunk"], positions, pe, aff_alt, batch, mode
            )
        records = [
            CandidateRecord(
                chrom=job["chunk"].ctg_name,
                pos=p + 1,  # VCF 1-based
                ref_base=pe._ref_base(p),
                alt_info=aff_alt[p][0],
            )
            for p in positions
        ]
        rows = []
        from clairs_to_tpu_torch.infer.calling import call_from_posterior
        from clairs_to_tpu_torch.ops.posterior import quality_score_np

        # batch-vectorized argmax/max/QUAL (bitwise-identical values; cuts
        # ~9k per-row numpy dispatches per chunk)
        post = np.asarray(batch.posterior)
        best_idx = np.argmax(post, axis=1)
        best_p = post[np.arange(len(post)), best_idx]
        quals = quality_score_np(best_p)
        fwd = np.asarray(batch.forward_acgt).tolist()
        rev = np.asarray(batch.reverse_acgt).tolist()
        for i, rec in enumerate(records):
            row = call_from_posterior(
                rec,
                post[i],
                fwd[i],
                rev[i],
                mode=mode,
                show_ref=self.opt.show_ref or (positions[i] in show_ref_at),
                qual_cutoff=self.opt.qual_cutoff,
                best_idx=int(best_idx[i]),
                best_p=float(best_p[i]),
                quality=float(quals[i]),
            )
            if row is not None:
                rows.append(row)
        return rows
