// Port copy of clairs_to_tpu/bamio/native/pileup_native.cpp.
// Native BAM -> column-entry-table decoder (the pileup hot loop).
//
// Replaces the per-read Python loop in clairs_to_tpu/bamio/pileup.py
// (PileupEngine.add_read) — which itself replaces the reference's
// `samtools mpileup` text pipeline (src/create_tensor_pileup_calling.py:442)
// — with a single C++ pass: BGZF inflate (zlib) -> BAM record parse ->
// CIGAR walk emitting one column entry per (read, ref position):
//
//   entry = { pos, code (0-3 ACGT fwd / 4-7 acgt rev / 8 '*' / 9 '#' /
//             10 skip), bq, mq, hp, indel kind/len, insertion seq }
//
// Semantics mirror pileup.py exactly (indel suffix attaches to the anchor
// entry, last-wins; deletion placeholder bq = next aligned base's quality;
// htslib-style read-pair overlap quality tweaking).  The Python side wraps
// the returned arrays in the same PileupEngine used by the pure-Python path,
// so every downstream reduction (channel counts, candidate gating, alt_info)
// is shared and the two paths are cross-validated in tests.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -o libpileup_native.so \
//            pileup_native.cpp -lz

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <string>
#include <unordered_map>
#include <vector>
#include <zlib.h>

namespace {

constexpr int8_t CODE_DEL_FWD = 8;
constexpr int8_t CODE_DEL_REV = 9;
constexpr int8_t CODE_SKIP = 10;      // N/other non-ACGT, forward strand
constexpr int8_t CODE_SKIP_REV = 11;  // N/other non-ACGT, reverse strand
constexpr int8_t INDEL_NONE = 0, INDEL_INS = 1, INDEL_DEL = 2;

constexpr uint16_t FLAG_PAIRED = 0x1;
constexpr uint16_t FLAG_REVERSE = 0x10;

const char SEQ_NT16[] = "=ACMGRSVTWYHKDBN";

int8_t base_code(char b, bool rev) {
  switch (b) {
    case 'A': return rev ? 4 : 0;
    case 'C': return rev ? 5 : 1;
    case 'G': return rev ? 6 : 2;
    case 'T': return rev ? 7 : 3;
    // strand is preserved for skip-family bases: the reference decoders
    // use the anchor character's case for indel strand ('N' fwd / 'n' rev,
    // create_tensor_pileup_calling.py:182,199)
    default: return rev ? CODE_SKIP_REV : CODE_SKIP;
  }
}

// Column storage in one of two modes: owned (growable vector, legacy
// export path) or external (caller-provided buffer, e.g. a numpy array the
// decode writes into directly — no intermediate copy, no per-window
// alloc/free churn).  External mode requires the exact capacity from the
// counting pass (pileup_stream_window_begin).
template <typename T>
struct Col {
  std::vector<T> own;
  T* ext = nullptr;
  size_t n = 0;
  inline void push_back(T v) {
    if (ext) ext[n++] = v;
    else own.push_back(v), n++;
  }
  inline T& operator[](size_t i) { return ext ? ext[i] : own[i]; }
  inline const T& operator[](size_t i) const { return ext ? ext[i] : own[i]; }
  inline size_t size() const { return n; }
  inline const T* data() const { return ext ? ext : own.data(); }
};

struct EntryTable {
  Col<int64_t> pos;
  Col<int8_t> code;
  Col<int16_t> bq;
  Col<int16_t> mq;
  Col<int8_t> hp;
  Col<int8_t> ikind;
  Col<int32_t> ilen;
  Col<int64_t> iseq_off;  // offset into iseq_blob; -1 if none
  Col<int32_t> read_id;
  Col<int8_t> eflags;     // bit1 read-start entry, bit2 read-end
  Col<char> iseq_blob;
  int64_t n_reads = 0;
};

// ----------------------------------------------------------------- BGZF ---
// Streaming BGZF inflater over a whole file.
class BgzfReader {
 public:
  explicit BgzfReader(const char* path) : fp_(fopen(path, "rb")) {}
  ~BgzfReader() {
    if (fp_) fclose(fp_);
  }
  bool ok() const { return fp_ != nullptr; }

  // Read exactly n bytes of decompressed data; returns false at clean EOF
  // (when 0 bytes available), aborts on short read.
  bool read(void* dst, size_t n) {
    uint8_t* out = static_cast<uint8_t*>(dst);
    size_t got = 0;
    while (got < n) {
      if (buf_pos_ == buf_.size()) {
        if (!next_block()) return got == 0 ? false : throw_short();
      }
      size_t take = std::min(n - got, buf_.size() - buf_pos_);
      memcpy(out + got, buf_.data() + buf_pos_, take);
      buf_pos_ += take;
      got += take;
    }
    return true;
  }

 private:
  bool throw_short() {
    fprintf(stderr, "pileup_native: truncated BGZF stream\n");
    exit(3);
  }
  bool next_block() {
    uint8_t header[12];
    size_t n = fread(header, 1, 12, fp_);
    if (n == 0) return false;
    if (n < 12 || header[0] != 0x1f || header[1] != 0x8b) return false;
    uint16_t xlen = header[10] | (header[11] << 8);
    std::vector<uint8_t> extra(xlen);
    if (fread(extra.data(), 1, xlen, fp_) != xlen) return false;
    int bsize = -1;
    for (size_t e = 0; e + 4 <= extra.size();) {
      uint8_t si1 = extra[e], si2 = extra[e + 1];
      uint16_t slen = extra[e + 2] | (extra[e + 3] << 8);
      if (si1 == 66 && si2 == 67 && slen == 2)
        bsize = (extra[e + 4] | (extra[e + 5] << 8)) + 1;
      e += 4 + slen;
    }
    if (bsize < 0) return false;
    int cdata_len = bsize - 12 - xlen - 8;
    std::vector<uint8_t> cdata(cdata_len);
    if (fread(cdata.data(), 1, cdata_len, fp_) != (size_t)cdata_len) return false;
    uint8_t footer[8];
    if (fread(footer, 1, 8, fp_) != 8) return false;
    uint32_t isize = footer[4] | (footer[5] << 8) | (footer[6] << 16) |
                     ((uint32_t)footer[7] << 24);
    buf_.resize(isize);
    buf_pos_ = 0;
    if (isize == 0) return next_block();  // EOF marker block
    z_stream zs{};
    inflateInit2(&zs, -15);
    zs.next_in = cdata.data();
    zs.avail_in = cdata_len;
    zs.next_out = buf_.data();
    zs.avail_out = isize;
    int ret = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    return ret == Z_STREAM_END;
  }

 public:
  // Seek to a BGZF virtual offset (coffset<<16 | uoffset).
  bool seek_virtual(uint64_t voff) {
    if (!fp_) return false;
    if (fseek(fp_, (long)(voff >> 16), SEEK_SET) != 0) return false;
    buf_.clear();
    buf_pos_ = 0;
    size_t skip = voff & 0xFFFF;
    if (skip) {
      std::vector<uint8_t> tmp(skip);
      return read(tmp.data(), skip);
    }
    return true;
  }

 private:
  FILE* fp_;
  std::vector<uint8_t> buf_;
  size_t buf_pos_ = 0;
};

// ------------------------------------------------------------------ BAI ---
// Minimal BAI reader: returns the lowest virtual offset of any chunk whose
// bin overlaps [start, end) on ref rid, or UINT64_MAX when absent.
uint64_t bai_min_voffset(const char* bai_path, int rid, int64_t start,
                         int64_t end) {
  FILE* f = fopen(bai_path, "rb");
  if (!f) return UINT64_MAX;
  auto rd_i32 = [&](int32_t* v) { return fread(v, 4, 1, f) == 1; };
  char magic[4];
  if (fread(magic, 1, 4, f) != 4 || memcmp(magic, "BAI\1", 4) != 0) {
    fclose(f);
    return UINT64_MAX;
  }
  int32_t n_ref;
  if (!rd_i32(&n_ref) || rid >= n_ref) { fclose(f); return UINT64_MAX; }
  // target bins for the query
  std::vector<uint32_t> want;
  {
    int64_t b = start, e = end - 1;
    want.push_back(0);
    int shifts[5] = {26, 23, 20, 17, 14};
    int offs[5] = {1, 9, 73, 585, 4681};
    for (int k = 0; k < 5; k++)
      for (int64_t x = offs[k] + (b >> shifts[k]); x <= offs[k] + (e >> shifts[k]); x++)
        want.push_back((uint32_t)x);
  }
  std::sort(want.begin(), want.end());
  uint64_t best = UINT64_MAX;
  uint64_t lin_min = 0;
  for (int r = 0; r < n_ref; r++) {
    int32_t n_bin;
    if (!rd_i32(&n_bin)) break;
    for (int b = 0; b < n_bin; b++) {
      uint32_t binv;
      int32_t n_chunk;
      if (fread(&binv, 4, 1, f) != 1 || !rd_i32(&n_chunk)) { fclose(f); return best; }
      bool wanted = r == rid &&
                    std::binary_search(want.begin(), want.end(), binv);
      for (int c = 0; c < n_chunk; c++) {
        uint64_t u, v;
        if (fread(&u, 8, 1, f) != 1 || fread(&v, 8, 1, f) != 1) { fclose(f); return best; }
        if (wanted) best = std::min(best, u);
      }
    }
    int32_t n_intv;
    if (!rd_i32(&n_intv)) break;
    std::vector<uint64_t> intv(n_intv);
    if (n_intv && fread(intv.data(), 8, n_intv, f) != (size_t)n_intv) break;
    if (r == rid && n_intv) {
      int64_t w = start >> 14;
      if (w < n_intv) lin_min = intv[w];
    }
    if (r == rid && best != UINT64_MAX) {
      // linear index refines the start: skip chunks entirely below it
      if (lin_min > best) best = lin_min;
      fclose(f);
      return best;
    }
  }
  fclose(f);
  return best;
}

// --------------------------------------------------------------- decoder ---
struct OverlapSpan {
  std::vector<std::pair<int64_t, int64_t>> pos_idx;  // (ref pos, entry index)
};

class Decoder {
 public:
  Decoder(EntryTable* t, bool handle_overlaps)
      : t_(t), handle_overlaps_(handle_overlaps) {}

  void add_read(const char* name, uint16_t flag, int64_t pos0, uint8_t mapq,
                const uint32_t* cigar, int n_cigar, const uint8_t* seq4,
                const uint8_t* qual, int l_seq, int hp) {
    bool rev = flag & FLAG_REVERSE;
    int64_t first_idx = (int64_t)t_->pos.size();
    int64_t last_entry_idx = -1;
    int64_t ref_pos = pos0;
    int qpos = 0;
    auto seq_at = [&](int i) -> char {
      uint8_t c = (i & 1) ? (seq4[i >> 1] & 0xF) : (seq4[i >> 1] >> 4);
      return SEQ_NT16[c];
    };
    int32_t rid = (int32_t)t_->n_reads;
    // hot-loop fast path: when the table writes into caller buffers (the
    // direct-fill pipeline), hoist the 10 destination pointers and a single
    // running index out of the per-entry Col bookkeeping — the per-entry
    // push is the single hottest loop in the framework (10^8 entries/chunk)
    const bool fast = t_->pos.ext != nullptr;
    int64_t n = first_idx;
    int64_t* Fpos = t_->pos.ext;
    int8_t* Fcode = t_->code.ext;
    int16_t* Fbq = t_->bq.ext;
    int16_t* Fmq = t_->mq.ext;
    int8_t* Fhp = t_->hp.ext;
    int8_t* Fik = t_->ikind.ext;
    int32_t* Fil = t_->ilen.ext;
    int64_t* Fio = t_->iseq_off.ext;
    int32_t* Frid = t_->read_id.ext;
    int8_t* Fef = t_->eflags.ext;
    const int8_t hp8 = (int8_t)hp;
    const int16_t mq16 = mapq;
    auto push = [&](int64_t p, int8_t code, int16_t bq) -> int64_t {
      if (fast) {
        Fpos[n] = p;
        Fcode[n] = code;
        Fbq[n] = bq;
        Fmq[n] = mq16;
        Fhp[n] = hp8;
        Fik[n] = INDEL_NONE;
        Fil[n] = 0;
        Fio[n] = -1;
        Frid[n] = rid;
        Fef[n] = 0;
        return n++;
      }
      t_->pos.push_back(p);
      t_->code.push_back(code);
      t_->bq.push_back(bq);
      t_->mq.push_back(mq16);
      t_->hp.push_back(hp8);
      t_->ikind.push_back(INDEL_NONE);
      t_->ilen.push_back(0);
      t_->iseq_off.push_back(-1);
      t_->read_id.push_back(rid);
      t_->eflags.push_back(0);
      return n++;
    };

    for (int i = 0; i < n_cigar; i++) {
      int op = cigar[i] & 0xF;
      int ln = cigar[i] >> 4;
      if (op == 0 || op == 7 || op == 8) {  // M, =, X
        for (int k = 0; k < ln; k++) {
          char b = seq_at(qpos + k);
          int16_t q = l_seq ? qual[qpos + k] : 0;
          last_entry_idx = push(ref_pos + k, base_code(b, rev), q);
        }
        ref_pos += ln;
        qpos += ln;
      } else if (op == 1) {  // I: suffix on anchor (last-wins)
        if (last_entry_idx >= 0 && t_->pos[last_entry_idx] == ref_pos - 1) {
          t_->ikind[last_entry_idx] = INDEL_INS;
          t_->ilen[last_entry_idx] = ln;
          t_->iseq_off[last_entry_idx] = (int64_t)t_->iseq_blob.size();
          for (int k = 0; k < ln; k++) {
            char b = seq_at(qpos + k);
            t_->iseq_blob.push_back(rev ? (char)tolower(b) : b);
          }
        }
        qpos += ln;
      } else if (op == 2) {  // D
        if (last_entry_idx >= 0 && t_->pos[last_entry_idx] == ref_pos - 1) {
          t_->ikind[last_entry_idx] = INDEL_DEL;
          t_->ilen[last_entry_idx] = ln;
        }
        int nxt = qpos < l_seq ? qpos : (l_seq ? l_seq - 1 : 0);
        int16_t del_bq = l_seq ? qual[nxt] : 0;
        int8_t code = rev ? CODE_DEL_REV : CODE_DEL_FWD;
        for (int k = 0; k < ln; k++)
          last_entry_idx = push(ref_pos + k, code, del_bq);
        ref_pos += ln;
      } else if (op == 3) {  // N
        ref_pos += ln;
        last_entry_idx = -1;
      } else if (op == 4) {  // S
        qpos += ln;
      }
    }

    if (fast) {
      // commit the running index into every Col before anything that
      // reads .size() (overlap_adjust does)
      t_->pos.n = t_->code.n = t_->bq.n = t_->mq.n = t_->hp.n = (size_t)n;
      t_->ikind.n = t_->ilen.n = t_->iseq_off.n = (size_t)n;
      t_->read_id.n = t_->eflags.n = (size_t)n;
    }
    if (n > first_idx) {
      t_->eflags[first_idx] |= 1;
      t_->eflags[n - 1] |= 2;
    }
    if (handle_overlaps_ && (flag & FLAG_PAIRED))
      overlap_adjust(name, first_idx);
    t_->n_reads++;
  }

 private:
  void overlap_adjust(const char* name, int64_t first_idx) {
    OverlapSpan span;
    for (int64_t i = first_idx; i < (int64_t)t_->pos.size(); i++)
      if (t_->code[i] < 8) span.pos_idx.emplace_back(t_->pos[i], i);
    auto it = pending_.find(name);
    if (it == pending_.end()) {
      pending_.emplace(name, std::move(span));
      return;
    }
    std::unordered_map<int64_t, int64_t> prev;
    prev.reserve(it->second.pos_idx.size());
    for (auto& pi : it->second.pos_idx) prev[pi.first] = pi.second;
    for (auto& pi : span.pos_idx) {
      auto pit = prev.find(pi.first);
      if (pit == prev.end()) continue;
      int64_t i1 = pit->second, i2 = pi.second;
      int c1 = t_->code[i1] % 4, c2 = t_->code[i2] % 4;
      int q1 = t_->bq[i1], q2 = t_->bq[i2];
      if (c1 == c2) {
        t_->bq[i1] = (int16_t)std::min(q1 + q2, 200);
        t_->bq[i2] = 0;
      } else if (q1 >= q2) {
        t_->bq[i1] = (int16_t)(0.8 * q1);
        t_->bq[i2] = 0;
      } else {
        t_->bq[i2] = (int16_t)(0.8 * q2);
        t_->bq[i1] = 0;
      }
    }
    pending_.erase(it);
  }

  EntryTable* t_;
  bool handle_overlaps_;
  std::unordered_map<std::string, OverlapSpan> pending_;
};

int find_hp_tag(const uint8_t* tags, int tags_len) {
  int pos = 0;
  while (pos + 3 <= tags_len) {
    char t0 = tags[pos], t1 = tags[pos + 1], typ = tags[pos + 2];
    pos += 3;
    int val = 0;
    bool is_hp = (t0 == 'H' && t1 == 'P');
    switch (typ) {
      case 'A': case 'c': case 'C':
        val = (int8_t)tags[pos]; pos += 1; break;
      case 's': case 'S': {
        int16_t v; memcpy(&v, tags + pos, 2); val = v; pos += 2; break;
      }
      case 'i': case 'I': {
        int32_t v; memcpy(&v, tags + pos, 4); val = v; pos += 4; break;
      }
      case 'f': pos += 4; break;
      case 'Z': case 'H':
        while (pos < tags_len && tags[pos]) pos++;
        pos++;
        break;
      case 'B': {
        char sub = tags[pos];
        uint32_t cnt;
        memcpy(&cnt, tags + pos + 1, 4);
        int size = (sub == 'c' || sub == 'C') ? 1
                   : (sub == 's' || sub == 'S') ? 2 : 4;
        pos += 5 + size * (int)cnt;
        break;
      }
      default:
        return 0;
    }
    if (is_hp && (typ == 'c' || typ == 'C' || typ == 's' || typ == 'S' ||
                  typ == 'i' || typ == 'I' || typ == 'A'))
      return val;
  }
  return 0;
}

}  // namespace

// ---------------------------------------------------------- streaming ----
// Sequential-chunk streaming: the calling pipeline visits chunks in
// coordinate order, so instead of re-decoding the BGZF stream per chunk
// (or needing a BAI index), a persistent BamStream decodes each record
// once, hands out the records overlapping the current window, and buffers
// reads that span into the next window.
struct RawRecord {
  int32_t ref_id;
  int64_t pos;
  int64_t end;
  std::vector<uint8_t> rec;  // full BAM record body
};

struct BamStream {
  BgzfReader* reader = nullptr;
  std::vector<std::string> ref_names;
  std::string bam_path;
  // decoded, not yet consumed past their end; shared_ptr so a WindowHandle
  // (the fused-reduce path) can retain a window's records across the
  // stream's advance to the next window (decode-ahead prefetch)
  std::deque<std::shared_ptr<RawRecord>> buffer;
  bool eof = false;
  bool started = false;  // any record decoded yet (gates the BAI fast-seek)
  ~BamStream() { delete reader; }
};

int64_t record_ref_span(const uint8_t* rec) {
  uint16_t n_cigar;
  memcpy(&n_cigar, rec + 12, 2);
  uint8_t l_read_name = rec[8];
  const uint32_t* cigar = (const uint32_t*)(rec + 32 + l_read_name);
  int64_t span = 0;
  for (int i = 0; i < n_cigar; i++) {
    int op = cigar[i] & 0xF;
    if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
      span += cigar[i] >> 4;
  }
  return span;
}

bool decode_one_record(BamStream* s, RawRecord* out) {
  int32_t block_size;
  if (!s->reader->read(&block_size, 4)) return false;
  out->rec.resize(block_size);
  if (!s->reader->read(out->rec.data(), block_size)) return false;
  memcpy(&out->ref_id, out->rec.data(), 4);
  int32_t pos32;
  memcpy(&pos32, out->rec.data() + 4, 4);
  out->pos = pos32;
  out->end = out->pos + record_ref_span(out->rec.data());
  return true;
}

void feed_record(Decoder& dec, const RawRecord& rr, int excl_flags,
                 int min_mapq) {
  const uint8_t* rec = rr.rec.data();
  int64_t block_size = rr.rec.size();
  uint8_t l_read_name = rec[8];
  uint8_t mapq = rec[9];
  uint16_t n_cigar, flag;
  int32_t l_seq;
  memcpy(&n_cigar, rec + 12, 2);
  memcpy(&flag, rec + 14, 2);
  memcpy(&l_seq, rec + 16, 4);
  if (flag & excl_flags) return;
  if (mapq < min_mapq) return;
  const char* name = (const char*)rec + 32;
  const uint32_t* cigar = (const uint32_t*)(rec + 32 + l_read_name);
  const uint8_t* seq4 = rec + 32 + l_read_name + 4 * n_cigar;
  const uint8_t* qual = seq4 + (l_seq + 1) / 2;
  const uint8_t* tags = qual + l_seq;
  int tags_len = (int)(rec + block_size - tags);
  int hp = find_hp_tag(tags, tags_len);
  std::vector<uint8_t> qual_buf;
  if (l_seq && qual[0] == 0xFF) {
    qual_buf.assign(l_seq, 0);
    qual = qual_buf.data();
  }
  dec.add_read(name, flag, rr.pos, mapq, cigar, n_cigar, seq4, qual, l_seq, hp);
}

// Counting pass for the direct-fill path: entry count = sum of M/=/X and D
// cigar lengths; blob bytes = sum of anchored I lengths (anchor = previous
// ref-consuming op in this read, reset by N — mirrors add_read's last-wins
// anchor logic, which appends to the blob for every anchored I).
void count_record(const RawRecord& rr, int excl_flags, int min_mapq,
                  int64_t* n_entries, int64_t* blob_len) {
  const uint8_t* rec = rr.rec.data();
  uint8_t l_read_name = rec[8];
  uint8_t mapq = rec[9];
  uint16_t n_cigar, flag;
  memcpy(&n_cigar, rec + 12, 2);
  memcpy(&flag, rec + 14, 2);
  if (flag & excl_flags) return;
  if (mapq < min_mapq) return;
  const uint32_t* cigar = (const uint32_t*)(rec + 32 + l_read_name);
  bool have_anchor = false;
  for (int i = 0; i < n_cigar; i++) {
    int op = cigar[i] & 0xF;
    int64_t ln = cigar[i] >> 4;
    if (op == 0 || op == 7 || op == 8 || op == 2) {  // M, =, X, D
      *n_entries += ln;
      have_anchor = true;
    } else if (op == 1) {  // I
      if (have_anchor) *blob_len += ln;
    } else if (op == 3) {  // N
      have_anchor = false;
    }
  }
}

// Pending direct-fill window: records selected by _begin, decoded by _fill.
// shared_ptr ownership keeps the records alive independently of the
// stream's deque (which advances during decode-ahead prefetch).
struct PendingWindow {
  BamStream* stream;
  std::vector<std::shared_ptr<RawRecord>> records;
  int excl_flags, min_mapq, handle_overlaps;
};

// Advance the stream to `rid`:[start,end) and collect the overlapping
// records (stream order preserved).  Shared by the legacy entry-table
// windows and the fused-reduce path.
void select_window_records(BamStream* s, int rid, int64_t start, int64_t end,
                           std::vector<std::shared_ptr<RawRecord>>* out) {
  // BAI fast-seek for the FIRST window: a region-restricted run
  // (-r chr17:...) or a late contig would otherwise BGZF-inflate the
  // whole file prefix sequentially (pileup_load already seeks; the
  // stream now does too, once, before any record is decoded)
  if (!s->started) {
    s->started = true;
    std::string bai = s->bam_path + ".bai";
    uint64_t voff = bai_min_voffset(bai.c_str(), rid, start, end);
    if (voff != UINT64_MAX && voff > 0) s->reader->seek_virtual(voff);
  }
  while (!s->buffer.empty() &&
         (s->buffer.front()->ref_id < rid ||
          (s->buffer.front()->ref_id == rid && s->buffer.front()->end <= start)))
    s->buffer.pop_front();
  for (auto& rr : s->buffer)
    if (rr->ref_id == rid && rr->pos < end && rr->end > start)
      out->push_back(rr);
  while (!s->eof) {
    if (!s->buffer.empty() &&
        (s->buffer.back()->ref_id > rid ||
         (s->buffer.back()->ref_id == rid && s->buffer.back()->pos >= end)))
      break;
    auto rr = std::make_shared<RawRecord>();
    if (!decode_one_record(s, rr.get())) { s->eof = true; break; }
    if (rr->ref_id < rid || (rr->ref_id == rid && rr->end <= start)) continue;
    bool overlaps = rr->ref_id == rid && rr->pos < end && rr->end > start;
    bool past = rr->ref_id > rid || (rr->ref_id == rid && rr->pos >= end);
    s->buffer.push_back(rr);
    if (overlaps) out->push_back(rr);
    if (past) break;
  }
}

int stream_rid(BamStream* s, const char* ctg) {
  for (size_t i = 0; i < s->ref_names.size(); i++)
    if (s->ref_names[i] == ctg) return (int)i;
  return -1;
}

extern "C" {

// Open a persistent stream over a coordinate-sorted BAM.
void* pileup_open_stream(const char* bam_path) {
  auto* s = new BamStream();
  s->bam_path = bam_path;
  s->reader = new BgzfReader(bam_path);
  if (!s->reader->ok()) { delete s; return nullptr; }
  char magic[4];
  if (!s->reader->read(magic, 4) || memcmp(magic, "BAM\1", 4) != 0) {
    delete s;
    return nullptr;
  }
  int32_t l_text;
  s->reader->read(&l_text, 4);
  std::vector<char> text(l_text);
  s->reader->read(text.data(), l_text);
  int32_t n_ref;
  s->reader->read(&n_ref, 4);
  for (int i = 0; i < n_ref; i++) {
    int32_t l_name;
    s->reader->read(&l_name, 4);
    std::vector<char> nm(l_name);
    s->reader->read(nm.data(), l_name);
    int32_t l_ref;
    s->reader->read(&l_ref, 4);
    s->ref_names.emplace_back(nm.data());
  }
  return s;
}

void pileup_close_stream(void* h) { delete (BamStream*)h; }

// Entry table for reads of `ctg` overlapping [start, end).  Requires
// coordinate-sorted input and non-decreasing (ctg, start) across calls.
void* pileup_stream_window(void* sh, const char* ctg, int64_t start,
                           int64_t end, int excl_flags, int min_mapq,
                           int handle_overlaps) {
  auto* s = (BamStream*)sh;
  int rid = stream_rid(s, ctg);
  if (rid < 0) return nullptr;

  auto* table = new EntryTable();
  Decoder dec(table, handle_overlaps != 0);
  std::vector<std::shared_ptr<RawRecord>> records;
  select_window_records(s, rid, start, end, &records);
  for (auto& rr : records) feed_record(dec, *rr, excl_flags, min_mapq);
  return table;
}

// Direct-fill phase A: advance the stream like pileup_stream_window, but
// only select records and count output sizes.  Returns PendingWindow* (or
// nullptr on unknown contig); caller allocates buffers of the returned
// sizes and calls pileup_stream_window_fill.
void* pileup_stream_window_begin(void* sh, const char* ctg, int64_t start,
                                 int64_t end, int excl_flags, int min_mapq,
                                 int handle_overlaps, int64_t* n_entries,
                                 int64_t* blob_len) {
  auto* s = (BamStream*)sh;
  int rid = stream_rid(s, ctg);
  if (rid < 0) return nullptr;

  auto* pw = new PendingWindow{s, {}, excl_flags, min_mapq, handle_overlaps};
  *n_entries = 0;
  *blob_len = 0;
  select_window_records(s, rid, start, end, &pw->records);
  for (auto& rr : pw->records)
    count_record(*rr, excl_flags, min_mapq, n_entries, blob_len);
  return pw;
}

// Direct-fill phase B: decode the pending records straight into the caller's
// buffers (sized from phase A).  Writes the entry count actually produced to
// *n_used and blob bytes to *blob_used (== phase A counts by construction),
// returns n_reads.  Frees the PendingWindow.
int64_t pileup_stream_window_fill(void* pwh, int64_t* pos, int8_t* code,
                                  int16_t* bq, int16_t* mq, int8_t* hp,
                                  int8_t* ikind, int32_t* ilen,
                                  int64_t* iseq_off, char* blob,
                                  int32_t* read_id, int8_t* eflags,
                                  int64_t* n_used, int64_t* blob_used) {
  auto* pw = (PendingWindow*)pwh;
  EntryTable t;
  t.pos.ext = pos; t.code.ext = code; t.bq.ext = bq; t.mq.ext = mq;
  t.hp.ext = hp; t.ikind.ext = ikind; t.ilen.ext = ilen;
  t.iseq_off.ext = iseq_off; t.read_id.ext = read_id; t.eflags.ext = eflags;
  t.iseq_blob.ext = blob;
  Decoder dec(&t, pw->handle_overlaps != 0);
  for (auto& rr : pw->records)
    feed_record(dec, *rr, pw->excl_flags, pw->min_mapq);
  *n_used = (int64_t)t.pos.size();
  *blob_used = (int64_t)t.iseq_blob.size();
  int64_t n_reads = t.n_reads;
  delete pw;
  return n_reads;
}

void pileup_stream_window_abort(void* pwh) { delete (PendingWindow*)pwh; }

// Decode reads of `ctg` overlapping [start, end) into an entry table.
// Returns an opaque handle (EntryTable*), or nullptr on error.
void* pileup_load(const char* bam_path, const char* ctg, int64_t start,
                  int64_t end, int excl_flags, int min_mapq,
                  int handle_overlaps) {
  BgzfReader r(bam_path);
  if (!r.ok()) return nullptr;
  char magic[4];
  if (!r.read(magic, 4) || memcmp(magic, "BAM\1", 4) != 0) return nullptr;
  int32_t l_text;
  r.read(&l_text, 4);
  std::vector<char> text(l_text);
  r.read(text.data(), l_text);
  int32_t n_ref;
  r.read(&n_ref, 4);
  int target_rid = -1;
  for (int i = 0; i < n_ref; i++) {
    int32_t l_name;
    r.read(&l_name, 4);
    std::vector<char> nm(l_name);
    r.read(nm.data(), l_name);
    int32_t l_ref;
    r.read(&l_ref, 4);
    if (ctg && strcmp(nm.data(), ctg) == 0) target_rid = i;
  }
  if (ctg && target_rid < 0) return nullptr;

  // BAI random access: seek straight to the first chunk for the region
  bool used_index = false;
  if (ctg && target_rid >= 0) {
    std::string bai = std::string(bam_path) + ".bai";
    uint64_t voff = bai_min_voffset(bai.c_str(), target_rid, start, end);
    if (voff != UINT64_MAX) used_index = r.seek_virtual(voff);
  }

  auto* table = new EntryTable();
  Decoder dec(table, handle_overlaps != 0);
  std::vector<uint8_t> rec;
  while (true) {
    int32_t block_size;
    if (!r.read(&block_size, 4)) break;
    rec.resize(block_size);
    if (!r.read(rec.data(), block_size)) break;
    int32_t ref_id, pos, l_seq, next_ref, next_pos, tlen;
    memcpy(&ref_id, rec.data(), 4);
    memcpy(&pos, rec.data() + 4, 4);
    uint8_t l_read_name = rec[8];
    uint8_t mapq = rec[9];
    uint16_t n_cigar, flag;
    memcpy(&n_cigar, rec.data() + 12, 2);
    memcpy(&flag, rec.data() + 14, 2);
    memcpy(&l_seq, rec.data() + 16, 4);
    memcpy(&next_ref, rec.data() + 20, 4);
    memcpy(&next_pos, rec.data() + 24, 4);
    memcpy(&tlen, rec.data() + 28, 4);
    if (flag & excl_flags) continue;
    if (mapq < min_mapq) continue;
    if (target_rid >= 0 && ref_id != target_rid) continue;
    if (target_rid >= 0 && ref_id > target_rid) break;  // sorted: past contig
    if (pos >= end && ref_id == target_rid) {
      if (used_index) break;  // index implies coordinate order
      continue;
    }
    const char* name = (const char*)rec.data() + 32;
    const uint32_t* cigar = (const uint32_t*)(rec.data() + 32 + l_read_name);
    const uint8_t* seq4 = rec.data() + 32 + l_read_name + 4 * n_cigar;
    const uint8_t* qual = seq4 + (l_seq + 1) / 2;
    // reference span check
    int64_t span = 0;
    for (int i = 0; i < n_cigar; i++) {
      int op = cigar[i] & 0xF;
      if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
        span += cigar[i] >> 4;
    }
    if (pos + span <= start) continue;
    const uint8_t* tags = qual + l_seq;
    int tags_len = (int)(rec.data() + block_size - tags);
    int hp = find_hp_tag(tags, tags_len);
    // qual 0xFF sentinel -> zeros
    std::vector<uint8_t> qual_buf;
    if (l_seq && qual[0] == 0xFF) {
      qual_buf.assign(l_seq, 0);
      qual = qual_buf.data();
    }
    dec.add_read(name, flag, pos, mapq, cigar, n_cigar, seq4, qual, l_seq, hp);
  }
  return table;
}

int64_t pileup_n_entries(void* h) {
  return ((EntryTable*)h)->pos.size();
}

int64_t pileup_n_reads(void* h) { return ((EntryTable*)h)->n_reads; }

int64_t pileup_iseq_blob_len(void* h) {
  return (int64_t)((EntryTable*)h)->iseq_blob.size();
}

// Copy columns into caller-allocated numpy buffers.
void pileup_export(void* h, int64_t* pos, int8_t* code, int16_t* bq,
                   int16_t* mq, int8_t* hp, int8_t* ikind, int32_t* ilen,
                   int64_t* iseq_off, char* iseq_blob, int32_t* read_id,
                   int8_t* eflags) {
  auto* t = (EntryTable*)h;
  size_t n = t->pos.size();
  memcpy(pos, t->pos.data(), n * sizeof(int64_t));
  memcpy(code, t->code.data(), n * sizeof(int8_t));
  memcpy(bq, t->bq.data(), n * sizeof(int16_t));
  memcpy(mq, t->mq.data(), n * sizeof(int16_t));
  memcpy(hp, t->hp.data(), n * sizeof(int8_t));
  memcpy(ikind, t->ikind.data(), n * sizeof(int8_t));
  memcpy(ilen, t->ilen.data(), n * sizeof(int32_t));
  memcpy(iseq_off, t->iseq_off.data(), n * sizeof(int64_t));
  memcpy(iseq_blob, t->iseq_blob.data(), t->iseq_blob.size());
  memcpy(read_id, t->read_id.data(), n * sizeof(int32_t));
  memcpy(eflags, t->eflags.data(), n * sizeof(int8_t));
}

void pileup_free(void* h) { delete (EntryTable*)h; }

}  // extern "C"

// ===================================================================
// Array-native reductions: single-pass channel counts + candidate
// prefilter over an exported entry table.  These replace the
// memory-bound multi-pass numpy reductions in pileup.py for the hot
// path; the numpy implementations remain the behavioral reference
// (cross-validated in tests/test_native.py).
// ===================================================================

extern "C" {

// Tensor-view channel counts (create_tensor semantics; see pileup.py
// channel_counts).  out: (L, nchan) int32 row-major; depth: (L,) int32.
// nchan = 34 (+16 when with_phasing).  iseq blob/offsets carry insertion
// sequences for the I1/i1 max-per-distinct-seq channels.
void entry_channel_counts(
    int64_t n, const int64_t* pos, const int8_t* code, const int16_t* bq,
    const int16_t* mq, const int8_t* hp, const int8_t* ikind,
    const int32_t* ilen, const int64_t* iseq_off, const char* iseq_blob,
    int min_bq, int64_t region_start, int64_t region_end,
    int low_mq_thresh, int low_bq_thresh, int max_indel_len,
    int with_phasing, int32_t* out, int32_t* depth) {
  const int64_t L = region_end - region_start;
  const int nchan = 34 + (with_phasing ? 16 : 0);
  // channel indices (config.PILEUP_CHANNELS layout)
  const int CH_I = 4, CH_I1 = 5, CH_D = 6, CH_D1 = 7, CH_STAR = 8;
  const int CH_i = 13, CH_i1 = 14, CH_d = 15, CH_d1 = 16, CH_HASH = 17;
  const int CH_ALMQ = 18, CH_aLMQ = 22, CH_ALBQ = 26, CH_aLBQ = 30;
  // per-(pos,strand) distinct-insertion-seq max: small hash per call
  std::unordered_map<uint64_t, std::unordered_map<std::string, int>> ins_groups;
  std::unordered_map<uint64_t, std::unordered_map<int, int>> del_groups;
  for (int64_t j = 0; j < n; j++) {
    int64_t p = pos[j] - region_start;
    if (p < 0 || p >= L) continue;
    int8_t c = code[j];
    if (c >= 10 && ikind[j] == 0) continue;  // pure N: no view counts it
    if (bq[j] < min_bq) continue;
    bool hi_mq = mq[j] >= low_mq_thresh;
    bool pure = ikind[j] == 0;
    int32_t* row = out + p * nchan;
    if (pure) {
      if (hi_mq) {
        int ch;
        if (c < 4) ch = c;
        else if (c < 8) ch = c + 5;
        else ch = (c == 8) ? CH_STAR : CH_HASH;
        row[ch] += 1;
        depth[p] += 1;
      } else if (c < 8) {
        row[(c < 4 ? c + CH_ALMQ : c - 4 + CH_aLMQ)] += 1;
      }
      if (c < 8 && bq[j] < low_bq_thresh) {
        row[(c < 4 ? c + CH_ALBQ : c - 4 + CH_aLBQ)] += 1;
      }
    } else if (hi_mq) {
      // indel-suffix entry: counts only as indel evidence
      bool is_ins = ikind[j] == 1;
      int len = ilen[j];
      bool ok = is_ins ? (len <= max_indel_len) : (len + 1 <= max_indel_len);
      if (ok) {
        // anchor-char strand set is 'ACGTN*' fwd (create_tensor:182,199):
        // N-anchored indels count as forward evidence
        bool fwd = (c < 4) || (c == 8) || (c == 10);
        depth[p] += 1;
        if (is_ins) {
          row[fwd ? CH_I : CH_i] += 1;
          std::string seq(iseq_blob + iseq_off[j], (size_t)len);
          for (auto& ch2 : seq) ch2 = toupper(ch2);
          uint64_t key = ((uint64_t)p << 1) | (fwd ? 1 : 0);
          ins_groups[key][seq] += 1;
        } else {
          row[fwd ? CH_D : CH_d] += 1;
          uint64_t key = ((uint64_t)p << 1) | (fwd ? 1 : 0);
          del_groups[key][len] += 1;
        }
      }
      // LBQ counting skips indel-suffix entries (pure keys only)
    }
    // phase channels take PURE base entries only: an indel-suffixed
    // entry's joined key ("A+TG") fails the reference's 'ACGTacgt'
    // membership test (create_tensor_pileup_calling.py:150-154)
    if (with_phasing && pure && c < 8 && (hp[j] == 1 || hp[j] == 2)) {
      int base_off = 34 + (hp[j] == 2 ? 8 : 0);
      row[base_off + (c % 8)] += 1;
    }
  }
  for (auto& kv : ins_groups) {
    int64_t p = kv.first >> 1;
    bool fwd = kv.first & 1;
    int best = 0;
    for (auto& g : kv.second) best = std::max(best, g.second);
    int32_t* row = out + p * nchan;
    int ch = fwd ? CH_I1 : CH_i1;
    row[ch] = std::max(row[ch], (int32_t)best);
  }
  for (auto& kv : del_groups) {
    int64_t p = kv.first >> 1;
    bool fwd = kv.first & 1;
    int best = 0;
    for (auto& g : kv.second) best = std::max(best, g.second);
    int32_t* row = out + p * nchan;
    int ch = fwd ? CH_D1 : CH_d1;
    row[ch] = std::max(row[ch], (int32_t)best);
  }
}

// Candidate-view prefilter (extract_candidates gating, superset-exact for
// SNVs): writes cand_mask (L,) uint8 with bit1 = SNV-possible, bit2 =
// indel-possible.  ref_codes: (L,) int8 (0-3 or -1 for non-ACGT).
void entry_candidate_prefilter(
    int64_t n, const int64_t* pos, const int8_t* code, const int16_t* bq,
    const int16_t* mq, const int8_t* ikind,
    int min_bq, int min_mq, int64_t region_start, int64_t region_end,
    const int8_t* ref_codes, int min_coverage, double snv_af,
    double indel_af, int support, int select_indels, uint8_t* cand_mask) {
  const int64_t L = region_end - region_start;
  std::vector<int32_t> base_counts((size_t)L * 4, 0);
  std::vector<int32_t> depth(L, 0), ins_tot(L, 0), del_tot(L, 0);
  for (int64_t j = 0; j < n; j++) {
    int64_t p = pos[j] - region_start;
    if (p < 0 || p >= L) continue;
    if (bq[j] < min_bq || mq[j] < min_mq) continue;
    // skip-family (N) entries add no depth/base but their indel suffix
    // counts (extract_candidates decode: pileup_dict['I'/'D'] has no
    // anchor gate while depth requires an ACGT/#/* key)
    if (code[j] < 10) {
      depth[p] += 1;
      if (code[j] < 8) base_counts[p * 4 + code[j] % 4] += 1;
    } else if (ikind[j] == 0) {
      continue;
    }
    if (ikind[j] == 1) ins_tot[p] += 1;
    else if (ikind[j] == 2) del_tot[p] += 1;
  }
  for (int64_t p = 0; p < L; p++) {
    cand_mask[p] = 0;
    if (ref_codes[p] < 0 || depth[p] <= min_coverage) continue;
    double denom = depth[p] > 0 ? depth[p] : 1;
    for (int c = 0; c < 4; c++) {
      if (c == ref_codes[p]) continue;
      int cnt = base_counts[p * 4 + c];
      if (cnt >= support && cnt / denom >= snv_af) { cand_mask[p] |= 1; break; }
    }
    if (select_indels) {
      if ((ins_tot[p] >= support && ins_tot[p] / denom >= indel_af) ||
          (del_tot[p] >= support && del_tot[p] / denom >= indel_af))
        cand_mask[p] |= 2;
    }
  }
}

// Group entry indices by wanted position (two-phase: count, then fill).
// `want` is sorted ascending; an int32 lookup table over [want[0],
// want[npos-1]] gives O(1) per-entry dispatch.  Entry order is preserved
// within each group (mpileup column order = original entry order).
// Replaces per-call full-table scans in Python (alt_info_at's per-entry
// loop and find_candidates' searchsorted+mask chain).
namespace {
// k for pos p: lookup table when the want span is small (the per-chunk
// case), binary search otherwise.
struct WantIndex {
  int64_t lo, hi;
  std::vector<int32_t> slot;     // direct map when span <= kMaxSpan
  const int64_t* want;
  int64_t npos;
  static constexpr int64_t kMaxSpan = 1LL << 27;
  WantIndex(int64_t n, const int64_t* w) : want(w), npos(n) {
    lo = w[0];
    hi = w[n - 1] + 1;
    if (hi - lo <= kMaxSpan) {
      slot.assign((size_t)(hi - lo), -1);
      for (int64_t k = 0; k < n; k++) slot[w[k] - lo] = (int32_t)k;
    }
  }
  inline int64_t find(int64_t p) const {
    if (p < lo || p >= hi) return -1;
    if (!slot.empty()) return slot[p - lo];
    const int64_t* it = std::lower_bound(want, want + npos, p);
    return (it != want + npos && *it == p) ? it - want : -1;
  }
};
}  // namespace

void entry_group_count(
    int64_t n, const int64_t* pos,
    int64_t npos, const int64_t* want, int64_t* counts) {
  if (npos == 0) return;
  WantIndex wi(npos, want);
  for (int64_t k = 0; k < npos; k++) counts[k] = 0;
  for (int64_t j = 0; j < n; j++) {
    int64_t k = wi.find(pos[j]);
    if (k >= 0) counts[k] += 1;
  }
}

void entry_group_fill(
    int64_t n, const int64_t* pos,
    int64_t npos, const int64_t* want,
    const int64_t* offsets /* npos group start offsets */,
    int64_t* out_idx) {
  if (npos == 0) return;
  WantIndex wi(npos, want);
  std::vector<int64_t> cur(offsets, offsets + npos);
  for (int64_t j = 0; j < n; j++) {
    int64_t k = wi.find(pos[j]);
    if (k >= 0) out_idx[cur[k]++] = j;
  }
}

// Per-position distinct-entry-key aggregation (first-encounter order =
// mpileup column order).  One pass groups entries at the wanted positions,
// a second pass per position dedupes by (code, ikind, ilen, iseq bytes) and
// materialises the exact mpileup entry strings (pileup.py::_entry_string):
// pure base char, base+'+'+iseq (case as stored), or base+'-'+refseq (case
// by strand, 'N' outside the reference window).  Serves both alt_info_at
// and find_candidates' exact gating: their per-entry Python loops become
// per-distinct-key loops (~4 keys/position vs ~depth entries/position).
//
// Returns the number of keys written, or -1 when keys_cap/blob_cap are too
// small — needed sizes are always stored so the caller can retry once.
int64_t entry_alt_aggregate(
    int64_t n, const int64_t* pos, const int8_t* code, const int16_t* bq,
    const int16_t* mq, const int8_t* ikind, const int32_t* ilen,
    const int64_t* iseq_off, const char* iseq_blob,
    int64_t npos, const int64_t* want,
    int min_bq, int min_mq,
    const char* ref_seq, int64_t ref_len, int64_t ref_start,
    int32_t* out_nkeys, int32_t* out_counts, int32_t* out_key_len,
    uint8_t* key_blob, int64_t keys_cap, int64_t blob_cap,
    int64_t* needed_keys, int64_t* needed_blob) {
  *needed_keys = 0;
  *needed_blob = 0;
  if (npos == 0) return 0;
  WantIndex wi(npos, want);
  // phase A: group entry indices by wanted position (order preserved)
  std::vector<int64_t> counts(npos, 0);
  for (int64_t j = 0; j < n; j++) {
    int64_t k = wi.find(pos[j]);
    if (k >= 0) counts[k] += 1;
  }
  std::vector<int64_t> offsets(npos + 1, 0);
  for (int64_t k = 0; k < npos; k++) offsets[k + 1] = offsets[k] + counts[k];
  std::vector<int64_t> idx(offsets[npos]);
  {
    std::vector<int64_t> cur(offsets.begin(), offsets.end() - 1);
    for (int64_t j = 0; j < n; j++) {
      int64_t k = wi.find(pos[j]);
      if (k >= 0) idx[cur[k]++] = j;
    }
  }
  // phase B: per position, dedupe entries by key in first-encounter order
  struct Slot {
    int8_t code, kind;
    int32_t len;
    int64_t off;     // iseq offset (ins) for byte-identity compare
    int32_t count;
  };
  std::vector<Slot> slots;
  int64_t keys_out = 0, blob_out = 0;
  bool overflow = false;
  for (int64_t k = 0; k < npos; k++) {
    slots.clear();
    int16_t pure_slot[12];
    for (int i = 0; i < 12; i++) pure_slot[i] = -1;
    for (int64_t t = offsets[k]; t < offsets[k + 1]; t++) {
      int64_t j = idx[t];
      int8_t c = code[j];
      if (bq[j] < min_bq || mq[j] < min_mq) continue;
      int8_t kind = ikind[j];
      if (c >= 10 && kind == 0) continue;  // pure N: every counter ignores it
      if (kind == 0) {
        int16_t s = pure_slot[c];
        if (s < 0) {
          pure_slot[c] = (int16_t)slots.size();
          slots.push_back({c, 0, 0, 0, 1});
        } else {
          slots[s].count += 1;
        }
        continue;
      }
      int32_t len = ilen[j];
      int64_t off = (kind == 1) ? iseq_off[j] : 0;
      int found = -1;
      for (size_t s = 0; s < slots.size(); s++) {
        const Slot& sl = slots[s];
        if (sl.code != c || sl.kind != kind || sl.len != len) continue;
        if (kind == 1 &&
            memcmp(iseq_blob + sl.off, iseq_blob + off, (size_t)len) != 0)
          continue;
        found = (int)s;
        break;
      }
      if (found >= 0) slots[found].count += 1;
      else slots.push_back({c, kind, len, off, 1});
    }
    out_nkeys[k] = (int32_t)slots.size();
    for (const Slot& sl : slots) {
      static const char kBaseChar[12] = {'A', 'C', 'G', 'T', 'a', 'c',
                                         'g', 't', '*', '#', 'N', 'n'};
      int64_t slen = (sl.kind == 0) ? 1 : 2 + sl.len;
      *needed_keys += 1;
      *needed_blob += slen;
      if (overflow) continue;
      if (keys_out + 1 > keys_cap || blob_out + slen > blob_cap) {
        overflow = true;
        continue;
      }
      uint8_t* dst = key_blob + blob_out;
      dst[0] = (uint8_t)kBaseChar[sl.code];
      if (sl.kind == 1) {
        dst[1] = '+';
        memcpy(dst + 2, iseq_blob + sl.off, (size_t)sl.len);
      } else if (sl.kind == 2) {
        dst[1] = '-';
        bool rev = (sl.code >= 4 && sl.code < 8) || sl.code == 9 ||
                   sl.code == 11;
        int64_t p = want[k];
        for (int32_t t = 0; t < sl.len; t++) {
          int64_t ri = p + 1 + t - ref_start;
          char rb = (ri >= 0 && ri < ref_len) ? ref_seq[ri] : 'N';
          dst[2 + t] = (uint8_t)(rev ? tolower(rb) : rb);
        }
      }
      out_counts[keys_out] = sl.count;
      out_key_len[keys_out] = (int32_t)slen;
      keys_out += 1;
      blob_out += slen;
    }
  }
  return overflow ? -1 : keys_out;
}

}  // extern "C" (template helper below needs C++ linkage)

namespace {
// Shared aggregation core for the alt_info / candidate-gate fast paths:
// phase A groups entry indices by wanted position, phase B dedupes each
// position's view-filtered entries into first-encounter-order slots —
// identical slot semantics to entry_alt_aggregate above.
struct AltSlot {
  int8_t code, kind;
  int32_t len;
  int64_t off;
  int32_t count;
};

template <class F>
void aggregate_slots(
    int64_t n, const int64_t* pos, const int8_t* code, const int16_t* bq,
    const int16_t* mq, const int8_t* ikind, const int32_t* ilen,
    const int64_t* iseq_off, const char* iseq_blob,
    int64_t npos, const int64_t* want, int min_bq, int min_mq, F&& emit) {
  if (npos == 0) return;
  WantIndex wi(npos, want);
  std::vector<int64_t> counts(npos, 0);
  for (int64_t j = 0; j < n; j++) {
    int64_t k = wi.find(pos[j]);
    if (k >= 0) counts[k] += 1;
  }
  std::vector<int64_t> offsets(npos + 1, 0);
  for (int64_t k = 0; k < npos; k++) offsets[k + 1] = offsets[k] + counts[k];
  std::vector<int64_t> idx(offsets[npos]);
  {
    std::vector<int64_t> cur(offsets.begin(), offsets.end() - 1);
    for (int64_t j = 0; j < n; j++) {
      int64_t k = wi.find(pos[j]);
      if (k >= 0) idx[cur[k]++] = j;
    }
  }
  std::vector<AltSlot> slots;
  for (int64_t k = 0; k < npos; k++) {
    slots.clear();
    int16_t pure_slot[12];
    for (int i = 0; i < 12; i++) pure_slot[i] = -1;
    for (int64_t t = offsets[k]; t < offsets[k + 1]; t++) {
      int64_t j = idx[t];
      int8_t c = code[j];
      if (bq[j] < min_bq || mq[j] < min_mq) continue;
      int8_t kind = ikind[j];
      if (c >= 10 && kind == 0) continue;
      if (kind == 0) {
        int16_t s = pure_slot[c];
        if (s < 0) {
          pure_slot[c] = (int16_t)slots.size();
          slots.push_back({c, 0, 0, 0, 1});
        } else {
          slots[s].count += 1;
        }
        continue;
      }
      int32_t len = ilen[j];
      int64_t off = (kind == 1) ? iseq_off[j] : 0;
      int found = -1;
      for (size_t s = 0; s < slots.size(); s++) {
        const AltSlot& sl = slots[s];
        if (sl.code != c || sl.kind != kind || sl.len != len) continue;
        if (kind == 1 &&
            memcmp(iseq_blob + sl.off, iseq_blob + off, (size_t)len) != 0)
          continue;
        found = (int)s;
        break;
      }
      if (found >= 0) slots[found].count += 1;
      else slots.push_back({c, kind, len, off, 1});
    }
    emit(k, slots);
  }
}

const char kAltBaseChar[12] = {'A', 'C', 'G', 'T', 'a', 'c',
                               'g', 't', '*', '#', 'N', 'n'};

inline int append_int(uint8_t* dst, int64_t v) {
  char buf[24];
  int n = snprintf(buf, sizeof buf, "%lld", (long long)v);
  memcpy(dst, buf, (size_t)n);
  return n;
}
}  // namespace

extern "C" {

// Vectorized-superset candidate prefilter over the fused window's dense
// candidate-view stats (the numpy mask chain in pileup.py::find_candidates
// use_win branch, one C pass): a position survives when depth >
// min_coverage, its reference base is ACGT, and some non-ref base count
// (or, with select_indel, the ins/del total) meets both the support and
// AF thresholds.  Identical float semantics (double division).
void window_candidate_prefilter(
    int64_t L, const int32_t* cand_base, const int32_t* cand_depth,
    const int32_t* cand_ins, const int32_t* cand_del,
    const int8_t* ref_codes, int min_coverage, double snv_min_af,
    double indel_min_af, int support, int select_indel, uint8_t* out_mask) {
  for (int64_t i = 0; i < L; i++) {
    out_mask[i] = 0;
    int8_t rc = ref_codes[i];
    if (rc < 0) continue;
    int32_t depth = cand_depth[i];
    if (depth <= min_coverage) continue;
    double denom = depth > 1 ? (double)depth : 1.0;
    const int32_t* bc = cand_base + i * 4;
    bool alt = false;
    for (int c = 0; c < 4 && !alt; c++) {
      if (c == rc) continue;
      int32_t cnt = bc[c];
      if (cnt >= support && (double)cnt / denom >= snv_min_af) alt = true;
    }
    if (!alt && select_indel) {
      int32_t it = cand_ins[i], dt = cand_del[i];
      if ((it >= support && (double)it / denom >= indel_min_af) ||
          (dt >= support && (double)dt / denom >= indel_min_af))
        alt = true;
    }
    if (alt) out_mask[i] = 1;
  }
}

// Candidate exact gating on the aggregated keys (the Python fold in
// pileup.py::find_candidates:879-948, flag outputs only).  out_flags[k]:
// bit0 = SNV candidate (pass_snv && depth gate && an ACGT alt entry
// exists), bit1 = indel candidate.  The af/alt_list bookkeeping of the
// Python loop is debug-output-only (--alt_fn) and is skipped here — the
// CLI falls back to the Python path when those are requested.
void entry_candidate_gate(
    int64_t n, const int64_t* pos, const int8_t* code, const int16_t* bq,
    const int16_t* mq, const int8_t* ikind, const int32_t* ilen,
    const int64_t* iseq_off, const char* iseq_blob,
    int64_t npos, const int64_t* want, int min_bq, int min_mq,
    const char* ref_seq, int64_t ref_len, int64_t ref_start,
    int min_coverage, double snv_min_af, double indel_min_af, int support,
    int select_indel, uint8_t* out_flags) {
  aggregate_slots(
      n, pos, code, bq, mq, ikind, ilen, iseq_off, iseq_blob, npos, want,
      min_bq, min_mq,
      [&](int64_t k, const std::vector<AltSlot>& slots) {
        out_flags[k] = 0;
        int64_t ri = want[k] - ref_start;
        char rb = (ri >= 0 && ri < ref_len) ? ref_seq[ri] : 'N';
        int rbi = -1;
        switch (rb) {
          case 'A': rbi = 0; break;
          case 'C': rbi = 1; break;
          case 'G': rbi = 2; break;
          case 'T': rbi = 3; break;
        }
        if (rbi < 0) return;   // rb not in ACGT -> no candidate
        // folded counters: ACGT (uppercased), distinct I-keys, distinct
        // D-keys (select_indel folds by identity; otherwise one bucket)
        int64_t base_cnt[4] = {0, 0, 0, 0};
        int64_t depth = 0;
        bool has_snv_alt = false, has_indel_alt = false;
        // distinct indel folded keys: by (kind, len, bytes-upper) when
        // select_indel, else one I and one D bucket
        std::vector<std::pair<const AltSlot*, int64_t>> ikeys;
        for (const AltSlot& sl : slots) {
          char bc = kAltBaseChar[sl.code];
          int bi = -1;
          switch (bc) {
            case 'A': case 'a': bi = 0; break;
            case 'C': case 'c': bi = 1; break;
            case 'G': case 'g': bi = 2; break;
            case 'T': case 't': bi = 3; break;
          }
          if (bi >= 0) {
            base_cnt[bi] += sl.count;
            depth += sl.count;
            if (sl.kind == 0 && bi != rbi) has_snv_alt = true;
          } else if (bc == '#' || bc == '*') {
            depth += sl.count;
          }
          if (sl.kind == 1 || sl.kind == 2) {
            has_indel_alt = true;
            if (select_indel) {
              // fold by uppercase identity: I<base><SEQ> / D<NNN...>
              bool found = false;
              for (auto& kv : ikeys) {
                const AltSlot* o = kv.first;
                if (o->kind != sl.kind || o->len != sl.len) continue;
                if (sl.kind == 2) { kv.second += sl.count; found = true; break; }
                // ins: uppercase byte compare of seq + anchor base class
                char ob = kAltBaseChar[o->code], nb = kAltBaseChar[sl.code];
                if (toupper(ob) != toupper(nb)) continue;
                bool eq = true;
                for (int32_t t = 0; t < sl.len; t++)
                  if (toupper((unsigned char)iseq_blob[o->off + t]) !=
                      toupper((unsigned char)iseq_blob[sl.off + t])) {
                    eq = false;
                    break;
                  }
                if (eq) { kv.second += sl.count; found = true; break; }
              }
              if (!found) ikeys.push_back({&sl, sl.count});
            }
          }
        }
        int64_t denom = depth > 0 ? depth : 1;
        bool pass_depth = depth > min_coverage;
        bool pass_snv = false, pass_indel = false;
        for (int b = 0; b < 4; b++) {
          if (b == rbi) continue;
          if (base_cnt[b] > 0 &&
              (double)base_cnt[b] / (double)denom >= snv_min_af &&
              base_cnt[b] >= support)
            pass_snv = true;
        }
        if (select_indel)
          for (auto& kv : ikeys)
            if ((double)kv.second / (double)denom >= indel_min_af &&
                kv.second >= support)
              pass_indel = true;
        uint8_t f = 0;
        if (pass_snv && pass_depth && has_snv_alt) f |= 1;
        if (select_indel && pass_indel && pass_depth && has_indel_alt)
          f |= 2;
        out_flags[k] = f;
      });
}

// alt_info string assembly on the aggregated keys — byte-identical to
// pileup.py::alt_info_at's fold over _alt_groups output (X/I/D/R keys in
// first-encounter order of the FOLDED key, R last, max_indel gates, D info
// from raw reference bytes anchored AT the position).  Returns total blob
// bytes used, or -1 when blob_cap is too small (needed size stored).
int64_t entry_alt_info(
    int64_t n, const int64_t* pos, const int8_t* code, const int16_t* bq,
    const int16_t* mq, const int8_t* ikind, const int32_t* ilen,
    const int64_t* iseq_off, const char* iseq_blob,
    int64_t npos, const int64_t* want, int min_bq, int min_mq,
    int max_indel_len,
    const char* ref_seq, int64_t ref_len, int64_t ref_start,
    int32_t* out_depth, int32_t* out_str_len,
    uint8_t* str_blob, int64_t blob_cap, int64_t* needed_blob) {
  *needed_blob = 0;
  int64_t blob_out = 0;
  bool overflow = false;
  // folded output keys per position, first-encounter order
  struct FKey {
    char tag;              // 'X', 'I', 'D'
    char xbase;            // X: uppercased base
    const AltSlot* sl;     // I/D: representative slot (uppercase identity)
    int64_t count;
  };
  std::vector<FKey> fkeys;
  std::string scratch;
  aggregate_slots(
      n, pos, code, bq, mq, ikind, ilen, iseq_off, iseq_blob, npos, want,
      min_bq, min_mq,
      [&](int64_t k, const std::vector<AltSlot>& slots) {
        fkeys.clear();
        int64_t p = want[k];
        int64_t ri = p - ref_start;
        char rb = (ri >= 0 && ri < ref_len) ? ref_seq[ri] : 'N';
        int64_t depth = 0, ref_count = 0;
        for (const AltSlot& sl : slots) {
          char bc = kAltBaseChar[sl.code];
          char up = (char)toupper((unsigned char)bc);
          if (sl.kind == 0) {
            if (up == 'A' || up == 'C' || up == 'G' || up == 'T') {
              depth += sl.count;
              if (up != rb) {
                bool found = false;
                for (auto& fk : fkeys)
                  if (fk.tag == 'X' && fk.xbase == up) {
                    fk.count += sl.count;
                    found = true;
                    break;
                  }
                if (!found) fkeys.push_back({'X', up, nullptr, sl.count});
              } else {
                ref_count += sl.count;
              }
            } else if (bc == '#' || bc == '*') {
              depth += sl.count;
            }
          } else if (sl.kind == 1) {
            if (sl.len > max_indel_len) continue;
            depth += sl.count;
            bool found = false;
            for (auto& fk : fkeys) {
              if (fk.tag != 'I' || fk.sl->len != sl.len) continue;
              char ob = (char)toupper(
                  (unsigned char)kAltBaseChar[fk.sl->code]);
              char nb = up;
              if (ob != nb) continue;
              bool eq = true;
              for (int32_t t = 0; t < sl.len; t++)
                if (toupper((unsigned char)iseq_blob[fk.sl->off + t]) !=
                    toupper((unsigned char)iseq_blob[sl.off + t])) {
                  eq = false;
                  break;
                }
              if (eq) { fk.count += sl.count; found = true; break; }
            }
            if (!found) fkeys.push_back({'I', up, &sl, sl.count});
          } else {  // deletion: key "D" + ref[p .. p+len] raw bytes
            if (1 + sl.len > max_indel_len) continue;
            depth += sl.count;
            bool found = false;
            for (auto& fk : fkeys)
              if (fk.tag == 'D' && fk.sl->len == sl.len) {
                // D info depends only on (pos, len) -> same key
                fk.count += sl.count;
                found = true;
                break;
              }
            if (!found) fkeys.push_back({'D', 0, &sl, sl.count});
          }
        }
        out_depth[k] = (int32_t)depth;
        // assemble "<depth>-<k1 c1 k2 c2 ...>[ R<rb> c]-"
        scratch.clear();
        {
          char buf[24];
          snprintf(buf, sizeof buf, "%lld", (long long)depth);
          scratch += buf;
        }
        scratch += '-';
        bool first = true;
        auto add_key = [&](const std::string& key, int64_t cnt) {
          if (!first) scratch += ' ';
          first = false;
          scratch += key;
          scratch += ' ';
          char buf[24];
          snprintf(buf, sizeof buf, "%lld", (long long)cnt);
          scratch += buf;
        };
        std::string keybuf;
        for (auto& fk : fkeys) {
          keybuf.clear();
          if (fk.tag == 'X') {
            keybuf += 'X';
            keybuf += fk.xbase;
          } else if (fk.tag == 'I') {
            keybuf += 'I';
            keybuf += (char)toupper((unsigned char)kAltBaseChar[fk.sl->code]);
            for (int32_t t = 0; t < fk.sl->len; t++)
              keybuf += (char)toupper((unsigned char)iseq_blob[fk.sl->off + t]);
          } else {
            keybuf += 'D';
            for (int32_t t = 0; t <= fk.sl->len; t++) {
              int64_t rj = p + t - ref_start;
              keybuf += (rj >= 0 && rj < ref_len) ? ref_seq[rj] : 'N';
            }
          }
          add_key(keybuf, fk.count);
        }
        if (ref_count > 0) {
          keybuf.clear();
          keybuf += 'R';
          keybuf += rb;
          add_key(keybuf, ref_count);
        }
        scratch += '-';
        int64_t slen = (int64_t)scratch.size();
        out_str_len[k] = (int32_t)slen;
        *needed_blob += slen;
        if (!overflow) {
          if (blob_out + slen > blob_cap) {
            overflow = true;
          } else {
            memcpy(str_blob + blob_out, scratch.data(), (size_t)slen);
            blob_out += slen;
          }
        }
      });
  return overflow ? -1 : blob_out;
}

// Reference-channel negation (create_tensor_pileup_calling.py:223-228):
// for each row, overwrite the ref base's slot in each 4-wide strand block
// with the negated block sum.  One memory-bound pass over (L, nchan) int32
// counts; blocks are the channel offsets of the A.../a... groups.
void ref_negate_channels(
    int64_t L, int32_t nchan, int32_t* counts,
    const int64_t* ref_idx, int32_t n_blocks, const int32_t* blocks) {
  for (int64_t i = 0; i < L; i++) {
    int32_t* row = counts + i * (int64_t)nchan;
    const int64_t r = ref_idx[i];
    for (int32_t b = 0; b < n_blocks; b++) {
      int32_t* blk = row + blocks[b];
      const int32_t s = blk[0] + blk[1] + blk[2] + blk[3];
      blk[r] = -s;
    }
  }
}


// ---------------------------------------------------------------------------
// Fused per-chunk reductions for the hard/haplotype filter index
// (postcall/hardfilter.py::FilterIndex).  The index needs a dozen per-column
// and per-entry reductions; doing them as separate numpy passes costs tens
// of seconds on deep chunks (10^7-10^8 entries) — these two fused passes
// replace all of them.  ref_tok: int16 per column in [p0, p0+m):
// 0-3 = ACGT, 10 = sentinel (never matches an entry).

static const int16_t FILT_BASE_ID[11] = {0, 1, 2, 3, 0, 1, 2, 3, 8, 9, 10};

// [j0, j1): entry subrange — the two passes are memory-bandwidth bound, so
// the caller splits the table across worker threads (ctypes releases the
// GIL) with per-thread output arrays merged in numpy.
void entry_filter_stats(
    int64_t j0, int64_t j1, const int64_t* pos, const int8_t* code,
    const int16_t* bq,
    const int16_t* mq, const int8_t* ikind, const int32_t* ilen,
    const int32_t* read_id, const int8_t* eflags,
    int64_t p0, int64_t m, int16_t min_bq, int16_t min_mq, int32_t ins_cap,
    const int16_t* ref_tok,
    const uint8_t* col_mask,  // optional [m]: 0 = column outside any
                              // verdict window, entry skipped entirely
    int64_t* depth, int64_t* nstarts, int64_t* nends,
    int64_t* nonref_cnt, int64_t* col_ins,
    int64_t* out_n_sel, int64_t* out_n_nonref, int64_t* out_max_read) {
  for (int64_t c = 0; c < m; c++)
    depth[c] = nstarts[c] = nends[c] = nonref_cnt[c] = col_ins[c] = 0;
  int64_t n_sel = 0, n_nonref = 0, max_read = -1;
  for (int64_t j = j0; j < j1; j++) {
    if (mq[j] < min_mq || bq[j] < min_bq || code[j] >= 10) continue;
    int64_t c = pos[j] - p0;
    if (c < 0 || c >= m) continue;
    if (col_mask && !col_mask[c]) continue;
    n_sel++;
    depth[c]++;
    if (read_id[j] > max_read) max_read = read_id[j];
    if (eflags[j] & 1) nstarts[c]++;
    if (eflags[j] & 2) nends[c]++;
    int16_t b = FILT_BASE_ID[(int)code[j]];
    bool is_ref = (ikind[j] == 0) && (b == ref_tok[c]);
    if (!is_ref) {
      n_nonref++;
      nonref_cnt[c]++;
      if (ikind[j] == 1 && ilen[j] > 2)
        col_ins[c] += (ilen[j] < ins_cap ? ilen[j] : ins_cap);
    }
  }
  *out_n_sel = n_sel;
  *out_n_nonref = n_nonref;
  *out_max_read = max_read;
}

void entry_filter_extract(
    int64_t j0, int64_t j1, const int64_t* pos, const int8_t* code,
    const int16_t* bq,
    const int16_t* mq, const int8_t* ikind, const int32_t* ilen,
    const int32_t* read_id, const int8_t* eflags,
    int64_t p0, int64_t m, int16_t min_bq, int16_t min_mq,
    const int16_t* ref_tok,
    const uint8_t* col_mask,
    const int8_t* col_side,   // 0 = unmarked col, 1 = starts marked, 2 = ends
    int64_t* sort_ofs,        // [m] column start offsets (consumed)
    int64_t* nr_ofs,          // [m] nonref column start offsets (consumed)
    int32_t* orig,            // [n_sel] counting-sorted original entry rows
    int32_t* nr_entry, int64_t* nr_pos, int32_t* nr_read,
    int8_t* nr_base, int8_t* nr_ik, int32_t* nr_ilen,
    int64_t* rse_pos, int32_t* rse_read, int64_t* out_n_rse) {
  int64_t n_rse = 0;
  for (int64_t j = j0; j < j1; j++) {
    if (mq[j] < min_mq || bq[j] < min_bq || code[j] >= 10) continue;
    int64_t c = pos[j] - p0;
    if (c < 0 || c >= m) continue;
    if (col_mask && !col_mask[c]) continue;
    orig[sort_ofs[c]++] = (int32_t)j;
    int16_t b = FILT_BASE_ID[(int)code[j]];
    bool is_ref = (ikind[j] == 0) && (b == ref_tok[c]);
    if (!is_ref) {
      int64_t k = nr_ofs[c]++;
      nr_entry[k] = (int32_t)j;
      nr_pos[k] = pos[j];
      nr_read[k] = read_id[j];
      nr_base[k] = (int8_t)b;
      nr_ik[k] = ikind[j];
      nr_ilen[k] = ilen[j];
    }
    int8_t side = col_side[c];
    if ((side == 1 && (eflags[j] & 1)) || (side == 2 && (eflags[j] & 2))) {
      rse_pos[n_rse] = pos[j];
      rse_read[n_rse] = read_id[j];
      n_rse++;
    }
  }
  *out_n_rse = n_rse;
}



}  // extern "C"

// ===================================================================
// Fused window reduce (round 4): decode a window's reads ONCE, directly
// accumulating the dense per-position reductions every downstream stage
// needs — the dual-BQ tensor channel counts (create_tensor semantics),
// their depths, and the candidate-view stats (extract_candidates
// semantics) — WITHOUT materializing the full column-entry table.
//
// Rationale: a 4Mb@60x chunk holds ~2.4e8 entries = ~7.7 GB of entry
// arrays, and this host first-touch-faults fresh pages at ~250 MB/s, so
// the table IS the end-to-end wall (BENCH_r03: decode 158s of a 156s
// calling stage).  The dense outputs are ~1 GB (pooled and re-used across
// chunks); full entries are materialized afterwards ONLY inside
// candidate/filter site windows via pileup_window_entries_* — typically
// 100-1000x fewer entries than the full table.
//
// Semantics are inherited 1:1 from the entry-table reductions above
// (entry_channel_counts / entry_candidate_prefilter), which remain the
// behavioral reference and are cross-validated in tests/test_fused_decode.
// ===================================================================

namespace {

// Parsed view over a RawRecord body (no copies).
struct RecView {
  const char* name;
  uint16_t flag;
  int64_t pos;
  uint8_t mapq;
  const uint32_t* cigar;
  int n_cigar;
  const uint8_t* seq4;
  const uint8_t* qual;   // nullptr when the 0xFF "missing" sentinel is set
  int32_t l_seq;
  const uint8_t* tags;
  int tags_len;
};

bool parse_rec(const RawRecord& rr, int excl_flags, int min_mapq,
               RecView* v) {
  const uint8_t* rec = rr.rec.data();
  int64_t block_size = (int64_t)rr.rec.size();
  uint8_t l_read_name = rec[8];
  v->mapq = rec[9];
  memcpy(&v->n_cigar, rec + 12, 2);
  v->n_cigar &= 0xFFFF;
  memcpy(&v->flag, rec + 14, 2);
  memcpy(&v->l_seq, rec + 16, 4);
  if (v->flag & excl_flags) return false;
  if (v->mapq < min_mapq) return false;
  v->pos = rr.pos;
  v->name = (const char*)rec + 32;
  v->cigar = (const uint32_t*)(rec + 32 + l_read_name);
  v->seq4 = rec + 32 + l_read_name + 4 * v->n_cigar;
  const uint8_t* qual = v->seq4 + (v->l_seq + 1) / 2;
  v->qual = (v->l_seq && qual[0] == 0xFF) ? nullptr : qual;
  v->tags = qual + v->l_seq;
  v->tags_len = (int)(rec + block_size - v->tags);
  return true;
}

inline char rec_base(const RecView& v, int i) {
  uint8_t c = (i & 1) ? (v.seq4[i >> 1] & 0xF) : (v.seq4[i >> 1] >> 4);
  return SEQ_NT16[c];
}
inline int rec_qual(const RecView& v, int i) {
  return v.qual ? v.qual[i] : 0;
}

// Open-addressing hash for indel distinct-seq events.  Key packs
// (rel_pos <=26 bits, fwd, kind, len <=6 bits, 3-bit-packed seq <=8 bases)
// plus a high tag bit so 0 stays the empty sentinel; longer insertion
// seqs go to an exact std::string map (rare).
struct IndelHash {
  std::vector<uint64_t> keys;
  std::vector<int32_t> affc, negc;
  size_t msk = 0, used = 0;
  void init(size_t want) {
    size_t cap = 1024;
    while (cap < want * 2) cap <<= 1;
    keys.assign(cap, 0);
    affc.assign(cap, 0);
    negc.assign(cap, 0);
    msk = cap - 1;
    used = 0;
  }
  void grow() {
    IndelHash bigger;
    bigger.init((msk + 1));
    for (size_t i = 0; i <= msk; i++)
      if (keys[i]) {
        size_t j = bigger.find(keys[i]);
        bigger.keys[j] = keys[i];
        bigger.affc[j] = affc[i];
        bigger.negc[j] = negc[i];
        bigger.used++;
      }
    *this = std::move(bigger);
  }
  inline size_t find(uint64_t key) const {
    size_t i = (size_t)(key * 0x9E3779B97F4A7C15ull) & msk;
    while (keys[i] != 0 && keys[i] != key) i = (i + 1) & msk;
    return i;
  }
  inline void add(uint64_t key, bool aff) {
    if (used * 10 >= (msk + 1) * 7) grow();
    size_t i = find(key);
    if (keys[i] == 0) { keys[i] = key; used++; }
    negc[i] += 1;
    if (aff) affc[i] += 1;
  }
};

inline int pack3(char b) {
  switch (b) {
    case 'A': return 0;
    case 'C': return 1;
    case 'G': return 2;
    case 'T': return 3;
    default: return 4;
  }
}

struct ReduceOut {
  int32_t *aff, *aff_depth, *neg, *neg_depth;
  int32_t *cand_base, *cand_depth, *cand_ins, *cand_del;
  int64_t L;
  int nchan;
  int aff_bq, low_mq, low_bq, max_indel, with_phasing, dual, cand_min_mq;
  IndelHash ih;
  std::unordered_map<std::string, std::pair<int32_t, int32_t>> ih_long;
};

// One tensor view's accumulation for a single entry (mirrors
// entry_channel_counts above; 'pure' = no indel suffix).
inline void accum_tensor(ReduceOut& o, int32_t* out, int32_t* depth,
                         int64_t rel, int c, int bq, int mq, int hp,
                         int ikind, int ilen) {
  bool hi_mq = mq >= o.low_mq;
  int32_t* row = out + rel * o.nchan;
  if (ikind == 0) {
    if (c >= 10) return;  // pure N: nothing, not even LMQ/LBQ
    if (hi_mq) {
      int ch = c < 4 ? c : (c < 8 ? c + 5 : (c == 8 ? 8 : 17));
      row[ch] += 1;
      depth[rel] += 1;
    } else if (c < 8) {
      row[c < 4 ? c + 18 : c - 4 + 22] += 1;
    }
    if (c < 8 && bq < o.low_bq) row[c < 4 ? c + 26 : c - 4 + 30] += 1;
  } else if (hi_mq) {
    bool is_ins = ikind == 1;
    bool ok = is_ins ? (ilen <= o.max_indel) : (ilen + 1 <= o.max_indel);
    if (ok) {
      bool fwd = (c < 4) || (c == 8) || (c == 10);
      depth[rel] += 1;
      row[is_ins ? (fwd ? 4 : 13) : (fwd ? 6 : 15)] += 1;
    }
  }
  // pure entries only: indel-suffixed keys fail the reference's
  // 'ACGTacgt' membership test (create_tensor:150-154)
  if (o.with_phasing && ikind == 0 && c < 8 && (hp == 1 || hp == 2))
    row[34 + (hp == 2 ? 8 : 0) + (c % 8)] += 1;
}

// Full per-entry accumulation: AFF view (bq >= aff_bq), NEG view (all bq,
// only when dual), indel distinct-seq events, candidate-view stats.
// seq: uppercase insertion sequence (only consulted for kind==1 with
// ilen <= max_indel); may be null otherwise.
inline void accum_entry(ReduceOut& o, int64_t rel, int c, int bq, int mq,
                        int hp, int ikind, int ilen, const char* seq) {
  if (c >= 10 && ikind == 0) return;  // pure N consumes nothing in any view
  bool aff_ok = bq >= o.aff_bq;
  // NEG = AFF + low-bq delta on every additive channel: entries passing
  // the AFF bq gate accumulate once, the final reduce adds aff into neg
  // (the I1/i1/D1/d1 max channels are zero until the hash flush, which
  // writes both views from its per-cell counts — so the add is exact)
  if (aff_ok) accum_tensor(o, o.aff, o.aff_depth, rel, c, bq, mq, hp, ikind, ilen);
  else if (o.dual) accum_tensor(o, o.neg, o.neg_depth, rel, c, bq, mq, hp, ikind, ilen);
  if (ikind != 0 && mq >= o.low_mq && (aff_ok || o.dual)) {
    bool is_ins = ikind == 1;
    bool ok = is_ins ? (ilen <= o.max_indel) : (ilen + 1 <= o.max_indel);
    if (ok) {
      bool fwd = (c < 4) || (c == 8) || (c == 10);
      uint64_t key = (1ull << 63) | ((uint64_t)rel << 37) |
                     ((uint64_t)(fwd ? 1 : 0) << 36) |
                     ((uint64_t)(is_ins ? 0 : 1) << 35) |
                     ((uint64_t)(ilen & 63) << 29);
      if (is_ins && ilen > 8) {
        char hdr[8];
        memcpy(hdr, &key, 8);
        std::string k(hdr, 8);
        k.append(seq, (size_t)ilen);
        auto& cell = o.ih_long[k];
        cell.second += 1;
        if (aff_ok) cell.first += 1;
      } else {
        if (is_ins) {
          uint64_t sp = 0;
          for (int t = 0; t < ilen; t++)
            sp |= (uint64_t)pack3(seq[t]) << (3 * t);
          key |= sp;
        }
        o.ih.add(key, aff_ok);
      }
    }
  }
  if (aff_ok && mq >= o.cand_min_mq) {
    if (c < 10) {
      o.cand_depth[rel] += 1;
      if (c < 8) o.cand_base[rel * 4 + (c & 3)] += 1;
    }
    if (ikind == 1) o.cand_ins[rel] += 1;
    else if (ikind == 2) o.cand_del[rel] += 1;
  }
}

// Apply one distinct-seq cell to the I1/i1/D1/d1 max channels.
inline void flush_indel_cell(ReduceOut& o, uint64_t key, int32_t ac,
                             int32_t nc) {
  int64_t rel = (int64_t)((key >> 37) & ((1ull << 26) - 1));
  bool fwd = (key >> 36) & 1;
  bool is_del = (key >> 35) & 1;
  int ch = is_del ? (fwd ? 7 : 16) : (fwd ? 5 : 14);
  int32_t* ra = o.aff + rel * o.nchan;
  if (ac > ra[ch]) ra[ch] = ac;
  if (o.dual) {
    int32_t* rn = o.neg + rel * o.nchan;
    if (nc > rn[ch]) rn[ch] = nc;
  }
}

static const int16_t FILT_BASE_ID12[12] = {0, 1, 2, 3, 0, 1, 2, 3,
                                           8, 9, 10, 10};

// --- M-run fast-path lookup tables (round 5) -------------------------------
// nibble -> entry code per strand (BAM 4-bit seq encoding; SEQ_NT16 order):
// A=1 C=2 G=4 T=8 map to 0-3 (+4 reversed); everything else is skip.
struct NibCodeLUT {
  int8_t t[2][16];
  NibCodeLUT() {
    for (int rev = 0; rev < 2; rev++)
      for (int n = 0; n < 16; n++) {
        int8_t c = rev ? CODE_SKIP_REV : CODE_SKIP;
        switch (n) {
          case 1: c = rev ? 4 : 0; break;   // A
          case 2: c = rev ? 5 : 1; break;   // C
          case 4: c = rev ? 6 : 2; break;   // G
          case 8: c = rev ? 7 : 3; break;   // T
        }
        t[rev][n] = c;
      }
  }
};
static const NibCodeLUT NIB_CODE;
// channel of a pure base entry, per code 0-7 (accum_tensor's ch formula)
static const int8_t CH_MAIN[8] = {0, 1, 2, 3, 9, 10, 11, 12};
static const int8_t CH_LMQ[8] = {18, 19, 20, 21, 22, 23, 24, 25};
static const int8_t CH_LBQ[8] = {26, 27, 28, 29, 30, 31, 32, 33};

inline uint8_t rec_nib(const RecView& v, int i) {
  return (i & 1) ? (v.seq4[i >> 1] & 0xF) : (uint8_t)(v.seq4[i >> 1] >> 4);
}

// Fused-reduce window state, retained for the masked entries pass.
// Also carries the filter-view (hard/haplotype verdict) accumulators: the
// non-ref entry stream, read start/end marks, and dense per-column
// depth/nonref/inserted-length stats over the extended span
// [start - fmargin, end + fmargin) — emitted during the SAME decode pass so
// FilterIndex construction never touches a full entry table again.
struct WindowHandle {
  std::vector<std::shared_ptr<RawRecord>> records;
  // filter-view config (set when filt_depth != nullptr)
  int filt_min_bq = 0, filt_min_mq = 20;
  int64_t fstart = 0, fend = 0;       // extended span bounds
  const int16_t* ref_tok = nullptr;   // [fend - fstart], python-owned
  int32_t *filt_depth = nullptr, *filt_nonref = nullptr;
  int32_t *filt_colins = nullptr;     // sum of min(ilen,200) for ins>2
  // non-ref entry stream (filter view), emission order
  std::vector<int32_t> nr_rel, nr_read, nr_ilen;
  std::vector<int8_t> nr_base, nr_ik;
  std::vector<int64_t> nr_sub;
  std::unordered_map<std::string, int64_t> long_ins_ids;
  // read start/end marks (filter view)
  std::vector<int32_t> st_rel, st_read, en_rel, en_read;
  // assembled (column-sorted) state, built by pileup_window_filter_assemble
  bool assembled = false;
  int64_t T = 11;
  std::vector<int64_t> nr_token, ck_key, ck_cnt;
  // scratch for pileup_window_reads_select (realignment-filter fetches)
  std::vector<int64_t> rd_pos;
  std::vector<int32_t> rd_flag, rd_mapq;
  std::vector<int64_t> rd_seq_off, rd_cig_off;
  std::string rd_seq_blob, rd_cig_blob;
  // overlap-adjusted qual copies (htslib tweak_overlap_quality), computed
  // over the FULL mate overlap at reduce time and shared by the masked
  // entries pass — records themselves stay immutable (thread-safety with
  // the decode-ahead worker)
  std::unordered_map<const RawRecord*, std::vector<uint8_t>> adj_quals;
  int excl_flags = 0, min_mapq = 0, handle_overlaps = 0;
  int64_t start = 0, end = 0;
  int64_t n_reads = 0;
};

// Filter-view accumulation for one entry (mirrors entry_filter_stats /
// entry_filter_extract semantics over the full window, maskless).
inline void filt_accum(WindowHandle* h, int64_t p, int c, int bq, int mq,
                       int ikind, int ilen, const char* seq, int rid,
                       bool is_start, bool is_end) {
  if (!h->filt_depth) return;
  if (c >= 10 || mq < h->filt_min_mq || bq < h->filt_min_bq) return;
  if (p < h->fstart || p >= h->fend) return;
  int64_t rel = p - h->fstart;
  h->filt_depth[rel] += 1;
  if (is_start) { h->st_rel.push_back((int32_t)rel); h->st_read.push_back(rid); }
  if (is_end) { h->en_rel.push_back((int32_t)rel); h->en_read.push_back(rid); }
  int16_t b = FILT_BASE_ID12[c];
  bool is_ref = (ikind == 0) && (b == h->ref_tok[rel]);
  if (is_ref) return;
  h->filt_nonref[rel] += 1;
  int64_t sub = 0;
  if (ikind == 1) {
    if (ilen > 2)
      h->filt_colins[rel] += (ilen < 200 ? ilen : 200);
    if (ilen <= 8) {
      int64_t packed = 0;
      for (int t = 0; t < ilen; t++)
        packed |= (int64_t)pack3(seq[t]) << (3 * t);
      sub = packed + 1;
    } else {
      // key capped at the 64-byte capture buffer: two distinct >64bp
      // insertions sharing a 64bp prefix at the same column fold to one
      // token (affects only a tie-break in the variant-cluster verdict)
      std::string k(seq, (size_t)(ilen < 64 ? ilen : 64));
      auto it = h->long_ins_ids.find(k);
      if (it == h->long_ins_ids.end()) {
        sub = (1ll << 25) + (int64_t)h->long_ins_ids.size();
        h->long_ins_ids.emplace(std::move(k), sub);
      } else {
        sub = it->second;
      }
    }
  } else if (ikind == 2) {
    sub = ilen;
  }
  h->nr_rel.push_back((int32_t)rel);
  h->nr_read.push_back(rid);
  h->nr_base.push_back((int8_t)b);
  h->nr_ik.push_back((int8_t)ikind);
  h->nr_ilen.push_back(ilen);
  h->nr_sub.push_back(sub);
}


// Per-read hoisted gates for the M-run fast path.
struct MRunCtx {
  bool hi_mq, cand_ok, dual, filt_on, filt_mq_ok;
  const int8_t* nibcode;   // strand's nibble->code row
  int aff_bq, low_bq, filt_min_bq;
};

// Specialized accumulation for the INTERIOR of an M/=/X run: pure bases
// only (no indel anchoring, no phasing channels), per-read gates hoisted,
// k-range pre-clipped by the caller so the loop carries no bounds checks.
// Semantics identical to accum_entry + filt_accum for ikind==0 entries
// (cross-checked by tests/test_fused_decode.py's bitwise equality).
template <bool TENSOR>
inline void mrun_accum(ReduceOut& o, WindowHandle* h, const RecView& v,
                       const uint8_t* q_eff, const MRunCtx& cx,
                       int64_t ref_pos, int qpos, int64_t k0, int64_t k1,
                       int64_t start, int rid, int64_t first_pos,
                       int64_t last_pos) {
  for (int64_t k = k0; k < k1; k++) {
    int qk = qpos + (int)k;
    int c = cx.nibcode[rec_nib(v, qk)];
    if (c >= 10) continue;             // pure N: consumed by no view
    int q = q_eff[qk];
    int64_t p = ref_pos + k;
    if (TENSOR) {
      bool aff_ok = q >= cx.aff_bq;
      int64_t rel = p - start;
      if (aff_ok || cx.dual) {
        int32_t* row = (aff_ok ? o.aff : o.neg) + rel * o.nchan;
        if (cx.hi_mq) {
          row[CH_MAIN[c]] += 1;
          (aff_ok ? o.aff_depth : o.neg_depth)[rel] += 1;
        } else {
          row[CH_LMQ[c]] += 1;
        }
        if (q < cx.low_bq) row[CH_LBQ[c]] += 1;
      }
      if (aff_ok && cx.cand_ok) {
        o.cand_depth[rel] += 1;
        o.cand_base[rel * 4 + (c & 3)] += 1;
      }
    }
    if (cx.filt_mq_ok && q >= cx.filt_min_bq) {
      int64_t frel = p - h->fstart;
      h->filt_depth[frel] += 1;
      if (p == first_pos) {
        h->st_rel.push_back((int32_t)frel);
        h->st_read.push_back(rid);
      }
      if (p == last_pos) {
        h->en_rel.push_back((int32_t)frel);
        h->en_read.push_back(rid);
      }
      int16_t b = FILT_BASE_ID12[c];
      if (b != h->ref_tok[frel]) {   // rare: mismatch entry
        h->filt_nonref[frel] += 1;
        h->nr_rel.push_back((int32_t)frel);
        h->nr_read.push_back(rid);
        h->nr_base.push_back((int8_t)b);
        h->nr_ik.push_back(0);
        h->nr_ilen.push_back(0);
        h->nr_sub.push_back(0);
      }
    }
  }
}

// First/last ref-consuming positions of a read ('^'/'$' flag columns).
inline void read_span_marks(const RecView& v, int64_t* first_pos,
                            int64_t* last_pos) {
  int64_t ref_pos = v.pos;
  *first_pos = -1;
  *last_pos = -1;
  for (int i = 0; i < v.n_cigar; i++) {
    int op = v.cigar[i] & 0xF;
    int ln = v.cigar[i] >> 4;
    if (op == 0 || op == 7 || op == 8 || op == 2) {
      if (*first_pos < 0) *first_pos = ref_pos;
      *last_pos = ref_pos + ln - 1;
      ref_pos += ln;
    } else if (op == 3) {
      ref_pos += ln;
    }
  }
}

// The fused streaming decode+accumulate for one record.  A one-entry
// "pending" buffer reproduces the anchor semantics of Decoder::add_read
// (indel suffix attaches to the previous ref-consuming entry, last-wins)
// before each entry is flushed into the dense accumulators.  Entries
// outside [start,end) are skipped — matching the region filters of the
// entry-table reductions.
void reduce_record(ReduceOut& o, const RecView& v, const uint8_t* adj_qual,
                   int64_t start, int64_t end, int hp, WindowHandle* h,
                   int rid) {
  bool rev = v.flag & FLAG_REVERSE;
  int64_t ref_pos = v.pos;
  int qpos = 0;
  // one resolved qual pointer (zeros for the 0xFF missing-qual sentinel)
  thread_local std::vector<uint8_t> zero_q;
  const uint8_t* q_orig = v.qual;
  if (!q_orig) {
    if ((int)zero_q.size() < v.l_seq) zero_q.assign(v.l_seq, 0);
    q_orig = zero_q.data();
  }
  const uint8_t* q_eff = adj_qual ? adj_qual : q_orig;
  int64_t first_pos = -1, last_pos = -1;
  if (h && h->filt_depth) read_span_marks(v, &first_pos, &last_pos);
  const int64_t fstart = h ? h->fstart : 0, fend = h ? h->fend : 0;
  struct Pend {
    bool valid = false;    // inside the tensor/candidate window
    bool fvalid = false;   // inside the extended filter span
    int64_t p = -2;
    int c = 0, bq = 0, ikind = 0, ilen = 0;
    char seq[64];
  } pend;
  auto flush = [&]() {
    if (pend.valid)
      accum_entry(o, pend.p - start, pend.c, pend.bq, v.mapq, hp, pend.ikind,
                  pend.ilen, pend.seq);
    if (pend.fvalid)
      filt_accum(h, pend.p, pend.c, pend.bq, v.mapq, pend.ikind, pend.ilen,
                 pend.seq, rid, pend.p == first_pos, pend.p == last_pos);
    pend.valid = false;
    pend.fvalid = false;
    pend.p = -2;
  };
  auto push = [&](int64_t p, int c, int bq) {
    flush();
    pend.p = p;
    bool valid = p >= start && p < end;
    bool fvalid = h && h->filt_depth && p >= fstart && p < fend;
    if (valid || fvalid) {
      pend.valid = valid;
      pend.fvalid = fvalid;
      pend.c = c;
      pend.bq = bq;
      pend.ikind = 0;
      pend.ilen = 0;
    }
  };
  const bool filt_on = h && h->filt_depth;
  // fast-path context (phasing channels need hp per entry -> generic path)
  MRunCtx cx;
  cx.hi_mq = v.mapq >= o.low_mq;
  cx.cand_ok = v.mapq >= o.cand_min_mq;
  cx.dual = o.dual != 0;
  cx.filt_on = filt_on;
  cx.filt_mq_ok = filt_on && v.mapq >= (h ? h->filt_min_mq : 0);
  cx.nibcode = NIB_CODE.t[rev ? 1 : 0];
  cx.aff_bq = o.aff_bq;
  cx.low_bq = o.low_bq;
  cx.filt_min_bq = filt_on ? h->filt_min_bq : 0;
  const bool fast_on = !o.with_phasing;
  for (int i = 0; i < v.n_cigar; i++) {
    int op = v.cigar[i] & 0xF;
    int ln = v.cigar[i] >> 4;
    if (op == 0 || op == 7 || op == 8) {  // M, =, X
      // only the LAST base of an M-run can anchor a following indel —
      // every earlier base flushes immediately, skipping the pending-
      // entry bookkeeping on ~99% of entries (the single hottest loop)
      flush();
      if (fast_on && ln > 1) {
        // interior positions [ref_pos, ref_pos + ln - 1), pre-clipped
        const int64_t lo = ref_pos, hi = ref_pos + ln - 1;
        int64_t a = std::max(lo, start), b = std::min(hi, end);
        if (a < b)
          mrun_accum<true>(o, h, v, q_eff, cx, ref_pos, qpos,
                           a - ref_pos, b - ref_pos, start, rid,
                           first_pos, last_pos);
        if (cx.filt_mq_ok) {
          // filter-only margins outside the tensor window
          int64_t a2 = std::max(lo, fstart);
          int64_t b2 = std::min(hi, std::min(start, fend));
          if (a2 < b2)
            mrun_accum<false>(o, h, v, q_eff, cx, ref_pos, qpos,
                              a2 - ref_pos, b2 - ref_pos, start, rid,
                              first_pos, last_pos);
          int64_t a3 = std::max(lo, std::max(end, fstart));
          int64_t b3 = std::min(hi, fend);
          if (a3 < b3)
            mrun_accum<false>(o, h, v, q_eff, cx, ref_pos, qpos,
                              a3 - ref_pos, b3 - ref_pos, start, rid,
                              first_pos, last_pos);
        }
      } else {
        for (int k = 0; k < ln - 1; k++) {
          int64_t p = ref_pos + k;
          int c = base_code(rec_base(v, qpos + k), rev);
          int q = q_eff[qpos + k];
          if (p >= start && p < end)
            accum_entry(o, p - start, c, q, v.mapq, hp, 0, 0, nullptr);
          if (filt_on && p >= fstart && p < fend)
            filt_accum(h, p, c, q, v.mapq, 0, 0, nullptr, rid,
                       p == first_pos, p == last_pos);
        }
      }
      if (ln > 0) {
        push(ref_pos + ln - 1, base_code(rec_base(v, qpos + ln - 1), rev),
             q_eff[qpos + ln - 1]);
      }
      ref_pos += ln;
      qpos += ln;
    } else if (op == 1) {  // I — suffix on the pending anchor (last-wins)
      if (pend.p == ref_pos - 1) {
        pend.ikind = 1;
        pend.ilen = ln;
        if (pend.valid || pend.fvalid) {
          for (int k = 0; k < ln && k < 64; k++) {
            char b = rec_base(v, qpos + k);
            pend.seq[k] = (char)toupper(b);
          }
        }
      }
      qpos += ln;
    } else if (op == 2) {  // D — suffix on anchor + placeholders
      if (pend.p == ref_pos - 1) {
        pend.ikind = 2;
        pend.ilen = ln;
      }
      // placeholder bq = next aligned base's ORIGINAL quality (overlap
      // adjustment never touches placeholders in the entry-table path)
      int nxt = qpos < v.l_seq ? qpos : (v.l_seq ? v.l_seq - 1 : 0);
      int del_bq = v.l_seq ? q_orig[nxt] : 0;
      int code = rev ? CODE_DEL_REV : CODE_DEL_FWD;
      for (int k = 0; k < ln; k++) push(ref_pos + k, code, del_bq);
      ref_pos += ln;
    } else if (op == 3) {  // N
      ref_pos += ln;
      flush();
    } else if (op == 4) {  // S
      qpos += ln;
    }
  }
  flush();
}

std::vector<uint8_t>& adj_for(WindowHandle* h, const RawRecord* r,
                              const RecView& v) {
  auto it = h->adj_quals.find(r);
  if (it != h->adj_quals.end()) return it->second;
  auto& vec = h->adj_quals[r];
  vec.resize((size_t)v.l_seq);
  if (v.qual) memcpy(vec.data(), v.qual, (size_t)v.l_seq);
  else memset(vec.data(), 0, (size_t)v.l_seq);
  return vec;
}

// htslib-style tweak_overlap_quality on one mate pair: for every reference
// position where both mates have an aligned ACGT base, agreeing bases keep
// mate1 at min(q1+q2, 200) and zero mate2; disagreeing keep the higher-qual
// mate at 0.8q and zero the other.  Matches Decoder::overlap_adjust.
void adjust_pair(WindowHandle* h, const RawRecord* r1, const RawRecord* r2) {
  RecView v1, v2;
  if (!parse_rec(*r1, h->excl_flags, h->min_mapq, &v1)) return;
  if (!parse_rec(*r2, h->excl_flags, h->min_mapq, &v2)) return;
  // mate1 aligned ACGT positions -> (base code 0-3, qpos)
  std::unordered_map<int64_t, std::pair<int, int>> m1;
  auto walk = [](const RecView& v, auto&& fn) {
    int64_t ref_pos = v.pos;
    int qpos = 0;
    for (int i = 0; i < v.n_cigar; i++) {
      int op = v.cigar[i] & 0xF;
      int ln = v.cigar[i] >> 4;
      if (op == 0 || op == 7 || op == 8) {
        for (int k = 0; k < ln; k++) {
          char b = rec_base(v, qpos + k);
          int bc;
          switch (b) {
            case 'A': bc = 0; break;
            case 'C': bc = 1; break;
            case 'G': bc = 2; break;
            case 'T': bc = 3; break;
            default: bc = -1;
          }
          if (bc >= 0) fn(ref_pos + k, bc, qpos + k);
        }
        ref_pos += ln;
        qpos += ln;
      } else if (op == 1 || op == 4) {
        qpos += ln;
      } else if (op == 2 || op == 3) {
        ref_pos += ln;
      }
    }
  };
  walk(v1, [&](int64_t p, int bc, int qp) { m1.emplace(p, std::make_pair(bc, qp)); });
  bool any = false;
  walk(v2, [&](int64_t p, int bc, int qp) {
    auto it = m1.find(p);
    if (it == m1.end()) return;
    auto& a1 = adj_for(h, r1, v1);
    auto& a2 = adj_for(h, r2, v2);
    int q1 = a1[it->second.second], q2 = a2[qp];
    if (it->second.first == bc) {
      a1[it->second.second] = (uint8_t)std::min(q1 + q2, 200);
      a2[qp] = 0;
    } else if (q1 >= q2) {
      a1[it->second.second] = (uint8_t)(int)(0.8 * q1);
      a2[qp] = 0;
    } else {
      a2[qp] = (uint8_t)(int)(0.8 * q2);
      a1[it->second.second] = 0;
    }
    any = true;
  });
  (void)any;
}

void stage_overlaps(WindowHandle* h) {
  std::unordered_map<std::string, const RawRecord*> pending;
  for (auto& sp : h->records) {
    RecView v;
    if (!parse_rec(*sp, h->excl_flags, h->min_mapq, &v)) continue;
    if (!(v.flag & FLAG_PAIRED)) continue;
    std::string name(v.name);
    auto it = pending.find(name);
    if (it == pending.end()) {
      pending.emplace(std::move(name), sp.get());
      continue;
    }
    adjust_pair(h, it->second, sp.get());
    pending.erase(it);
  }
}

}  // namespace

extern "C" {

// Fused decode+reduce for one window (see header comment above).
// All output arrays are zeroed here; neg_* may be null when dual == 0.
// nchan = 34 + 16*with_phasing.  Returns a WindowHandle* retaining the
// window's records for pileup_window_entries_*, or nullptr for an unknown
// contig / oversized window (L must fit the 26-bit event key).
void* pileup_window_reduce(
    void* sh, const char* ctg, int64_t start, int64_t end, int excl_flags,
    int min_mapq, int handle_overlaps, int aff_min_bq, int low_mq_thresh,
    int low_bq_thresh, int max_indel_len, int with_phasing, int cand_min_mq,
    int dual, int32_t* aff_counts, int32_t* aff_depth, int32_t* neg_counts,
    int32_t* neg_depth, int32_t* cand_base, int32_t* cand_depth,
    int32_t* cand_ins, int32_t* cand_del,
    // filter-view accumulation over [start - fmargin, end + fmargin):
    // ref_tok [span] int16 (10 = non-ACGT sentinel); pass nulls to disable
    int64_t fmargin, const int16_t* ref_tok, int filt_min_bq,
    int filt_min_mq, int32_t* filt_depth, int32_t* filt_nonref,
    int32_t* filt_colins, int64_t* out_n_reads) {
  auto* s = (BamStream*)sh;
  int rid = stream_rid(s, ctg);
  int64_t L = end - start;
  if (rid < 0 || L <= 0 || L >= (1ll << 26)) return nullptr;

  // env-gated phase profiling (CLAIRS_DECODE_PROFILE=1): stderr timings
  static int prof = -1;
  if (prof < 0) {
    const char* e = getenv("CLAIRS_DECODE_PROFILE");
    prof = (e && e[0] == '1') ? 1 : 0;
  }
  struct Clk {
    timespec t;
    void mark() { clock_gettime(CLOCK_MONOTONIC, &t); }
    double since() const {
      timespec n;
      clock_gettime(CLOCK_MONOTONIC, &n);
      return (n.tv_sec - t.tv_sec) + 1e-9 * (n.tv_nsec - t.tv_nsec);
    }
  } clk;
  double t_sel = 0, t_ovl = 0, t_memset = 0, t_loop = 0, t_fold = 0,
         t_flush = 0;
  if (prof) clk.mark();

  auto* h = new WindowHandle();
  h->excl_flags = excl_flags;
  h->min_mapq = min_mapq;
  h->handle_overlaps = handle_overlaps;
  h->start = start;
  h->end = end;
  select_window_records(s, rid, start, end, &h->records);
  if (prof) { t_sel = clk.since(); clk.mark(); }
  if (handle_overlaps) stage_overlaps(h);
  if (prof) { t_ovl = clk.since(); clk.mark(); }
  if (ref_tok && filt_depth) {
    h->fstart = start - fmargin;
    h->fend = end + fmargin;
    h->ref_tok = ref_tok;
    h->filt_min_bq = filt_min_bq;
    h->filt_min_mq = filt_min_mq;
    h->filt_depth = filt_depth;
    h->filt_nonref = filt_nonref;
    h->filt_colins = filt_colins;
    int64_t fl = h->fend - h->fstart;
    memset(filt_depth, 0, (size_t)fl * sizeof(int32_t));
    memset(filt_nonref, 0, (size_t)fl * sizeof(int32_t));
    memset(filt_colins, 0, (size_t)fl * sizeof(int32_t));
  }

  ReduceOut o;
  o.aff = aff_counts;
  o.aff_depth = aff_depth;
  o.neg = neg_counts;
  o.neg_depth = neg_depth;
  o.cand_base = cand_base;
  o.cand_depth = cand_depth;
  o.cand_ins = cand_ins;
  o.cand_del = cand_del;
  o.L = L;
  o.nchan = 34 + (with_phasing ? 16 : 0);
  o.aff_bq = aff_min_bq;
  o.low_mq = low_mq_thresh;
  o.low_bq = low_bq_thresh;
  o.max_indel = max_indel_len;
  o.with_phasing = with_phasing;
  o.dual = dual;
  o.cand_min_mq = cand_min_mq;
  o.ih.init(4096);

  memset(aff_counts, 0, (size_t)L * o.nchan * sizeof(int32_t));
  memset(aff_depth, 0, (size_t)L * sizeof(int32_t));
  if (dual) {
    memset(neg_counts, 0, (size_t)L * o.nchan * sizeof(int32_t));
    memset(neg_depth, 0, (size_t)L * sizeof(int32_t));
  }
  memset(cand_base, 0, (size_t)L * 4 * sizeof(int32_t));
  memset(cand_depth, 0, (size_t)L * sizeof(int32_t));
  memset(cand_ins, 0, (size_t)L * sizeof(int32_t));
  memset(cand_del, 0, (size_t)L * sizeof(int32_t));
  if (prof) { t_memset = clk.since(); clk.mark(); }

  int64_t n_reads = 0;
  for (auto& sp : h->records) {
    RecView v;
    if (!parse_rec(*sp, excl_flags, min_mapq, &v)) continue;
    int hp = find_hp_tag(v.tags, v.tags_len);
    const uint8_t* adj = nullptr;
    auto it = h->adj_quals.find(sp.get());
    if (it != h->adj_quals.end()) adj = it->second.data();
    reduce_record(o, v, adj, start, end, hp, h, (int)n_reads);
    n_reads++;
  }
  if (prof) { t_loop = clk.since(); clk.mark(); }
  if (dual) {
    // fold the AFF view into the NEG delta (additive channels only; the
    // max channels are still zero here — see accum_entry)
    const int64_t total = L * o.nchan;
    for (int64_t i = 0; i < total; i++) neg_counts[i] += aff_counts[i];
    for (int64_t i = 0; i < L; i++) neg_depth[i] += aff_depth[i];
  }
  if (prof) { t_fold = clk.since(); clk.mark(); }
  // distinct-seq max channels (I1/i1/D1/d1)
  for (size_t i = 0; i <= o.ih.msk; i++)
    if (o.ih.keys[i]) flush_indel_cell(o, o.ih.keys[i], o.ih.affc[i], o.ih.negc[i]);
  for (auto& kv : o.ih_long) {
    uint64_t key;
    memcpy(&key, kv.first.data(), 8);
    flush_indel_cell(o, key, kv.second.first, kv.second.second);
  }
  if (prof) {
    t_flush = clk.since();
    fprintf(stderr,
            "[decode_profile] sel=%.3f ovl=%.3f memset=%.3f loop=%.3f "
            "fold=%.3f flush=%.3f n_reads=%lld\n",
            t_sel, t_ovl, t_memset, t_loop, t_fold, t_flush,
            (long long)n_reads);
  }
  h->n_reads = n_reads;
  *out_n_reads = n_reads;
  return h;
}

// Masked entries pass A: exact output sizes for pileup_window_entries_fill.
// mask: uint8 over [mask_start, mask_start+mask_len); a position outside
// the mask produces no entry.  Anchored insertion blob bytes count only
// when the anchor position is masked (the suffix lives on the anchor).
void pileup_window_entries_count(void* wh, const uint8_t* mask,
                                 int64_t mask_start, int64_t mask_len,
                                 int64_t* n_entries, int64_t* blob_len) {
  auto* h = (WindowHandle*)wh;
  *n_entries = 0;
  *blob_len = 0;
  // prefix sum over the mask: per-op masked-column counts become O(1)
  // instead of O(bases) — decisive for sparse (radius-0) site masks
  std::vector<int64_t> psum(mask_len + 1, 0);
  for (int64_t i = 0; i < mask_len; i++)
    psum[i + 1] = psum[i] + (mask[i] ? 1 : 0);
  auto masked = [&](int64_t p) {
    int64_t r = p - mask_start;
    return r >= 0 && r < mask_len && mask[r];
  };
  auto count_range = [&](int64_t a, int64_t b) -> int64_t {
    a = std::max(a - mask_start, (int64_t)0);
    b = std::min(b - mask_start, mask_len);
    return (b > a) ? psum[b] - psum[a] : 0;
  };
  for (auto& sp : h->records) {
    RecView v;
    if (!parse_rec(*sp, h->excl_flags, h->min_mapq, &v)) continue;
    int64_t ref_pos = v.pos;
    int64_t last_pos = -2;
    for (int i = 0; i < v.n_cigar; i++) {
      int op = v.cigar[i] & 0xF;
      int64_t ln = v.cigar[i] >> 4;
      if (op == 0 || op == 7 || op == 8 || op == 2) {  // M,=,X,D
        *n_entries += count_range(ref_pos, ref_pos + ln);
        last_pos = ref_pos + ln - 1;
        ref_pos += ln;
      } else if (op == 1) {  // I
        if (last_pos == ref_pos - 1 && masked(ref_pos - 1)) *blob_len += ln;
      } else if (op == 3) {  // N
        ref_pos += ln;
        last_pos = -2;
      }
    }
  }
}

// Masked entries pass B: decode the window's records into entry arrays,
// emitting only masked columns.  read_id = the read's ordinal among the
// window's filter-passing records — STABLE across repeated calls, so
// entry tables fetched for different site sets share read identity (and
// match the read numbering of pileup_window_reduce).  eflags mark the
// read's true first/last ref-consuming positions when they fall inside
// the mask.  Returns n_reads.
int64_t pileup_window_entries_fill(
    void* wh, const uint8_t* mask, int64_t mask_start, int64_t mask_len,
    int64_t* pos, int8_t* code, int16_t* bq, int16_t* mq, int8_t* hp,
    int8_t* ikind, int32_t* ilen, int64_t* iseq_off, char* blob,
    int32_t* read_id, int8_t* eflags, int64_t* n_used, int64_t* blob_used) {
  auto* h = (WindowHandle*)wh;
  auto masked = [&](int64_t p) {
    int64_t r = p - mask_start;
    return r >= 0 && r < mask_len && mask[r];
  };
  // next masked column at or after index i (mask_len = "none")
  std::vector<int32_t> nxt(mask_len + 1);
  nxt[mask_len] = (int32_t)mask_len;
  for (int64_t i = mask_len - 1; i >= 0; i--)
    nxt[i] = mask[i] ? (int32_t)i : nxt[i + 1];
  // first masked ABSOLUTE position >= p (or INT64_MAX)
  auto next_masked = [&](int64_t p) -> int64_t {
    int64_t r = p - mask_start;
    if (r >= mask_len) return INT64_MAX;
    if (r < 0) r = 0;
    int64_t j = nxt[r];
    return (j >= mask_len) ? INT64_MAX : j + mask_start;
  };
  int64_t n = 0, bl = 0;
  int32_t rid = 0;
  for (auto& sp : h->records) {
    RecView v;
    if (!parse_rec(*sp, h->excl_flags, h->min_mapq, &v)) continue;
    const uint8_t* adj = nullptr;
    auto it = h->adj_quals.find(sp.get());
    if (it != h->adj_quals.end()) adj = it->second.data();
    int hpv = find_hp_tag(v.tags, v.tags_len);
    bool rev = v.flag & FLAG_REVERSE;
    int64_t first_pos, last_mark;
    read_span_marks(v, &first_pos, &last_mark);
    int64_t ref_pos = v.pos;
    int qpos = 0;
    int64_t last_push_pos = -2;   // pos of the last pushed (masked) entry
    int64_t last_entry_idx = -1;  // its index, -1 when unmasked/reset
    auto eff_q = [&](int i) -> int {
      return adj ? adj[i] : rec_qual(v, i);
    };
    auto push = [&](int64_t p, int c, int q) {
      last_push_pos = p;
      if (!masked(p)) {
        last_entry_idx = -1;
        return;
      }
      pos[n] = p;
      code[n] = (int8_t)c;
      bq[n] = (int16_t)q;
      mq[n] = (int16_t)v.mapq;
      hp[n] = (int8_t)hpv;
      ikind[n] = 0;
      ilen[n] = 0;
      iseq_off[n] = -1;
      read_id[n] = rid;
      int8_t ef = 0;
      if (p == first_pos) ef |= 1;
      if (p == last_mark) ef |= 2;
      eflags[n] = ef;
      last_entry_idx = n;
      n++;
    };
    for (int i = 0; i < v.n_cigar; i++) {
      int op = v.cigar[i] & 0xF;
      int ln = v.cigar[i] >> 4;
      if (op == 0 || op == 7 || op == 8) {
        // jump straight between masked columns; the final base must still
        // go through push (it is the only possible indel anchor), and the
        // push() bookkeeping only matters for masked positions anyway
        int64_t p = next_masked(ref_pos);
        int64_t run_end = ref_pos + ln;
        bool tail_done = false;
        while (p < run_end) {
          if (p == run_end - 1) tail_done = true;
          int k = (int)(p - ref_pos);
          char b = rec_base(v, qpos + k);
          push(p, base_code(b, rev), eff_q(qpos + k));
          p = next_masked(p + 1);
        }
        if (!tail_done) {
          // unmasked tail base: reset the anchor exactly like a masked
          // walk would (push on an unmasked position invalidates it)
          last_push_pos = run_end - 1;
          last_entry_idx = -1;
        }
        ref_pos += ln;
        qpos += ln;
      } else if (op == 1) {
        if (last_push_pos == ref_pos - 1 && last_entry_idx >= 0) {
          ikind[last_entry_idx] = INDEL_INS;
          ilen[last_entry_idx] = ln;
          iseq_off[last_entry_idx] = bl;
          for (int k = 0; k < ln; k++) {
            char b = rec_base(v, qpos + k);
            blob[bl++] = rev ? (char)tolower(b) : b;
          }
        }
        qpos += ln;
      } else if (op == 2) {
        if (last_push_pos == ref_pos - 1 && last_entry_idx >= 0) {
          ikind[last_entry_idx] = INDEL_DEL;
          ilen[last_entry_idx] = ln;
        }
        int nq = qpos < v.l_seq ? qpos : (v.l_seq ? v.l_seq - 1 : 0);
        int del_bq = v.l_seq ? rec_qual(v, nq) : 0;
        int cd = rev ? CODE_DEL_REV : CODE_DEL_FWD;
        int64_t p = next_masked(ref_pos);
        int64_t run_end = ref_pos + ln;
        bool tail_done = false;
        while (p < run_end) {
          if (p == run_end - 1) tail_done = true;
          push(p, cd, del_bq);
          p = next_masked(p + 1);
        }
        if (!tail_done) {
          last_push_pos = run_end - 1;
          last_entry_idx = -1;
        }
        ref_pos += ln;
      } else if (op == 3) {
        ref_pos += ln;
        last_push_pos = -2;
        last_entry_idx = -1;
      } else if (op == 4) {
        qpos += ln;
      }
    }
    rid++;
  }
  *n_used = n;
  *blob_used = bl;
  return rid;
}

// Select the window's retained records overlapping [lo, hi) that pass
// min_mapq (+ the window's excl_flags), expanding seq and CIGAR strings
// into handle scratch.  Serves the short-read realignment filter without
// any second BAM pass (it previously re-fetched per site through the
// pure-Python reader — 680s on a 2Mb ilmn chunk).  Returns read count.
int64_t pileup_window_reads_select(void* wh, int64_t lo, int64_t hi,
                                   int min_mapq) {
  auto* h = (WindowHandle*)wh;
  h->rd_pos.clear();
  h->rd_flag.clear();
  h->rd_mapq.clear();
  h->rd_seq_off.clear();
  h->rd_cig_off.clear();
  h->rd_seq_blob.clear();
  h->rd_cig_blob.clear();
  static const char* OPS = "MIDNSHP=X";
  char num[16];
  for (auto& sp : h->records) {
    if (sp->pos >= hi || sp->end <= lo) continue;
    RecView v;
    if (!parse_rec(*sp, h->excl_flags,
                   std::max(h->min_mapq, min_mapq), &v)) continue;
    h->rd_pos.push_back(v.pos);
    h->rd_flag.push_back(v.flag);
    h->rd_mapq.push_back(v.mapq);
    h->rd_seq_off.push_back((int64_t)h->rd_seq_blob.size());
    for (int i = 0; i < v.l_seq; i++) h->rd_seq_blob.push_back(rec_base(v, i));
    h->rd_cig_off.push_back((int64_t)h->rd_cig_blob.size());
    for (int i = 0; i < v.n_cigar; i++) {
      int n = snprintf(num, sizeof(num), "%u", v.cigar[i] >> 4);
      h->rd_cig_blob.append(num, n);
      h->rd_cig_blob.push_back(OPS[v.cigar[i] & 0xF]);
    }
  }
  h->rd_seq_off.push_back((int64_t)h->rd_seq_blob.size());
  h->rd_cig_off.push_back((int64_t)h->rd_cig_blob.size());
  return (int64_t)h->rd_pos.size();
}

void pileup_window_reads_sizes(void* wh, int64_t* seq_bytes,
                               int64_t* cig_bytes) {
  auto* h = (WindowHandle*)wh;
  *seq_bytes = (int64_t)h->rd_seq_blob.size();
  *cig_bytes = (int64_t)h->rd_cig_blob.size();
}

void pileup_window_reads_export(void* wh, int64_t* pos, int32_t* flag,
                                int32_t* mapq, int64_t* seq_off,
                                int64_t* cig_off, char* seq_blob,
                                char* cig_blob) {
  auto* h = (WindowHandle*)wh;
  auto cp = [](auto& v, auto* dst) {
    if (!v.empty()) memcpy(dst, v.data(), v.size() * sizeof(v[0]));
  };
  cp(h->rd_pos, pos);
  cp(h->rd_flag, flag);
  cp(h->rd_mapq, mapq);
  cp(h->rd_seq_off, seq_off);
  cp(h->rd_cig_off, cig_off);
  if (!h->rd_seq_blob.empty())
    memcpy(seq_blob, h->rd_seq_blob.data(), h->rd_seq_blob.size());
  if (!h->rd_cig_blob.empty())
    memcpy(cig_blob, h->rd_cig_blob.data(), h->rd_cig_blob.size());
}

int64_t pileup_window_reduce_n_reads(void* wh) {
  return ((WindowHandle*)wh)->n_reads;
}

// Column-sort the non-ref stream in place (counting sort keyed by rel;
// stable, preserving per-column mpileup order) and build the per-(column,
// token) distinct-count table used by col_token_count.  O(n) + one
// O(n log n) sort of the column-token composites; runs once per window —
// on the decode-ahead worker, off the verdict critical path.
void pileup_window_filter_assemble(void* wh, int64_t span,
                                   int64_t* out_n_keys) {
  auto* h = (WindowHandle*)wh;
  const int64_t n = (int64_t)h->nr_rel.size();
  if (h->assembled) { *out_n_keys = (int64_t)h->ck_key.size(); return; }
  // per-column counts -> offsets
  std::vector<int64_t> cnt((size_t)span + 1, 0);
  for (int64_t i = 0; i < n; i++) cnt[h->nr_rel[i] + 1]++;
  for (int64_t c = 0; c < span; c++) cnt[c + 1] += cnt[c];
  std::vector<int32_t> s_rel(n), s_read(n), s_ilen(n);
  std::vector<int8_t> s_base(n), s_ik(n);
  std::vector<int64_t> s_sub(n);
  {
    std::vector<int64_t> cur(cnt.begin(), cnt.end() - 1);
    for (int64_t i = 0; i < n; i++) {
      int64_t k = cur[h->nr_rel[i]]++;
      s_rel[k] = h->nr_rel[i];
      s_read[k] = h->nr_read[i];
      s_ilen[k] = h->nr_ilen[i];
      s_base[k] = h->nr_base[i];
      s_ik[k] = h->nr_ik[i];
      s_sub[k] = h->nr_sub[i];
    }
  }
  h->nr_rel.swap(s_rel);
  h->nr_read.swap(s_read);
  h->nr_ilen.swap(s_ilen);
  h->nr_base.swap(s_base);
  h->nr_ik.swap(s_ik);
  h->nr_sub.swap(s_sub);
  // tokens + per-(col, token) counts
  h->nr_token.resize(n);
  int64_t maxtok = 0;
  for (int64_t i = 0; i < n; i++) {
    int64_t t = (int64_t)h->nr_base[i] + (int64_t)h->nr_ik[i] * 16 +
                h->nr_sub[i] * 64;
    h->nr_token[i] = t;
    if (t > maxtok) maxtok = t;
  }
  h->T = maxtok + 11;
  std::vector<int64_t> keys(n);
  for (int64_t i = 0; i < n; i++)
    keys[i] = (int64_t)h->nr_rel[i] * h->T + h->nr_token[i];
  std::sort(keys.begin(), keys.end());
  h->ck_key.clear();
  h->ck_cnt.clear();
  for (int64_t i = 0; i < n;) {
    int64_t j = i;
    while (j < n && keys[j] == keys[i]) j++;
    h->ck_key.push_back(keys[i]);
    h->ck_cnt.push_back(j - i);
    i = j;
  }
  h->assembled = true;
  *out_n_keys = (int64_t)h->ck_key.size();
}

void pileup_window_filter_export_assembled(
    void* wh, int32_t* nr_rel, int32_t* nr_read, int64_t* nr_token,
    int8_t* nr_ik, int8_t* nr_base, int64_t* ck_key, int64_t* ck_cnt,
    int64_t* out_T) {
  auto* h = (WindowHandle*)wh;
  auto cp = [](auto& v, auto* dst) {
    if (!v.empty()) memcpy(dst, v.data(), v.size() * sizeof(v[0]));
  };
  cp(h->nr_rel, nr_rel);
  cp(h->nr_read, nr_read);
  cp(h->nr_token, nr_token);
  cp(h->nr_ik, nr_ik);
  cp(h->nr_base, nr_base);
  cp(h->ck_key, ck_key);
  cp(h->ck_cnt, ck_cnt);
  *out_T = h->T;
}

// Filter-view stream sizes accumulated by pileup_window_reduce.
void pileup_window_filter_sizes(void* wh, int64_t* n_nr, int64_t* n_st,
                                int64_t* n_en) {
  auto* h = (WindowHandle*)wh;
  *n_nr = (int64_t)h->nr_rel.size();
  *n_st = (int64_t)h->st_rel.size();
  *n_en = (int64_t)h->en_rel.size();
}

void pileup_window_filter_export(void* wh, int32_t* nr_rel, int32_t* nr_read,
                                 int8_t* nr_base, int8_t* nr_ik,
                                 int32_t* nr_ilen, int64_t* nr_sub,
                                 int32_t* st_rel, int32_t* st_read,
                                 int32_t* en_rel, int32_t* en_read) {
  auto* h = (WindowHandle*)wh;
  auto cp = [](auto& v, auto* dst) {
    if (!v.empty()) memcpy(dst, v.data(), v.size() * sizeof(v[0]));
  };
  cp(h->nr_rel, nr_rel);
  cp(h->nr_read, nr_read);
  cp(h->nr_base, nr_base);
  cp(h->nr_ik, nr_ik);
  cp(h->nr_ilen, nr_ilen);
  cp(h->nr_sub, nr_sub);
  cp(h->st_rel, st_rel);
  cp(h->st_read, st_read);
  cp(h->en_rel, en_rel);
  cp(h->en_read, en_read);
}

// Start/end mark streams only (filter_assembly does not need a second
// copy of the non-ref stream — it gets the assembled one).
void pileup_window_filter_export_startend(void* wh, int32_t* st_rel,
                                          int32_t* st_read, int32_t* en_rel,
                                          int32_t* en_read) {
  auto* h = (WindowHandle*)wh;
  auto cp = [](auto& v, auto* dst) {
    if (!v.empty()) memcpy(dst, v.data(), v.size() * sizeof(v[0]));
  };
  cp(h->st_rel, st_rel);
  cp(h->st_read, st_read);
  cp(h->en_rel, en_rel);
  cp(h->en_read, en_read);
}

void pileup_window_release(void* wh) { delete (WindowHandle*)wh; }

}  // extern "C"
