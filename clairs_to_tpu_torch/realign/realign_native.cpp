// Port copy of clairs_to_tpu/realign/realign_native.cpp.
// Local-reassembly realignment: de Bruijn consensus + affine-gap alignment.
//
// Native replacement for the reference's vendored
// DeepVariant-lineage libraries (ClairS-TO src/realign/{debruijn_graph,
// ssw,realigner}.*, consumed via ctypes in src/realign_reads.py:519-615).
// Re-designed from the algorithmic spec rather than translated:
//
//  * dbg_consensus: k-mer graph over the reference window + quality-masked
//    reads, low-support edge pruning, bounded source->sink path enumeration
//    -> candidate haplotypes (cap 500 like the reference,
//    debruijn_graph.h:117-123).
//  * affine-gap Smith-Waterman (match 4, mismatch 6, gap open 8, extend 1 —
//    the reference's scoring, realigner.h:296-299) for read->haplotype and
//    haplotype->reference alignment.
//  * realign_reads: choose each read's best haplotype (fast k-mer vote,
//    alignment fallback), then compose read->hap->ref into a new position
//    + CIGAR (realigner.h:260-264 semantics).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -o librealign_native.so
//        realign_native.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <map>
#include <set>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

constexpr int MATCH = 4;
constexpr int MISMATCH = 6;
constexpr int GAP_OPEN = 8;
constexpr int GAP_EXT = 1;
constexpr int MAX_HAPLOTYPES = 500;
constexpr int MIN_EDGE_SUPPORT = 2;
constexpr int MIN_K = 15, MAX_K = 31;

// ------------------------------------------------------------- de Bruijn --
struct DbgResult {
  std::vector<std::string> haplotypes;
};

bool has_repeated_kmer(const std::string& s, int k) {
  if ((int)s.size() < k) return true;
  std::unordered_set<std::string> seen;
  for (size_t i = 0; i + k <= s.size(); i++) {
    auto sub = s.substr(i, k);
    if (!seen.insert(sub).second) return true;
  }
  return false;
}

std::vector<std::string> dbg_consensus_impl(
    const std::string& ref, const std::vector<std::string>& reads,
    const std::vector<std::vector<uint8_t>>& quals, int min_bq) {
  // choose k: smallest odd k in [MIN_K, MAX_K] with no repeated ref k-mer
  int k = -1;
  for (int kk = MIN_K; kk <= MAX_K; kk += 2) {
    if (!has_repeated_kmer(ref, kk)) { k = kk; break; }
  }
  if (k < 0) return {ref};

  // edge weights: kmer -> next-kmer counts
  std::unordered_map<std::string, std::map<std::string, int>> edges;
  auto add_seq = [&](const std::string& s, const std::vector<uint8_t>* q,
                     int weight) {
    if ((int)s.size() < k + 1) return;
    for (size_t i = 0; i + k + 1 <= s.size(); i++) {
      bool ok = true;
      for (int j = 0; j < k + 1; j++) {
        char c = s[i + j];
        if (c != 'A' && c != 'C' && c != 'G' && c != 'T') { ok = false; break; }
        if (q && (int)(*q)[i + j] < min_bq) { ok = false; break; }
      }
      if (!ok) continue;
      edges[s.substr(i, k)][s.substr(i + 1, k)] += weight;
    }
  };
  add_seq(ref, nullptr, MIN_EDGE_SUPPORT);  // ref edges always kept
  for (size_t r = 0; r < reads.size(); r++)
    add_seq(reads[r], quals.empty() ? nullptr : &quals[r], 1);

  // prune low-support edges
  for (auto& kv : edges) {
    for (auto it = kv.second.begin(); it != kv.second.end();) {
      if (it->second < MIN_EDGE_SUPPORT) it = kv.second.erase(it);
      else ++it;
    }
  }

  std::string source = ref.substr(0, k);
  std::string sink = ref.substr(ref.size() - k);
  // bounded DFS source -> sink
  std::vector<std::string> haps;
  size_t max_len = ref.size() + 60;
  struct Frame { std::string node; std::string path; };
  std::vector<Frame> stack;
  stack.push_back({source, source});
  size_t expansions = 0;
  while (!stack.empty() && (int)haps.size() < MAX_HAPLOTYPES &&
         expansions < 200000) {
    expansions++;
    Frame f = stack.back();
    stack.pop_back();
    if (f.node == sink && f.path.size() >= source.size() + 1) {
      haps.push_back(f.path);
      continue;
    }
    if (f.path.size() > max_len) continue;
    auto it = edges.find(f.node);
    if (it == edges.end()) continue;
    for (auto& nx : it->second) {
      stack.push_back({nx.first, f.path + nx.first.back()});
    }
  }
  if (haps.empty()) haps.push_back(ref);
  return haps;
}

// ------------------------------------------------ affine-gap alignment ----
struct Aln {
  int score = 0;
  int ref_start = 0;               // 0-based start on target
  std::vector<std::pair<char, int>> cigar;  // M/I/D runs (query vs target)
};

Aln align_affine(const std::string& q, const std::string& t) {
  // global-in-query, local-in-target alignment (glocal): query fully
  // aligned, free target flanks — standard for read->haplotype.
  int n = q.size(), m = t.size();
  const int NEG = -1000000;
  // exact-substring short-circuit: an all-match alignment scores n*MATCH,
  // which no gapped/mismatched alignment can reach, so the DP's answer is
  // the pure-M CIGAR; among multiple occurrences the DP's `>=` best-j scan
  // keeps the LARGEST end column = the RIGHTMOST occurrence, and its
  // traceback prefers the diagonal on ties = all M.  rfind reproduces
  // both choices exactly.  (Most reads are error-free copies of one
  // haplotype — this skips the O(n*m) fill for them.)
  if (n > 0) {
    size_t p = t.rfind(q);
    if (p != std::string::npos) {
      Aln out;
      out.score = n * MATCH;
      out.ref_start = (int)p;
      out.cigar = {{'M', n}};
      return out;
    }
  }
  // Rolling score rows + per-cell backpointer bytes.  The former full
  // H/E/F int matrices cost ~24 B of memory traffic per cell; this keeps
  // two int rows live and stores the three traceback decisions as one
  // byte/cell, recorded with EXACTLY the comparisons (and precedence) the
  // original traceback performed — outputs are bit-identical (A/B-tested
  // against the matrix version on randomized cases).
  //   bit0-1: H-state move (0 = diag/M, 1 = enter E, 2 = enter F)
  //   bit2:   E run ends here (E == H[i-1][j] - GAP_OPEN)
  //   bit3:   F run ends here (F == H[i][j-1] - GAP_OPEN)
  static thread_local std::vector<int> Hprev_b, Hcur_b, Eprev_b, Ecur_b;
  static thread_local std::vector<uint8_t> BPb;
  const int W = m + 1;
  if ((int)Hprev_b.size() < W) {
    Hprev_b.resize(W); Hcur_b.resize(W);
    Eprev_b.resize(W); Ecur_b.resize(W);
  }
  if (BPb.size() < (size_t)(n + 1) * W) BPb.resize((size_t)(n + 1) * W);
  int* Hp = Hprev_b.data();
  int* Hi = Hcur_b.data();
  int* Ep = Eprev_b.data();
  int* Ei = Ecur_b.data();
  uint8_t* BP = BPb.data();
  for (int j = 0; j <= m; j++) { Hp[j] = 0; Ep[j] = NEG; }
  for (int i = 1; i <= n; i++) {
    uint8_t* bp = BP + (size_t)i * W;
    const char qc = q[i - 1];
    int e0 = std::max(Hp[0] - GAP_OPEN, Ep[0] - GAP_EXT);
    Ei[0] = e0;
    Hi[0] = e0;                           // F[i][0] = NEG in the original
    // original H-state traceback at j==0: diag = NEG, then H==E -> E
    bp[0] = (uint8_t)((1) | ((e0 == Hp[0] - GAP_OPEN) ? 4 : 0));
    int f_prev = NEG;                     // F[i][j-1] (current row)
    for (int j = 1; j <= m; j++) {
      int e = std::max(Hp[j] - GAP_OPEN, Ep[j] - GAP_EXT);
      int f = std::max(Hi[j - 1] - GAP_OPEN, f_prev - GAP_EXT);
      int diag = Hp[j - 1] + (qc == t[j - 1] ? MATCH : -MISMATCH);
      int h = diag > e ? diag : e;
      if (f > h) h = f;
      // H-state move with the original precedence: diag on tie, else E
      // on tie, else F
      uint8_t mv = (h == diag) ? 0 : (h == e ? 1 : 2);
      bp[j] = (uint8_t)(mv | ((e == Hp[j] - GAP_OPEN) ? 4 : 0) |
                        ((f == Hi[j - 1] - GAP_OPEN) ? 8 : 0));
      Ei[j] = e;
      Hi[j] = h;
      f_prev = f;
    }
    std::swap(Hp, Hi);
    std::swap(Ep, Ei);
  }
  // free target suffix: best over H[n][j] (in Hp after the final swap)
  int best_j = 0, best = NEG;
  for (int j = 0; j <= m; j++)
    if (Hp[j] >= best) { best = Hp[j]; best_j = j; }
  Aln out;
  out.score = best;
  // affine-aware traceback over the backpointer bytes
  std::vector<std::pair<char, int>> rev;
  int i = n, j = best_j;
  auto push = [&](char op) {
    if (!rev.empty() && rev.back().first == op) rev.back().second++;
    else rev.push_back({op, 1});
  };
  char state = 'H';
  while (i > 0) {
    uint8_t b = BP[(size_t)i * W + j];
    if (state == 'H') {
      uint8_t mv = b & 3;
      if (mv == 0) { push('M'); i--; j--; }
      else if (mv == 1) state = 'E';
      else state = 'F';
    } else if (state == 'E') {
      push('I');
      if (b & 4) state = 'H';
      i--;
    } else {  // F
      push('D');
      if (b & 8) state = 'H';
      j--;
    }
  }
  out.ref_start = j;
  out.cigar.assign(rev.rbegin(), rev.rend());
  return out;
}

// expand an alignment to per-query-base target coordinates (-1 = inserted)
std::vector<int> query_to_target(const Aln& a, int qlen) {
  std::vector<int> map(qlen, -1);
  int qi = 0, tj = a.ref_start;
  for (auto& [op, len] : a.cigar) {
    if (op == 'M') {
      for (int x = 0; x < len; x++) map[qi++] = tj++;
    } else if (op == 'I') {
      for (int x = 0; x < len; x++) map[qi++] = -1;
    } else {
      tj += len;
    }
  }
  return map;
}

struct Realigned {
  int pos;                          // new 0-based ref pos (or -1: keep orig)
  std::string cigar;
};

std::string cigar_to_string(const std::vector<std::pair<char, int>>& c) {
  std::string s;
  for (auto& [op, len] : c) {
    s += std::to_string(len);
    s += op;
  }
  return s;
}

Realigned compose(const Aln& read2hap, const std::vector<int>& hap2ref,
                  int ref_start0, int qlen) {
  // project each read base through hap coords into ref coords
  auto r2h = query_to_target(read2hap, qlen);
  std::vector<int> r2r(qlen, -1);
  for (int i = 0; i < qlen; i++) {
    int h = r2h[i];
    if (h >= 0 && h < (int)hap2ref.size()) r2r[i] = hap2ref[h];
  }
  // build CIGAR from the monotone mapping
  int first = -1;
  for (int i = 0; i < qlen; i++)
    if (r2r[i] >= 0) { first = i; break; }
  if (first < 0) return {-1, ""};
  std::vector<std::pair<char, int>> cig;
  auto push = [&](char op, int len) {
    if (len <= 0) return;
    if (!cig.empty() && cig.back().first == op) cig.back().second += len;
    else cig.push_back({op, len});
  };
  push('S', first);
  int prev_ref = r2r[first];
  push('M', 1);
  int trailing = 0;
  for (int i = first + 1; i < qlen; i++) {
    if (r2r[i] < 0) {
      trailing++;  // provisional insertion/softclip
      continue;
    }
    int gap = r2r[i] - prev_ref;
    if (trailing > 0) {
      push('I', trailing);
      trailing = 0;
    }
    if (gap > 1) push('D', gap - 1);
    push('M', 1);
    prev_ref = r2r[i];
  }
  if (trailing > 0) push('S', trailing);
  return {ref_start0 + r2r[first] - 0, cigar_to_string(cig)};
}

}  // namespace

extern "C" {

// ---- de Bruijn consensus ----
// reads: '\n'-joined; quals: per-base phred bytes '\n'-aligned lengths or
// null.  Returns '\n'-joined haplotypes in a malloc'd buffer (caller frees
// with realign_free).
char* dbg_consensus(const char* ref, const char* reads_joined, int min_bq) {
  std::vector<std::string> reads;
  {
    const char* p = reads_joined;
    const char* s = p;
    for (; *p; p++) {
      if (*p == '\n') {
        reads.emplace_back(s, p - s);
        s = p + 1;
      }
    }
    if (p > s) reads.emplace_back(s, p - s);
  }
  auto haps = dbg_consensus_impl(ref, reads, {}, min_bq);
  std::string joined;
  for (size_t i = 0; i < haps.size(); i++) {
    if (i) joined += '\n';
    joined += haps[i];
  }
  char* out = (char*)malloc(joined.size() + 1);
  memcpy(out, joined.c_str(), joined.size() + 1);
  return out;
}

void realign_free(char* p) { free(p); }

// ---- full realignment ----
// Realigns reads against consensus haplotypes anchored at ref_start0 on ref.
// seqs: '\n'-joined read sequences; haps: '\n'-joined haplotypes.
// out_pos: (n_reads,) int64 new 0-based positions (-1 = unchanged);
// out_cigars: buffer receiving '\n'-joined cigar strings (returns ptr).
char* realign_reads(const char* ref_window, int64_t ref_start0,
                    const char* seqs_joined, const char* haps_joined,
                    int64_t* out_pos, int* n_out) {
  std::vector<std::string> seqs, haps;
  auto split = [](const char* joined, std::vector<std::string>& out) {
    const char* p = joined;
    const char* s = p;
    for (; *p; p++)
      if (*p == '\n') { out.emplace_back(s, p - s); s = p + 1; }
    if (p > s) out.emplace_back(s, p - s);
  };
  split(seqs_joined, seqs);
  split(haps_joined, haps);
  std::string ref(ref_window);

  // hap -> ref alignments
  std::vector<std::vector<int>> hap2ref;
  for (auto& h : haps) {
    Aln a = align_affine(h, ref);
    hap2ref.push_back(query_to_target(a, h.size()));
  }

  // k-mer index per haplotype for fast best-hap vote
  const int K = 15;
  std::vector<std::unordered_set<uint64_t>> hap_kmers(haps.size());
  auto kmer_hash = [](const char* s, int k) -> uint64_t {
    uint64_t h = 0;
    for (int i = 0; i < k; i++) {
      int c = s[i] == 'A' ? 0 : s[i] == 'C' ? 1 : s[i] == 'G' ? 2 : s[i] == 'T' ? 3 : -1;
      if (c < 0) return UINT64_MAX;
      h = (h << 2) | c;
    }
    return h;
  };
  for (size_t hi = 0; hi < haps.size(); hi++) {
    const auto& h = haps[hi];
    for (size_t i = 0; i + K <= h.size(); i++) {
      uint64_t kh = kmer_hash(h.data() + i, K);
      if (kh != UINT64_MAX) hap_kmers[hi].insert(kh);
    }
  }

  std::string cigars_joined;
  for (size_t r = 0; r < seqs.size(); r++) {
    const auto& s = seqs[r];
    // vote best haplotype by shared k-mers
    int best_h = -1;
    int best_votes = -1;
    for (size_t hi = 0; hi < haps.size(); hi++) {
      int votes = 0;
      for (size_t i = 0; i + K <= s.size(); i += K) {
        uint64_t kh = kmer_hash(s.data() + i, K);
        if (kh != UINT64_MAX && hap_kmers[hi].count(kh)) votes++;
      }
      if (votes > best_votes) { best_votes = votes; best_h = (int)hi; }
    }
    Realigned res{-1, ""};
    if (best_h >= 0) {
      Aln a = align_affine(s, haps[best_h]);
      res = compose(a, hap2ref[best_h], (int)ref_start0, (int)s.size());
    }
    out_pos[r] = res.pos;
    if (r) cigars_joined += '\n';
    cigars_joined += res.cigar;
  }
  *n_out = (int)seqs.size();
  char* out = (char*)malloc(cigars_joined.size() + 1);
  memcpy(out, cigars_joined.c_str(), cigars_joined.size() + 1);
  return out;
}

}  // extern "C"
