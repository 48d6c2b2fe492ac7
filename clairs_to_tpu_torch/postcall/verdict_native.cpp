// Port copy of clairs_to_tpu/postcall/verdict_native.cpp.
// Native batch kernel for the post-calling filter verdicts (SNV sites).
//
// Behavioral contract: bit-for-bit the same verdicts/p-values as the
// Python engines in postcall/hardfilter.py (HardFilterEngine, 4 verdicts:
// reference src/postfilter_variants.py) and postcall/haplotype.py
// (HaplotypeFilterEngine, 9 verdicts: reference src/haplotype_filtering.py)
// for SNV ref/alt pairs under the default scipy-semantics Fisher test.
// Indel sites and the --exact_reference_fisher parity mode stay on the
// Python path (entropy strings / big-int recurrence are not hot).
//
// The Python per-site loop's cost is almost entirely small-array numpy
// dispatch overhead (co_exist sort/unique, Fisher, means/searchsorted/masks).  This kernel runs the same per-site
// work as straight loops over the shared FilterIndex arrays.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -ffp-contract=off
//        -o libverdict_native.so verdict_native.cpp
// -ffp-contract=off matters: the Fisher log-space accumulation must match
// CPython's libm-call-per-op arithmetic exactly (no FMA contraction).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

typedef int64_t i64;
typedef int32_t i32;
typedef int8_t i8;
typedef int16_t i16;
typedef uint8_t u8;

// ---- Fisher exact (scipy-semantics log-gamma formulation) ---------------
// Mirrors hardfilter.fisher_exact: same expression grouping, same ascending
// support walk, same tie cutoff, same min(p, 1.0).  CPython's math.lgamma
// is NOT libm lgamma — it is its own Lanczos implementation
// (Modules/mathmodule.c m_lgamma); the positive-argument branch is ported
// verbatim below so log-binomials are bit-identical to the Python engine's.

const int LANCZOS_N = 13;
const double lanczos_g = 6.024680040776729583740234375;
const double lanczos_num_coeffs[LANCZOS_N] = {
    23531376880.410759688572007674451636754734846804940,
    42919803642.649098768957899047001988850926355848959,
    35711959237.355668049440185451547166705960488635843,
    17921034426.037209699919755754458931112671403265390,
    6039542586.3520280050642916443072979210699388420708,
    1439720407.3117216736632230727949123939715485786772,
    248874557.86205415651146038641322942321632125127801,
    31426415.585400194380614231628318205362874684987640,
    2876370.6289353724412254090516208496135991145378768,
    186056.26539522349504029498971604569928220784236328,
    8071.6720023658162106380029022722506138218516325024,
    210.82427775157934587250973392071336271166969580291,
    2.5066282746310002701649081771338373386264310793408};
const double lanczos_den_coeffs[LANCZOS_N] = {
    0.0, 39916800.0, 120543840.0, 150917976.0, 105258076.0, 45995730.0,
    13339535.0, 2637558.0, 357423.0, 32670.0, 1925.0, 66.0, 1.0};

double lanczos_sum(double x) {
    double num = 0.0, den = 0.0;
    if (x < 5.0) {
        for (int i = LANCZOS_N; --i >= 0;) {
            num = num * x + lanczos_num_coeffs[i];
            den = den * x + lanczos_den_coeffs[i];
        }
    } else {
        for (int i = 0; i < LANCZOS_N; i++) {
            num = num / x + lanczos_num_coeffs[i];
            den = den / x + lanczos_den_coeffs[i];
        }
    }
    return num / den;
}

// CPython m_lgamma, positive finite arguments only (always the case here:
// inputs are n+1 for integer n >= 0)
double py_lgamma(double x) {
    if (x == floor(x) && x <= 2.0) return 0.0;   // lgamma(1) = lgamma(2) = 0
    double absx = fabs(x);
    if (absx < 1e-20) return -log(absx);
    double r = log(lanczos_sum(absx)) - lanczos_g;
    r += (absx - 0.5) * (log(absx + lanczos_g - 0.5) - 1);
    return r;
}

double log_binom(double n, double k) {
    return py_lgamma(n + 1.0) - py_lgamma(k + 1.0) - py_lgamma(n - k + 1.0);
}

std::unordered_map<uint64_t, double> g_fisher_memo;

double fisher_exact(i64 a, i64 b, i64 c, i64 d) {
    if (a == b && b == c && c == d) return 1.0;
    uint64_t key = ((uint64_t)(uint16_t)a << 48) |
                   ((uint64_t)(uint16_t)b << 32) |
                   ((uint64_t)(uint16_t)c << 16) | (uint64_t)(uint16_t)d;
    bool memoizable = a < 65536 && b < 65536 && c < 65536 && d < 65536;
    if (memoizable) {
        auto it = g_fisher_memo.find(key);
        if (it != g_fisher_memo.end()) return it->second;
    }
    i64 m = a + b, n = c + d, k = a + c;
    double log_denom = log_binom((double)(m + n), (double)k);
    double log_obs = log_binom((double)m, (double)a) +
                     log_binom((double)n, (double)(k - a)) - log_denom;
    double cutoff = log_obs + 1e-7;
    double p = 0.0;
    i64 x0 = k - n > 0 ? k - n : 0;
    i64 x1 = k < m ? k : m;
    for (i64 x = x0; x <= x1; ++x) {
        double lp = log_binom((double)m, (double)x) +
                    log_binom((double)n, (double)(k - x)) - log_denom;
        if (lp <= cutoff) p += exp(lp);
    }
    if (p > 1.0) p = 1.0;
    if (memoizable && g_fisher_memo.size() < 200000)
        g_fisher_memo[key] = p;
    return p;
}

// base-identity fold of an entry code (hardfilter._BASE_ID)
inline int base_id(i8 code) {
    static const int tab[12] = {0, 1, 2, 3, 0, 1, 2, 3, 8, 9, 10, 10};
    return tab[(int)code];
}

inline bool is_rev(i8 code) {
    return (code >= 4 && code < 8) || code == 9;
}

struct GermState {
    // one row per center-column entry (reads are unique per column)
    std::vector<i32> reads;
    std::vector<i8> hp;
    std::vector<u8> match;   // carries the germline alt (SNV token match)
    i64 n_match = 0;
    // hom-only summaries
    i64 hcount[3] = {0, 0, 0};
    i64 acount[3] = {0, 0, 0};
};

struct VerdictEngine {
    // entry-table arrays (borrowed pointers; Python keeps them alive)
    const i8 *code; const i16 *bq; const i16 *mq; const i8 *hp;
    const i8 *ikind; const i32 *read_id;
    const i32 *orig; const i64 *col_start;
    i64 p0, p1;
    const i64 *nr_pos; const i32 *nr_read; const i64 *nr_token;
    const u8 *nr_bare_del; i64 n_nr; i64 T;
    const i64 *colkey; const i64 *colkey_cnt; i64 n_colkey;
    const double *cum_ins; const double *col_ins; const u8 *col_only_ref;
    const i64 *rse_pos; const i32 *rse_read; i64 n_rse;
    i64 n_reads;
    const i64 *het_pos; const i8 *het_alt; i64 n_het;
    const i64 *hom_pos; const i8 *hom_alt; i64 n_hom;
    int max_co_exist;
    int disable_rse;
    int mode;        // 0 = hard (ilmn postfilter), 1 = haplotype (9 verdicts)
    double ont_min_bq, min_mq_thresh;

    std::vector<u8> read_flag;     // scratch: marks alt reads
    std::vector<u8> hapalt_flag;   // scratch: alt reads on chosen haplotype
    std::unordered_map<i64, GermState> het_memo, hom_memo;
};

i64 lower_bound64(const i64 *arr, i64 n, i64 v) {
    i64 lo = 0, hi = n;
    while (lo < hi) { i64 mid = (lo + hi) >> 1;
        if (arr[mid] < v) lo = mid + 1; else hi = mid; }
    return lo;
}

i64 upper_bound64(const i64 *arr, i64 n, i64 v) {
    i64 lo = 0, hi = n;
    while (lo < hi) { i64 mid = (lo + hi) >> 1;
        if (arr[mid] <= v) lo = mid + 1; else hi = mid; }
    return lo;
}

// center-column state for a germline site (memoized like the Python
// _het_col/_hom_col; SNV-only token match = (ikind==0 && base==alt))
const GermState &germ_state(VerdictEngine *E, i64 gp, int alt_i, bool hom) {
    auto &memo = hom ? E->hom_memo : E->het_memo;
    i64 key = gp * 4 + alt_i;       // Python memo key is (gp, gab)
    auto it = memo.find(key);
    if (it != memo.end()) return it->second;
    GermState st;
    if (gp >= E->p0 && gp < E->p1) {
        i64 c = gp - E->p0;
        i64 r0 = E->col_start[c], r1 = E->col_start[c + 1];
        st.reads.reserve(r1 - r0);
        for (i64 r = r0; r < r1; ++r) {
            i32 row = E->orig[r];
            i8 hpv = E->hp[row];
            bool m = E->ikind[row] == 0 && base_id(E->code[row]) == alt_i;
            st.reads.push_back(E->read_id[row]);
            st.hp.push_back(hpv);
            st.match.push_back(m ? 1 : 0);
            if (m) st.n_match++;
            if (hom) {
                int h = hpv >= 0 && hpv < 3 ? hpv : 0;
                st.acount[h]++;
                if (m) st.hcount[h]++;
            }
        }
    }
    return memo.emplace(key, std::move(st)).first->second;
}

}  // namespace

extern "C" {

void *verdict_engine_create(
    const i8 *code, const i16 *bq, const i16 *mq, const i8 *hp,
    const i8 *ikind, const i32 *read_id,
    const i32 *orig, const i64 *col_start, i64 p0, i64 p1,
    const i64 *nr_pos, const i32 *nr_read, const i64 *nr_token,
    const u8 *nr_bare_del, i64 n_nr, i64 T,
    const i64 *colkey, const i64 *colkey_cnt, i64 n_colkey,
    const double *cum_ins, const double *col_ins, const u8 *col_only_ref,
    const i64 *rse_pos, const i32 *rse_read, i64 n_rse, i64 n_reads,
    const i64 *het_pos, const i8 *het_alt, i64 n_het,
    const i64 *hom_pos, const i8 *hom_alt, i64 n_hom,
    int max_co_exist, int disable_rse, int mode,
    double ont_min_bq, double min_mq_thresh) {
    VerdictEngine *E = new VerdictEngine();
    E->code = code; E->bq = bq; E->mq = mq; E->hp = hp;
    E->ikind = ikind; E->read_id = read_id;
    E->orig = orig; E->col_start = col_start; E->p0 = p0; E->p1 = p1;
    E->nr_pos = nr_pos; E->nr_read = nr_read; E->nr_token = nr_token;
    E->nr_bare_del = nr_bare_del; E->n_nr = n_nr; E->T = T;
    E->colkey = colkey; E->colkey_cnt = colkey_cnt; E->n_colkey = n_colkey;
    E->cum_ins = cum_ins; E->col_ins = col_ins;
    E->col_only_ref = col_only_ref;
    E->rse_pos = rse_pos; E->rse_read = rse_read; E->n_rse = n_rse;
    E->n_reads = n_reads > 0 ? n_reads : 1;
    E->het_pos = het_pos; E->het_alt = het_alt; E->n_het = n_het;
    E->hom_pos = hom_pos; E->hom_alt = hom_alt; E->n_hom = n_hom;
    E->max_co_exist = max_co_exist; E->disable_rse = disable_rse;
    E->mode = mode;
    E->ont_min_bq = ont_min_bq; E->min_mq_thresh = min_mq_thresh;
    E->read_flag.assign((size_t)E->n_reads, 0);
    E->hapalt_flag.assign((size_t)E->n_reads, 0);
    return E;
}

void verdict_engine_free(void *h) { delete (VerdictEngine *)h; }

// out_flags bit layout (1 = pass / true):
//   bit0 bq, bit1 mq, bit2 read_start_end, bit3 co_exist, bit4 hetero,
//   bit5 homo, bit6 hetero_both_side, bit7 strand_bias,
//   bit8 sequence_entropy (always pass here: SNV), bit9 phaseable
void verdict_engine_run(
    void *hdl, i64 n_sites, const i64 *site_pos, const i8 *site_alt,
    const double *site_af, i32 *out_flags, double *out_p, i32 *out_table) {
    VerdictEngine *E = (VerdictEngine *)hdl;
    const int FLANKING = 100;
    const double EPS = 0.5;
    std::vector<i32> alt_ids;
    std::vector<i32> col_entry_tok_first;   // scratch reused per site

    for (i64 s = 0; s < n_sites; ++s) {
        i64 pos0 = site_pos[s];
        int ai = site_alt[s];
        double af = site_af[s];
        i32 flags = (1 << 9) - 1;    // all 9 pass
        bool phaseable = false;

        i64 win_lo = pos0 - FLANKING > 0 ? pos0 - FLANKING : 0;
        i64 win_hi = pos0 + FLANKING;

        // --- center-column state ------------------------------------------
        i64 r0 = 0, r1 = 0;
        if (pos0 >= E->p0 && pos0 < E->p1) {
            i64 c = pos0 - E->p0;
            r0 = E->col_start[c]; r1 = E->col_start[c + 1];
        }
        i64 depth_rows = r1 - r0;
        alt_ids.clear();
        i64 n_alt = 0, a1 = 0, nrev = 0;
        i64 bq_sum = 0, mq_sum = 0;
        i64 hp1 = 0, hp2 = 0, all1 = 0, all2 = 0;
        for (i64 r = r0; r < r1; ++r) {
            i32 row = E->orig[r];
            bool rev = is_rev(E->code[row]);
            if (rev) nrev++;
            i8 hpv = E->hp[row];
            if (hpv == 1) all1++; else if (hpv == 2) all2++;
            if (E->ikind[row] == 0 && base_id(E->code[row]) == ai) {
                n_alt++;
                if (rev) a1++;
                bq_sum += E->bq[row];
                mq_sum += E->mq[row];
                alt_ids.push_back(E->read_id[row]);
                if (hpv == 1) hp1++; else if (hpv == 2) hp2++;
            }
        }
        i64 a0 = n_alt - a1;
        i64 r_fwd = depth_rows - nrev - a0;
        i64 r_rev = nrev - a1;

        // --- ①② mean alt BQ / MQ (haplotype mode only) --------------------
        if (E->mode == 1 && n_alt) {
            if ((double)bq_sum / (double)n_alt <= E->ont_min_bq)
                flags &= ~(1 << 0);
            if ((double)mq_sum / (double)n_alt <= E->min_mq_thresh)
                flags &= ~(1 << 1);
        }

        // mark alt reads (scratch flags)
        for (i32 rd : alt_ids) E->read_flag[rd] = 1;

        // --- ③ read start/end ---------------------------------------------
        // hard mode keeps the reference's 0 >= 0 failure at zero-alt sites
        if (!E->disable_rse && (E->mode == 0 || n_alt > 0)) {
            i64 s0 = lower_bound64(E->rse_pos, E->n_rse, win_lo);
            i64 s1 = lower_bound64(E->rse_pos, E->n_rse, win_hi + 1);
            i64 hits = 0;
            // count DISTINCT alt reads among the marks: flip each read's
            // flag to 2 on first hit
            for (i64 t = s0; t < s1; ++t) {
                i32 rd = E->rse_read[t];
                if (E->read_flag[rd] == 1) { E->read_flag[rd] = 2; hits++; }
            }
            for (i64 t = s0; t < s1; ++t) {
                i32 rd = E->rse_read[t];
                if (E->read_flag[rd] == 2) E->read_flag[rd] = 1;
            }
            if ((double)hits >= 0.3 * (double)n_alt) flags &= ~(1 << 2);
        }

        // --- haplotype memberships / ⑦ both-side --------------------------
        i64 MAXh = hp1 > hp2 ? hp1 : hp2;
        i64 MINh = hp1 < hp2 ? hp1 : hp2;
        int hap_index = 0;
        if (E->mode == 1) {
            const double low_af = 0.1;   // SNV
            if (af < low_af && hp1 * hp2 > 0 &&
                (MINh > E->max_co_exist ||
                 (double)MAXh / (double)MINh <= 10.0))
                flags &= ~(1 << 6);
            bool is_phasable =
                hp1 * hp2 == 0 ||
                ((double)MAXh / (double)MINh >= 5.0 &&
                 (hp1 > E->max_co_exist || hp2 > E->max_co_exist));
            hap_index = !is_phasable ? 0 : (hp1 > hp2 ? 1 : 2);
            phaseable = (all1 * all2 > 0) && (hp1 * hp2 == 0) &&
                        (hp1 > E->max_co_exist || hp2 > E->max_co_exist);
        }

        // --- ④ co-exist / variant cluster ---------------------------------
        {
            i64 m_cols = E->p1 - E->p0;
            i64 lo_c = win_lo - E->p0;
            if (lo_c < 0) lo_c = 0; if (lo_c > m_cols) lo_c = m_cols;
            i64 hi_c = win_hi + 1 - E->p0;
            if (hi_c < 0) hi_c = 0; if (hi_c > m_cols) hi_c = m_cols;
            double ins_length = E->cum_ins[hi_c] - E->cum_ins[lo_c];
            if (pos0 >= E->p0 && pos0 < E->p1)
                ins_length -= E->col_ins[pos0 - E->p0];
            i64 match_count = 0;
            if (n_alt > 0) {
                i64 s0 = lower_bound64(E->nr_pos, E->n_nr, win_lo);
                i64 s1 = lower_bound64(E->nr_pos, E->n_nr, win_hi + 1);
                // walk masked entries column by column (nr_pos is sorted;
                // per-column entries arrive in table order = the Python
                // first-occurrence tie-break order)
                i64 t = s0;
                double lo_thr = (double)n_alt * (1.0 - EPS);
                double hi_thr = (double)n_alt * (1.0 + EPS);
                // per-column token accumulator: (token, count, first_idx)
                std::vector<i64> toks; std::vector<i64> cnts;
                while (t < s1) {
                    i64 col = E->nr_pos[t];
                    i64 u = t;
                    toks.clear(); cnts.clear();
                    bool any = false;
                    for (; u < s1 && E->nr_pos[u] == col; ++u) {
                        if (!E->read_flag[E->nr_read[u]]) continue;
                        if (E->nr_bare_del[u]) continue;
                        if (col == pos0) continue;
                        any = true;
                        i64 tok = E->nr_token[u];
                        size_t j = 0;
                        for (; j < toks.size(); ++j)
                            if (toks[j] == tok) { cnts[j]++; break; }
                        if (j == toks.size()) {
                            toks.push_back(tok);
                            cnts.push_back(1);
                        }
                    }
                    t = u;
                    if (!any) continue;
                    // top token: max count, ties -> earliest first
                    // occurrence (vector order IS first-occurrence order)
                    size_t best = 0;
                    for (size_t j = 1; j < toks.size(); ++j)
                        if (cnts[j] > cnts[best]) best = j;
                    i64 top = cnts[best];
                    if (!((double)top > lo_thr && (double)top < hi_thr))
                        continue;
                    if (E->col_only_ref[col - E->p0]) continue;
                    // full-column count of the top token
                    i64 key = col * E->T + toks[best];
                    i64 ki = lower_bound64(E->colkey, E->n_colkey, key);
                    i64 full = (ki < E->n_colkey && E->colkey[ki] == key)
                                   ? E->colkey_cnt[ki] : 0;
                    if ((double)full >= (double)top * (1.0 + EPS)) continue;
                    match_count++;
                }
            }
            i64 depth = depth_rows > 1 ? depth_rows : 1;
            if (match_count >= E->max_co_exist ||
                ins_length / (double)depth > 3.0)
                flags &= ~(1 << 3);
        }

        if (E->mode == 1) {
            // --- ⑤ ancestral het-germline support -------------------------
            if (hap_index > 0) {
                // mark alt reads on the chosen haplotype
                for (i64 r = r0; r < r1; ++r) {
                    i32 row = E->orig[r];
                    if (E->ikind[row] == 0 && base_id(E->code[row]) == ai &&
                        E->hp[row] == hap_index)
                        E->hapalt_flag[E->read_id[row]] = 1;
                }
                i64 g0 = lower_bound64(E->het_pos, E->n_het, win_lo);
                i64 g1 = upper_bound64(E->het_pos, E->n_het, win_hi);
                for (i64 g = g0; g < g1; ++g) {
                    i64 gp = E->het_pos[g];
                    if (gp == pos0) continue;
                    const GermState &st =
                        germ_state(E, gp, E->het_alt[g], false);
                    if (st.reads.empty()) continue;
                    i64 n_phased = 0;
                    bool on_hap = false;
                    for (size_t j = 0; j < st.reads.size(); ++j) {
                        if (st.hp[j] == hap_index && st.match[j]) {
                            n_phased++;
                            if (E->hapalt_flag[st.reads[j]]) on_hap = true;
                        }
                    }
                    if (n_phased == 0 ||
                        (double)(n_phased * 2) < (double)st.n_match)
                        continue;
                    if (!on_hap) { flags &= ~(1 << 4); break; }
                }
                for (i64 r = r0; r < r1; ++r)
                    E->hapalt_flag[E->read_id[E->orig[r]]] = 0;
            }

            // --- ⑥ hom-germline carryover ---------------------------------
            {
                i64 g0 = lower_bound64(E->hom_pos, E->n_hom, win_lo);
                i64 g1 = upper_bound64(E->hom_pos, E->n_hom, win_hi);
                for (i64 g = g0; g < g1; ++g) {
                    i64 gp = E->hom_pos[g];
                    if (gp == pos0) continue;
                    const GermState &st =
                        germ_state(E, gp, E->hom_alt[g], true);
                    if (st.reads.empty()) continue;
                    i64 tot = st.acount[0] + st.acount[1] + st.acount[2];
                    double af_g = tot
                        ? (double)(st.hcount[0] + st.hcount[1] + st.hcount[2])
                              / (double)tot
                        : 0.0;
                    bool g_phasable = false;
                    if (st.acount[1] * st.acount[2] != 0) {
                        i64 mx = st.hcount[1] > st.hcount[2] ? st.hcount[1]
                                                             : st.hcount[2];
                        i64 mn = st.hcount[1] < st.hcount[2] ? st.hcount[1]
                                                             : st.hcount[2];
                        g_phasable = !(st.hcount[1] * st.hcount[2] > 0 &&
                                       (double)mx / (double)mn <= 10.0);
                    }
                    if (af_g < 0.75 || g_phasable) continue;
                    i64 n_inter = 0, n_overlap = 0;
                    for (size_t j = 0; j < st.reads.size(); ++j) {
                        if (E->read_flag[st.reads[j]]) {
                            n_inter++;
                            if (st.match[j]) n_overlap++;
                        }
                    }
                    if (n_inter == 0) continue;
                    if (n_overlap == 0 ||
                        (double)n_overlap / (double)n_inter < EPS) {
                        flags &= ~(1 << 5);
                        break;
                    }
                }
            }
        }

        // --- ⑧ strand bias ------------------------------------------------
        double p = fisher_exact(a0, r_fwd, a1, r_rev);
        if (E->mode == 1) {
            // SNV branch of the reference's precedence quirk: fail when
            // p < 0.001 OR either strand has zero alt support
            if (p < 0.001 || a0 == 0 || a1 == 0) flags &= ~(1 << 7);
        } else {
            if (p < 0.001) flags &= ~(1 << 7);
        }

        // clear alt-read scratch
        for (i32 rd : alt_ids) E->read_flag[rd] = 0;

        if (phaseable) flags |= (1 << 9);
        out_flags[s] = flags;
        out_p[s] = p;
        out_table[s * 4 + 0] = (i32)a0;
        out_table[s * 4 + 1] = (i32)r_fwd;
        out_table[s * 4 + 2] = (i32)a1;
        out_table[s * 4 + 3] = (i32)r_rev;
    }
}

// direct Fisher entry point (testing / cross-validation)
double verdict_fisher_exact(i64 a, i64 b, i64 c, i64 d) {
    return fisher_exact(a, b, c, d);
}

}  // extern "C"
