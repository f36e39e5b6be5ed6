// Native step-3 alignment engine for kma_tpu.
//
// Exact C++ port of kma_tpu/align/{cci,nw,kma_aln}.py -- the host-side
// seed-chain-extend aligner whose semantics are oracle-tested against the
// reference (align.c / chain.c / nw.c / hashmapcci.c).  The Python module
// remains the semantics reference and fallback; this engine removes the
// interpreter overhead from the per-(read, template) hot loop (~0.7 ms ->
// ~2 us per alignment).
//
// API is C (ctypes-friendly): an opaque per-template index handle plus
// alignment entry points that mirror kma_align / anker_rc_comp /
// anker_rc_bytes / preseed.  A single global seed buffer ("points")
// mirrors the reference's per-thread AlnPoints; the pipeline is
// single-threaded per process.
//
// Build: g++ -O2 -fPIC -shared -o libkma_align.so kma_align.cpp

#include <cstdint>
#include <cstring>
#include <cstdarg>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <chrono>
#include <vector>
#include <unordered_map>
#include <algorithm>
#include <climits>

typedef long long ll;

// ---- KMA_ALN_PROF=1 sub-phase accounting (ns totals across threads) -----
#include <atomic>
static std::atomic<ll> g_p_collect(0), g_p_chain(0), g_p_tails(0),
    g_p_nw(0), g_p_calls(0), g_p_seeds(0), g_p_nwcells(0), g_p_skipped(0),
    g_p_anker(0), g_p_key(0), g_p_walk(0), g_p_phA(0), g_p_phB(0),
    g_p_phC(0), g_p_pre(0), g_p_preskip(0), g_p_pre_small(0),
    g_p_pre_nobest(0), g_p_pre_run(0), g_p_pre_dev(0),
    g_p_tfull_cells(0), g_p_tband_cells(0);

// Device pre-pass score tables (per GLOBAL candidate = tpl_off[r]+ci),
// produced by the device banded-NW scorer over the windows exported by
// kaln_se_windows.  Set immediately before ONE kaln_frags_se_batch*
// call and cleared by it; read-only while the batch workers run.
// -ca circular templates: the batched scorers' chainSeeds variant
// (chainSeedsPtr role, kma.c:693).  Set once per run before any
// kaln_*_batch / kaln_se_windows call; read-only while workers run.
static std::atomic<int> g_chain_circular(0);
extern "C" void kaln_set_circular(int v) { g_chain_circular.store(v); }

static const long long *g_dev_lead = nullptr, *g_dev_trail = nullptr;
static const uint8_t *g_dev_has_lead = nullptr,
                     *g_dev_has_trail = nullptr;
extern "C" void kaln_set_dev_scores(const long long* lead,
                                    const uint8_t* has_lead,
                                    const long long* trail,
                                    const uint8_t* has_trail) {
    g_dev_lead = lead;
    g_dev_has_lead = has_lead;
    g_dev_trail = trail;
    g_dev_has_trail = has_trail;
}
static bool aln_prof_on() {
    static bool v = getenv("KMA_ALN_PROF") != nullptr;
    return v;
}
static inline double prof_now() {
    return std::chrono::duration<double>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
}
extern "C" void kaln_prof_report(void) {
    if (!aln_prof_on())
        return;
    fprintf(stderr,
            "# kaln prof: calls %lld collect %.3f chain %.3f tails %.3f "
            "nw %.3f anker %.3f walk %.3f key %.3f seeds %lld "
            "nw_cells %lld skipped %lld phA %.3f phB %.3f phC %.3f "
            "pre %.3f preskip %lld presmall %lld prenobest %lld "
            "prerun %lld predev %lld tfull_cells %lld tband_cells %lld\n",
            (ll)g_p_calls.load(), g_p_collect.load() * 1e-9,
            g_p_chain.load() * 1e-9, g_p_tails.load() * 1e-9,
            g_p_nw.load() * 1e-9, g_p_anker.load() * 1e-9,
            g_p_walk.load() * 1e-9, g_p_key.load() * 1e-9,
            (ll)g_p_seeds.load(), (ll)g_p_nwcells.load(),
            (ll)g_p_skipped.load(), g_p_phA.load() * 1e-9,
            g_p_phB.load() * 1e-9, g_p_phC.load() * 1e-9,
            g_p_pre.load() * 1e-9, (ll)g_p_preskip.load(),
            (ll)g_p_pre_small.load(), (ll)g_p_pre_nobest.load(),
            (ll)g_p_pre_run.load(), (ll)g_p_pre_dev.load(),
            (ll)g_p_tfull_cells.load(), (ll)g_p_tband_cells.load());
}

// ---------------------------------------------------------------- structs

struct AlnStat {
    ll score;
    int pos;
    int len;
    int match;
    int tGaps;
    int qGaps;
    int mapQ;
};

struct Penal {
    int M, MM, U, W1;
    int d[5][5];
};

struct Points {
    std::vector<int> qStart, qEnd, tStart, tEnd, weight, next;
    std::vector<ll> score;
    int len = 0;

    void clear_all() {
        qStart.clear(); qEnd.clear(); tStart.clear(); tEnd.clear();
        weight.clear(); next.clear(); score.clear(); len = 0;
    }
    void add(int qs, int qe, int ts, int te, int w) {
        qStart.push_back(qs); qEnd.push_back(qe);
        tStart.push_back(ts); tEnd.push_back(te);
        weight.push_back(w);
    }
    size_t n() const { return qStart.size(); }
    void trim_to(int m) {
        qStart.resize(m); qEnd.resize(m); tStart.resize(m);
        tEnd.resize(m); weight.resize(m);
    }
    void shift_down(int offset, int count) {
        auto mv = [&](std::vector<int>& a) {
            for (int i = 0; i < count; i++) a[i] = a[offset + i];
            a.resize(count);
        };
        mv(tStart); mv(tEnd); mv(qStart); mv(qEnd); mv(weight);
    }
};

static Points g_points;   // reference AlnPoints analog (single-threaded)

struct TIndex {
    int len = 0;
    int k = 0;
    std::vector<uint8_t> codes;
    // kmer -> positions, as a 4-byte open-addressed table verified
    // against the template sequence (the reference CCI shape,
    // hashmapcci.c:95-199: positions in the table, key equality checked
    // by re-extracting the kmer at the stored position).  slot[i] = 0
    // empty, +pos (1-based) unique kmer, -(chain_off+1) duplicated kmer
    // with chains[chain_off] = count followed by ascending positions.
    // kidx_create drops kmer 0 ("likely undefined region",
    // hashmapcci.c:414).
    std::vector<int32_t> slot;
    std::vector<int32_t> chains;
    uint64_t hmask = 0;

    static inline uint64_t mix(uint64_t v) {
        v ^= v >> 33;
        v *= 0xff51afd7ed558ccdULL;
        v ^= v >> 33;
        v *= 0xc4ceb9fe1a85ec53ULL;
        v ^= v >> 33;
        return v;
    }
    // the kmer the rolling build produced at 1-based position `pos`
    // (N folds to base 0, like the build)
    inline bool verify(uint64_t key, int pos) const {
        const uint8_t* c = codes.data() + (pos - 1);
        for (int i = 0; i < k; i++) {
            uint8_t b = c[i];
            if (b > 3)
                b = 0;
            if ((uint8_t)((key >> (2 * (k - 1 - i))) & 3) != b)
                return false;
        }
        return true;
    }
    // miss -> 0.  unique -> 1, *pos set.  dup -> n (count), *list set to
    // the ascending positions.
    inline int find2(uint64_t kmer, int* pos,
                     const int32_t** list) const {
        if (slot.empty())
            return 0;
        uint64_t s = mix(kmer) & hmask;
        for (;;) {
            int32_t v = slot[s];
            if (v == 0)
                return 0;
            if (v > 0) {
                if (verify(kmer, v)) {
                    *pos = v;
                    return 1;
                }
            } else {
                const int32_t* ch = chains.data() + (-v - 1);
                if (verify(kmer, ch[1])) {
                    *list = ch + 1;
                    return ch[0];
                }
            }
            s = (s + 1) & hmask;
        }
    }

    // hashMapCCI_get semantics: 0 miss, +pos unique, -first duplicated
    int get(uint64_t kmer) const {
        int p;
        const int32_t* ls;
        int n = find2(kmer, &p, &ls);
        if (!n)
            return 0;
        return n == 1 ? p : -ls[0];
    }
    // first position in (lo, hi) exclusive; sign marks duplication
    int get_bound(uint64_t kmer, int lo, int hi) const {
        int p;
        const int32_t* ls;
        int n = find2(kmer, &p, &ls);
        if (!n)
            return 0;
        if (n == 1)
            return (lo < p && p < hi) ? p : 0;
        for (int i = 0; i < n; i++)
            if (lo < ls[i] && ls[i] < hi)
                return -ls[i];
        return 0;
    }
};

// count of equal leading bytes of a[0..n) vs b[0..n), compared 8 at a time
static inline int ext_match_fwd(const uint8_t* a, const uint8_t* b, int n) {
    int i = 0;
    while (i + 8 <= n) {
        uint64_t x, y;
        memcpy(&x, a + i, 8);
        memcpy(&y, b + i, 8);
        uint64_t d = x ^ y;
        if (d)
            return i + (__builtin_ctzll(d) >> 3);
        i += 8;
    }
    while (i < n && a[i] == b[i])
        i++;
    return i;
}

// ------------------------------------------------------------ index build

extern "C" void* kidx_create(const uint8_t* codes, int len, int kmersize) {
    TIndex* t = new TIndex();
    t->len = len;
    t->k = kmersize;
    t->codes.assign(codes, codes + len);
    int end = len - kmersize + 1;
    if (end > 0) {
        // rolling k-mers (N counted as 0, matching io.seq.kmer_scan);
        // one insert pass claiming slots with first positions, repeats
        // spill to a small dup list folded into chains afterwards
        uint64_t mask = (kmersize < 32)
            ? ((uint64_t(1) << (2 * kmersize)) - 1) : ~uint64_t(0);
        uint64_t cap = 8;
        while (cap < 2ull * (uint64_t)end)
            cap <<= 1;
        t->slot.assign(cap, 0);
        t->hmask = cap - 1;
        int32_t* tab = t->slot.data();
        const uint64_t hmask = t->hmask;
        // (slot_idx, pos) of occurrences past the first, ascending pos
        static thread_local std::vector<std::pair<int32_t, int32_t>> dups;
        dups.clear();
        uint64_t key = 0;
        for (int i = 0; i < kmersize - 1; i++) {
            uint8_t c = codes[i];
            key = (key << 2) | (c > 3 ? 0 : c);
        }
        for (int i = 0; i < end; i++) {
            uint8_t c = codes[i + kmersize - 1];
            key = ((key << 2) | (c > 3 ? 0 : c)) & mask;
            if (key == 0)   // "likely undefined region" (hashmapcci.c:414)
                continue;
            uint64_t s = TIndex::mix(key) & hmask;
            for (;;) {
                int32_t v = tab[s];
                if (v == 0) {
                    tab[s] = i + 1;   // 1-based first position
                    break;
                }
                // during the pass slots only hold positive first
                // positions (chains are folded in afterwards)
                if (t->verify(key, v)) {
                    dups.emplace_back((int32_t)s, i + 1);
                    break;
                }
                s = (s + 1) & hmask;
            }
        }
        if (!dups.empty()) {
            std::stable_sort(dups.begin(), dups.end(),
                             [](const std::pair<int32_t, int32_t>& a,
                                const std::pair<int32_t, int32_t>& b) {
                                 return a.first < b.first;
                             });
            size_t i = 0;
            while (i < dups.size()) {
                size_t j = i;
                while (j < dups.size()
                       && dups[j].first == dups[i].first)
                    j++;
                int32_t s = dups[i].first;
                int32_t first = tab[s];
                int32_t off = (int32_t)t->chains.size();
                t->chains.push_back((int32_t)(j - i) + 1);
                t->chains.push_back(first);
                for (size_t x = i; x < j; x++)
                    t->chains.push_back(dups[x].second);
                tab[s] = -(off + 1);
                i = j;
            }
        }
    }
    return t;
}

extern "C" void kidx_free(void* h) { delete (TIndex*)h; }

// template byte codes of a kidx handle (length == template length)
extern "C" const uint8_t* kidx_codes(void* h) {
    return ((TIndex*)h)->codes.data();
}

// -------------------------------------------------------------------- NW

struct Aligned {
    std::vector<uint8_t> t, s, q;
    int start = 0, end = 0, pos = 0;
};

static void empty_case(AlnStat& st, int t_len, int q_len, int W1, int U,
                       const uint8_t* query, const uint8_t* tmpl, int t_e,
                       int template_length, Aligned* aligned) {
    st.score = 0; st.len = 0; st.match = 0; st.tGaps = 0; st.qGaps = 0;
    if (t_len == q_len) {
        if (aligned) { aligned->t.clear(); aligned->s.clear(); aligned->q.clear(); }
        return;
    }
    if (t_len == 0) {
        st.len = q_len; st.tGaps = q_len;
        st.score = W1 + (ll)(q_len - 1) * U;
        if (aligned) {
            aligned->t.assign(q_len, 5);
            aligned->s.assign(q_len, '_');
            aligned->q.assign(query, query + q_len);
        }
        return;
    }
    st.len = t_len; st.qGaps = t_len;
    st.score = W1 + (ll)(t_len - 1) * U;
    if (aligned) {
        aligned->t.resize(t_len);
        int nuc_pos = (t_e ? t_e : aligned->pos) - 1;
        for (int m = t_len - 1; m >= 0; m--) {
            aligned->t[m] = tmpl[nuc_pos];
            nuc_pos--;
            if (nuc_pos < 0) nuc_pos = aligned->pos - 1;
        }
        aligned->s.assign(t_len, '_');
        aligned->q.assign(t_len, 5);
    }
}

// NW / NW_score (nw.c:26-308 / 642-890); template wraps at template_length
static void nw_full(const uint8_t* tmpl, const uint8_t* query, int k,
                    int t_s, int t_e, int q_s, int q_e, const Penal& pen,
                    int template_length, AlnStat& st, Aligned* aligned,
                    std::vector<uint8_t>& Ebuf, std::vector<ll>& Dbuf) {
    const int W1 = pen.W1, U = pen.U, MM = pen.MM;
    int q_len = q_e - q_s;
    int t_len = t_e - t_s;
    if (t_len < 0) t_len += template_length;
    const uint8_t* q = query + q_s;
    if (aligned) { aligned->start = 0; aligned->end = 0; }
    st.score = 0; st.pos = 0; st.len = 0; st.match = 0;
    st.tGaps = 0; st.qGaps = 0;
    if (t_len == 0 || q_len == 0) {
        empty_case(st, t_len, q_len, W1, U, q, tmpl, t_e, template_length,
                   aligned);
        return;
    }
    // scores fit i32 (the reference's own int arrays, nw.c:26); the
    // narrower rows halve DP memory traffic
    int32_t neg = (int32_t)((t_len + q_len) * (MM + U + W1));
    size_t Erows = (size_t)(t_len + 1) * (q_len + 1);
    // every interior cell is overwritten by the DP sweep; only the
    // boundary row/column the init branches leave untouched must be
    // zeroed, so large (assembly realignment) calls skip the full memset
    if (Erows <= (16 << 10)) {
        Ebuf.assign(Erows, 0);
    } else {
        Ebuf.resize(Erows);
        // k > 0: column q_len terminates the traceback; k == 2 also
        // leaves row t_len unwritten
        for (int m = 0; m <= t_len; m++)
            Ebuf[(size_t)m * (q_len + 1) + q_len] = 0;
        if (k > 1)
            memset(Ebuf.data() + (size_t)t_len * (q_len + 1), 0,
                   q_len + 1);
    }
    auto E = [&](int m, int n) -> uint8_t& {
        return Ebuf[(size_t)m * (q_len + 1) + n];
    };
    static thread_local std::vector<int32_t> D32;
    D32.assign(2 * (q_len + 1), neg);
    int32_t* D_prev = D32.data();        // [q_len+1]
    int32_t* P_prev = D32.data() + q_len + 1;

    if (0 < k) {
        if (k == 1) {
            for (int n = 0; n < q_len; n++)
                D_prev[n] = W1 + (ll)(q_len - 1 - n) * U;
            for (int n = 0; n < q_len; n++) E(t_len, n) = 3;
            E(t_len, q_len - 1) = 18;
            E(t_len, q_len) = 0;
            D_prev[q_len] = 0;
            P_prev[q_len] = 0;
        } else {
            for (int n = 0; n <= q_len; n++) D_prev[n] = 0;
        }
    } else {
        for (int m = 0; m < t_len; m++) E(m, q_len) = 5;
        E(t_len - 1, q_len) = 36;
        for (int n = 0; n < q_len; n++)
            D_prev[n] = W1 + (ll)(q_len - 1 - n) * U;
        for (int n = 0; n < q_len; n++) E(t_len, n) = 3;
        E(t_len, q_len - 1) = 18;
        E(t_len, q_len) = 0;
        D_prev[q_len] = 0;
        P_prev[q_len] = 0;
    }

    ll best_score = neg;
    int best_m = 0;
    for (int m = t_len - 1; m >= 0; m--) {
        int32_t D_boundary =
            (0 < k) ? 0 : (int32_t)(W1 + (ll)(t_len - 1 - m) * U);
        int nuc_pos = (t_e - 1 - (t_len - 1 - m)) % template_length;
        if (nuc_pos < 0) nuc_pos += template_length;
        const int* drow = pen.d[tmpl[nuc_pos]];
        int32_t Qprev = neg;
        int32_t Dfin_next = D_boundary;
        int32_t diag = D_prev[q_len];     // D_prev[n+1] running from right
        for (int n = q_len - 1; n >= 0; n--) {
            int32_t Popen = D_prev[n] + W1;
            int32_t Pext = P_prev[n] + U;
            int32_t P = Popen < Pext ? Pext : Popen;
            int32_t Msc = diag + drow[q[n]];
            int32_t D0 = P < Msc ? Msc : P;
            int32_t Qopen = Dfin_next + W1;
            int32_t Qext = Qprev + U;
            int32_t Q = Qopen < Qext ? Qext : Qopen;
            int e = (Qopen < Popen) ? 4 : 2;
            int32_t Dr = Qopen < Popen ? Popen : Qopen;
            int bit16 = !(Qopen < Qext);
            if (Qopen < Qext && Dr <= Qext) { Dr = Qext; e = 3; }
            int bit32 = !(Popen < Pext);
            if (Popen < Pext && Dr <= Pext) { Dr = Pext; e = 5; }
            E(m, n) = (uint8_t)(bit16 * 16 + bit32 * 32
                                + ((Dr <= Msc) ? 1 : e));
            int32_t Dfin = D0 < Q ? Q : D0;
            diag = D_prev[n];
            D_prev[n] = Dfin;
            P_prev[n] = P;
            Qprev = Q;
            Dfin_next = Dfin;
        }
        D_prev[q_len] = D_boundary;
        if (k < 0 && best_score < D_prev[0]) {
            best_score = D_prev[0];
            best_m = m;
        }
    }

    int pos0 = 0, pos1 = 0;
    if (k < 0) {
        st.score = best_score;
        pos0 = best_m;
        if (k == -2) {
            for (int n = 0; n < q_len; n++) {
                if (st.score <= D_prev[n]) {
                    st.score = D_prev[n];
                    pos0 = 0;
                    pos1 = n;
                }
            }
            if (aligned) aligned->start = pos1;
        }
    } else {
        st.score = D_prev[0];
    }

    // traceback (nw.c:250-307)
    int m = pos0, n = pos1;
    int nuc_pos = m + t_s;
    bool emit = aligned != nullptr;
    while (E(m, n) != 0) {
        if (nuc_pos == template_length) nuc_pos = 0;
        int b = E(m, n);
        int op = b & 7;
        if (op == 1) {
            if (emit) {
                uint8_t tn = tmpl[nuc_pos];
                uint8_t qn = q[n];
                aligned->t.push_back(tn);
                aligned->q.push_back(qn);
                aligned->s.push_back(tn == qn ? '|' : '_');
            }
            st.match++;
            nuc_pos++; m++; n++;
        } else if (op >= 4) {
            while (!(E(m, n) >> 4)) {
                if (emit) {
                    aligned->t.push_back(tmpl[nuc_pos]);
                    aligned->q.push_back(5);
                    aligned->s.push_back('_');
                }
                nuc_pos++; m++;
                st.len++; st.qGaps++;
            }
            if (emit) {
                aligned->t.push_back(tmpl[nuc_pos]);
                aligned->q.push_back(5);
                aligned->s.push_back('_');
            }
            nuc_pos++; m++;
            st.qGaps++;
        } else {
            while (!(E(m, n) >> 3)) {
                if (emit) {
                    aligned->t.push_back(5);
                    aligned->q.push_back(q[n]);
                    aligned->s.push_back('_');
                }
                n++;
                st.len++; st.tGaps++;
            }
            if (emit) {
                aligned->t.push_back(5);
                aligned->q.push_back(q[n]);
                aligned->s.push_back('_');
            }
            n++;
            st.tGaps++;
        }
        st.len++;
    }
    if (emit) aligned->end = q_len - n;
}

// NW_band / NW_band_score (nw.c:310-640 / 892-1188)
static void nw_band(const uint8_t* tmpl, const uint8_t* query, int k,
                    int t_s, int t_e, int q_s, int q_e, int band,
                    const Penal& pen, int template_length, AlnStat& st,
                    Aligned* aligned, std::vector<uint8_t>& Ebuf,
                    std::vector<ll>& Dbuf) {
    const int W1 = pen.W1, U = pen.U, MM = pen.MM;
    int q_len = q_e - q_s;
    int t_len = t_e - t_s;
    if (t_len < 0) t_len += template_length;
    const uint8_t* q = query + q_s;
    if (aligned) { aligned->start = 0; aligned->end = 0; }
    st.score = 0; st.pos = 0; st.len = 0; st.match = 0;
    st.tGaps = 0; st.qGaps = 0;
    if (t_len == 0 || q_len == 0) {
        empty_case(st, t_len, q_len, W1, U, q, tmpl, t_e, template_length,
                   aligned);
        return;
    }
    if (band & 1) band++;
    int halfBand = band >> 1;
    int bq_len = band + 1;
    // scores fit i32 (the reference's own int rows, nw.c:310)
    int32_t neg = (int32_t)((t_len + q_len) * (MM + U + W1));
    Ebuf.assign((size_t)(t_len + 1) * (bq_len + 1), 0);
    auto E = [&](int m, int n) -> uint8_t& {
        return Ebuf[(size_t)m * (bq_len + 1) + n];
    };
    static thread_local std::vector<int32_t> D32b;
    D32b.assign(4 * (bq_len + 1), neg);
    int32_t* D_prev = D32b.data();
    int32_t* P_prev = D32b.data() + (bq_len + 1);
    int32_t* D_ptr = D32b.data() + 2 * (bq_len + 1);
    int32_t* P_ptr = D32b.data() + 3 * (bq_len + 1);

    int c_pos = (t_len + q_len) >> 1;
    int sn0 = q_len - 1 - (c_pos - halfBand);
    if (k != 2) {
        for (int n = 0; n < sn0; n++)
            D_prev[n] = W1 + (ll)(sn0 - n - 1) * U;
        for (int n = 0; n < sn0; n++) E(t_len, n) = 3;
        if (sn0 >= 1) E(t_len, sn0 - 1) = 18;
        E(t_len, sn0) = 0;
        D_prev[sn0] = 0;
        P_prev[sn0] = 0;
    } else {
        for (int n = 0; n <= sn0; n++) D_prev[n] = 0;
    }

    int pos0 = 0, pos1 = 0;
    int en = 0;
    ll best_score = neg;
    int nuc_pos = t_e - 1;
    int en_final = 0;
    for (int m = t_len - 1; m >= 0; m--) {
        if (nuc_pos < 0) nuc_pos = template_length - 1;
        int sq = c_pos + halfBand;
        int eq = c_pos - halfBand;
        if (eq < 0) { eq = 0; en++; } else en = 0;

        int sn;
        if (sq < q_len - 1) {
            sn = bq_len - 1;
            D_ptr[bq_len] = neg;
            E(m, bq_len) = 37;
        } else {
            sq = q_len - 1;
            sn = en + (q_len - eq);
            D_ptr[sn] = (0 < k) ? 0 : (W1 + (ll)(t_len - 1 - m) * U);
            E(m, sn) = (0 < k) ? 0 : 37;
            sn--;
        }

        const int* drow = pen.d[tmpl[nuc_pos]];
        int width = sn - en;
        int32_t q_en = neg;
        bool have_q_en = false;
        if (width > 0) {
            int32_t Qprev = neg;
            int32_t Dfin_next = D_ptr[sn + 1];
            for (int n = sn; n >= en + 1; n--) {
                int qpos = sq - (sn - n);
                int32_t Popen = D_prev[n - 1] + W1;
                int32_t Pext = P_prev[n - 1] + U;
                int32_t P = Popen < Pext ? Pext : Popen;
                int32_t Msc = D_prev[n] + drow[q[qpos]];
                int32_t D0 = P < Msc ? Msc : P;
                int32_t Qopen = Dfin_next + W1;
                int32_t Qext = Qprev + U;
                int32_t Q = Qopen < Qext ? Qext : Qopen;
                int e = (Qopen < Popen) ? 4 : 2;
                int32_t Dr = Qopen < Popen ? Popen : Qopen;
                int bit16 = !(Qopen < Qext);
                if (Qopen < Qext && Dr <= Qext) { Dr = Qext; e = 3; }
                int bit32 = !(Popen < Pext);
                if (Popen < Pext && Dr <= Pext) { Dr = Pext; e = 5; }
                E(m, n) = (uint8_t)(bit16 * 16 + bit32 * 32
                                    + ((Dr <= Msc) ? 1 : e));
                int32_t Dfin = D0 < Q ? Q : D0;
                D_ptr[n] = Dfin;
                P_ptr[n] = P;
                Qprev = Q;
                Dfin_next = Dfin;
            }
            q_en = Qprev;   // Q value at n = en+1
            have_q_en = true;
        }

        // boundary cell n = en (nw.c:513-539)
        {
            int n = en;
            int q_pos = sq - (sn - n);
            int Ebits = 0;
            int32_t Qb = D_ptr[n + 1] + W1;
            int32_t ext = (have_q_en ? q_en : neg) + U;
            int eb;
            if (Qb < ext) { Qb = ext; eb = 3; }
            else { eb = 2; Ebits |= 16; }
            P_ptr[n] = neg;
            int32_t Db = D_prev[n] + drow[q[q_pos]];
            if (Qb <= Db) Ebits |= 1;
            else { Db = Qb; Ebits |= eb; }
            D_ptr[n] = Db;
            E(m, n) = (uint8_t)Ebits;
            if (eq == 0 && k < 0 && best_score < Db) {
                best_score = Db;
                pos0 = m; pos1 = n;
            }
        }

        std::swap(D_prev, D_ptr);
        std::swap(P_prev, P_ptr);
        nuc_pos--;
        c_pos--;
        en_final = en;
    }

    int q_pos = 0;
    if (pos0 == 0) {
        pos1 = en_final;
        st.score = D_prev[en_final];
    } else {
        st.score = best_score;
    }
    if (k == -2) {
        for (int n = en_final; n < bq_len; n++) {
            if (st.score <= D_prev[n]) {
                st.score = D_prev[n];
                pos0 = 0;
                pos1 = n;
                q_pos = aligned ? (n - en_final) : n;
            }
        }
    }
    if (aligned) aligned->start = q_pos;

    // back tracking (nw.c:578-637)
    int m = pos0, n = pos1;
    nuc_pos = m + t_s;
    bool emit = aligned != nullptr;
    while (E(m, n) != 0) {
        if (nuc_pos == template_length) nuc_pos = 0;
        int op = E(m, n) & 7;
        if (op == 1) {
            if (emit) {
                uint8_t tn = tmpl[nuc_pos];
                uint8_t qn = q[q_pos];
                aligned->t.push_back(tn);
                aligned->q.push_back(qn);
                aligned->s.push_back(tn == qn ? '|' : '_');
            }
            st.match++;
            nuc_pos++; m++; q_pos++;
        } else if (op >= 4) {
            while (!(E(m, n) >> 4)) {
                if (emit) {
                    aligned->t.push_back(tmpl[nuc_pos]);
                    aligned->q.push_back(5);
                    aligned->s.push_back('_');
                }
                nuc_pos++; m++; n--;
                st.len++; st.qGaps++;
            }
            if (emit) {
                aligned->t.push_back(tmpl[nuc_pos]);
                aligned->q.push_back(5);
                aligned->s.push_back('_');
            }
            nuc_pos++; m++; n--;
            st.qGaps++;
        } else {
            while (!(E(m, n) >> 3)) {
                if (emit) {
                    aligned->t.push_back(5);
                    aligned->q.push_back(q[q_pos]);
                    aligned->s.push_back('_');
                }
                n++; q_pos++;
                st.len++; st.tGaps++;
            }
            if (emit) {
                aligned->t.push_back(5);
                aligned->q.push_back(q[q_pos]);
                aligned->s.push_back('_');
            }
            n++; q_pos++;
            st.tGaps++;
        }
        st.len++;
    }
    if (emit) aligned->end = q_len - q_pos;
}

// ------------------------------------------------------------- chain DP

static void mm_split(int gap, int k, int& Ms, int& MMs) {
    Ms = gap;
    if (Ms == 2) { Ms = 0; MMs = 2; return; }
    MMs = Ms / k + ((Ms % k) ? 1 : 0);
    if (MMs < 2) MMs = 2;
    Ms = std::min(Ms - MMs, k);
    Ms = std::min(Ms, MMs);
}

// chainSeeds / chainSeeds_circular (chain.c:79-494)
static void chain_seeds(Points& pts, int q_len, int t_len, int kmersize,
                        const Penal& pen, bool circular, int& bestPosOut,
                        int& mapQOut) {
    const int W1 = pen.W1, U = pen.U, M = pen.M, MM = pen.MM;
    int nMems = pts.len;
    pts.score.assign(nMems + 1, 0);
    pts.next.assign(nMems + 1, 0);
    int bestPos = nMems - 1;
    ll bestScore = 0, secondScore = 0;

    for (int i = nMems - 1; i >= 0; i--) {
        ll weight = (ll)pts.weight[i] * M;
        pts.next[i] = 0;
        int tEnd = pts.tEnd[i];
        int qEnd = pts.qEnd[i];

        // stop score (chain.c:104-129)
        int gap = std::min(t_len - tEnd, q_len - qEnd);
        int Msv = gap;
        gap -= 1;
        ll gcost = gap ? ((ll)gap * U + W1) : W1;
        int m_, mm_;
        mm_split(Msv, kmersize, m_, mm_);
        ll Msc = (ll)m_ * M + (ll)mm_ * MM;
        ll score = weight + (Msc < gcost ? gcost : Msc);

        int nMin = std::min(nMems, i + 128);
        for (int j = i + 1; j < nMin; j++) {
            if (qEnd < pts.qStart[j]) {
                int tStart_j = pts.tStart[j];
                if (tEnd < tStart_j) {                 // full compatibility
                    int tGap = tStart_j - tEnd;
                    int qGap = pts.qStart[j] - qEnd;
                    int gv = std::abs(tGap - qGap);
                    ll g = gv ? ((ll)(gv - 1) * U + W1) : 0;
                    mm_split(std::min(tGap, qGap), kmersize, m_, mm_);
                    g += weight + pts.score[j] + (ll)m_ * M + (ll)mm_ * MM;
                    if (score <= g) { score = g; pts.next[i] = j; }
                } else if (kmersize <= pts.tEnd[j] - tEnd) {  // semi compat
                    int gv = pts.qStart[j] - qEnd;
                    ll g = gv ? ((ll)(gv - 1) * U + W1) : 0;
                    int cut = tStart_j - tEnd;
                    g += weight + pts.score[j] - (ll)cut * M;
                    if (score < g) { score = g; pts.next[i] = j; }
                } else if (circular && pts.tEnd[j] < pts.tStart[i]) {
                    // circular joining (chain.c:366-395)
                    int tGap = t_len - tEnd + tStart_j;
                    int qGap = pts.qStart[j] - qEnd;
                    int gv = std::abs(tGap - qGap);
                    ll g = gv ? ((ll)(gv - 1) * U + W1) : 0;
                    mm_split(std::min(tGap, qGap), kmersize, m_, mm_);
                    g += weight + pts.score[j] + (ll)m_ * M + (ll)mm_ * MM;
                    if (score < g) { score = g; pts.next[i] = j; }
                }
            } else if (kmersize <= pts.qEnd[j] - qEnd) {
                int tStart = pts.tStart[j] + qEnd - pts.qStart[j];
                if (tEnd < tStart) {
                    int gv = tStart - tEnd;
                    ll g = gv ? ((ll)(gv - 1) * U + W1) : 0;
                    g += weight + pts.score[j] - (ll)(tStart - tEnd) * M;
                    if (circular) {
                        if (score <= g) { score = g; pts.next[i] = j; }
                    } else {
                        if (score < g) { score = g; pts.next[i] = j; }
                    }
                } else if (circular) {
                    if (t_len < tStart) tStart -= t_len;
                    if (tStart != tEnd && pts.tEnd[j] < tStart) {
                        int tGap = t_len - tEnd + tStart;
                        ll g = tGap ? ((ll)(tGap - 1) * U + W1) : 0;
                        g += weight + pts.score[j] - (ll)(tEnd - tStart) * M;
                        if (score < g) { score = g; pts.next[i] = j; }
                    }
                }
            }
        }

        // update seed weight (chain.c:206-212)
        if (pts.next[i])
            pts.weight[i] += pts.weight[pts.next[i]] - kmersize + 1;
        else
            pts.weight[i] -= kmersize - 1;
        pts.score[i] = score;

        // penalize start (chain.c:214-241)
        gap = std::min(pts.tStart[i], pts.qStart[i]);
        Msv = gap;
        gap -= 1;
        if (0 < gap) gcost = (ll)gap * U + W1;
        else if (gap == 0) gcost = W1;
        else gcost = 0;
        mm_split(Msv, kmersize, m_, mm_);
        Msc = (ll)m_ * M + (ll)mm_ * MM;
        score += (Msc < gcost ? gcost : Msc);

        if (bestScore <= score) {
            if (pts.next[i] != bestPos) secondScore = bestScore;
            bestScore = score;
            bestPos = i;
        } else if (secondScore <= score && pts.next[i] != bestPos) {
            secondScore = bestScore;
        }
    }

    int mapQ = 0;
    if (0 < bestScore) {
        double w = pts.weight[bestPos] / 10.0;
        if (w > 1.0) w = 1.0;
        mapQ = (int)std::ceil(40.0 * (1.0 - (double)secondScore / bestScore)
                              * w * std::log((double)bestScore));
    }
    pts.score[bestPos] = bestScore;
    bestPosOut = bestPos;
    mapQOut = mapQ;
}

// trimSeeds / trimSeedsNoLead (chain.c:496-566)
static void trim_seeds(Points& pts, int start, int ts, bool no_lead) {
    if (!ts) return;
    if (no_lead || !pts.qStart[start]) {
        start = pts.next[start];
        while (start) {
            int ln = pts.qEnd[start] - pts.qStart[start];
            if (ln < ts) {
                ln -= 1;
                pts.tStart[start] += ln;
                pts.qStart[start] += ln;
            } else {
                pts.tStart[start] += ts;
                pts.qStart[start] += ts;
            }
            start = pts.next[start];
        }
    } else {
        for (;;) {
            int ln = pts.qEnd[start] - pts.qStart[start];
            if (ln < ts) {
                ln -= 1;
                pts.tStart[start] += ln;
                pts.qStart[start] += ln;
            } else {
                pts.tStart[start] += ts;
                pts.qStart[start] += ts;
            }
            start = pts.next[start];
            if (!start) break;
        }
    }
}

// ---------------------------------------------------------- seed collect

// rolling k-mer at position j of a byte array (N counted as 0)
static inline uint64_t kmer_at(const uint8_t* s, int j, int k,
                               uint64_t mask) {
    uint64_t key = 0;
    for (int i = 0; i < k; i++) {
        uint8_t c = s[j + i];
        key = (key << 2) | (c > 3 ? 0 : c);
    }
    return key & mask;
}

// KMA_score seed scan over compressed k-mer windows (align.c:529-639)
static void collect_seeds_comp(const TIndex& T, const uint8_t* qseq,
                               const int32_t* n_pos, int n_n, int q_len,
                               int q_start, int q_end, Points& pts) {
    int k = T.k;
    int t_len = T.len;
    const uint8_t* tc = T.codes.data();
    uint64_t mask = (k < 32) ? ((uint64_t(1) << (2 * k)) - 1) : ~uint64_t(0);
    int km_end = q_len - k + 1;   // kmer_scan length

    int j = q_start;
    for (int si = 0; si <= n_n; si++) {
        int seg_end = (si < n_n) ? n_pos[si] : q_len;
        int end = (si != n_n) ? (seg_end - k + 1) : (q_end - k + 1);
        uint64_t key = 0;
        int kj = INT_MIN;   // position `key` is valid for
        while (j < end) {
            if (j >= 0 && j < km_end) {
                if (kj == j - 1) {
                    uint8_t c = qseq[j + k - 1];
                    key = ((key << 2) | (c > 3 ? 0 : c)) & mask;
                } else {
                    key = kmer_at(qseq, j, k, mask);
                }
            } else {
                key = 0;
            }
            kj = j;
            // single probe serves both the unique and duplicated case
            int upos = 0;
            const int32_t* plist = nullptr;
            int pn = T.find2(key, &upos, &plist);
            int value = pn == 0 ? 0 : (pn == 1 ? upos : -plist[0]);
            if (value == 0) {
                j++;
            } else if (0 < value) {
                int prev = value - 2;
                int kk = j - 1;
                while (0 <= kk && 0 <= prev && qseq[kk] == tc[prev]) {
                    kk--; prev--;
                }
                pts.add(kk + 1, 0, prev + 2, 0, 0);
                value += k - 1;
                j += k;
                int ext_end = end + (k - 1);
                {
                    int nmax = ext_end - j;
                    if (t_len - value < nmax) nmax = t_len - value;
                    if (nmax > 0) {
                        int adv = ext_match_fwd(qseq + j, tc + value, nmax);
                        j += adv;
                        value += adv;
                    }
                }
                size_t idx = pts.n() - 1;
                pts.qEnd[idx] = j;
                pts.tEnd[idx] = value + 1;
                pts.weight[idx] = j - pts.qStart[idx];
            } else {
                int bias = j;
                for (int pi = 0; pi < pn; pi++) {
                    int value2 = plist[pi];
                    int llp = j;
                    int prev = value2 - 2;
                    int kk = llp - 1;
                    while (0 <= kk && 0 <= prev && qseq[kk] == tc[prev]) {
                        kk--; prev--;
                    }
                    pts.add(kk + 1, 0, prev + 2, 0, 0);
                    value2 += k - 1;
                    llp += k;
                    int ext_end = end + (k - 1);
                    {
                        int nmax = ext_end - llp;
                        if (t_len - value2 < nmax) nmax = t_len - value2;
                        if (nmax > 0) {
                            int adv = ext_match_fwd(qseq + llp,
                                                    tc + value2, nmax);
                            llp += adv;
                            value2 += adv;
                        }
                    }
                    size_t idx = pts.n() - 1;
                    pts.qEnd[idx] = llp;
                    pts.tEnd[idx] = value2 + 1;
                    pts.weight[idx] = llp - pts.qStart[idx];
                    if (bias < llp) bias = llp;
                }
                j = bias + 1;
            }
        }
        j = seg_end + 1;
    }
}

// score-only NW / NW_band (identical DP numeric path as nw_full /
// nw_band, no E matrix and no traceback): the exact-score pre-pass of
// the step-3 candidate scorer — candidates whose exact score proves
// they cannot be selected never pay the stats pass
static ll nw_full_score(const uint8_t* tmpl, const uint8_t* query, int k,
                        int t_s, int t_e, int q_s, int q_e,
                        const Penal& pen, int template_length) {
    const int W1 = pen.W1, U = pen.U, MM = pen.MM;
    int q_len = q_e - q_s;
    int t_len = t_e - t_s;
    if (t_len < 0) t_len += template_length;
    const uint8_t* q = query + q_s;
    if (t_len == 0 || q_len == 0) {
        if (t_len == q_len)
            return 0;
        int g = t_len ? t_len : q_len;
        return (ll)W1 + (ll)(g - 1) * U;
    }
    int32_t neg = (int32_t)((t_len + q_len) * (MM + U + W1));
    static thread_local std::vector<int32_t> D32;
    D32.assign(2 * (q_len + 1), neg);
    int32_t* D_prev = D32.data();
    int32_t* P_prev = D32.data() + q_len + 1;
    if (0 < k) {
        if (k == 1) {
            for (int n = 0; n < q_len; n++)
                D_prev[n] = W1 + (ll)(q_len - 1 - n) * U;
            D_prev[q_len] = 0;
            P_prev[q_len] = 0;
        } else {
            for (int n = 0; n <= q_len; n++)
                D_prev[n] = 0;
        }
    } else {
        for (int n = 0; n < q_len; n++)
            D_prev[n] = W1 + (ll)(q_len - 1 - n) * U;
        D_prev[q_len] = 0;
        P_prev[q_len] = 0;
    }
    ll best_score = neg;
    for (int m = t_len - 1; m >= 0; m--) {
        int32_t D_boundary =
            (0 < k) ? 0 : (int32_t)(W1 + (ll)(t_len - 1 - m) * U);
        int nuc_pos = (t_e - 1 - (t_len - 1 - m)) % template_length;
        if (nuc_pos < 0) nuc_pos += template_length;
        const int* drow = pen.d[tmpl[nuc_pos]];
        int32_t Qprev = neg;
        int32_t Dfin_next = D_boundary;
        int32_t diag = D_prev[q_len];
        for (int n = q_len - 1; n >= 0; n--) {
            int32_t Popen = D_prev[n] + W1;
            int32_t Pext = P_prev[n] + U;
            int32_t P = Popen < Pext ? Pext : Popen;
            int32_t Msc = diag + drow[q[n]];
            int32_t D0 = P < Msc ? Msc : P;
            int32_t Qopen = Dfin_next + W1;
            int32_t Qext = Qprev + U;
            int32_t Q = Qopen < Qext ? Qext : Qopen;
            int32_t Dfin = D0 < Q ? Q : D0;
            diag = D_prev[n];
            D_prev[n] = Dfin;
            P_prev[n] = P;
            Qprev = Q;
            Dfin_next = Dfin;
        }
        D_prev[q_len] = D_boundary;
        if (k < 0 && best_score < D_prev[0])
            best_score = D_prev[0];
    }
    if (k < 0) {
        ll sc = best_score;
        if (k == -2)
            for (int n = 0; n < q_len; n++)
                if (sc <= D_prev[n])
                    sc = D_prev[n];
        return sc;
    }
    return D_prev[0];
}

static ll nw_band_score(const uint8_t* tmpl, const uint8_t* query, int k,
                        int t_s, int t_e, int q_s, int q_e, int band,
                        const Penal& pen, int template_length) {
    const int W1 = pen.W1, U = pen.U, MM = pen.MM;
    int q_len = q_e - q_s;
    int t_len = t_e - t_s;
    if (t_len < 0) t_len += template_length;
    const uint8_t* q = query + q_s;
    if (t_len == 0 || q_len == 0) {
        if (t_len == q_len)
            return 0;
        int g = t_len ? t_len : q_len;
        return (ll)W1 + (ll)(g - 1) * U;
    }
    if (band & 1) band++;
    int halfBand = band >> 1;
    int bq_len = band + 1;
    int32_t neg = (int32_t)((t_len + q_len) * (MM + U + W1));
    static thread_local std::vector<int32_t> D32b;
    D32b.assign(4 * (bq_len + 1), neg);
    int32_t* D_prev = D32b.data();
    int32_t* P_prev = D32b.data() + (bq_len + 1);
    int32_t* D_ptr = D32b.data() + 2 * (bq_len + 1);
    int32_t* P_ptr = D32b.data() + 3 * (bq_len + 1);

    int c_pos = (t_len + q_len) >> 1;
    int sn0 = q_len - 1 - (c_pos - halfBand);
    if (k != 2) {
        for (int n = 0; n < sn0; n++)
            D_prev[n] = W1 + (ll)(sn0 - n - 1) * U;
        D_prev[sn0] = 0;
        P_prev[sn0] = 0;
    } else {
        for (int n = 0; n <= sn0; n++)
            D_prev[n] = 0;
    }

    int en = 0;
    ll best_score = neg;
    int nuc_pos = t_e - 1;
    int en_final = 0;
    for (int m = t_len - 1; m >= 0; m--) {
        if (nuc_pos < 0) nuc_pos = template_length - 1;
        int sq = c_pos + halfBand;
        int eq = c_pos - halfBand;
        if (eq < 0) { eq = 0; en++; } else en = 0;

        int sn;
        if (sq < q_len - 1) {
            sn = bq_len - 1;
            D_ptr[bq_len] = neg;
        } else {
            sq = q_len - 1;
            sn = en + (q_len - eq);
            D_ptr[sn] = (0 < k) ? 0 : (W1 + (ll)(t_len - 1 - m) * U);
            sn--;
        }

        const int* drow = pen.d[tmpl[nuc_pos]];
        int width = sn - en;
        int32_t q_en = neg;
        bool have_q_en = false;
        if (width > 0) {
            int32_t Qprev = neg;
            int32_t Dfin_next = D_ptr[sn + 1];
            for (int n = sn; n >= en + 1; n--) {
                int qpos = sq - (sn - n);
                int32_t Popen = D_prev[n - 1] + W1;
                int32_t Pext = P_prev[n - 1] + U;
                int32_t P = Popen < Pext ? Pext : Popen;
                int32_t Msc = D_prev[n] + drow[q[qpos]];
                int32_t D0 = P < Msc ? Msc : P;
                int32_t Qopen = Dfin_next + W1;
                int32_t Qext = Qprev + U;
                int32_t Q = Qopen < Qext ? Qext : Qopen;
                int32_t Dfin = D0 < Q ? Q : D0;
                D_ptr[n] = Dfin;
                P_ptr[n] = P;
                Qprev = Q;
                Dfin_next = Dfin;
            }
            q_en = Qprev;
            have_q_en = true;
        }
        {
            int n = en;
            int q_pos = sq - (sn - n);
            int32_t Qb = D_ptr[n + 1] + W1;
            int32_t ext = (have_q_en ? q_en : neg) + U;
            if (Qb < ext)
                Qb = ext;
            P_ptr[n] = neg;
            int32_t Db = D_prev[n] + drow[q[q_pos]];
            if (Qb > Db)
                Db = Qb;
            D_ptr[n] = Db;
            if (eq == 0 && k < 0 && best_score < Db)
                best_score = Db;
        }
        std::swap(D_prev, D_ptr);
        std::swap(P_prev, P_ptr);
        nuc_pos--;
        c_pos--;
        en_final = en;
    }
    ll sc;
    if (k >= 0 || best_score == neg) {
        // pos0 == 0 path of nw_band: the final row's edge cell
        sc = D_prev[en_final];
        if (k < 0 && best_score > sc)
            sc = best_score;
    } else {
        sc = best_score;
    }
    if (k == -2)
        for (int n = en_final; n < bq_len; n++)
            if (sc <= D_prev[n])
                sc = D_prev[n];
    return sc;
}

// KMA seeding over byte codes (align.c:244-377)
static void collect_seeds_bytes(const TIndex& T, const uint8_t* qseq,
                                int q_len, int q_start, int q_end,
                                Points& pts, int lo, int hi) {
    int k = T.k;
    int t_len = T.len;
    const uint8_t* tc = T.codes.data();
    uint64_t mask = (k < 32) ? ((uint64_t(1) << (2 * k)) - 1) : ~uint64_t(0);

    int i = q_start;
    while (i < q_end) {
        // charpos(qseq, 4, i, q_len); miss -> q_end
        int end = q_end;
        for (int x = i; x < q_len; x++) {
            if (qseq[x] == 4) { end = x; break; }
        }
        uint64_t key = 0;
        if (i < end - k) {
            for (int b = i; b < i + k - 1; b++)
                key = (key << 2) | qseq[b];
            i += k - 1;
        } else {
            i = end + 1;
            continue;
        }
        while (i < end) {
            key = ((key << 2) | qseq[i]) & mask;
            int value = T.get_bound(key, lo, hi);
            if (value == 0) {
                i++;
            } else if (0 < value) {
                i -= k - 1;
                int prev = value - 2;
                int jj = i - 1;
                while (0 <= jj && 0 <= prev && qseq[jj] == tc[prev]) {
                    jj--; prev--;
                }
                pts.add(jj + 1, 0, prev + 2, 0, 0);
                value += k - 1;
                i += k;
                while (i < end && value < t_len && qseq[i] == tc[value]) {
                    i++; value++;
                }
                size_t idx = pts.n() - 1;
                pts.qEnd[idx] = i;
                pts.tEnd[idx] = value + 1;
                pts.weight[idx] = i - pts.qStart[idx];
                if (i < end - k) {
                    key = 0;
                    for (int b = i; b < i + k - 1; b++)
                        key = (key << 2) | qseq[b];
                    i += k - 1;
                } else {
                    i = end + 1;
                }
            } else {
                i -= k - 1;
                int bias = i;
                int upos2 = 0;
                const int32_t* plist2 = nullptr;
                int pn2 = T.find2(key & mask, &upos2, &plist2);
                if (pn2 == 1)
                    plist2 = &upos2;
                for (int pi = 0; pi < pn2; pi++) {
                    int value2 = plist2[pi];
                    int kk = i;
                    int prev = value2 - 2;
                    int jj = kk - 1;
                    while (0 <= jj && 0 <= prev && qseq[jj] == tc[prev]) {
                        jj--; prev--;
                    }
                    pts.add(jj + 1, 0, prev + 2, 0, 0);
                    value2 += k - 1;
                    kk += k;
                    while (kk < end && value2 < t_len
                           && qseq[kk] == tc[value2]) {
                        kk++; value2++;
                    }
                    size_t idx = pts.n() - 1;
                    pts.qEnd[idx] = kk;
                    pts.tEnd[idx] = value2 + 1;
                    pts.weight[idx] = kk - pts.qStart[idx];
                    if (bias < kk) bias = kk;
                }
                i = bias + 1;
                if (i < end - k) {
                    key = 0;
                    for (int b = i; b < i + k - 1; b++)
                        key = (key << 2) | qseq[b];
                    i += k - 1;
                } else {
                    i = end + 1;
                }
            }
        }
        i = end + 1;
    }
}

// ------------------------------------------------------------ tails + KMA

static const int BANDWIDTH = 64;   // align.c:216

// leadTailAln / skipLeadAln (align.c:34-131)
static void lead_tail_aln(Aligned* aligned, const TIndex& T,
                          const uint8_t* qseq, int t_e, int t_len, int q_e,
                          const Penal& pen, bool skip, AlnStat& st,
                          std::vector<uint8_t>& Ebuf, std::vector<ll>& Dbuf) {
    st.score = 0; st.pos = t_e; st.len = 0; st.match = 0;
    st.tGaps = 0; st.qGaps = 0; st.mapQ = 0;
    if (skip) {
        if (aligned) aligned->start = q_e;
        return;
    }
    if (!q_e) return;
    int t_s = 0, q_s = 0;
    int bw = BANDWIDTH;
    if ((q_e << 1) < t_e || (q_e + bw) < t_e)
        t_s = t_e - (q_e + (q_e < bw ? q_e : bw));
    else if ((t_e << 1) < q_e || (t_e + bw) < q_e)
        q_s = q_e - (t_e + (t_e < bw ? t_e : bw));

    if (t_e - t_s > 0 && q_e - q_s > 0) {
        int band = std::abs(t_e - t_s - q_e + q_s) + bw;
        Aligned frag_store;
        Aligned* frag = nullptr;
        if (aligned) { frag_store.pos = t_len; frag = &frag_store; }
        int k = -1 - (t_s == 0 ? 1 : 0);
        AlnStat nw;
        if (q_e - q_s <= band || t_e - t_s <= band) {
            if (aln_prof_on())
                g_p_tfull_cells += (ll)(q_e - q_s) * (t_e - t_s);
            nw_full(T.codes.data(), qseq, k, t_s, t_e, q_s, q_e, pen,
                    t_len, nw, frag, Ebuf, Dbuf);
        } else {
            if (aln_prof_on())
                g_p_tband_cells += (ll)(t_e - t_s) * (band + 1);
            nw_band(T.codes.data(), qseq, k, t_s, t_e, q_s, q_e, band, pen,
                    t_len, nw, frag, Ebuf, Dbuf);
        }
        if (frag) {
            int bias = 0;
            if (t_s == 0) {
                while (bias < nw.len && (frag->t[bias] == 5
                                         || frag->q[bias] == 5)) {
                    if (frag->t[bias] == 5) { nw.tGaps--; frag->start++; }
                    else nw.qGaps--;
                    bias++;
                }
                nw.len -= bias;
            }
            aligned->t.assign(frag->t.begin() + bias,
                              frag->t.begin() + bias + nw.len);
            aligned->s.assign(frag->s.begin() + bias,
                              frag->s.begin() + bias + nw.len);
            aligned->q.assign(frag->q.begin() + bias,
                              frag->q.begin() + bias + nw.len);
            aligned->start = q_s + frag->start;
        }
        st.pos -= (nw.len - nw.tGaps);
        st.score = nw.score;
        st.len = nw.len;
        st.match = nw.match;
        st.tGaps = nw.tGaps;
        st.qGaps = nw.qGaps;
    } else if (aligned) {
        aligned->start = q_s;
    }
}

// trailTailAln / skipTrailAln (align.c:133-212)
static void trail_tail_aln(Aligned* aligned, AlnStat& st, const TIndex& T,
                           const uint8_t* qseq, int t_s, int t_len, int q_s,
                           int q_len, const Penal& pen, bool skip,
                           std::vector<uint8_t>& Ebuf, std::vector<ll>& Dbuf) {
    if (skip) {
        if (aligned) aligned->end = q_len - q_s;
        return;
    }
    int q_e = q_len;
    int t_e = t_len;
    int bw = BANDWIDTH;
    if (((q_len - q_s) << 1) < (t_len - t_s)
        || (q_len - q_s + bw) < (t_len - t_s)) {
        int te = q_len - q_s;
        t_e = t_s + (te + (te < bw ? te : bw));
    } else if (((t_len - t_s) << 1) < (q_len - q_s)
               || (t_len - t_s + bw) < (q_len - q_s)) {
        int qe = t_len - t_s;
        q_e = q_s + (qe + (qe < bw ? qe : bw));
    }

    int frag_end = 0;
    if (t_e - t_s > 0 && q_e - q_s > 0) {
        int band = std::abs(t_e - t_s - q_e + q_s) + bw;
        Aligned frag_store;
        Aligned* frag = nullptr;
        if (aligned) { frag_store.pos = t_len; frag = &frag_store; }
        int k = 1 + (t_e == t_len ? 1 : 0);
        AlnStat nw;
        if (q_e - q_s <= band || t_e - t_s <= band) {
            if (aln_prof_on())
                g_p_tfull_cells += (ll)(q_e - q_s) * (t_e - t_s);
            nw_full(T.codes.data(), qseq, k, t_s, t_e, q_s, q_e, pen,
                    t_len, nw, frag, Ebuf, Dbuf);
        } else {
            if (aln_prof_on())
                g_p_tband_cells += (ll)(t_e - t_s) * (band + 1);
            nw_band(T.codes.data(), qseq, k, t_s, t_e, q_s, q_e, band, pen,
                    t_len, nw, frag, Ebuf, Dbuf);
        }
        if (frag) {
            if (t_e == t_len) {
                int bias = nw.len - 1;
                while (bias && (frag->t[bias] == 5 || frag->q[bias] == 5)) {
                    if (frag->t[bias] == 5) { nw.tGaps--; frag->end++; }
                    else nw.qGaps--;
                    bias--;
                }
                bias++;
                if (bias != nw.len) nw.len = bias;
            }
            aligned->t.insert(aligned->t.end(), frag->t.begin(),
                              frag->t.begin() + nw.len);
            aligned->s.insert(aligned->s.end(), frag->s.begin(),
                              frag->s.begin() + nw.len);
            aligned->q.insert(aligned->q.end(), frag->q.begin(),
                              frag->q.begin() + nw.len);
            frag_end = frag->end;
        }
        st.score += nw.score;
        st.len += nw.len;
        st.match += nw.match;
        st.tGaps += nw.tGaps;
        st.qGaps += nw.qGaps;
    }
    if (aligned) aligned->end = q_len - q_e + frag_end;
}

// ---------------------------------------------------------------- preseed

static int g_preseed_exhaustive = 0;

extern "C" void kaln_set_exhaustive(int v) { g_preseed_exhaustive = v; }

// preseed (align.c:750-770)
static int preseed(const TIndex& T, const uint8_t* qseq, int qseq_len,
                   int q_len) {
    if (g_preseed_exhaustive) return 0;
    int k = T.k;
    int i = 0;
    while (i < q_len) {
        uint64_t key = 0;
        bool ok = true;
        for (int b = i; b < i + k; b++) {
            if (b >= qseq_len) break;
            if (qseq[b] > 3) { ok = false; break; }
            key = (key << 2) | qseq[b];
        }
        if (ok && qseq_len - i >= k && T.get_bound(key, 0, T.len))
            return 0;
        i += k;
    }
    return i;
}

// ------------------------------------------------------------- kma_align

static Aligned g_aligned;   // last traceback result (single-threaded)

// KMA() / KMA_score core (align.c:214-507 / 509-748).  pts/Ebuf/Dbuf are
// supplied by the caller so batch workers can run concurrently;
// use_points != 0 reuses the seeds left in pts by a preceding anker_rc.
static int kaln_align_impl(TIndex& T, const uint8_t* qseq, int q_len,
                           int q_start, int q_end, int lo, int hi, int mq,
                           const Penal& pen,
                           const int32_t* n_positions, int n_n,
                           int traceback, int use_points,
                           int circular, int ts, int skip_tails,
                           Points& pts, std::vector<uint8_t>& Ebuf,
                           std::vector<ll>& Dbuf, Aligned* aligned,
                           AlnStat* out) {
    int t_len = T.len;
    if (traceback) {
        aligned->t.clear(); aligned->s.clear(); aligned->q.clear();
        aligned->pos = t_len;
        aligned->start = 0; aligned->end = 0;
        if (lo < hi) { lo = 0; hi = t_len; }   // align.c:237-240
    } else {
        aligned = nullptr;
    }

    const bool prof = aln_prof_on();
    double pt0 = prof ? prof_now() : 0.0;
    if (!use_points) {
        pts.clear_all();
        if (traceback)
            collect_seeds_bytes(T, qseq, q_len, q_start, q_end, pts, lo, hi);
        else
            collect_seeds_comp(T, qseq, n_positions, n_n, q_len, q_start,
                               q_end, pts);
        pts.len = (int)pts.n();
    }
    if (prof) {
        double t1 = prof_now();
        g_p_collect += (ll)((t1 - pt0) * 1e9);
        g_p_calls += 1;
        g_p_seeds += pts.len;
        pt0 = t1;
    }

    out->score = 0; out->pos = 0; out->len = 1; out->match = 0;
    out->tGaps = 0; out->qGaps = 0; out->mapQ = 0;
    if (!pts.len) {
        out->len = 1;
        pts.len = 0;
        return 0;
    }

    int start, mapQ;
    chain_seeds(pts, q_len, t_len, T.k, pen, circular != 0, start, mapQ);
    if (prof) {
        double t1 = prof_now();
        g_p_chain += (ll)((t1 - pt0) * 1e9);
        pt0 = t1;
    }
    out->mapQ = mapQ;
    ll score = pts.score[start];
    if (mapQ < mq || score < T.k) {
        out->len = 1;
        pts.len = 0;
        return 0;
    }

    trim_seeds(pts, start, ts, false);

    AlnStat st;
    lead_tail_aln(aligned, T, qseq, pts.tStart[start] - 1, t_len,
                  pts.qStart[start], pen, skip_tails != 0, st, Ebuf, Dbuf);
    if (prof) {
        double t1 = prof_now();
        g_p_tails += (ll)((t1 - pt0) * 1e9);
        pt0 = t1;
    }

    for (;;) {
        int q_s = pts.qStart[start];
        int seg = pts.qEnd[start] - q_s;
        if (traceback) {
            for (int x = q_s; x < pts.qEnd[start]; x++) {
                uint8_t c = qseq[x];
                aligned->t.push_back(c);
                aligned->s.push_back('|');
                aligned->q.push_back(c);
            }
        }
        st.len += seg;
        st.match += seg;
        for (int x = q_s; x < pts.qEnd[start]; x++) {
            uint8_t nuc = qseq[x];
            st.score += pen.d[nuc][nuc];
        }

        if (pts.next[start]) {
            q_s = pts.qEnd[start];
            int t_sv = pts.tEnd[start] - 1;
            start = pts.next[start];
            if (pts.qStart[start] < q_s) {
                pts.tStart[start] += q_s - pts.qStart[start];
                pts.qStart[start] = q_s;
            }
            int t_ev = pts.tStart[start] - 1;
            int t_l;
            if (t_ev < t_sv) {
                if (t_sv <= pts.tEnd[start]) {
                    pts.qStart[start] += t_sv - t_ev;
                    t_ev = t_sv;
                    t_l = 0;
                } else {
                    t_l = t_len - t_sv + t_ev;
                }
            } else {
                t_l = t_ev - t_sv;
            }
            int q_ev = pts.qStart[start];

            if ((ll)std::abs(t_l - q_ev + q_s) * pen.U > (ll)q_len * pen.M
                || t_l > q_len || q_ev - q_s > (q_len >> 1)) {
                out->score = 0; out->pos = 0; out->len = 1; out->match = 0;
                out->tGaps = 0; out->qGaps = 0; out->mapQ = mapQ;
                if (traceback) {
                    aligned->t.clear(); aligned->s.clear();
                    aligned->q.clear();
                }
                pts.len = 0;
                return 0;
            }
            if (t_l > 0 || q_ev - q_s > 0) {
                if (prof) pt0 = prof_now();
                int band = std::abs(t_l - q_ev + q_s) + BANDWIDTH;
                Aligned frag_store;
                Aligned* frag = nullptr;
                if (traceback) { frag_store.pos = t_len; frag = &frag_store; }
                AlnStat nw;
                if (q_ev - q_s <= band || t_l <= band)
                    nw_full(T.codes.data(), qseq, 0, t_sv, t_ev, q_s, q_ev,
                            pen, t_len, nw, frag, Ebuf, Dbuf);
                else
                    nw_band(T.codes.data(), qseq, 0, t_sv, t_ev, q_s, q_ev,
                            band, pen, t_len, nw, frag, Ebuf, Dbuf);
                if (traceback) {
                    aligned->t.insert(aligned->t.end(), frag->t.begin(),
                                      frag->t.begin() + nw.len);
                    aligned->s.insert(aligned->s.end(), frag->s.begin(),
                                      frag->s.begin() + nw.len);
                    aligned->q.insert(aligned->q.end(), frag->q.begin(),
                                      frag->q.begin() + nw.len);
                }
                st.score += nw.score;
                st.len += nw.len;
                st.match += nw.match;
                st.tGaps += nw.tGaps;
                st.qGaps += nw.qGaps;
                if (prof) {
                    g_p_nw += (ll)((prof_now() - pt0) * 1e9);
                    g_p_nwcells += (ll)(q_ev - q_s)
                        * (t_l <= band ? t_l : band);
                }
            }
        } else {
            break;
        }
    }

    if (prof) pt0 = prof_now();
    trail_tail_aln(aligned, st, T, qseq, pts.tEnd[start] - 1, t_len,
                   pts.qEnd[start], q_len, pen, skip_tails != 0, Ebuf, Dbuf);
    if (prof) g_p_tails += (ll)((prof_now() - pt0) * 1e9);
    pts.len = 0;
    *out = st;
    out->mapQ = mapQ;
    return 1;
}

extern "C" int kaln_align(void* h, const uint8_t* qseq, int q_len,
                          int q_start, int q_end, int lo, int hi, int mq,
                          int M, int MM, int U, int W1,
                          const int32_t* dmat,
                          const int32_t* n_positions, int n_n,
                          int traceback, int use_points,
                          int circular, int ts, int skip_tails,
                          AlnStat* out) {
    Penal pen;
    pen.M = M; pen.MM = MM; pen.U = U; pen.W1 = W1;
    for (int a = 0; a < 5; a++)
        for (int b = 0; b < 5; b++)
            pen.d[a][b] = dmat[a * 5 + b];
    static std::vector<uint8_t> Ebuf;
    static std::vector<ll> Dbuf;
    return kaln_align_impl(*(TIndex*)h, qseq, q_len, q_start, q_end, lo, hi,
                           mq, pen, n_positions, n_n, traceback, use_points,
                           circular, ts, skip_tails, g_points, Ebuf, Dbuf,
                           traceback ? &g_aligned : nullptr, out);
}

// fetch the traceback strings of the last kaln_align(traceback=1)
extern "C" int kaln_aligned_len(void) { return (int)g_aligned.t.size(); }
extern "C" void kaln_aligned_fetch(uint8_t* t, uint8_t* s, uint8_t* q,
                                   int32_t* start_end) {
    size_t n = g_aligned.t.size();
    memcpy(t, g_aligned.t.data(), n);
    memcpy(s, g_aligned.s.data(), n);
    memcpy(q, g_aligned.q.data(), n);
    start_end[0] = g_aligned.start;
    start_end[1] = g_aligned.end;
}

// ------------------------------------------------------------- anker_rc

// anker_rc_comp (align.c:993-1176); returns +score fw, -score rc, 0 none.
// Fills pts with the winner's seeds (consumed by kaln_align_impl with
// use_points=1); *n_points_out reports the seed count.
static int anker_rc_comp_impl(TIndex& T, const uint8_t* qseq,
                              const uint8_t* qseq_r,
                              const int32_t* n_pos_f, int n_f,
                              const int32_t* n_pos_r, int n_r,
                              int q_len, int q_start, int q_end,
                              int one2one, int* n_points_out, Points& pts) {
    int k = T.k;
    int t_len = T.len;
    const uint8_t* tc = T.codes.data();
    uint64_t mask = (k < 32) ? ((uint64_t(1) << (2 * k)) - 1) : ~uint64_t(0);
    pts.clear_all();

    ll bestScore = 0, score = 0, score_r = 0;
    int mem_count = 0, fw_count = 0;
    int km_end = q_len - k + 1;

    for (int rc = 0; rc < 2; rc++) {
        const uint8_t* cur;
        const int32_t* npos;
        int n_np;
        int q_start_c, q_end_c, i;
        if (rc) {
            cur = qseq_r; npos = n_pos_r; n_np = n_r;
            score = score_r;
            fw_count = mem_count;
            q_start_c = q_len - q_end;
            q_end_c = q_len - q_start;
            i = q_start_c;
        } else {
            cur = qseq; npos = n_pos_f; n_np = n_f;
            q_start_c = q_start; q_end_c = q_end;
            if (q_start_c) i = q_start_c;
            else i = preseed(T, cur, q_len, q_end_c - q_start_c);
        }
        score_r = 0;
        mem_count = 0;
        int si = 0;
        while (i < q_end_c && si < n_np + 1) {
            int seg_end = (si < n_np) ? npos[si] : q_len;
            si++;
            int end = seg_end - k + 1;
            while (i < end) {
                uint64_t key = (i >= 0 && i < km_end)
                    ? kmer_at(cur, i, k, mask) : 0;
                int value = T.get(key);
                if (value == 0) {
                    i++;
                } else if (0 < value) {
                    int prev = value - 2;
                    int j = i - 1;
                    while (0 <= j && 0 <= prev && cur[j] == tc[prev]) {
                        j--; prev--;
                        score_r++;
                    }
                    pts.add(j + 1, 0, prev + 2, 0, 0);
                    value += k - 1;
                    i += k;
                    score_r += k;
                    while (i < end && value < t_len && cur[i] == tc[value]) {
                        i++; value++;
                        score_r++;
                    }
                    size_t idx = pts.n() - 1;
                    pts.qEnd[idx] = i;
                    pts.tEnd[idx] = value + 1;
                    pts.weight[idx] = pts.tEnd[idx] - pts.tStart[idx];
                    mem_count++;
                    i++;
                } else {
                    score_r += k;
                    int bias = i;
                    int upos2 = 0;
                    const int32_t* plist2 = nullptr;
                    int pn2 = T.find2(key, &upos2, &plist2);
                    if (pn2 == 1)
                        plist2 = &upos2;
                    for (int pi = 0; pi < pn2; pi++) {
                        int value2 = plist2[pi];
                        int kk = i;
                        int prev = value2 - 2;
                        int j = kk - 1;
                        while (0 <= j && 0 <= prev && cur[j] == tc[prev]) {
                            j--; prev--;
                        }
                        pts.add(j + 1, 0, prev + 2, 0, 0);
                        value2 += k - 1;
                        kk += k;
                        while (kk < end && value2 < t_len
                               && cur[kk] == tc[value2]) {
                            kk++; value2++;
                        }
                        size_t idx = pts.n() - 1;
                        pts.qEnd[idx] = kk;
                        pts.tEnd[idx] = value2 + 1;
                        pts.weight[idx] = kk - pts.qStart[idx];
                        mem_count++;
                        if (bias < kk) bias = kk;
                    }
                    score_r += bias - i;
                    i = bias + 1;
                }
            }
            i = end + k;
        }
        if (bestScore < score_r) bestScore = score_r;
    }

    int result;
    if (one2one && bestScore < k
        && bestScore * k < (ll)(q_len - k) - bestScore) {
        pts.clear_all();
        pts.len = 0;
        *n_points_out = 0;
        return 0;
    }
    if (bestScore == score) {
        pts.trim_to(fw_count);
        pts.len = fw_count;
        result = (int)bestScore;
    } else {
        pts.shift_down(fw_count, mem_count);
        pts.len = mem_count;
        result = -(int)bestScore;
    }
    *n_points_out = pts.len;
    return result;
}

extern "C" int kaln_anker_rc_comp(void* h, const uint8_t* qseq,
                                  const uint8_t* qseq_r,
                                  const int32_t* n_pos_f, int n_f,
                                  const int32_t* n_pos_r, int n_r,
                                  int q_len, int q_start, int q_end,
                                  int one2one, int* n_points_out) {
    return anker_rc_comp_impl(*(TIndex*)h, qseq, qseq_r, n_pos_f, n_f,
                              n_pos_r, n_r, q_len, q_start, q_end, one2one,
                              n_points_out, g_points);
}

// anker_rc (align.c:780-991) -- the BYTE variant used by assembly / Mt1
static int anker_rc_bytes_impl(TIndex& T, const uint8_t* qseq,
                               const uint8_t* qseq_r, int q_len,
                               int q_start, int q_end, int one2one,
                               int* n_points_out, Points& pts_arg) {
    int k = T.k;
    int t_len = T.len;
    const uint8_t* tc = T.codes.data();
    uint64_t mask = (k < 32) ? ((uint64_t(1) << (2 * k)) - 1) : ~uint64_t(0);
    Points& pts = pts_arg;
    pts.clear_all();

    ll bestScore = 0, score = 0, score_r = 0;
    int mem_count = 0, fw_count = 0;
    int km_end = q_len - k + 1;

    for (int rc = 0; rc < 2; rc++) {
        const uint8_t* cur;
        int q_start_c, q_end_c, i;
        if (rc) {
            cur = qseq_r;
            score = score_r;
            fw_count = mem_count;
            q_start_c = q_len - q_end;
            q_end_c = q_len - q_start;
            i = q_start_c;
        } else {
            cur = qseq;
            q_start_c = q_start; q_end_c = q_end;
            if (q_start_c) i = q_start_c;
            else i = preseed(T, cur, q_len, q_end_c - q_start_c);
        }
        score_r = 0;
        mem_count = 0;
        while (i < q_end_c) {
            // charpos(qseq, 4, i, q_len); the bound is q_len, an N past
            // q_end still terminates the segment there
            int end = q_end_c;
            for (int x = i; x < q_len; x++) {
                if (cur[x] == 4) { end = x; break; }
            }
            if (i < end - k) {
                int pos = i + k - 1;
                while (pos < end) {
                    int s = pos - k + 1;
                    uint64_t key = (s >= 0 && s < km_end)
                        ? kmer_at(cur, s, k, mask) : 0;
                    int value = T.get(key);
                    if (value == 0) {
                        pos++;
                    } else if (0 < value) {
                        int prev = value - 2;
                        int j = s - 1;
                        while (0 <= j && 0 <= prev && cur[j] == tc[prev]) {
                            j--; prev--;
                            score_r++;
                        }
                        pts.add(j + 1, 0, prev + 2, 0, 0);
                        value += k - 1;
                        int p2 = s + k;
                        score_r += k;
                        while (p2 < end && value < t_len
                               && cur[p2] == tc[value]) {
                            p2++; value++;
                            score_r++;
                        }
                        size_t idx = pts.n() - 1;
                        pts.qEnd[idx] = p2;
                        pts.tEnd[idx] = value + 1;
                        pts.weight[idx] = pts.tEnd[idx] - pts.tStart[idx];
                        mem_count++;
                        pos = (p2 < end - k) ? (p2 + k - 1) : end;
                    } else {
                        score_r += k;
                        int bias = s;
                        int upos2 = 0;
                        const int32_t* plist2 = nullptr;
                        int pn2 = T.find2(key, &upos2, &plist2);
                        if (pn2 == 1)
                            plist2 = &upos2;
                        for (int pi = 0; pi < pn2; pi++) {
                            int value2 = plist2[pi];
                            int kk = s;
                            int prev = value2 - 2;
                            int j = kk - 1;
                            while (0 <= j && 0 <= prev
                                   && cur[j] == tc[prev]) {
                                j--; prev--;
                            }
                            pts.add(j + 1, 0, prev + 2, 0, 0);
                            value2 += k - 1;
                            kk += k;
                            while (kk < end && value2 < t_len
                                   && cur[kk] == tc[value2]) {
                                kk++; value2++;
                            }
                            size_t idx = pts.n() - 1;
                            pts.qEnd[idx] = kk;
                            pts.tEnd[idx] = value2 + 1;
                            pts.weight[idx] = kk - pts.qStart[idx];
                            mem_count++;
                            if (bias < kk) bias = kk;
                        }
                        score_r += bias - s;
                        int nx = bias + 1;
                        pos = (nx < end - k) ? (nx + k - 1) : end;
                    }
                }
            }
            i = end + 1;
        }
        if (bestScore < score_r) bestScore = score_r;
    }

    int result;
    if (one2one && bestScore < k
        && bestScore * k < (ll)(q_len - k) - bestScore) {
        pts.clear_all();
        pts.len = 0;
        *n_points_out = 0;
        return 0;
    }
    if (bestScore == score) {
        pts.trim_to(fw_count);
        pts.len = fw_count;
        result = (int)bestScore;
    } else {
        pts.shift_down(fw_count, mem_count);
        pts.len = mem_count;
        result = -(int)bestScore;
    }
    *n_points_out = pts.len;
    return result;
}

extern "C" int kaln_anker_rc_bytes(void* h, const uint8_t* qseq,
                                   const uint8_t* qseq_r, int q_len,
                                   int q_start, int q_end, int one2one,
                                   int* n_points_out) {
    return anker_rc_bytes_impl(*(TIndex*)h, qseq, qseq_r, q_len, q_start,
                               q_end, one2one, n_points_out, g_points);
}

// ----------------------------------------------------- batched alnFragsSE
//
// alnFragsSE (alnfrags.c:1052-1218) over a whole batch of reads with a
// std::thread worker pool (the reference's per-thread aligners,
// alnfrags.c:2150-2293).  Each worker owns its Points / NW buffers; all
// outputs land in per-read slots so results are deterministic regardless
// of scheduling.  The caller (kma_tpu/align/native_aln.py) packs the
// batch flat; hits for read r are written at tpl_off[r] (capacity =
// candidate count, hits never exceed it).

#include <thread>
#include <atomic>

// ---- bound-skipped batch scoring ------------------------------------------
//
// Per-candidate chain state stashed between the chain phase and the NW
// phase.  Segments carry the fixed-up coordinates of the chain walk
// (kaln_align_impl's merge fixups applied); gaps carry the junction
// geometry the NW calls consume.
struct ChainSeg { int qs, qe; };
struct GapGeom { int t_sv, t_ev, q_s, q_ev, t_l; };
struct CandWork {
    uint8_t done;        // 1 = st already final (dead/aborted candidate)
    uint8_t skipped;     // 1 = bound-skipped (treated as read_score 0)
    int tmpl;            // sign-resolved template id
    int mapQ;
    const uint8_t* q;    // oriented query the alignment uses
    ll bound;            // strict upper bound on the alignment score
    int seg_total;       // signed segment length sum (<= final aln_len)
    int seg_off, seg_n;  // into the segment arena
    int gap_off;         // into the gap arena (seg_n - 1 entries)
    int lead_te, lead_qe;    // first segment tStart-1 / qStart
    int tail_ts, tail_qs;    // last segment tEnd-1 / qEnd
    AlnStat st;
};

// Content-dedupe of candidate alignments: with a redundant DB most
// candidates of a read are alleles whose aligned windows are
// byte-identical, so the NW result (score/len/match/gaps and the lead
// offset) is identical too.  The key captures everything the NW phase
// reads: orientation, segment q-coords, the k-flag cases, and the raw
// template bytes of the lead/gap/trail windows.
struct AlnCacheEnt {
    uint64_t hash;
    int key_off, key_len;
    ll score;
    int len, match, tGaps, qGaps;
    int pos_delta;   // lead_te - st.pos (content-determined)
};

static inline uint64_t fnv1a(const uint8_t* p, size_t n, uint64_t h) {
    // 8-byte chunks with a murmur-style mix (exact compare backs it up,
    // so only distribution matters)
    size_t i = 0;
    for (; i + 8 <= n; i += 8) {
        uint64_t x;
        memcpy(&x, p + i, 8);
        h ^= x;
        h *= 0xff51afd7ed558ccdULL;
        h ^= h >> 33;
    }
    for (; i < n; i++) {
        h ^= p[i];
        h *= 0x100000001b3ULL;
    }
    return h;
}

// exact score of a stashed chain: lead tail + matched segments + gap
// NWs + trail tail (the post-chain half of KMA_score, align.c:509-748)
static void nw_score_chain(TIndex& T, const uint8_t* q, int q_len,
                           const Penal& pen, const ChainSeg* segs,
                           int nseg, const GapGeom* gaps, int lead_te,
                           int lead_qe, int tail_ts, int tail_qs,
                           std::vector<uint8_t>& Ebuf,
                           std::vector<ll>& Dbuf, AlnStat& st) {
    const bool prof = aln_prof_on();
    int t_len = T.len;
    double pt0 = prof ? prof_now() : 0.0;
    lead_tail_aln(nullptr, T, q, lead_te, t_len, lead_qe, pen, false, st,
                  Ebuf, Dbuf);
    if (prof) {
        double t1 = prof_now();
        g_p_tails += (ll)((t1 - pt0) * 1e9);
    }
    for (int si = 0; si < nseg; si++) {
        const ChainSeg& sg = segs[si];
        int seg = sg.qe - sg.qs;
        st.len += seg;
        st.match += seg;
        for (int x = sg.qs; x < sg.qe; x++) {
            uint8_t nuc = q[x];
            st.score += pen.d[nuc][nuc];
        }
        if (si + 1 < nseg) {
            const GapGeom& g = gaps[si];
            int qg = g.q_ev - g.q_s;
            if (g.t_l > 0 || qg > 0) {
                if (prof) pt0 = prof_now();
                int band = std::abs(g.t_l - qg) + BANDWIDTH;
                AlnStat nw;
                if (qg <= band || g.t_l <= band)
                    nw_full(T.codes.data(), q, 0, g.t_sv, g.t_ev, g.q_s,
                            g.q_ev, pen, t_len, nw, nullptr, Ebuf, Dbuf);
                else
                    nw_band(T.codes.data(), q, 0, g.t_sv, g.t_ev, g.q_s,
                            g.q_ev, band, pen, t_len, nw, nullptr, Ebuf,
                            Dbuf);
                st.score += nw.score;
                st.len += nw.len;
                st.match += nw.match;
                st.tGaps += nw.tGaps;
                st.qGaps += nw.qGaps;
                if (prof) {
                    g_p_nw += (ll)((prof_now() - pt0) * 1e9);
                    g_p_nwcells +=
                        (ll)qg * (g.t_l <= band ? g.t_l : band);
                }
            }
        }
    }
    if (prof) pt0 = prof_now();
    trail_tail_aln(nullptr, st, T, q, tail_ts, t_len, tail_qs, q_len, pen,
                   false, Ebuf, Dbuf);
    if (prof) g_p_tails += (ll)((prof_now() - pt0) * 1e9);
}

// exact score of a stashed chain WITHOUT stats (nw_*_score pre-pass):
// identical numeric path as nw_score_chain, a fraction of the cost —
// candidates whose exact score proves they cannot be selected skip the
// stats pass entirely
// Lead/trail window geometry (lead_tail_aln / trail_tail_aln rules):
// shared by the bound math, the exact pre-pass, and the device window
// export (kaln_se_windows).  use_band marks the banded-NW branch -- the
// shape the device wavefront scorer (ops/nw_kernel.py) covers.
struct WinGeom {
    int t_s, t_e, q_s, q_e, kf, band;
    bool use_band;
    bool nonzero;
};

static WinGeom lead_window_geom(int lead_te, int lead_qe) {
    WinGeom g{};
    int t_e = lead_te, q_e = lead_qe;
    if (!q_e)
        return g;
    int t_s = 0, q_s = 0;
    if ((q_e << 1) < t_e || (q_e + BANDWIDTH) < t_e)
        t_s = t_e - (q_e + (q_e < BANDWIDTH ? q_e : BANDWIDTH));
    else if ((t_e << 1) < q_e || (t_e + BANDWIDTH) < q_e)
        q_s = q_e - (t_e + (t_e < BANDWIDTH ? t_e : BANDWIDTH));
    if (t_e - t_s <= 0 || q_e - q_s <= 0)
        return g;
    g.nonzero = true;
    g.t_s = t_s;
    g.t_e = t_e;
    g.q_s = q_s;
    g.q_e = q_e;
    g.band = std::abs(t_e - t_s - q_e + q_s) + BANDWIDTH;
    g.kf = -1 - (t_s == 0 ? 1 : 0);
    g.use_band = !(q_e - q_s <= g.band || t_e - t_s <= g.band);
    return g;
}

static WinGeom trail_window_geom(int tail_ts, int tail_qs, int q_len,
                                 int t_len) {
    WinGeom g{};
    int t_s = tail_ts, q_s = tail_qs;
    int q_e = q_len, t_e = t_len;
    int qr0 = q_len - q_s, tr0 = t_len - t_s;
    if ((qr0 << 1) < tr0 || (qr0 + BANDWIDTH) < tr0)
        t_e = t_s + (qr0 + (qr0 < BANDWIDTH ? qr0 : BANDWIDTH));
    else if ((tr0 << 1) < qr0 || (tr0 + BANDWIDTH) < qr0)
        q_e = q_s + (tr0 + (tr0 < BANDWIDTH ? tr0 : BANDWIDTH));
    if (t_e - t_s <= 0 || q_e - q_s <= 0)
        return g;
    g.nonzero = true;
    g.t_s = t_s;
    g.t_e = t_e;
    g.q_s = q_s;
    g.q_e = q_e;
    g.band = std::abs(t_e - t_s - q_e + q_s) + BANDWIDTH;
    g.kf = 1 + (t_e == t_len ? 1 : 0);
    g.use_band = !(q_e - q_s <= g.band || t_e - t_s <= g.band);
    return g;
}

static ll window_score(TIndex& T, const uint8_t* q, const Penal& pen,
                       const WinGeom& g) {
    if (!g.nonzero)
        return 0;
    const uint8_t* tc = T.codes.data();
    if (g.use_band)
        return nw_band_score(tc, q, g.kf, g.t_s, g.t_e, g.q_s, g.q_e,
                             g.band, pen, T.len);
    return nw_full_score(tc, q, g.kf, g.t_s, g.t_e, g.q_s, g.q_e, pen,
                         T.len);
}

// exact segment + junction contributions between the lead/trail windows
static ll chain_mid_score(TIndex& T, const uint8_t* q, const Penal& pen,
                          const ChainSeg* segs, int nseg,
                          const GapGeom* gaps) {
    int t_len = T.len;
    const uint8_t* tc = T.codes.data();
    ll score = 0;
    for (int si = 0; si < nseg; si++) {
        for (int x = segs[si].qs; x < segs[si].qe; x++) {
            uint8_t nuc = q[x];
            score += pen.d[nuc][nuc];
        }
        if (si + 1 < nseg) {
            const GapGeom& g = gaps[si];
            int qg = g.q_ev - g.q_s;
            if (g.t_l > 0 || qg > 0) {
                int band = std::abs(g.t_l - qg) + BANDWIDTH;
                if (qg <= band || g.t_l <= band)
                    score += nw_full_score(tc, q, 0, g.t_sv, g.t_ev,
                                           g.q_s, g.q_ev, pen, t_len);
                else
                    score += nw_band_score(tc, q, 0, g.t_sv, g.t_ev,
                                           g.q_s, g.q_ev, band, pen,
                                           t_len);
            }
        }
    }
    return score;
}

static ll chain_exact_score(TIndex& T, const uint8_t* q, int q_len,
                            const Penal& pen, const ChainSeg* segs,
                            int nseg, const GapGeom* gaps, int lead_te,
                            int lead_qe, int tail_ts, int tail_qs) {
    return window_score(T, q, pen, lead_window_geom(lead_te, lead_qe))
        + chain_mid_score(T, q, pen, segs, nseg, gaps)
        + window_score(T, q, pen,
                       trail_window_geom(tail_ts, tail_qs, q_len, T.len));
}

// content-dedupe key of a stashed chain (everything nw_score_chain
// reads): tag byte (orientation/mate), segment q-coords, window k-flag
// cases and the raw template bytes of the lead/gap/trail windows.
// Exact-sized upfront, raw cursor writes — this runs per candidate.
static void chain_key(std::vector<uint8_t>& kb, uint8_t tag,
                      const TIndex& T, const ChainSeg* segs, int nseg,
                      const GapGeom* gaps, int lead_te, int lead_qe,
                      int tail_ts, int tail_qs, int q_len) {
    const uint8_t* tc = T.codes.data();
    int t_len = T.len;
    // lead window geometry (lead_tail_aln rules)
    int l_te = lead_te, l_qe = lead_qe, l_ts = 0, l_qs = 0;
    if (l_qe) {
        if ((l_qe << 1) < l_te || (l_qe + BANDWIDTH) < l_te)
            l_ts = l_te - (l_qe + (l_qe < BANDWIDTH ? l_qe : BANDWIDTH));
        else if ((l_te << 1) < l_qe || (l_te + BANDWIDTH) < l_qe)
            l_qs = l_qe - (l_te + (l_te < BANDWIDTH ? l_te : BANDWIDTH));
    }
    bool l_win = l_qe && l_te - l_ts > 0 && l_qe - l_qs > 0;
    // trail window geometry (trail_tail_aln rules)
    int r_ts = tail_ts, r_qs = tail_qs, r_qe = q_len, r_te = t_len;
    {
        int qr0 = q_len - r_qs, tr0 = t_len - r_ts;
        if ((qr0 << 1) < tr0 || (qr0 + BANDWIDTH) < tr0)
            r_te = r_ts + (qr0 + (qr0 < BANDWIDTH ? qr0 : BANDWIDTH));
        else if ((tr0 << 1) < qr0 || (tr0 + BANDWIDTH) < qr0)
            r_qe = r_qs + (tr0 + (tr0 < BANDWIDTH ? tr0 : BANDWIDTH));
    }
    bool r_win = r_te - r_ts > 0 && r_qe - r_qs > 0;
    size_t need = 1 + 4 + 8 * (size_t)nseg + 9 + 9
                  + (l_win ? (size_t)(l_te - l_ts) : 0)
                  + (r_win ? (size_t)(r_te - r_ts) : 0) + 2;
    for (int si = 0; si + 1 < nseg; si++)
        need += 4 + (gaps[si].t_l > 0 ? (size_t)gaps[si].t_l : 0);
    kb.resize(need);
    uint8_t* w = kb.data();
    auto wi32 = [&w](int x) {
        memcpy(w, &x, 4);
        w += 4;
    };
    *w++ = tag;
    wi32(nseg);
    for (int si = 0; si < nseg; si++) {
        wi32(segs[si].qs);
        wi32(segs[si].qe);
    }
    wi32(l_qe - l_qs);
    wi32(l_qe ? l_te - l_ts : -1);
    *w++ = (l_ts == 0 ? 1 : 0);
    if (l_win) {
        memcpy(w, tc + l_ts, (size_t)(l_te - l_ts));
        w += l_te - l_ts;
    }
    for (int si = 0; si + 1 < nseg; si++) {
        const GapGeom& g = gaps[si];
        wi32(g.t_l);
        if (g.t_l > 0) {
            int p0 = g.t_sv % t_len;
            if (p0 < 0) p0 += t_len;
            if (p0 + g.t_l <= t_len) {
                memcpy(w, tc + p0, (size_t)g.t_l);
                w += g.t_l;
            } else {
                for (int i = 0; i < g.t_l; i++)
                    *w++ = tc[(p0 + i) % t_len];
            }
        }
    }
    wi32(r_qe - r_qs);
    wi32(r_te - r_ts);
    *w++ = (r_te == t_len ? 1 : 0);
    if (r_win) {
        memcpy(w, tc + r_ts, (size_t)(r_te - r_ts));
        w += r_te - r_ts;
    }
    kb.resize((size_t)(w - kb.data()));
}

// Both selection channels a sub-best candidate could still reach must
// stay strictly below run_frac:
// - the real-division best tracker, read_score/denom with denom >=
//   min(q_len, t_len) whenever the candidate can gate-pass,
// - update_Scores' INT-division tie rule, read_score/aln_len with
//   aln_len >= the chained segment sum; its value is an integer <=
//   floor(sc_cap/seg_total), which can only equal an integral
//   best_frac.
// `sc_cap` is an upper limit on the candidate's score (the chain bound
// or the exact pre-pass score).
static inline bool frac_channels_below(ll sc_cap, int q_len, int t_len,
                                       int seg_total, double run_frac) {
    if (sc_cap <= 0)
        return 0.0 < run_frac;
    int mn = q_len < t_len ? q_len : t_len;
    if (mn < 1)
        mn = 1;
    if (!((double)sc_cap / mn < run_frac))
        return false;
    ll st = seg_total > 0 ? seg_total : 1;
    return (double)(sc_cap / st) < run_frac;   // int division = floor
}

// best possible (least negative) cost of `diff` gapped bases: one run
// when extensions beat openings, else all openings
static inline ll gap_best(int diff, int W1, int U) {
    if (diff <= 0) return 0;
    ll one_run = (ll)W1 + (ll)(diff - 1) * U;
    ll all_open = (ll)diff * W1;
    return one_run < all_open ? all_open : one_run;
}

// upper bound of a global-in-q NW over a (qr x tr) window (the tail
// windows and interior gaps): <= maxd per aligned pair, mandatory gap
// run when qr > tr
static inline ll window_bound(int qr, int tr, int maxd, int W1, int U) {
    if (qr <= 0 || tr <= 0) return 0;
    int mn = qr < tr ? qr : tr;
    return (ll)maxd * mn + (qr > tr ? gap_best(qr - tr, W1, U) : 0);
}

// ---- phase A extracted: seed + chain + walk + score bound for every
// candidate of one read (shared by the fused batch scorer and the
// device-NW window export, kaln_se_windows) ---------------------------------
static void stage_read_chains(void* const* handles, const int32_t* tpl_ids,
                              ll base, int ncand, const uint8_t* q,
                              const uint8_t* rcq, const int32_t* np,
                              int n_np, const int32_t* npr, int q_len,
                              int q_start, int q_end, bool arc,
                              const Penal& pen, int maxd, int W1, int U,
                              int mq, Points& pts,
                              std::vector<ChainSeg>& segA,
                              std::vector<GapGeom>& gapA,
                              std::vector<CandWork>& cands) {
    const bool prof = aln_prof_on();
    segA.clear();
    gapA.clear();
    cands.assign(ncand, CandWork());
    for (int ci = 0; ci < ncand; ci++) {
        CandWork& w = cands[ci];
        TIndex& T = *(TIndex*)handles[base + ci];
        int tmpl = tpl_ids[base + ci];
        int t_len = T.len;
        w.done = 0;
        w.skipped = 0;
        w.st.score = 0; w.st.pos = 0; w.st.len = 0;
        w.st.match = 0; w.st.tGaps = 0; w.st.qGaps = 0;
        w.st.mapQ = 0;
        pts.clear_all();
        pts.len = 0;
        int use_points = 0;
        double pt0 = prof ? prof_now() : 0.0;
        if (arc) {
            int npout = 0;
            int rc = anker_rc_comp_impl(T, q, rcq, np, n_np,
                                        npr, n_np, q_len,
                                        q_start, q_end, 1, &npout,
                                        pts);
            pts.len = npout;
            if (prof) {
                double t1 = prof_now();
                g_p_anker += (ll)((t1 - pt0) * 1e9);
                pt0 = t1;
            }
            if (rc < 0) {
                if (0 < tmpl) tmpl = -tmpl;
                w.q = rcq;
                use_points = pts.len ? 1 : 0;
                if (!use_points) {
                    pts.clear_all();
                    collect_seeds_comp(T, rcq, npr,
                                       n_np, q_len, q_len - q_end,
                                       q_len - q_start, pts);
                    pts.len = (int)pts.n();
                }
            } else if (rc > 0) {
                if (tmpl < 0) tmpl = -tmpl;
                w.q = q;
                use_points = pts.len ? 1 : 0;
                if (!use_points) {
                    pts.clear_all();
                    collect_seeds_comp(T, q, np, n_np, q_len,
                                       q_start, q_end, pts);
                    pts.len = (int)pts.n();
                }
            } else {
                // no anker: st stays zeroed (len 0), mapQ 0
                w.tmpl = tmpl;
                w.done = 1;
                if (prof) g_p_collect += (ll)((prof_now() - pt0) * 1e9);
                continue;
            }
        } else if (tmpl < 0) {
            w.q = rcq;
            pts.clear_all();
            collect_seeds_comp(T, rcq, npr, n_np,
                               q_len, q_len - q_end,
                               q_len - q_start, pts);
            pts.len = (int)pts.n();
        } else {
            w.q = q;
            pts.clear_all();
            collect_seeds_comp(T, q, np, n_np, q_len, q_start,
                               q_end, pts);
            pts.len = (int)pts.n();
        }
        w.tmpl = tmpl;
        if (prof) {
            double t1 = prof_now();
            g_p_collect += (ll)((t1 - pt0) * 1e9);
            g_p_calls += 1;
            g_p_seeds += pts.len;
            pt0 = t1;
        }
        if (!pts.len) {
            // kaln_align_impl's !pts.len outcome: zeroed, len 1
            w.st.len = 1;
            w.done = 1;
            continue;
        }
        int start, mapQ;
        chain_seeds(pts, q_len, t_len, T.k, pen,
                    g_chain_circular.load() != 0, start, mapQ);
        if (prof) {
            double t1 = prof_now();
            g_p_chain += (ll)((t1 - pt0) * 1e9);
            pt0 = t1;
        }
        w.mapQ = mapQ;
        w.st.mapQ = mapQ;
        ll cscore = pts.score[start];
        if (mapQ < mq || cscore < T.k) {
            w.st.len = 1;
            w.done = 1;
            pts.len = 0;
            continue;
        }
        trim_seeds(pts, start, 0, false);

        // walk the chain: apply the merge fixups, stash the
        // fixed-up segments + junction geometry, abort like
        // kaln_align_impl's gap check
        w.seg_off = (int)segA.size();
        w.gap_off = (int)gapA.size();
        w.lead_te = pts.tStart[start] - 1;
        w.lead_qe = pts.qStart[start];
        ll bound = 0;
        {
            // lead window geometry (lead_tail_aln rules)
            int t_e = w.lead_te, q_e = w.lead_qe;
            int t_s = 0, q_s = 0;
            if ((q_e << 1) < t_e || (q_e + BANDWIDTH) < t_e)
                t_s = t_e - (q_e + (q_e < BANDWIDTH ? q_e
                                                    : BANDWIDTH));
            else if ((t_e << 1) < q_e || (t_e + BANDWIDTH) < q_e)
                q_s = q_e - (t_e + (t_e < BANDWIDTH ? t_e
                                                    : BANDWIDTH));
            if (q_e) {
                // t_s == 0 -> lead NW runs with k == -2 (free leading
                // clip): query excess costs nothing, so the sound
                // upper bound is maxd*min with NO gap charge
                if (t_s == 0) {
                    int mn = (q_e - q_s) < (t_e - t_s) ? (q_e - q_s)
                                                       : (t_e - t_s);
                    bound = mn > 0 ? (ll)maxd * mn : 0;
                } else {
                    bound = window_bound(q_e - q_s, t_e - t_s, maxd,
                                         W1, U);
                }
            }
        }
        bool aborted = false;
        w.seg_total = 0;
        for (;;) {
            segA.push_back({pts.qStart[start], pts.qEnd[start]});
            int seg = pts.qEnd[start] - pts.qStart[start];
            w.seg_total += seg;
            if (seg > 0) bound += (ll)maxd * seg;
            if (!pts.next[start]) {
                w.tail_ts = pts.tEnd[start] - 1;
                w.tail_qs = pts.qEnd[start];
                break;
            }
            int q_s = pts.qEnd[start];
            int t_sv = pts.tEnd[start] - 1;
            start = pts.next[start];
            if (pts.qStart[start] < q_s) {
                pts.tStart[start] += q_s - pts.qStart[start];
                pts.qStart[start] = q_s;
            }
            int t_ev = pts.tStart[start] - 1;
            int t_l;
            if (t_ev < t_sv) {
                if (t_sv <= pts.tEnd[start]) {
                    pts.qStart[start] += t_sv - t_ev;
                    t_ev = t_sv;
                    t_l = 0;
                } else {
                    t_l = t_len - t_sv + t_ev;
                }
            } else {
                t_l = t_ev - t_sv;
            }
            int q_ev = pts.qStart[start];
            if ((ll)std::abs(t_l - q_ev + q_s) * pen.U
                        > (ll)q_len * pen.M
                || t_l > q_len || q_ev - q_s > (q_len >> 1)) {
                aborted = true;
                break;
            }
            gapA.push_back({t_sv, t_ev, q_s, q_ev, t_l});
            int qg = q_ev - q_s;
            if (t_l > 0 || qg > 0) {
                if (qg == 1 && t_l == 1) {
                    // single mismatch junction: exact value
                    int t_nuc_pos = t_sv % t_len;
                    if (t_nuc_pos < 0) t_nuc_pos += t_len;
                    ll d = pen.d[T.codes[t_nuc_pos]][w.q[q_s]];
                    ll gg = 2LL * W1;
                    bound += d < gg ? gg : d;
                } else if (qg == 0 || t_l == 0) {
                    // pure gap: empty_case value, exact
                    int g = qg > t_l ? qg : t_l;
                    bound += (ll)W1 + (ll)(g - 1) * U;
                } else {
                    bound += window_bound(qg, t_l, maxd, W1, U);
                }
            }
        }
        pts.len = 0;
        if (aborted) {
            segA.resize(w.seg_off);
            gapA.resize(w.gap_off);
            w.st.len = 1;
            w.done = 1;
            continue;
        }
        if (prof) g_p_walk += (ll)((prof_now() - pt0) * 1e9);
        w.seg_n = (int)(segA.size() - w.seg_off);
        // trail window geometry (trail_tail_aln rules)
        {
            int t_s = w.tail_ts, q_s = w.tail_qs;
            int q_e = q_len, t_e = t_len;
            int qr0 = q_len - q_s, tr0 = t_len - t_s;
            if ((qr0 << 1) < tr0 || (qr0 + BANDWIDTH) < tr0)
                t_e = t_s + (qr0 + (qr0 < BANDWIDTH ? qr0
                                                    : BANDWIDTH));
            else if ((tr0 << 1) < qr0 || (tr0 + BANDWIDTH) < qr0)
                q_e = q_s + (tr0 + (tr0 < BANDWIDTH ? tr0
                                                    : BANDWIDTH));
            // t_e == t_len -> trail NW runs with k == 2 (free trailing
            // clip): query excess is free, bound is maxd*min
            if (t_e == t_len) {
                int mn = (q_e - q_s) < (t_e - t_s) ? (q_e - q_s)
                                                   : (t_e - t_s);
                bound += mn > 0 ? (ll)maxd * mn : 0;
            } else {
                bound += window_bound(q_e - q_s, t_e - t_s, maxd, W1,
                                      U);
            }
        }
        w.bound = bound;
    }
}

extern "C" void kaln_frags_se_batch_mf(
    void* const* handles,        // [total_tpl] TIndex* per candidate
    const int32_t* tpl_ids,      // [total_tpl] signed template ids
    const int64_t* tpl_off,      // [n_reads+1]
    const uint8_t* codes_flat,   // forward codes, concatenated
    const int64_t* codes_off,    // [n_reads+1]
    const int32_t* npos_flat,    // forward N positions, concatenated
    const int64_t* npos_off,     // [n_reads+1]
    const int32_t* qbounds,      // [n_reads,2] q_start,q_end
    const uint8_t* arc_flags,    // [n_reads] rc_flag<0
    // optional custom rc codes per read (the HMM whole-word-slice rc,
    // AnkerHit.rc_override); empty slice = derive the plain revcomp
    const uint8_t* crc_flat, const int64_t* crc_off,
    int n_reads,
    int M, int MM, int U, int W1, const int32_t* dmat,
    int kmersize, int minlen, int mq, double scoreT, double mrc,
    int n_threads,
    // min_frac of the DOWNSTREAM update_Scores selection
    // (updatescores.c:203-298).  When == 1.0, candidates whose score
    // bound is strictly below both running bests are skipped (they can
    // neither be selected nor move the per-read bests).  Pass NaN when
    // the selection rule is unknown; the bound<=kmersize skip (exact for
    // every consumer: such candidates never pass the in-loop gate) still
    // applies.
    double sel_min_frac,
    int32_t* out_nhits,          // [n_reads]
    long long* out_best_score,   // [n_reads] bestReadScore
    double* out_best_frac,       // [n_reads] bestScore ratio
    int32_t* out_tpl, int32_t* out_start, int32_t* out_end,
    long long* out_score, int32_t* out_len) {
    Penal pen;
    pen.M = M; pen.MM = MM; pen.U = U; pen.W1 = W1;
    int maxd = INT_MIN;
    for (int a = 0; a < 5; a++)
        for (int b = 0; b < 5; b++) {
            pen.d[a][b] = dmat[a * 5 + b];
            if (pen.d[a][b] > maxd) maxd = pen.d[a][b];
        }
    // the bound arithmetic assumes non-negative match rewards and
    // non-positive gap costs; disable skipping for exotic matrices
    const bool bounds_ok = maxd >= 0 && W1 <= 0 && U <= 0;
    const bool frac_skip = bounds_ok && sel_min_frac == 1.0;

    // process reads grouped by their first candidate template so each
    // per-template seed table stays cache-hot across its whole group
    // (outputs are per-read slots, so order is free)
    std::vector<int> rperm(n_reads);
    for (int i = 0; i < n_reads; i++)
        rperm[i] = i;
    std::stable_sort(rperm.begin(), rperm.end(), [&](int a, int b) {
        int ta = tpl_off[a] < tpl_off[a + 1]
                     ? std::abs(tpl_ids[tpl_off[a]]) : INT_MAX;
        int tb = tpl_off[b] < tpl_off[b + 1]
                     ? std::abs(tpl_ids[tpl_off[b]]) : INT_MAX;
        return ta < tb;
    });

    std::atomic<int> next(0);
    auto worker = [&]() {
        Points pts;
        std::vector<uint8_t> Ebuf;
        std::vector<ll> Dbuf;
        std::vector<uint8_t> rcq;
        std::vector<int32_t> npr;
        std::vector<ChainSeg> segA;
        std::vector<GapGeom> gapA;
        std::vector<CandWork> cands;
        std::vector<int> order;
        std::vector<uint8_t> keyA;          // per-read key arena
        std::vector<AlnCacheEnt> centries;  // per-read dedupe entries
        std::vector<uint8_t> kb;            // scratch key
        auto put_i32 = [](std::vector<uint8_t>& v, int x) {
            const uint8_t* p = (const uint8_t*)&x;
            v.insert(v.end(), p, p + 4);
        };
        for (;;) {
            int ri = next.fetch_add(1);
            if (ri >= n_reads) break;
            int r = rperm[ri];
            const uint8_t* q = codes_flat + codes_off[r];
            int q_len = (int)(codes_off[r + 1] - codes_off[r]);
            const int32_t* np = npos_flat + npos_off[r];
            int n_np = (int)(npos_off[r + 1] - npos_off[r]);
            if (crc_flat && crc_off[r + 1] > crc_off[r]) {
                rcq.assign(crc_flat + crc_off[r],
                           crc_flat + crc_off[r + 1]);
            } else {
                rcq.resize(q_len);
                for (int i = 0; i < q_len; i++) {
                    uint8_t c = q[q_len - 1 - i];
                    rcq[i] = c < 4 ? (uint8_t)(3 - c) : c;
                }
            }
            npr.resize(n_np);   // mirrored N positions, ascending
            for (int i = 0; i < n_np; i++)
                npr[i] = q_len - 1 - np[n_np - 1 - i];
            int q_start = qbounds[2 * r], q_end = qbounds[2 * r + 1];
            bool arc = arc_flags[r] != 0;
            long long base = tpl_off[r];
            int ncand = (int)(tpl_off[r + 1] - base);
            const bool prof = aln_prof_on();

            // ---- phase A: seed + chain every candidate, stash the walk
            double ph0 = prof ? prof_now() : 0.0;
            stage_read_chains(handles, tpl_ids, base, ncand, q,
                              rcq.data(), np, n_np, npr.data(), q_len,
                              q_start, q_end, arc, pen, maxd, W1, U, mq,
                              pts, segA, gapA, cands);

            if (prof) {
                double t1 = prof_now();
                g_p_phA += (ll)((t1 - ph0) * 1e9);
                ph0 = t1;
            }
            // ---- phase B: exact NW in descending-bound order, skipping
            // candidates whose bound proves they cannot be selected
            order.clear();
            for (int ci = 0; ci < ncand; ci++)
                if (!cands[ci].done) order.push_back(ci);
            std::stable_sort(order.begin(), order.end(),
                             [&](int a, int b) {
                                 return cands[a].bound > cands[b].bound;
                             });
            ll run_best = 0;
            double run_frac = 0.0;
            keyA.clear();
            centries.clear();
            for (int oi = 0; oi < (int)order.size(); oi++) {
                CandWork& w = cands[order[oi]];
                TIndex& T = *(TIndex*)handles[base + order[oi]];
                int t_len = T.len;
                if (bounds_ok) {
                    int mn0 = q_len < t_len ? q_len : t_len;
                    if (mn0 < 1)
                        mn0 = 1;
                    // the in-loop gate (kmersize < read_score &&
                    // scoreT <= score, score = read_score/denom with
                    // denom >= mn0) can provably never pass: exact for
                    // every consumer
                    if (w.bound <= kmersize
                        || (double)w.bound / mn0 < scoreT) {
                        w.skipped = 1;
                        if (prof) g_p_skipped += 1;
                        continue;
                    }
                }
                if (frac_skip && w.bound < run_best
                    && frac_channels_below(w.bound, q_len, t_len,
                                           w.seg_total, run_frac)) {
                    w.skipped = 1;
                    if (prof) g_p_skipped += 1;
                    continue;
                }

                // ---- content-dedupe key: everything the NW reads ----
                double kt0 = prof ? prof_now() : 0.0;
                chain_key(kb, w.q == q ? 0 : 1, T, segA.data() + w.seg_off,
                          w.seg_n, gapA.data() + w.gap_off, w.lead_te,
                          w.lead_qe, w.tail_ts, w.tail_qs, q_len);
                uint64_t h = fnv1a(kb.data(), kb.size(),
                                   0xcbf29ce484222325ULL);
                AlnCacheEnt* hit = nullptr;
                for (auto& e : centries)
                    if (e.hash == h && e.key_len == (int)kb.size()
                        && memcmp(keyA.data() + e.key_off, kb.data(),
                                  kb.size()) == 0) {
                        hit = &e;
                        break;
                    }
                if (prof) g_p_key += (ll)((prof_now() - kt0) * 1e9);
                // exact-score pre-pass for heavy-window candidates (long
                // reads): a score-only NW (no E matrix, no traceback)
                // costs a fraction of the stats pass, and the EXACT
                // score drives the same skip rules the bound drives —
                // strictly more skips where bounds are loose (indels)
                if (!hit) {
                    ll gcand = base + order[oi];
                    bool dev_l = g_dev_has_lead && g_dev_has_lead[gcand];
                    bool dev_t = g_dev_has_trail
                                 && g_dev_has_trail[gcand];
                    ll est_cells =
                        ((ll)w.lead_qe + (q_len - w.tail_qs))
                        * (2 * BANDWIDTH);
                    if (est_cells > (1 << 15) || dev_l || dev_t) {
                        if (prof) g_p_pre_run += 1;
                        double pp0 = prof ? prof_now() : 0.0;
                        ll exact;
                        if (dev_l || dev_t) {
                            // device-scored lead/trail windows (the
                            // device wavefront scorer): same numeric
                            // path, heavy windows off the host
                            if (prof) g_p_pre_dev += 1;
                            ll lead = dev_l
                                ? g_dev_lead[gcand]
                                : window_score(
                                      T, w.q, pen,
                                      lead_window_geom(w.lead_te,
                                                       w.lead_qe));
                            ll trail = dev_t
                                ? g_dev_trail[gcand]
                                : window_score(
                                      T, w.q, pen,
                                      trail_window_geom(w.tail_ts,
                                                        w.tail_qs,
                                                        q_len, t_len));
                            exact = lead
                                + chain_mid_score(T, w.q, pen,
                                                  segA.data() + w.seg_off,
                                                  w.seg_n,
                                                  gapA.data() + w.gap_off)
                                + trail;
                        } else {
                            exact = chain_exact_score(
                                T, w.q, q_len, pen,
                                segA.data() + w.seg_off, w.seg_n,
                                gapA.data() + w.gap_off, w.lead_te,
                                w.lead_qe, w.tail_ts, w.tail_qs);
                        }
                        if (prof)
                            g_p_pre += (ll)((prof_now() - pp0) * 1e9);
                        int mn = q_len < t_len ? q_len : t_len;
                        if (mn < 1)
                            mn = 1;
                        // exact <= kmersize or score (= exact/denom,
                        // denom >= mn) provably below scoreT: the
                        // in-loop gate can never pass — exact for every
                        // consumer, like the bound<=kmersize skip
                        bool skip = exact <= kmersize
                            || (double)exact / mn < scoreT
                            || (frac_skip && exact < run_best
                                && frac_channels_below(exact, q_len,
                                                       t_len, w.seg_total,
                                                       run_frac));
                        if (skip) {
                            w.skipped = 1;
                            if (prof) g_p_preskip += 1;
                            continue;
                        }
                    } else if (prof) {
                        g_p_pre_small += 1;
                    }
                }
                if (hit) {
                    AlnStat st;
                    st.score = hit->score;
                    st.len = hit->len;
                    st.match = hit->match;
                    st.tGaps = hit->tGaps;
                    st.qGaps = hit->qGaps;
                    st.pos = w.lead_te - hit->pos_delta;
                    st.mapQ = w.mapQ;
                    w.st = st;
                    if (prof) g_p_skipped += 1;
                    // running bests still advance off the cached result
                    int aln_len = st.len;
                    double denom;
                    if (q_len <= aln_len || t_len <= aln_len)
                        denom = (double)aln_len;
                    else
                        denom = (double)(q_len < t_len ? q_len : t_len);
                    ll read_score = st.score;
                    bool mr = (mrc * q_len <= st.len - st.qGaps)
                              || (mrc * t_len <= st.len - st.tGaps);
                    if (minlen <= aln_len && mr
                        && kmersize < read_score) {
                        double score = (double)read_score / denom;
                        if (scoreT <= score) {
                            if (run_frac < score) run_frac = score;
                            if (run_best < read_score)
                                run_best = read_score;
                        }
                    }
                    continue;
                }

                AlnStat st;
                nw_score_chain(T, w.q, q_len, pen, segA.data() + w.seg_off,
                               w.seg_n, gapA.data() + w.gap_off,
                               w.lead_te, w.lead_qe, w.tail_ts, w.tail_qs,
                               Ebuf, Dbuf, st);
                st.mapQ = w.mapQ;
                w.st = st;
                {
                    AlnCacheEnt e;
                    e.hash = h;
                    e.key_off = (int)keyA.size();
                    e.key_len = (int)kb.size();
                    keyA.insert(keyA.end(), kb.begin(), kb.end());
                    e.score = st.score;
                    e.len = st.len;
                    e.match = st.match;
                    e.tGaps = st.tGaps;
                    e.qGaps = st.qGaps;
                    e.pos_delta = w.lead_te - st.pos;
                    centries.push_back(e);
                }

                // replicate the in-loop gate to advance the running bests
                int aln_len = st.len;
                double denom;
                if (q_len <= aln_len || t_len <= aln_len)
                    denom = (double)aln_len;
                else
                    denom = (double)(q_len < t_len ? q_len : t_len);
                ll read_score = st.score;
                bool mr = (mrc * q_len <= st.len - st.qGaps)
                          || (mrc * t_len <= st.len - st.tGaps);
                if (minlen <= aln_len && mr && kmersize < read_score) {
                    double score = (double)read_score / denom;
                    if (scoreT <= score) {
                        if (run_frac < score) run_frac = score;
                        if (run_best < read_score) run_best = read_score;
                    }
                }
            }

            if (prof) {
                double t1 = prof_now();
                g_p_phB += (ll)((t1 - ph0) * 1e9);
                ph0 = t1;
            }
            // ---- phase C: gates + output in original candidate order
            ll best_read_score = 0;
            double bestScore = 0.0;
            int nh = 0;
            for (int ci = 0; ci < ncand; ci++) {
                CandWork& w = cands[ci];
                if (w.skipped)
                    continue;
                TIndex& T = *(TIndex*)handles[base + ci];
                int t_len = T.len;
                const AlnStat& st = w.st;
                int aln_len = st.len;
                int start = st.pos;
                int end = start + aln_len - st.tGaps;
                if (t_len < end) end -= t_len;
                double denom;
                if (q_len <= aln_len || t_len <= aln_len)
                    denom = (double)aln_len;
                else
                    denom = (double)(q_len < t_len ? q_len : t_len);
                ll read_score = st.score;
                double score;
                bool mr = (mrc * q_len <= st.len - st.qGaps)
                          || (mrc * t_len <= st.len - st.tGaps);
                if (minlen <= aln_len && mr) {
                    score = (double)read_score / denom;
                } else {
                    read_score = 0;
                    score = 0.0;
                }
                if (kmersize < read_score && scoreT <= score) {
                    out_tpl[base + nh] = w.tmpl;
                    out_start[base + nh] = start;
                    out_end[base + nh] = end;
                    out_score[base + nh] = read_score;
                    out_len[base + nh] = aln_len;
                    nh++;
                    if (bestScore < score) bestScore = score;
                    if (best_read_score < read_score)
                        best_read_score = read_score;
                }
            }
            out_nhits[r] = nh;
            out_best_score[r] = best_read_score;
            out_best_frac[r] = bestScore;
            if (prof) g_p_phC += (ll)((prof_now() - ph0) * 1e9);
        }
    };
    int nt = n_threads < 1 ? 1 : n_threads;
    if (nt == 1) {
        worker();
    } else {
        std::vector<std::thread> th;
        th.reserve(nt);
        for (int i = 0; i < nt; i++) th.emplace_back(worker);
        for (auto& t : th) t.join();
    }
    // device score tables are single-call scoped
    kaln_set_dev_scores(nullptr, nullptr, nullptr, nullptr);
}

// Export the heavy lead/trail banded windows of one SE batch for the
// device pre-pass (the wavefront scorer, ops/nw_kernel.py): runs
// phase A (stage_read_chains) per read, applies the same static gates
// phase B applies unconditionally, dedupes windows by CONTENT (the
// redundant-DB workload makes most candidates alleles with identical
// window bytes) and writes one descriptor per unique window plus the
// per-candidate window indices.  Returns the unique-window count, or
// -(needed) when `cap` is too small.
extern "C" ll kaln_se_windows(
    void* const* handles, const int32_t* tpl_ids, const int64_t* tpl_off,
    const uint8_t* codes_flat, const int64_t* codes_off,
    const int32_t* npos_flat, const int64_t* npos_off,
    const int32_t* qbounds, const uint8_t* arc_flags,
    const uint8_t* crc_flat, const int64_t* crc_off, int n_reads, int M,
    int MM, int U, int W1, const int32_t* dmat, int kmersize, int mq,
    double scoreT,
    ll est_cells_min,      // pre-pass trigger (must match phase B's)
    int max_band,          // device band cap (kernel lane budget)
    ll cap,
    // per unique window (size cap):
    int32_t* w_read, int32_t* w_cand, uint8_t* w_rc, int32_t* w_ts,
    int32_t* w_te, int32_t* w_qs, int32_t* w_qe, int32_t* w_kf,
    int32_t* w_band,
    // per global candidate (size tpl_off[n_reads]):
    int32_t* lead_win, int32_t* trail_win) {
    Penal pen;
    pen.M = M; pen.MM = MM; pen.U = U; pen.W1 = W1;
    int maxd = INT_MIN;
    for (int a = 0; a < 5; a++)
        for (int b = 0; b < 5; b++) {
            pen.d[a][b] = dmat[a * 5 + b];
            if (pen.d[a][b] > maxd) maxd = pen.d[a][b];
        }
    const bool bounds_ok = maxd >= 0 && W1 <= 0 && U <= 0;
    ll total_tpl = tpl_off[n_reads];
    for (ll i = 0; i < total_tpl; i++)
        lead_win[i] = trail_win[i] = -1;

    // content-dedupe of exported windows: key = window template bytes
    // ++ window query coords ++ kf/band (the query bytes are shared per
    // read, so q_s/q_e identify them)
    struct WKey {
        uint64_t hash;
        ll off;
        int len;
        int idx;
    };
    std::vector<WKey> wkeys;
    std::vector<uint8_t> karena;
    std::vector<uint8_t> kb;
    ll n_win = 0;
    ll needed = 0;

    Points pts;
    std::vector<uint8_t> rcq;
    std::vector<int32_t> npr;
    std::vector<ChainSeg> segA;
    std::vector<GapGeom> gapA;
    std::vector<CandWork> cands;

    auto try_emit = [&](int r, ll gcand, const CandWork& w,
                        const WinGeom& g, TIndex& T,
                        int32_t* slot_arr) {
        if (!g.nonzero || !g.use_band || g.band > max_band)
            return;
        // key: orientation tag + q window + kf/band + template bytes
        kb.clear();
        kb.push_back(w.q == (codes_flat + codes_off[r]) ? 0 : 1);
        auto put32 = [&](int v) {
            const uint8_t* p = (const uint8_t*)&v;
            kb.insert(kb.end(), p, p + 4);
        };
        put32(r);        // query bytes are per-read
        put32(g.q_s);
        put32(g.q_e);
        put32(g.kf);
        put32(g.band);
        put32(g.t_e - g.t_s);
        kb.insert(kb.end(), T.codes.data() + g.t_s,
                  T.codes.data() + g.t_e);
        uint64_t h = fnv1a(kb.data(), kb.size(), 0xcbf29ce484222325ULL);
        for (auto& e : wkeys)
            if (e.hash == h && e.len == (int)kb.size()
                && memcmp(karena.data() + e.off, kb.data(),
                          kb.size()) == 0) {
                slot_arr[gcand] = e.idx;
                return;
            }
        needed++;
        if (n_win >= cap)
            return;
        WKey e;
        e.hash = h;
        e.off = (ll)karena.size();
        e.len = (int)kb.size();
        e.idx = (int)n_win;
        karena.insert(karena.end(), kb.begin(), kb.end());
        wkeys.push_back(e);
        w_read[n_win] = r;
        w_cand[n_win] = (int32_t)gcand;
        w_rc[n_win] = kb[0];
        w_ts[n_win] = g.t_s;
        w_te[n_win] = g.t_e;
        w_qs[n_win] = g.q_s;
        w_qe[n_win] = g.q_e;
        w_kf[n_win] = g.kf;
        w_band[n_win] = g.band;
        slot_arr[gcand] = (int32_t)n_win;
        n_win++;
    };

    for (int r = 0; r < n_reads; r++) {
        const uint8_t* q = codes_flat + codes_off[r];
        int q_len = (int)(codes_off[r + 1] - codes_off[r]);
        const int32_t* np = npos_flat + npos_off[r];
        int n_np = (int)(npos_off[r + 1] - npos_off[r]);
        if (crc_flat && crc_off[r + 1] > crc_off[r]) {
            rcq.assign(crc_flat + crc_off[r], crc_flat + crc_off[r + 1]);
        } else {
            rcq.resize(q_len);
            for (int i = 0; i < q_len; i++) {
                uint8_t c = q[q_len - 1 - i];
                rcq[i] = c < 4 ? (uint8_t)(3 - c) : c;
            }
        }
        npr.resize(n_np);
        for (int i = 0; i < n_np; i++)
            npr[i] = q_len - 1 - np[n_np - 1 - i];
        int q_start = qbounds[2 * r], q_end = qbounds[2 * r + 1];
        bool arc = arc_flags[r] != 0;
        ll base = tpl_off[r];
        int ncand = (int)(tpl_off[r + 1] - base);
        stage_read_chains(handles, tpl_ids, base, ncand, q, rcq.data(),
                          np, n_np, npr.data(), q_len, q_start, q_end,
                          arc, pen, maxd, W1, U, mq, pts, segA, gapA,
                          cands);
        for (int ci = 0; ci < ncand; ci++) {
            CandWork& w = cands[ci];
            if (w.done)
                continue;
            TIndex& T = *(TIndex*)handles[base + ci];
            int t_len = T.len;
            if (bounds_ok) {
                int mn0 = q_len < t_len ? q_len : t_len;
                if (mn0 < 1)
                    mn0 = 1;
                if (w.bound <= kmersize
                    || (double)w.bound / mn0 < scoreT)
                    continue;  // phase B skips it before any pre-pass
            }
            ll est_cells = ((ll)w.lead_qe + (q_len - w.tail_qs))
                           * (2 * BANDWIDTH);
            if (est_cells <= est_cells_min)
                continue;
            try_emit(r, base + ci, w,
                     lead_window_geom(w.lead_te, w.lead_qe), T, lead_win);
            try_emit(r, base + ci, w,
                     trail_window_geom(w.tail_ts, w.tail_qs, q_len,
                                       t_len), T, trail_win);
        }
    }
    if (needed > n_win)
        return -needed;
    return n_win;
}

// Code staging for the device NW scorer (ops/nw_kernel.py
// nw_band_score): the sheared band's query position collapses to
// qpos(n) = K + n - i with K = max(c0 - half, -1), so the device needs
// only the row-(-1) query window (qc0, one code per lane), the per-row
// template code (tcol) and the per-row entering query code (inj).
// Code 5 = out-of-range pad (score 0).
extern "C" void kaln_se_stage_codes(
    void* const* handles, const uint8_t* codes_flat,
    const int64_t* codes_off, const uint8_t* crc_flat,
    const int64_t* crc_off, const int32_t* w_read, const int32_t* w_cand,
    const uint8_t* w_rc, const int32_t* w_ts, const int32_t* w_te,
    const int32_t* w_qs, const int32_t* w_qe, const int32_t* w_kf,
    const int32_t* w_band, const int64_t* sel, ll n_sel, int R, int L,
    uint8_t* qc0, uint8_t* tcol, uint8_t* inj, int32_t* tl_out,
    int32_t* ql_out, int32_t* kf_out, int32_t* hb_out) {
    memset(qc0, 5, (size_t)n_sel * L);
    memset(tcol, 0, (size_t)R * n_sel);
    memset(inj, 5, (size_t)R * n_sel);
    std::vector<uint8_t> rcq;
    for (ll j = 0; j < n_sel; j++) {
        ll wi = sel[j];
        int r = w_read[wi];
        const uint8_t* q_fw = codes_flat + codes_off[r];
        int q_len_full = (int)(codes_off[r + 1] - codes_off[r]);
        const uint8_t* q_used = q_fw;
        if (w_rc[wi]) {
            if (crc_flat && crc_off[r + 1] > crc_off[r]) {
                q_used = crc_flat + crc_off[r];
            } else {
                rcq.resize(q_len_full);
                for (int i = 0; i < q_len_full; i++) {
                    uint8_t c = q_fw[q_len_full - 1 - i];
                    rcq[i] = c < 4 ? (uint8_t)(3 - c) : c;
                }
                q_used = rcq.data();
            }
        }
        TIndex& T = *(TIndex*)handles[w_cand[wi]];
        const uint8_t* tw = T.codes.data() + w_ts[wi];
        const uint8_t* qw = q_used + w_qs[wi];
        int t_len = w_te[wi] - w_ts[wi];
        int q_len = w_qe[wi] - w_qs[wi];
        int band = w_band[wi];
        band += band & 1;
        int half = band / 2;
        tl_out[j] = t_len;
        ql_out[j] = q_len;
        kf_out[j] = w_kf[wi];
        hb_out[j] = half;
        int K = ((t_len + q_len) >> 1) - half;
        if (K < -1)
            K = -1;
        uint8_t* qrow = qc0 + (size_t)j * L;
        for (int n = 0; n < L; n++) {
            int qpos = K + 1 + n;
            if (qpos >= 0 && qpos < q_len)
                qrow[n] = qw[qpos];
        }
        for (int i = 0; i < t_len && i < R; i++) {
            tcol[(size_t)i * n_sel + j] = tw[t_len - 1 - i];
            int qpos = K - i;
            if (qpos >= 0 && qpos < q_len)
                inj[(size_t)i * n_sel + j] = qw[qpos];
        }
    }
}

extern "C" void kaln_frags_se_batch_crc(
    void* const* handles, const int32_t* tpl_ids, const int64_t* tpl_off,
    const uint8_t* codes_flat, const int64_t* codes_off,
    const int32_t* npos_flat, const int64_t* npos_off,
    const int32_t* qbounds, const uint8_t* arc_flags,
    const uint8_t* crc_flat, const int64_t* crc_off, int n_reads, int M,
    int MM, int U, int W1, const int32_t* dmat, int kmersize, int minlen,
    int mq, double scoreT, double mrc, int n_threads, int32_t* out_nhits,
    long long* out_best_score, double* out_best_frac, int32_t* out_tpl,
    int32_t* out_start, int32_t* out_end, long long* out_score,
    int32_t* out_len) {
    kaln_frags_se_batch_mf(handles, tpl_ids, tpl_off, codes_flat,
                           codes_off, npos_flat, npos_off, qbounds,
                           arc_flags, crc_flat, crc_off, n_reads, M, MM,
                           U, W1, dmat, kmersize, minlen, mq, scoreT,
                           mrc, n_threads, NAN, out_nhits,
                           out_best_score, out_best_frac, out_tpl,
                           out_start, out_end, out_score, out_len);
}

extern "C" void kaln_frags_se_batch(
    void* const* handles, const int32_t* tpl_ids, const int64_t* tpl_off,
    const uint8_t* codes_flat, const int64_t* codes_off,
    const int32_t* npos_flat, const int64_t* npos_off,
    const int32_t* qbounds, const uint8_t* arc_flags, int n_reads, int M,
    int MM, int U, int W1, const int32_t* dmat, int kmersize, int minlen,
    int mq, double scoreT, double mrc, int n_threads, int32_t* out_nhits,
    long long* out_best_score, double* out_best_frac, int32_t* out_tpl,
    int32_t* out_start, int32_t* out_end, long long* out_score,
    int32_t* out_len) {
    kaln_frags_se_batch_crc(handles, tpl_ids, tpl_off, codes_flat,
                            codes_off, npos_flat, npos_off, qbounds,
                            arc_flags, nullptr, nullptr, n_reads, M, MM,
                            U, W1, dmat, kmersize, minlen, mq, scoreT,
                            mrc, n_threads, out_nhits, out_best_score,
                            out_best_frac, out_tpl, out_start, out_end,
                            out_score, out_len);
}

// Cached KMA_score: collect + chain + walk-stash + content-dedupe + NW
// (the SE batch's phase A+B for a single alignment).  `tag`
// discriminates query streams sharing one cache (mate x orientation);
// the cache scope (keyA/centries) is caller-owned and must only span
// alignments of the same query set.
static void kma_score_cached(
    TIndex& T, const uint8_t* q_used, const int32_t* np, int n_np,
    int q_len, int q_start, int q_end, int mq, const Penal& pen,
    Points& pts, int use_points, uint8_t tag,
    std::vector<ChainSeg>& segS, std::vector<GapGeom>& gapS,
    std::vector<uint8_t>& keyA, std::vector<AlnCacheEnt>& centries,
    std::vector<uint8_t>& kb, std::vector<uint8_t>& Ebuf,
    std::vector<ll>& Dbuf, AlnStat* out) {
    const bool prof = aln_prof_on();
    double pt0 = prof ? prof_now() : 0.0;
    int t_len = T.len;
    if (!use_points) {
        pts.clear_all();
        collect_seeds_comp(T, q_used, np, n_np, q_len, q_start, q_end,
                           pts);
        pts.len = (int)pts.n();
    }
    if (prof) {
        double t1 = prof_now();
        g_p_collect += (ll)((t1 - pt0) * 1e9);
        g_p_calls += 1;
        g_p_seeds += pts.len;
        pt0 = t1;
    }
    out->score = 0;
    out->pos = 0;
    out->len = 1;
    out->match = 0;
    out->tGaps = 0;
    out->qGaps = 0;
    out->mapQ = 0;
    if (!pts.len) {
        pts.len = 0;
        return;
    }
    int start, mapQ;
    chain_seeds(pts, q_len, t_len, T.k, pen,
                g_chain_circular.load() != 0, start, mapQ);
    if (prof) {
        double t1 = prof_now();
        g_p_chain += (ll)((t1 - pt0) * 1e9);
        pt0 = t1;
    }
    out->mapQ = mapQ;
    if (mapQ < mq || pts.score[start] < T.k) {
        pts.len = 0;
        return;
    }
    trim_seeds(pts, start, 0, false);
    segS.clear();
    gapS.clear();
    int lead_te = pts.tStart[start] - 1;
    int lead_qe = pts.qStart[start];
    int tail_ts = 0, tail_qs = 0;
    bool aborted = false;
    for (;;) {
        segS.push_back({pts.qStart[start], pts.qEnd[start]});
        if (!pts.next[start]) {
            tail_ts = pts.tEnd[start] - 1;
            tail_qs = pts.qEnd[start];
            break;
        }
        int q_s = pts.qEnd[start];
        int t_sv = pts.tEnd[start] - 1;
        start = pts.next[start];
        if (pts.qStart[start] < q_s) {
            pts.tStart[start] += q_s - pts.qStart[start];
            pts.qStart[start] = q_s;
        }
        int t_ev = pts.tStart[start] - 1;
        int t_l;
        if (t_ev < t_sv) {
            if (t_sv <= pts.tEnd[start]) {
                pts.qStart[start] += t_sv - t_ev;
                t_ev = t_sv;
                t_l = 0;
            } else {
                t_l = t_len - t_sv + t_ev;
            }
        } else {
            t_l = t_ev - t_sv;
        }
        int q_ev = pts.qStart[start];
        if ((ll)std::abs(t_l - q_ev + q_s) * pen.U > (ll)q_len * pen.M
            || t_l > q_len || q_ev - q_s > (q_len >> 1)) {
            aborted = true;
            break;
        }
        gapS.push_back({t_sv, t_ev, q_s, q_ev, t_l});
    }
    if (prof) g_p_walk += (ll)((prof_now() - pt0) * 1e9);
    pts.len = 0;
    if (aborted)
        return;
    double kt0 = prof ? prof_now() : 0.0;
    chain_key(kb, tag, T, segS.data(), (int)segS.size(), gapS.data(),
              lead_te, lead_qe, tail_ts, tail_qs, q_len);
    uint64_t h = fnv1a(kb.data(), kb.size(), 0xcbf29ce484222325ULL);
    AlnCacheEnt* hit = nullptr;
    for (auto& e : centries)
        if (e.hash == h && e.key_len == (int)kb.size()
            && memcmp(keyA.data() + e.key_off, kb.data(), kb.size())
                       == 0) {
            hit = &e;
            break;
        }
    if (prof) g_p_key += (ll)((prof_now() - kt0) * 1e9);
    if (hit) {
        out->score = hit->score;
        out->len = hit->len;
        out->match = hit->match;
        out->tGaps = hit->tGaps;
        out->qGaps = hit->qGaps;
        out->pos = lead_te - hit->pos_delta;
        if (prof) g_p_skipped += 1;
        return;
    }
    AlnStat st;
    nw_score_chain(T, q_used, q_len, pen, segS.data(), (int)segS.size(),
                   gapS.data(), lead_te, lead_qe, tail_ts, tail_qs, Ebuf,
                   Dbuf, st);
    st.mapQ = mapQ;
    *out = st;
    AlnCacheEnt e;
    e.hash = h;
    e.key_off = (int)keyA.size();
    e.key_len = (int)kb.size();
    keyA.insert(keyA.end(), kb.begin(), kb.end());
    e.score = st.score;
    e.len = st.len;
    e.match = st.match;
    e.tGaps = st.tGaps;
    e.qGaps = st.qGaps;
    e.pos_delta = lead_te - st.pos;
    centries.push_back(e);
}

// ------------------------------------------------- batched PE mate scoring
//
// The shared per-(pair, template) mate scoring of alnFragsUnionPE /
// PenaltyPE / ForcePE (alnfrags.c:1246-1404, 1660-1786, 2010-2125): both
// mates KMA_score'd per candidate with the reference orientation rules
// (prefix-flip on the first negative id, or per-template anker_rc in arc
// mode, which sign-mutates tpl_ids like alnfrags.c:1286).  RAW AlnStat
// fields per mate are returned; the Python combiners apply each mode's
// gates, Wl bonuses and pairing logic.
extern "C" void kaln_pe_score_batch(
    void* const* handles,        // [total_tpl] TIndex*
    int32_t* tpl_ids,            // [total_tpl] signed; MUTATED (arc)
    const int64_t* tpl_off,      // [n_pairs+1]
    const uint8_t* a_flat, const int64_t* a_off,
    const uint8_t* b_flat, const int64_t* b_off,
    const uint8_t* arc_flags,    // [n_pairs]
    int n_pairs,
    int M, int MM, int U, int W1, const int32_t* dmat,
    int mq, int n_threads,
    long long* o_sc1, int32_t* o_pos1, int32_t* o_len1,
    int32_t* o_tg1, int32_t* o_qg1,
    long long* o_sc2, int32_t* o_pos2, int32_t* o_len2,
    int32_t* o_tg2, int32_t* o_qg2,
    uint8_t* out_flipped,        // [n_pairs] final flip state
    // arc-path state gates (alnFragsForcePE's rc/minlen/mrc machine;
    // union/penalty pairs never carry arc, savekmers.c pair emits)
    int minlen, double mrc) {
    Penal pen;
    pen.M = M; pen.MM = MM; pen.U = U; pen.W1 = W1;
    for (int a = 0; a < 5; a++)
        for (int b = 0; b < 5; b++)
            pen.d[a][b] = dmat[a * 5 + b];

    // pair-locality permutation (see kaln_frags_se_batch_mf)
    std::vector<int> rperm(n_pairs);
    for (int i = 0; i < n_pairs; i++)
        rperm[i] = i;
    std::stable_sort(rperm.begin(), rperm.end(), [&](int a, int b) {
        int ta = tpl_off[a] < tpl_off[a + 1]
                     ? std::abs(tpl_ids[tpl_off[a]]) : INT_MAX;
        int tb = tpl_off[b] < tpl_off[b + 1]
                     ? std::abs(tpl_ids[tpl_off[b]]) : INT_MAX;
        return ta < tb;
    });

    std::atomic<int> next(0);
    auto worker = [&]() {
        Points pts;
        std::vector<uint8_t> Ebuf;
        std::vector<ll> Dbuf;
        std::vector<uint8_t> rca, rcb;
        std::vector<int32_t> npa, npar, npb, npbr;
        std::vector<ChainSeg> segS;
        std::vector<GapGeom> gapS;
        std::vector<uint8_t> keyA, kb;
        std::vector<AlnCacheEnt> centries;
        for (;;) {
            int ri = next.fetch_add(1);
            if (ri >= n_pairs) break;
            int r = rperm[ri];
            const uint8_t* qa = a_flat + a_off[r];
            int la = (int)(a_off[r + 1] - a_off[r]);
            const uint8_t* qb = b_flat + b_off[r];
            int lb = (int)(b_off[r + 1] - b_off[r]);
            rca.resize(la); rcb.resize(lb);
            npa.clear(); npb.clear();
            for (int i = 0; i < la; i++) {
                uint8_t c = qa[la - 1 - i];
                rca[i] = c < 4 ? (uint8_t)(3 - c) : c;
                if (qa[i] == 4) npa.push_back(i);
            }
            for (int i = 0; i < lb; i++) {
                uint8_t c = qb[lb - 1 - i];
                rcb[i] = c < 4 ? (uint8_t)(3 - c) : c;
                if (qb[i] == 4) npb.push_back(i);
            }
            npar.resize(npa.size());
            for (size_t i = 0; i < npa.size(); i++)
                npar[i] = la - 1 - npa[npa.size() - 1 - i];
            npbr.resize(npb.size());
            for (size_t i = 0; i < npb.size(); i++)
                npbr[i] = lb - 1 - npb[npb.size() - 1 - i];
            bool arc = arc_flags[r] != 0;
            bool flipped = false;
            // alnFragsForcePE's rc state doubles as the in-place strrc
            // gate (alnfrags.c:2001-2018): a negative template with
            // rc != 0 TOGGLES both mates' working orientation; the
            // qseq_fr/qseq_rr copies stay original-rc.  rc resets to 1
            // only after an arc candidate passes the mate-1 gate.
            int rc_state = 1;
            long long base = tpl_off[r];
            int ncand = (int)(tpl_off[r + 1] - base);
            keyA.clear();
            centries.clear();
            for (int ci = 0; ci < ncand; ci++) {
                long long slot = base + ci;
                TIndex& T = *(TIndex*)handles[slot];
                int tmpl = tpl_ids[slot];
                if (arc) {
                    if (tmpl < 0 && rc_state)
                        flipped = !flipped;
                } else if (tmpl < 0 && !flipped) {
                    flipped = true;
                }
                const uint8_t* cur_a; const int32_t* na; int nna;
                const uint8_t* cur_b; const int32_t* nb; int nnb;
                pts.clear_all();
                pts.len = 0;
                int use_pts = 0;
                if (arc) {
                    const uint8_t* qa_cur = flipped ? rca.data() : qa;
                    const int32_t* na_cur =
                        flipped ? npar.data() : npa.data();
                    int npout = 0;
                    int rc = anker_rc_comp_impl(
                        T, qa_cur, rca.data(), na_cur, (int)npa.size(),
                        npar.data(), (int)npar.size(), la, 0, la, 1,
                        &npout, pts);
                    rc_state = rc;
                    pts.len = npout;
                    use_pts = pts.len ? 1 : 0;
                    if (rc < 0) {
                        cur_a = rca.data(); na = npar.data();
                        nna = (int)npar.size();
                        cur_b = rcb.data(); nb = npbr.data();
                        nnb = (int)npbr.size();
                    } else if (rc > 0) {
                        tpl_ids[slot] = -tpl_ids[slot];
                        cur_a = qa_cur; na = na_cur;
                        nna = (int)npa.size();
                        cur_b = flipped ? rcb.data() : qb;
                        nb = flipped ? npbr.data() : npb.data();
                        nnb = (int)npb.size();
                    } else {
                        cur_a = cur_b = nullptr;
                        na = nb = nullptr; nna = nnb = 0;
                    }
                } else {
                    cur_a = flipped ? rca.data() : qa;
                    na = flipped ? npar.data() : npa.data();
                    nna = (int)npa.size();
                    cur_b = flipped ? rcb.data() : qb;
                    nb = flipped ? npbr.data() : npb.data();
                    nnb = (int)npb.size();
                }
                AlnStat st;
                st.score = 0; st.pos = 0; st.len = 0; st.match = 0;
                st.tGaps = 0; st.qGaps = 0; st.mapQ = 0;
                if (cur_a) {
                    kma_score_cached(T, cur_a, na, nna, la, 0, la, mq,
                                     pen, pts, use_pts,
                                     cur_a == qa ? 0 : 1, segS, gapS,
                                     keyA, centries, kb, Ebuf, Dbuf, &st);
                }
                o_sc1[slot] = st.score;
                o_pos1[slot] = st.pos;
                o_len1[slot] = st.len;
                o_tg1[slot] = st.tGaps;
                o_qg1[slot] = st.qGaps;
                if (arc && cur_a) {
                    // rc resets to 1 only when the mate-1 gate passes
                    // (alnfrags.c:2055-2075)
                    double t_len_d = (double)T.len;
                    bool mr = (mrc * la <= st.len - st.qGaps)
                              || (mrc * t_len_d <= st.len - st.tGaps);
                    if (0 < st.score && minlen <= st.len && mr)
                        rc_state = 1;
                }
                // mate 2 (fresh seed state; alnfrags points->len = 0)
                pts.clear_all();
                pts.len = 0;
                st.score = 0; st.pos = 0; st.len = 0; st.match = 0;
                st.tGaps = 0; st.qGaps = 0; st.mapQ = 0;
                if (cur_b) {
                    kma_score_cached(T, cur_b, nb, nnb, lb, 0, lb, mq,
                                     pen, pts, 0,
                                     cur_b == qb ? 2 : 3, segS, gapS,
                                     keyA, centries, kb, Ebuf, Dbuf, &st);
                }
                o_sc2[slot] = st.score;
                o_pos2[slot] = st.pos;
                o_len2[slot] = st.len;
                o_tg2[slot] = st.tGaps;
                o_qg2[slot] = st.qGaps;
            }
            out_flipped[r] = flipped ? 1 : 0;
        }
    };
    int nt = n_threads < 1 ? 1 : n_threads;
    if (nt == 1) {
        worker();
        return;
    }
    std::vector<std::thread> th;
    th.reserve(nt);
    for (int i = 0; i < nt; i++) th.emplace_back(worker);
    for (auto& t : th) t.join();
}

// from native/kma_assem.cpp (linked into this .so as well)
extern "C" long long kassem_aln_to_mat(long long *counts, long long *next_,
                                       long long mat_len, int t_len,
                                       const unsigned char *aln_t,
                                       const unsigned char *aln_q,
                                       long long aln_len, int start);
extern "C" void kassem_aln_to_mat_dense(long long *counts,
                                        long long *next_,
                                        const unsigned char *aln_t,
                                        const unsigned char *aln_q,
                                        long long aln_len, int start);

// ------------------------------------------ per-template assembly batch
//
// The frag loop of assemble_KMA (assembly.c:1689-2127 / pipeline.py
// assemble_template) without sam/xml writers: per fragment, optional
// anker_rc orientation rescue, KMA() with traceback, the
// minlen/mrc/scoreT gates with the RAW Wl end penalties, and alnToMat
// applied DIRECTLY to the caller's assembly matrix (which the caller
// pre-grows to mat_len + sum(q_len)).  Per-frag stats come back for the
// frag_row writer.  o_acc: 0 = skipped, 1 = accepted (matrix updated),
// 2 = gated out.
// XML hit sink (hitXML, xml.c:147-230).  The reference prints the
// assembly thread's REUSED Aln buffers with %s, so each Hsp string
// runs past the current alignment into leftover bytes of earlier
// (longer) alignments until the first NUL; the buffer lifecycle
// (overlay of code bytes by every alignment, in-place ASCII conversion
// by each printed hit, doubling reallocation that resets the content,
// assembly.c:398-411) is emulated for byte parity -- the sink persists
// across templates like the reference's thread buffers.
// Undefined reference behavior deliberately NOT copied (see
// kma_tpu/out/xmlout.py): Hsp_bit-score prints the never-assigned
// smalloc'd aligned->score (xml.c:210) and the smalloc'd buffers start
// with recycled-heap garbage; we print the fresh realignment score and
// start zeroed, bit-identical to the python writer.
struct KXmlSink {
    std::vector<uint8_t> bt, bs, bq;
    std::vector<uint8_t> out;
    ll delta = 1024;
    ll num = 0;
    int d[5][5];
    int W1pos = 0, Upos = 0;
    void alloc() {
        size_t cap = (size_t)((delta + 1) << 1);
        bt.assign(cap, 0);
        bs.assign(cap, 0);
        bq.assign(cap, 0);
    }
};

extern "C" void* kxml_create(const int32_t* dmat, int W1, int U) {
    KXmlSink* x = new KXmlSink;
    for (int a = 0; a < 5; a++)
        for (int b = 0; b < 5; b++)
            x->d[a][b] = dmat[a * 5 + b];
    x->W1pos = 0 < W1;
    x->Upos = 0 < U;
    x->alloc();
    return x;
}
extern "C" void kxml_free(void* s) { delete (KXmlSink*)s; }
extern "C" long long kxml_rows_len(void* s) {
    return (ll)((KXmlSink*)s)->out.size();
}
extern "C" void kxml_rows_fetch(void* s, uint8_t* buf) {
    KXmlSink* x = (KXmlSink*)s;
    if (!x->out.empty())
        memcpy(buf, x->out.data(), x->out.size());
    x->out.clear();
}

static void kxml_prealloc(KXmlSink* x, ll q_len) {
    // assembly.c:398-411: fresh (zeroed) buffers for a longer read
    if (x->delta < q_len) {
        x->delta = q_len << 1;
        x->alloc();
    }
}

static void kxml_overlay(KXmlSink* x, const Aligned& a) {
    // every KMA call writes this alignment's CODE bytes; only s gets a
    // NUL (align.c:502); t/q leak
    size_t ln = a.t.size();
    memcpy(x->bt.data(), a.t.data(), ln);
    memcpy(x->bs.data(), a.s.data(), ln);
    memcpy(x->bq.data(), a.q.data(), ln);
    x->bs[ln] = 0;
}

static void kxml_append(std::vector<uint8_t>& o, const char* fmt, ...) {
    char tmp[512];
    va_list ap;
    va_start(ap, fmt);
    int n = vsnprintf(tmp, sizeof tmp, fmt, ap);
    va_end(ap);
    if (n > 0)
        o.insert(o.end(), tmp, tmp + n);
}

static void kxml_hit(KXmlSink* x, ll tpl, const uint8_t* hdr, ll hdr_len,
                     const Aligned& a, const AlnStat& st, int flag) {
    static const char B2C[6] = {'A', 'C', 'G', 'T', 'N', '-'};
    ll ln = (ll)a.t.size();
    ll Ms = 0, MMs = 0, W1s = 0, Us = 0, pos = 0;
    int gap = 0;
    for (ll i = 0; i < ln; ++i) {
        uint8_t t = a.t[i], s = a.s[i], q = a.q[i];
        if (s == '_') {
            x->bs[i] = ' ';
            if (t == 5 || q == 5) {
                if (gap)
                    ++Us;
                else {
                    ++W1s;
                    gap = 1;
                }
            } else {
                ++MMs;
                if (0 < x->d[t][q])
                    ++pos;
                gap = 1;
            }
        } else {
            x->bs[i] = s;
            ++Ms;
            if (0 < x->d[t][q])
                ++pos;
            gap = 1;
        }
        x->bt[i] = (uint8_t)B2C[t];
        x->bq[i] = (uint8_t)B2C[q];
    }
    pos += W1s * x->W1pos + Us * x->Upos;

    ++x->num;
    ll qn = 0;
    while (qn < hdr_len && hdr[qn] != 0)
        ++qn;
    auto cstr_len = [](const std::vector<uint8_t>& b) {
        size_t e = 0;
        while (e < b.size() && b[e] != 0)
            ++e;
        return (ll)e;
    };
    std::vector<uint8_t>& o = x->out;
    kxml_append(o, "<Hit>\n\t<Hit_num>%lld</Hit_num>\n"
                   "\t<Hit_id>gnl|BL_ORD_ID|%lld</Hit_id>\n",
                (long long)x->num, (long long)(tpl + 1));
    kxml_append(o, "\t<Hit_def>");
    o.insert(o.end(), hdr, hdr + qn);
    kxml_append(o, "</Hit_def>\n\t<Hit_accession>%lld</Hit_accession>\n"
                   "\t<Hit_len>%lld</Hit_len>\n\t<Hit_hsps>\n"
                   "\t\t<Hsp>\n\t\t\t<Hsp_num>1</Hsp_num>\n",
                (long long)tpl, (long long)ln);
    kxml_append(o, "\t\t\t<Hsp_bit-score>%lld</Hsp_bit-score>\n"
                   "\t\t\t<Hsp_score>%d</Hsp_score>\n"
                   "\t\t\t<Hsp_evalue>%f</Hsp_evalue>\n",
                (long long)st.score, st.mapQ,
                pow(10.0, st.mapQ / -10.0));
    ll qf = (flag & 16) ? a.end : a.start;
    ll qt = (flag & 16) ? a.start : a.end;
    kxml_append(o, "\t\t\t<Hsp_query-from>%lld</Hsp_query-from>\n"
                   "\t\t\t<Hsp_query-to>%lld</Hsp_query-to>\n"
                   "\t\t\t<Hsp_hit-from>%d</Hsp_hit-from>\n"
                   "\t\t\t<Hsp_hit-to>%d</Hsp_hit-to>\n",
                (long long)(qf + 1), (long long)(qt + 1), st.pos + 1,
                st.pos + st.len - st.tGaps + 1);
    kxml_append(o, "\t\t\t<Hsp_query-frame>%d</Hsp_query-frame>\n"
                   "\t\t\t<Hsp_hit-frame>%d</Hsp_hit-frame>\n"
                   "\t\t\t<Hsp_identity>%lld</Hsp_identity>\n"
                   "\t\t\t<Hsp_positive>%lld</Hsp_positive>\n"
                   "\t\t\t<Hsp_gaps>%lld</Hsp_gaps>\n"
                   "\t\t\t<Hsp_align-len>%lld</Hsp_align-len>\n",
                a.start % 3, st.pos % 3, (long long)Ms, (long long)pos,
                (long long)(W1s + Us), (long long)ln);
    kxml_append(o, "\t\t\t<Hsp_qseq>");
    o.insert(o.end(), x->bq.data(), x->bq.data() + cstr_len(x->bq));
    kxml_append(o, "</Hsp_qseq>\n\t\t\t<Hsp_hseq>");
    o.insert(o.end(), x->bt.data(), x->bt.data() + cstr_len(x->bt));
    kxml_append(o, "</Hsp_hseq>\n\t\t\t<Hsp_midline>");
    o.insert(o.end(), x->bs.data(), x->bs.data() + cstr_len(x->bs));
    kxml_append(o, "</Hsp_midline>\n\t\t</Hsp>\n\t</Hit_hsps>\n"
                   "</Hit>\n");
}

// SAM row emission shared by the assembly loops (samwrite,
// sam.c:114-211): qname up to NUL-then-tab, =/X/I/D cigar with soft
// clips, ET/AS tags.  Returns bytes written or -1 on overflow.
static ll sam_emit_row(uint8_t* buf, ll cap, ll w,
                       const uint8_t* hdr, ll hdr_len,
                       const uint8_t* name, ll name_len,
                       const uint8_t* seq_codes, ll q_len, int flag,
                       int mapq, ll pos, ll tlen, const Aligned* aligned,
                       int et, ll as_score) {
    static const char B2C[6] = {'A', 'C', 'G', 'T', 'N', '-'};
    ll qn = 0;
    while (qn < hdr_len && hdr[qn] != 0 && hdr[qn] != '\t')
        ++qn;
    ll need = qn + name_len + q_len * 2 + (aligned ? (ll)aligned->t.size() * 8 : 8)
              + 128;
    if (w + need > cap)
        return -1;
    memcpy(buf + w, hdr, (size_t)qn);
    w += qn;
    w += snprintf((char*)buf + w, 32, "\t%d\t", flag);
    if (name) {
        memcpy(buf + w, name, (size_t)name_len);
        w += name_len;
    } else {
        buf[w++] = '*';
    }
    w += snprintf((char*)buf + w, 48, "\t%lld\t%d\t", (long long)pos,
                  mapq);
    if (aligned) {
        // makeCigar (sam.c:30-98)
        ll ln = (ll)aligned->t.size();
        if (!ln && !aligned->start && !aligned->end) {
            buf[w++] = '*';
        } else {
            if (aligned->start)
                w += snprintf((char*)buf + w, 24, "%dS", aligned->start);
            if (ln) {
                auto op_at = [&](ll i) -> char {
                    if (aligned->s[i] == '|')
                        return '=';
                    if (aligned->t[i] == 5)
                        return 'I';
                    if (aligned->q[i] == 5)
                        return 'D';
                    return 'X';
                };
                char pop = op_at(0);
                ll rep = 1;
                for (ll i = 1; i < ln; ++i) {
                    char op = op_at(i);
                    if (op == pop) {
                        ++rep;
                    } else {
                        w += snprintf((char*)buf + w, 24, "%lld%c",
                                      (long long)rep, pop);
                        pop = op;
                        rep = 1;
                    }
                }
                w += snprintf((char*)buf + w, 24, "%lld%c",
                              (long long)rep, pop);
            }
            if (aligned->end)
                w += snprintf((char*)buf + w, 24, "%dS", aligned->end);
        }
    } else {
        buf[w++] = '*';
    }
    w += snprintf((char*)buf + w, 40, "\t*\t0\t%lld\t", (long long)tlen);
    for (ll j = 0; j < q_len; ++j)
        buf[w++] = (uint8_t)B2C[seq_codes[j]];
    w += snprintf((char*)buf + w, 64, "\t*\tET:i:%d\tAS:i:%lld\n", et,
                  (long long)as_score);
    return w;
}

extern "C" long long kaln_sam_emit_row(
    uint8_t* buf, long long cap, long long w, const uint8_t* hdr,
    long long hdr_len, const uint8_t* name, long long name_len,
    const uint8_t* seq_codes, long long q_len, int flag, int mapq,
    long long pos, long long tlen, const void* aligned, int et,
    long long as_score) {
    return sam_emit_row(buf, cap, w, hdr, hdr_len, name, name_len,
                        seq_codes, q_len, flag, mapq, pos, tlen,
                        (const Aligned*)aligned, et, as_score);
}

// ---- device pileup export (ops/pileup.py consumer) ------------------------
// Armed per assembly call: when set, the DENSE matrix scatter
// (alnToMatDense, assembly.c:1446-1497) is SKIPPED for rows that fit
// the export buffers -- the caller ships them to the device and adds
// the returned delta matrix instead (adds commute; +1 saturation at
// USHRT_MAX commutes with sum-then-clip).  Rows that do not fit fall
// back to the host scatter mid-call, so the result is always complete.
namespace {
struct PileupExport {
    uint8_t *t = nullptr, *q = nullptr;
    long long *off = nullptr;
    int32_t *start = nullptr;
    long long cap_bytes = 0, cap_rows = 0;
    long long rows = 0, used = 0;
    int over = 0;
};
PileupExport g_pexp;
}  // namespace

extern "C" void kassem_set_pileup_export(uint8_t *t, uint8_t *q,
                                         long long *off, int32_t *start,
                                         long long cap_bytes,
                                         long long cap_rows) {
    g_pexp.t = t;
    g_pexp.q = q;
    g_pexp.off = off;
    g_pexp.start = start;
    g_pexp.cap_bytes = cap_bytes;
    g_pexp.cap_rows = cap_rows;
    g_pexp.rows = 0;
    g_pexp.used = 0;
    g_pexp.over = 0;
    if (off)
        off[0] = 0;
}

extern "C" void kassem_pileup_export_take(long long *rows,
                                          long long *used, int *over) {
    *rows = g_pexp.rows;
    *used = g_pexp.used;
    *over = g_pexp.over;
    g_pexp = PileupExport();
}

extern "C" long long kassem_template_frags_sam(
    void* h, const uint8_t* codes_flat, const int64_t* codes_off,
    const int32_t* qbounds,   // [n,2] q_start,q_end (header tails)
    const int32_t* fstats,    // [n,3] score, start, end (spool record)
    int n_frags,
    int M, int MM, int U, int W1, const int32_t* dmat, int Wl_raw,
    int minlen, int mq, double scoreT, double mrc,
    int circular, int ts, int skip_tails, int dense,
    long long* counts, long long* next_, long long mat_len, int t_len_,
    uint8_t* o_acc, uint8_t* o_rc, long long* o_read_score,
    long long* o_mat_score,
    int32_t* o_start, int32_t* o_end, int32_t* o_len,
    // SAM emission (0 = off): rows for every fragment in order
    // (accepted, rejected-with-score, unmapped unless sam_mask & 2096)
    int sam_mask, const uint8_t* hdr_flat, const int64_t* hdr_off,
    const int32_t* bhs, const int32_t* sflags, const uint8_t* name,
    long long name_len, uint8_t* sam_buf, long long sam_cap,
    long long* sam_len,
    // XML hit sink (kxml_create); rows for accepted frags
    void* xml_sink, long long xml_tpl) {
    TIndex& T = *(TIndex*)h;
    int t_len = T.len;
    KXmlSink* xs = (KXmlSink*)xml_sink;
    ll sw = 0;
    if (sam_len)
        *sam_len = 0;
    (void)t_len_;
    Penal pen;
    pen.M = M; pen.MM = MM; pen.U = U; pen.W1 = W1;
    for (int a = 0; a < 5; a++)
        for (int b = 0; b < 5; b++)
            pen.d[a][b] = dmat[a * 5 + b];
    Points pts;
    std::vector<uint8_t> Ebuf;
    std::vector<ll> Dbuf;
    std::vector<uint8_t> rcq;
    Aligned aligned;

    for (int i = 0; i < n_frags; ++i) {
        const uint8_t* q = codes_flat + codes_off[i];
        int q_len = (int)(codes_off[i + 1] - codes_off[i]);
        int q_start = qbounds[2 * i], q_end = qbounds[2 * i + 1];
        int stats2 = fstats[3 * i + 1], stats3 = fstats[3 * i + 2];
        ll read_score = fstats[3 * i];
        if (xs)
            kxml_prealloc(xs, q_len);
        o_acc[i] = 0;
        o_rc[i] = 0;
        pts.clear_all();
        pts.len = 0;
        const uint8_t* cur = q;
        int use_pts = 0;
        if (!read_score) {
            // anker_rc rescue (align.c:780-991)
            rcq.resize(q_len);
            for (int x2 = 0; x2 < q_len; x2++) {
                uint8_t c = q[q_len - 1 - x2];
                rcq[x2] = c < 4 ? (uint8_t)(3 - c) : c;
            }
            int npout = 0;
            int res = anker_rc_bytes_impl(T, q, rcq.data(), q_len,
                                          q_start, q_end, 0, &npout, pts);
            pts.len = npout;
            if (res == 0)
                continue;  // proceed = False
            if (res < 0) {
                cur = rcq.data();
                o_rc[i] = 1;
            }
            use_pts = pts.len ? 1 : 0;
        }
        if (stats3 <= stats2) {
            stats2 = 0;
            stats3 = t_len;
        }
        AlnStat st;
        st.score = 0; st.pos = 0; st.len = 0; st.match = 0;
        st.tGaps = 0; st.qGaps = 0; st.mapQ = 0;
        kaln_align_impl(T, cur, q_len, q_start, q_end, stats2,
                        stats3 < t_len ? stats3 : t_len, mq, pen,
                        nullptr, 0, 1, use_pts, circular, ts, skip_tails,
                        pts, Ebuf, Dbuf, &aligned, &st);
        if (xs)
            kxml_overlay(xs, aligned);
        int aln_len = st.len;
        int start = st.pos;
        int end = start + aln_len - st.tGaps;
        if (t_len < end)
            end -= t_len;
        read_score = st.score;
        // assembly.c:1946-1953: RAW (negative) Wl per touched end
        if (start == 0)
            read_score += Wl_raw;
        if (end == t_len)
            read_score += Wl_raw;
        double score;
        bool mr = (mrc * q_len <= st.len - st.qGaps)
                  || (mrc * t_len <= st.len - st.tGaps);
        if (minlen <= aln_len && mr) {
            score = 1.0 * (double)read_score / (double)aln_len;
        } else {
            read_score = 0;
            score = 0.0;
        }
        o_read_score[i] = read_score;
        o_mat_score[i] = st.score;
        o_start[i] = start;
        o_end[i] = t_len < end ? end - t_len : end;
        o_len[i] = aln_len;
        if (0 < read_score && scoreT <= score) {
            o_acc[i] = 1;
            if (xs)
                kxml_hit(xs, xml_tpl, hdr_flat + hdr_off[i],
                         hdr_off[i + 1] - hdr_off[i], aligned, st,
                         sflags[i]);
            if (sam_mask && sw >= 0) {
                int mq_ = st.mapQ < 254 ? st.mapQ : 254;
                ll pos1 = start + 1;
                ll end_adj = t_len < end ? end - t_len : end;
                sw = sam_emit_row(sam_buf, sam_cap, sw,
                                  hdr_flat + hdr_off[i],
                                  hdr_off[i + 1] - hdr_off[i], name,
                                  name_len, cur, q_len, sflags[i], mq_,
                                  pos1, end_adj - pos1, &aligned, bhs[i],
                                  read_score);
            }
            if (dense) {
                ll al = (ll)aligned.t.size();
                if (g_pexp.t && !g_pexp.over
                    && g_pexp.rows < g_pexp.cap_rows
                    && g_pexp.used + al <= g_pexp.cap_bytes) {
                    memcpy(g_pexp.t + g_pexp.used, aligned.t.data(),
                           (size_t)al);
                    memcpy(g_pexp.q + g_pexp.used, aligned.q.data(),
                           (size_t)al);
                    g_pexp.used += al;
                    g_pexp.start[g_pexp.rows] = st.pos;
                    g_pexp.off[++g_pexp.rows] = g_pexp.used;
                } else {
                    if (g_pexp.t)
                        g_pexp.over = 1;
                    kassem_aln_to_mat_dense(counts, next_,
                                            aligned.t.data(),
                                            aligned.q.data(), al,
                                            st.pos);
                }
            } else
                mat_len = kassem_aln_to_mat(counts, next_, mat_len, t_len,
                                            aligned.t.data(),
                                            aligned.q.data(),
                                            (long long)aligned.t.size(),
                                            st.pos);
        } else {
            o_acc[i] = 2;
            if (sam_mask && !(sam_mask & 2096) && sw >= 0) {
                if (read_score) {
                    int mq_ = st.mapQ < 254 ? st.mapQ : 254;
                    ll pos1 = start + 1;
                    ll end_adj = t_len < end ? end - t_len : end;
                    sw = sam_emit_row(sam_buf, sam_cap, sw,
                                      hdr_flat + hdr_off[i],
                                      hdr_off[i + 1] - hdr_off[i], name,
                                      name_len, cur, q_len, sflags[i],
                                      mq_, pos1, end_adj - pos1,
                                      &aligned, bhs[i], read_score);
                } else {
                    sw = sam_emit_row(sam_buf, sam_cap, sw,
                                      hdr_flat + hdr_off[i],
                                      hdr_off[i + 1] - hdr_off[i], name,
                                      name_len, cur, q_len,
                                      sflags[i] | 4, 0, 0, 0, nullptr,
                                      bhs[i], 0);
                }
            }
        }
    }
    if (sam_len)
        *sam_len = sw;
    return mat_len;
}

// back-compat entry: the assembly loop without SAM emission
extern "C" long long kassem_template_frags(
    void* h, const uint8_t* codes_flat, const int64_t* codes_off,
    const int32_t* qbounds, const int32_t* fstats, int n_frags,
    int M, int MM, int U, int W1, const int32_t* dmat, int Wl_raw,
    int minlen, int mq, double scoreT, double mrc,
    int circular, int ts, int skip_tails, int dense,
    long long* counts, long long* next_, long long mat_len, int t_len_,
    uint8_t* o_acc, uint8_t* o_rc, long long* o_read_score,
    long long* o_mat_score,
    int32_t* o_start, int32_t* o_end, int32_t* o_len) {
    return kassem_template_frags_sam(
        h, codes_flat, codes_off, qbounds, fstats, n_frags, M, MM, U, W1,
        dmat, Wl_raw, minlen, mq, scoreT, mrc, circular, ts, skip_tails,
        dense, counts, next_, mat_len, t_len_, o_acc, o_rc, o_read_score,
        o_mat_score, o_start, o_end, o_len, 0, nullptr, nullptr, nullptr,
        nullptr, nullptr, 0, nullptr, 0, nullptr, nullptr, 0);
}

