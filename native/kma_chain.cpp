// Native default-mode chain scanner for kma_tpu.
//
// Exact port of kma_tpu/mapping/chain_scan.py (itself golden-tested
// against the reference's save_kmers_chain, savekmers.c:5127-5944 and
// kmeranker.c), which remains the semantics reference and the fallback.
// Handles plain-kmer DBs (flag&3 == 0) without proxi; the Python path
// keeps cmer modes, proxi and the sparse chain.
//
// All score arithmetic is int64 (the Python ints) and the
// length-corrected comparisons are IEEE doubles, so nan/inf behavior on
// deCon's out-of-bounds zero lengths matches both Python and C.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct KIdx {
    const void *exist;
    const void *key_index;
    const void *value_index;
    const void *values;
    int exist_es, key_es, vidx_es, val_es; // element sizes (bytes)
    uint64_t null_index;
    uint64_t smask; // size - 1
    uint64_t mmask; // idx.mask = (1 << 2*mlen) - 1
    uint64_t kroll; // (1 << 2*k) - 1 rolling-kmer mask
    int mega;
    int use_murmur; // idx.flag != 0
    int cmode;      // flag & 3: 1 = HC, 2 = minimizer, 3 = both
    int k;
    int mlen;
    const int64_t *template_lengths;
    // penalties
    int64_t M, MM, U, W1, Wl;
};

inline uint64_t get_u(const void *a, int es, uint64_t i) {
    return es == 4 ? (uint64_t)((const uint32_t *)a)[i]
                   : ((const uint64_t *)a)[i];
}

inline int64_t val_at(const KIdx *x, int64_t i) {
    return x->val_es == 2 ? (int64_t)((const uint16_t *)x->values)[i]
                          : (int64_t)((const uint32_t *)x->values)[i];
}

inline uint64_t murmur64(uint64_t v) {
    v = (v ^ 3323198485ull) * 0x5bd1e995ull;
    return v ^ (v >> 15);
}

// hashMap_getGlobal (hashmapkma.c:149 / scan.py lookup_voff)
int64_t lookup_voff(const KIdx *x, uint64_t kmer) {
    if (x->mega) {
        uint64_t pos = get_u(x->exist, x->exist_es, kmer & x->mmask);
        return pos == x->null_index ? -1 : (int64_t)pos;
    }
    uint64_t kpos = (x->use_murmur ? murmur64(kmer) : kmer) & x->smask;
    uint64_t pos = get_u(x->exist, x->exist_es, kpos);
    if (pos == x->null_index)
        return -1;
    for (;;) {
        uint64_t km = get_u(x->key_index, x->key_es, pos);
        if (km == kmer)
            return (int64_t)get_u(x->value_index, x->vidx_es, pos);
        uint64_t h = x->use_murmur ? murmur64(km) : km;
        if (kpos != (h & x->smask))
            return -1;
        ++pos;
    }
}

// Batched lookup_voff with software pipelining: the scalar probe chain
// (exist -> key_index -> value_index) is 2-3 dependent cache misses on
// an over-L2 table; issuing the independent per-window probes in three
// staged passes (hash+prefetch exist, read exist+prefetch keys, resolve)
// overlaps the misses.  out[j] = -1 for !ok[j] windows.
void lookup_voff_batch(const KIdx *x, const uint64_t *kmers,
                       const uint8_t *ok, int W, int64_t *out) {
    if (x->mega) {
        const int D = 8;
        for (int j = 0; j < W; ++j) {
            if (j + D < W && (!ok || ok[j + D]))
                __builtin_prefetch((const char *)x->exist +
                                   (kmers[j + D] & x->mmask) * x->exist_es);
            if (ok && !ok[j]) {
                out[j] = -1;
                continue;
            }
            uint64_t pos = get_u(x->exist, x->exist_es, kmers[j] & x->mmask);
            out[j] = pos == x->null_index ? -1 : (int64_t)pos;
        }
        return;
    }
    constexpr int T = 128;
    constexpr uint64_t SKIP = ~0ull; // > smask: never a valid slot
    uint64_t kpos[T];
    uint64_t pos[T];
    for (int base = 0; base < W; base += T) {
        int n = W - base < T ? W - base : T;
        for (int j = 0; j < n; ++j) {
            if (ok && !ok[base + j]) {
                kpos[j] = SKIP;
                continue;
            }
            uint64_t kp = (x->use_murmur ? murmur64(kmers[base + j])
                                         : kmers[base + j]) &
                          x->smask;
            kpos[j] = kp;
            __builtin_prefetch((const char *)x->exist + kp * x->exist_es);
        }
        for (int j = 0; j < n; ++j) {
            if (kpos[j] == SKIP) {
                pos[j] = x->null_index;
                continue;
            }
            uint64_t p = get_u(x->exist, x->exist_es, kpos[j]);
            pos[j] = p;
            if (p != x->null_index) {
                __builtin_prefetch((const char *)x->key_index +
                                   p * x->key_es);
                __builtin_prefetch((const char *)x->value_index +
                                   p * x->vidx_es);
            }
        }
        for (int j = 0; j < n; ++j) {
            uint64_t p = pos[j];
            if (p == x->null_index) {
                out[base + j] = -1;
                continue;
            }
            uint64_t kmer = kmers[base + j];
            for (;;) {
                uint64_t km = get_u(x->key_index, x->key_es, p);
                if (km == kmer) {
                    out[base + j] =
                        (int64_t)get_u(x->value_index, x->vidx_es, p);
                    break;
                }
                uint64_t h = x->use_murmur ? murmur64(km) : km;
                if (kpos[j] != (h & x->smask)) {
                    out[base + j] = -1;
                    break;
                }
                ++p;
            }
        }
    }
}

struct Anker {
    int start = 0;
    int end = 0;
    int64_t weight = 0;
    int64_t voff = -1;
    int64_t score = 0;
    double score_len = 0.0;
    int64_t len_len = 1;
    bool alive = true;
};

// getHmer (stdnuc.c:287-310): duplicate first base, append changes
inline uint64_t hmer_of(uint64_t kmer, int k, int *hlen) {
    int i = 2 * k - 2;
    uint64_t h = (kmer >> i) & 3;
    h = (h << 2) | h;
    int len = 1;
    i -= 2;
    while (i >= 0) {
        uint64_t nuc = (kmer >> i) & 3;
        if (nuc != (h & 3)) {
            h = (h << 2) | nuc;
            ++len;
        }
        i -= 2;
    }
    *hlen = len;
    return h;
}

// per-window hash KEYS + validity for one strand: plain k-mers, or the
// DB's cmer mode (getHmer / getMmer / getHMmer, stdnuc.c:287-421 --
// values match io/seq.py cmer_scan)
void window_kmers(const KIdx *x, const uint8_t *s, int seqlen,
                  std::vector<uint64_t> &kmers, std::vector<uint8_t> &ok) {
    int k = x->k;
    int W = seqlen - k + 1;
    kmers.assign(W > 0 ? W : 0, 0);
    ok.assign(W > 0 ? W : 0, 0);
    uint64_t km = 0;
    int lastN = -1;
    for (int i = 0; i < seqlen; ++i) {
        uint8_t c = s[i];
        km = ((km << 2) | (c == 4 ? 0 : c)) & x->kroll;
        if (c == 4)
            lastN = i;
        int j = i - k + 1;
        if (j >= 0) {
            kmers[j] = km;
            ok[j] = lastN < j;
        }
    }
    if (!x->cmode)
        return;
    uint64_t mm = ((uint64_t)1 << (2 * x->mlen)) - 1;
    for (int j = 0; j < W; ++j) {
        uint64_t raw = kmers[j];
        if (x->cmode == 2) { // minimizer over the window (getMmer)
            uint64_t out = raw & mm, cur = raw;
            for (int t = 0; t < k - x->mlen; ++t) {
                cur >>= 2;
                if ((cur & mm) < out)
                    out = cur & mm;
            }
            kmers[j] = out;
        } else if (x->cmode == 1) { // homopolymer compress (getHmer)
            int hlen;
            uint64_t h = hmer_of(raw, k, &hlen);
            kmers[j] = (k == 16) ? (h & 0xFFFFFFFFull) : h;
        } else { // both (getHMmer)
            int hlen;
            uint64_t h = hmer_of(raw, k, &hlen);
            uint64_t m = h & mm;
            if (x->mlen < hlen) {
                uint64_t hh = h >> 2;
                for (int t = 0; t < hlen - x->mlen; ++t) {
                    if ((hh & mm) < m)
                        m = hh & mm;
                    hh >>= 2;
                }
            }
            kmers[j] = m;
        }
    }
}

// _quick_hit (savekmers.c:2485-2495): stride-k probe across N segments
bool quick_hit(const KIdx *x, const uint8_t *s, int seqlen,
               const std::vector<uint64_t> &kmers,
               const std::vector<uint8_t> &ok) {
    int k = x->k;
    int j = 0;
    int e = 0;
    while (e <= seqlen) {
        int endN = seqlen;
        for (int t = e; t < seqlen; ++t)
            if (s[t] == 4) {
                endN = t;
                break;
            }
        int stop = endN - k + 1;
        while (j < stop) {
            if (ok[j] && lookup_voff(x, kmers[j]) >= 0)
                return true;
            j += k;
        }
        j = endN + 1;
        if (endN == seqlen)
            break;
        e = endN + 1;
    }
    return false;
}

// _tail_gaps (savekmers.c:5252-5330 replay from the last hit)
int tail_gaps(const uint8_t *s, int seqlen, int k, int w) {
    int seqend = seqlen - k + 1;
    int g = 0, j = w + 1, e = w + 1;
    for (;;) {
        int endN = seqlen;
        for (int t = e; t < seqlen; ++t)
            if (s[t] == 4) {
                endN = t;
                break;
            }
        while (j + k - 1 < endN) {
            ++g;
            ++j;
        }
        g += endN + 1 - j;
        j = endN + 1;
        if (j >= seqend)
            break;
        if (endN == seqlen)
            break;
        e = endN + 1;
    }
    return g;
}

// _quick_hit replay over precomputed per-window voffs (voff[j] >= 0 iff
// the window is N-free AND the hash hits -- identical to ok[j] && lookup)
bool quick_hit_voff(int k, const uint8_t *s, int seqlen,
                    const int64_t *voff, bool rc_strand) {
    int W = seqlen - k + 1;
    int j = 0;
    int e = 0;
    while (e <= seqlen) {
        int endN = seqlen;
        for (int t = e; t < seqlen; ++t)
            if (s[t] == 4) {
                endN = t;
                break;
            }
        int stop = endN - k + 1;
        while (j < stop) {
            // voff rows are iteration-indexed (fw window order); the rc
            // strand's window at rc-coordinate j lives at entry W-1-j
            if (voff[rc_strand ? (W - 1 - j) : j] >= 0)
                return true;
            j += k;
        }
        j = endN + 1;
        if (endN == seqlen)
            break;
        e = endN + 1;
    }
    return false;
}

// _collect_ankers (savekmers.c:5221-5450): one strand, fw coordinates.
// voff != nullptr supplies precomputed per-window values offsets (the
// device chain scanner's hash-lookup output); nullptr = native
// lookups.
// reference-shaped single-strand scan (savekmers.c:5221-5454) for plain
// k-mer DBs.  Segments come from the FORWARD N positions on BOTH strands
// (the rc scan is in forward notation); after every N crossing the rc
// window offset resets to seqlen - j instead of seqlen - k - j
// (savekmers.c:5443) so later rc windows read k-1 positions past their
// nominal span, including the 2-bit zero padding past the sequence end.
// That quirk is observable in chain scores of N-containing reads and is
// reproduced verbatim for byte parity.
static void collect_ankers_ref(const KIdx *x, const uint8_t *strand,
                               int seqlen, bool rc_strand, bool exhaustive,
                               std::vector<Anker> &out) {
    const int k = x->k;
    const int W = seqlen - k + 1;
    // this strand's N positions (probe segments, savekmers.c:5240/5346)
    static thread_local std::vector<int> sN;
    sN.clear();
    for (int i = 0; i < seqlen; ++i)
        if (strand[i] > 3)
            sN.push_back(i);
    bool hit = exhaustive;
    {
        int j = 0;
        size_t si = 0;
        while (!hit) {
            int endN = si < sN.size() ? sN[si] : seqlen;
            int stop = endN - k + 1;
            while (j < stop) {
                uint64_t key = 0;
                for (int t = 0; t < k; ++t)
                    key = (key << 2) | (strand[j + t] & 3);
                if (lookup_voff(x, key & x->kroll) >= 0) {
                    hit = true;
                    break;
                }
                j += k;
            }
            if (hit || endN == seqlen)
                break;
            j = endN + 1;
            ++si;
        }
    }
    if (!hit)
        return;
    // anker segments: forward N positions + the seqlen sentinel
    static thread_local std::vector<int> aN;
    aN.clear();
    if (!rc_strand) {
        aN = sN;
    } else {
        for (auto it = sN.rbegin(); it != sN.rend(); ++it)
            aN.push_back(seqlen - 1 - *it);
    }
    aN.push_back(seqlen);
    const int seqend = W;
    // pass 1: rolling window keys per position (the quirk rules above
    // are in the key generation, not the lookup); pass 2: pipelined
    // batch lookup; pass 3: the anker-building walk over the voffs.
    static thread_local std::vector<uint64_t> kbuf;
    static thread_local std::vector<uint8_t> kok;
    static thread_local std::vector<int64_t> vbuf;
    kbuf.assign(seqend, 0);
    kok.assign(seqend, 0);
    {
        int j = 0;
        bool first_seg = true;
        for (size_t si = 0; si < aN.size() && j < seqend; ++si) {
            int end = aN[si] - k + 1;
            uint64_t key = 0;
            bool inited = false;
            while (j < end) {
                if (!inited) {
                    if (rc_strand) {
                        int wpos =
                            first_seg ? (seqlen - k - j) : (seqlen - j);
                        key = 0;
                        for (int t = 0; t < k; ++t) {
                            int p = wpos + t;
                            // the reference's qseq_r stores N as the
                            // complement of the packed 0 = 'T' (rc_comp,
                            // compdna.c:229-251); past seqlen the shifted
                            // padding is 0 = 'A'
                            uint8_t c =
                                (p >= 0 && p < seqlen) ? strand[p] : 0;
                            key = (key << 2) | (c > 3 ? 3 : c);
                        }
                    } else {
                        key = 0;
                        for (int t = 0; t < k; ++t)
                            key = (key << 2) | (strand[j + t] & 3);
                        key &= x->kroll;
                    }
                    inited = true;
                } else if (rc_strand) {
                    int wpos = first_seg ? (seqlen - k - j) : (seqlen - j);
                    uint8_t c =
                        (wpos >= 0 && wpos < seqlen) ? strand[wpos] : 0;
                    key = ((uint64_t)(c > 3 ? 3 : c) << (2 * (k - 1)))
                          | (key >> 2);
                } else {
                    uint8_t c = strand[j + k - 1];
                    key = ((key << 2) | (c & 3)) & x->kroll;
                }
                kbuf[j] = key;
                kok[j] = 1;
                ++j;
            }
            j = aN[si] + 1;
            if (rc_strand)
                first_seg = false;
        }
    }
    vbuf.resize(seqend);
    lookup_voff_batch(x, kbuf.data(), kok.data(), seqend, vbuf.data());
    int64_t last = -1;
    int64_t Ms = 0, MMs = 0;
    int gaps = 0;
    int cur = -1;
    int j = 0;
    for (size_t si = 0; si < aN.size() && j < seqend; ++si) {
        int end = aN[si] - k + 1;
        while (j < end) {
            int64_t v = vbuf[j];
            if (v >= 0) {
                if (v == last && cur >= 0) {
                    if (gaps == 0) {
                        Ms += 1;
                    } else if (gaps == k) {
                        Ms += k;
                        MMs += 1;
                    } else {
                        out[cur].weight = Ms * x->M + MMs * x->MM;
                        out[cur].end = j - gaps + k;
                        out.push_back(Anker());
                        cur = (int)out.size() - 1;
                        out[cur].start = j;
                        out[cur].voff = v;
                        Ms = k;
                        MMs = 0;
                    }
                } else {
                    if (cur >= 0) {
                        out[cur].weight = Ms * x->M + MMs * x->MM;
                        out[cur].end = j - gaps + k;
                    }
                    out.push_back(Anker());
                    cur = (int)out.size() - 1;
                    out[cur].start = j;
                    out[cur].voff = v;
                    last = v;
                    Ms = k;
                    MMs = 0;
                }
                gaps = 0;
            } else {
                ++gaps;
            }
            ++j;
        }
        gaps += aN[si] + 1 - j;
        j = aN[si] + 1;
    }
    if (cur >= 0) {
        out[cur].weight = Ms * x->M + MMs * x->MM;
        out[cur].end = seqlen - gaps;
    }
}

void collect_ankers(const KIdx *x, const uint8_t *strand, int seqlen,
                    bool rc_strand, bool exhaustive,
                    std::vector<uint64_t> &kmers, std::vector<uint8_t> &ok,
                    std::vector<Anker> &out,
                    const int64_t *voff = nullptr) {
    out.clear();
    int k = x->k;
    int W = seqlen - k + 1;
    if (W <= 0)
        return;
    if (!voff && !x->cmode) {
        collect_ankers_ref(x, strand, seqlen, rc_strand, exhaustive, out);
        return;
    }
    if (voff) {
        if (!exhaustive &&
            !quick_hit_voff(k, strand, seqlen, voff, rc_strand))
            return;
    } else {
        window_kmers(x, strand, seqlen, kmers, ok);
        if (!exhaustive && !quick_hit(x, strand, seqlen, kmers, ok))
            return;
    }
    static thread_local std::vector<int64_t> vbuf;
    if (!voff) {
        vbuf.resize(W);
        lookup_voff_batch(x, kmers.data(), ok.data(), W, vbuf.data());
    }
    int64_t last = -1;
    int last_hit_j = 0;
    int gaps = 0;
    int64_t Ms = 0, MMs = 0;
    int cur = -1; // index into out
    for (int j = 0; j < W; ++j) {
        int p = rc_strand ? (seqlen - k - j) : j;
        // device voff rows are indexed by the ITERATION index j: for the
        // rc strand entry j holds lookup(revcomp(fw_kmer[j])), which IS
        // the rc window at rc-coordinate p = W-1-j (chain_device.py)
        int64_t v = voff ? voff[j] : vbuf[p];
        if (v >= 0) {
            last_hit_j = j;
            if (v == last && cur >= 0) {
                if (gaps == 0) {
                    Ms += 1;
                } else if (gaps == k) {
                    Ms += k;
                    MMs += 1;
                } else {
                    out[cur].weight = Ms * x->M + MMs * x->MM;
                    out[cur].end = j - gaps + k;
                    out.push_back(Anker());
                    cur = (int)out.size() - 1;
                    out[cur].start = j;
                    out[cur].voff = v;
                    Ms = k;
                    MMs = 0;
                }
            } else {
                if (cur >= 0) {
                    out[cur].weight = Ms * x->M + MMs * x->MM;
                    out[cur].end = j - gaps + k;
                }
                out.push_back(Anker());
                cur = (int)out.size() - 1;
                out[cur].start = j;
                out[cur].voff = v;
                last = v;
                Ms = k;
                MMs = 0;
            }
            gaps = 0;
        } else {
            ++gaps;
        }
    }
    if (cur >= 0) {
        out[cur].weight = Ms * x->M + MMs * x->MM;
        if (rc_strand)
            out[cur].end = seqlen - (gaps + k);
        else
            out[cur].end =
                seqlen - tail_gaps(strand, seqlen, k, last_hit_j);
    }
}

// gap-classification increment (kmeranker.c / chain_scan.py:196-214)
inline int64_t gap_score(const KIdx *x, int64_t gaps, int64_t weight,
                         int64_t score) {
    int64_t k = x->k;
    if (gaps == -k)
        return score + weight - (k - 1) * x->M;
    if (gaps == 0)
        return score + weight + x->MM;
    if (gaps > 0) {
        int64_t MMs, Ms;
        if (gaps <= 2) {
            MMs = gaps;
            Ms = 0;
        } else {
            MMs = gaps / k + (gaps % k ? 1 : 0);
            if (MMs < 2)
                MMs = 2;
            Ms = gaps - MMs;
            if (Ms > k)
                Ms = k;
            if (Ms > MMs)
                Ms = MMs;
        }
        if ((x->W1 + (gaps - 1) * x->U) <= (MMs * x->MM + Ms * x->M))
            return score + weight + Ms * x->M + MMs * x->MM;
        return score + weight + (x->W1 + (gaps - 1) * x->U);
    }
    if (x->mlen != k)
        return score + weight + gaps * x->M + x->MM;
    return score + weight + gaps * x->M - (gaps + 1) * x->U + x->W1;
}

struct BestState {
    Anker *best = nullptr;   // plain best
    int64_t ties = 0;
    Anker *best_l = nullptr; // length-corrected best
    int64_t ties_l = 0;
};

// _chain_pass (savekmers.c:5488-5634)
void chain_pass(const KIdx *x, std::vector<Anker> &ankers, int q_len,
                int64_t *Score, int64_t *extendScore, uint8_t *include,
                BestState &st, std::vector<int64_t> &bests) {
    bests.clear();
    int64_t k = x->k;
    for (auto &a : ankers) {
        a.score = 0;
        a.score_len = 0.0;
        a.len_len = 1;
        int64_t vo = a.voff;
        int64_t cnt = val_at(x, vo);
        for (int64_t i = vo + cnt; i > vo; --i) {
            int64_t t = val_at(x, i);
            int64_t score = Score[t];
            int64_t pos = extendScore[t];
            int64_t gaps = (int64_t)a.start - pos;
            if (!include[t]) {
                include[t] = 1;
                bests.push_back(t);
                if (a.start) {
                    int64_t s = x->W1 + ((int64_t)a.start - 1) * x->U;
                    score = a.weight + (s > x->Wl ? s : x->Wl);
                } else {
                    score = a.weight;
                }
            } else {
                score = gap_score(x, gaps, a.weight, score);
                if (score < 0) {
                    int64_t test =
                        a.start ? x->W1 + ((int64_t)a.start - 1) * x->U : 0;
                    if (test < x->Wl)
                        test = x->Wl;
                    if (score < test + a.weight)
                        score = test + a.weight;
                }
            }
            if (a.score < score)
                a.score = score;
            int64_t len_len = x->template_lengths[t];
            if (q_len < len_len)
                len_len = q_len;
            double score_len = (double)score;
            if (a.len_len != len_len)
                score_len =
                    score_len / (double)len_len * (double)a.len_len;
            if (a.score_len < score_len ||
                (a.score_len == score_len && a.score_len < (double)score)) {
                a.score_len = (double)score;
                a.len_len = len_len;
            }
            Score[t] = score;
            extendScore[t] = a.end;
        }
        // best-length tracking (savekmers.c:5590-5622)
        Anker *bl = st.best_l;
        double score_len = (double)a.score;
        if (bl && a.len_len != bl->len_len)
            score_len =
                score_len / (double)a.len_len * (double)bl->len_len;
        if (!bl || bl->score_len < score_len) {
            st.best_l = &a;
            st.ties_l = 0;
        } else if (bl->score_len == score_len) {
            if (bl->score_len < a.score_len) {
                st.best_l = &a;
                st.ties_l = 0;
            } else if (bl->score_len == a.score_len) {
                st.best_l = &a;
                st.ties_l += 1;
            }
        }
        Anker *b = st.best;
        if (!b || b->score < a.score) {
            st.best = &a;
            st.ties = 0;
        } else if (b->score == a.score) {
            if (b->score_len < a.score_len) {
                st.best = &a;
                st.ties = 0;
            } else {
                st.best = &a;
                st.ties += 1;
            }
        }
        (void)k;
    }
    for (int64_t t : bests) {
        Score[t] = 0;
        extendScore[t] = 0;
        include[t] = 0;
    }
}

// getBestChainTemplates (kmeranker.c:83-233); returns chain-start anker
// index or -1 (None)
int get_chain_templates(const KIdx *x, std::vector<Anker> &ankers,
                        int src_i, int q_len, std::vector<int64_t> &bests,
                        int64_t *Score, int64_t *extendScore,
                        uint8_t *include, int lc) {
    int64_t k = x->k;
    bests.clear();
    Anker &src = ankers[src_i];
    int64_t vo = src.voff;
    int64_t cnt = val_at(x, vo);
    std::vector<int64_t> marked;
    marked.reserve(cnt);
    bool nextAnker = false;
    for (int64_t i = vo + 1; i <= vo + cnt; ++i) {
        int64_t t = val_at(x, i);
        marked.push_back(t);
        include[t] += 1;
        if (include[t] == 1)
            nextAnker = true;
    }
    double bestScore = lc ? src.score_len : (double)src.score;
    int64_t target_len = src.len_len;
    int prev = src_i;

    int ni = src_i;
    while (nextAnker) {
        Anker &node = ankers[ni];
        int64_t nvo = node.voff;
        int64_t ncnt = val_at(x, nvo);
        int start = node.start;
        int end = node.end;
        for (int64_t i = nvo + ncnt; i > nvo; --i) {
            int64_t t = val_at(x, i);
            if (!include[t])
                continue;
            int64_t score = Score[t];
            int64_t pos = extendScore[t];
            int64_t gaps = pos - end;
            if (pos == 0) {
                score = node.weight;
            } else {
                score = gap_score(x, gaps, node.weight, score);
                node.score = 0; // mark as used
            }
            if (bestScore <= (double)score) {
                int64_t tmp;
                if (node.start) {
                    int64_t w = x->W1 + ((int64_t)node.start - 1) * x->U;
                    tmp = score + (w > x->Wl ? w : x->Wl);
                } else {
                    tmp = score;
                }
                int64_t tl = x->template_lengths[t];
                if ((double)tmp == bestScore &&
                    (!lc ||
                     (q_len < tl ? (int64_t)q_len : tl) == target_len)) {
                    score = (int64_t)bestScore;
                    nextAnker = false;
                    prev = ni;
                }
            }
            extendScore[t] = start;
            Score[t] = score;
        }
        --ni;
        if (ni < 0 && nextAnker) {
            prev = 0;
            break;
        }
    }
    (void)k;

    std::vector<int64_t> j_out;
    for (int64_t t : marked) {
        if (include[t] == 1) {
            int64_t s = Score[t];
            bool okv;
            if (lc) {
                int64_t tl = x->template_lengths[t];
                int64_t mn = q_len < tl ? (int64_t)q_len : tl;
                okv = (bestScore / (double)target_len * (double)mn
                       <= (double)s) ||
                      bestScore <= (double)s;
            } else {
                okv = bestScore <= (double)s;
            }
            if (okv)
                j_out.push_back(t);
        }
        Score[t] = 0;
        include[t] = 0;
        extendScore[t] = 0;
    }
    if (!j_out.empty()) {
        bests = j_out;
        return prev;
    }
    return -1;
}

// getProxiChainTemplates (kmeranker.c:235-370; Python reference
// chain_scan._chain_templates_proxi): no include gating in the walk --
// every template on every chained anker is extended and pos==0 events
// grow the candidate list; selection keeps scores within
// min_frac * bestScore (double, proxiTestBest[ScoreLen] semantics) and
// feeds the softProxi accumulator.  Always returns the chain-start
// anker index.
int get_chain_templates_proxi(const KIdx *x, std::vector<Anker> &ankers,
                              int src_i, int q_len,
                              std::vector<int64_t> &bests, int64_t *Score,
                              int64_t *extendScore, uint8_t *include,
                              int lc, double min_frac, int64_t *soft) {
    bests.clear();
    Anker &src = ankers[src_i];
    double bestScore = lc ? src.score_len : (double)src.score;
    double proxi_score = min_frac * bestScore;
    int64_t target_len = src.len_len;
    int prev = src_i;
    static thread_local std::vector<int64_t> cand;
    cand.clear();
    bool nextAnker = true;
    int ni = src_i;
    while (nextAnker) {
        Anker &node = ankers[ni];
        int64_t nvo = node.voff;
        int64_t ncnt = val_at(x, nvo);
        int start = node.start;
        int end = node.end;
        for (int64_t i = nvo + ncnt; i > nvo; --i) {
            int64_t t = val_at(x, i);
            int64_t score = Score[t];
            int64_t pos = extendScore[t];
            int64_t gaps = pos - end;
            if (pos == 0) {
                score = node.weight;
                cand.push_back(t);
            } else {
                score = gap_score(x, gaps, node.weight, score);
                node.score = 0; // mark as used
            }
            if (bestScore <= (double)score) {
                int64_t tmp;
                if (node.start) {
                    int64_t w = x->W1 + ((int64_t)node.start - 1) * x->U;
                    tmp = score + (w > x->Wl ? w : x->Wl);
                } else {
                    tmp = score;
                }
                int64_t tl = x->template_lengths[t];
                if ((double)tmp == bestScore &&
                    (!lc ||
                     (q_len < tl ? (int64_t)q_len : tl) == target_len)) {
                    score = (int64_t)bestScore;
                    nextAnker = false;
                    prev = ni;
                }
            }
            extendScore[t] = start;
            Score[t] = score;
        }
        --ni;
        if (ni < 0 && nextAnker) {
            prev = 0;
            break;
        }
    }
    for (int64_t t : cand) {
        int64_t s = Score[t];
        if (!include[t]) {
            bool okv;
            if (lc) {
                int64_t tl = x->template_lengths[t];
                int64_t mn = q_len < tl ? (int64_t)q_len : tl;
                okv = (proxi_score / (double)target_len * (double)mn
                       <= (double)s) ||
                      proxi_score <= (double)s;
            } else {
                okv = proxi_score <= (double)s;
            }
            if (okv) {
                bests.push_back(t);
                if (soft)
                    soft[t] += s;
            }
        }
        Score[t] = 0;
        extendScore[t] = 0;
        include[t] = 0;
    }
    return prev;
}

// SegmentList -- the chain-claimed-region accumulator (role of
// seqmenttree.c).  Re-derived from the BEHAVIORAL CONTRACT pinned by
// tests/test_segtree.py (fuzzed against the compiled reference): the
// structure is an APPROXIMATE binary segment union whose quirks are
// observable in chain acceptance, so the rules below state observed
// behavior, not reference statements:
//
//  R1 inner engulfed (ins strictly contains the subtree span): the
//     subtree collapses to a leaf carrying the INSERT's covered value;
//     both children are abandoned in place.
//  R2 inner partial: the span extends to the union; the insert descends
//     into one half picked by comparing against the right child's
//     start.  A straddling insert SPLITS there: the upper part goes
//     right first, then the SAME slot is rewritten to the lower part
//     [orig_start, left.end] and goes left -- the base at left.end+1 is
//     dropped from the upper part (1-base gap quirk).  covered becomes
//     untouched-sibling covered + descended-half result.
//  R3 disjoint leaf: the leaf turns inner -- old leaf copied to a fresh
//     slot, insert placed as the other child, covered values summed.
//  R4 overlapping leaf: span extends to the union and covered snaps to
//     the exact span length.
//
//  cover queries sum covered over fully-contained subtrees and clamp
//  partial leaf overlaps; callers read the u32 through int (wrap kept).
//
// Layout: structure-of-arrays; insertion runs an explicit
// descend/unwind stack instead of recursion.
struct SegmentList {
    std::vector<uint32_t> seg_s, seg_e, cov;
    std::vector<int> lo, hi;      // children; -1 == leaf
    int n = 0;

    void clear() { n = 0; }
    void slot(int i) {
        if ((int)seg_s.size() <= i) {
            seg_s.resize(i + 1);
            seg_e.resize(i + 1);
            cov.resize(i + 1);
            lo.resize(i + 1, -1);
            hi.resize(i + 1, -1);
        }
    }

    // one pending ancestor on the insertion path
    struct Path {
        int parent;
        uint32_t base;       // untouched sibling's covered
        int split_left;      // != -1: split continuation pending
        uint32_t low_s, low_e;
    };
    std::vector<Path> path;

    // insert `node` under the root; returns the root's new covered
    uint32_t insert(int node) {
        path.clear();
        int r = 0;
        uint32_t v = 0;
        for (;;) {
            // ---- descend to a terminal rule ----
            for (;;) {
                if (lo[r] == -1) {
                    // leaf terminals
                    if (seg_e[node] < seg_s[r] || seg_e[r] < seg_s[node]) {
                        // R3: disjoint -> become inner
                        int cp = node + 1;
                        seg_s[cp] = seg_s[r];
                        seg_e[cp] = seg_e[r];
                        cov[cp] = cov[r];
                        lo[cp] = -1;
                        hi[cp] = -1;
                        if (seg_e[node] < seg_s[r]) {
                            seg_s[r] = seg_s[node];
                            lo[r] = node;
                            hi[r] = cp;
                        } else {
                            seg_e[r] = seg_e[node];
                            lo[r] = cp;
                            hi[r] = node;
                        }
                        cov[r] += cov[node];
                    } else {
                        // R4: overlap -> exact union
                        if (seg_s[node] < seg_s[r])
                            seg_s[r] = seg_s[node];
                        if (seg_e[r] < seg_e[node])
                            seg_e[r] = seg_e[node];
                        cov[node] = 0;
                        cov[r] = seg_e[r] - seg_s[r];
                    }
                    v = cov[r];
                    break;
                }
                if (seg_s[node] < seg_s[r] && seg_e[r] < seg_e[node]) {
                    // R1: engulfed -> collapse to the insert
                    seg_s[r] = seg_s[node];
                    seg_e[r] = seg_e[node];
                    cov[r] = cov[node];
                    cov[node] = 0;
                    lo[r] = -1;
                    v = cov[r];
                    break;
                }
                // R2: extend the span, pick/ split at right child start
                if (seg_e[r] < seg_e[node])
                    seg_e[r] = seg_e[node];
                else if (seg_s[node] < seg_s[r])
                    seg_s[r] = seg_s[node];
                uint32_t mid = seg_s[hi[r]];
                if (seg_e[node] < mid) {
                    path.push_back({r, cov[hi[r]], -1, 0, 0});
                    r = lo[r];
                } else if (mid <= seg_s[node]) {
                    path.push_back({r, cov[lo[r]], -1, 0, 0});
                    r = hi[r];
                } else {
                    uint32_t low_s = seg_s[node];
                    uint32_t low_e = seg_e[lo[r]];
                    seg_s[node] = seg_e[lo[r]] + 1;  // 1-base gap quirk
                    cov[node] = seg_e[node] - seg_s[node];
                    path.push_back({r, 0, lo[r], low_s, low_e});
                    r = hi[r];
                }
            }
            // ---- unwind; a split continuation restarts the descent ----
            bool redo = false;
            while (!path.empty()) {
                Path ent = path.back();
                path.pop_back();
                if (ent.split_left != -1) {
                    // upper half done (v); rewrite to the lower part and
                    // descend the left child with base = v
                    seg_s[node] = ent.low_s;
                    seg_e[node] = ent.low_e;
                    cov[node] = ent.low_e - ent.low_s;
                    path.push_back({ent.parent, v, -1, 0, 0});
                    r = ent.split_left;
                    redo = true;
                    break;
                }
                cov[ent.parent] = ent.base + v;
                v = cov[ent.parent];
            }
            if (!redo)
                return v;
        }
    }

    int grow(uint32_t s, uint32_t e) { // growSeqmentTree role
        if (n == 0) {
            slot(1);
            seg_s[0] = s;
            seg_e[0] = e;
            cov[0] = e - s;
            lo[0] = -1;
            hi[0] = -1;
            n = 1;
            return (int)(e - s);
        }
        int node = n;
        slot(node + 1);
        seg_s[node] = s;
        seg_e[node] = e;
        cov[node] = e - s;
        lo[node] = -1;
        hi[node] = -1;
        uint32_t total = insert(node);
        cov[0] = total;
        if (cov[node])
            n += 2;
        return (int)cov[0];
    }

    int64_t query(int s, int e) const {
        // iterative contained-subtree sum; partial leaf overlaps clamp.
        // callers read the u32 through int (savekmers.c:5135)
        if (n == 0)
            return 0;
        uint32_t su = (uint32_t)s, eu = (uint32_t)e;
        uint32_t acc = 0;
        static thread_local std::vector<int> st;
        st.clear();
        st.push_back(0);
        while (!st.empty()) {
            int r = st.back();
            st.pop_back();
            if (eu < seg_s[r] || seg_e[r] < su)
                continue;
            if (su <= seg_s[r] && seg_e[r] <= eu) {
                acc += cov[r];
                continue;
            }
            if (lo[r] != -1) {
                st.push_back(lo[r]);
                st.push_back(hi[r]);
                continue;
            }
            if (seg_s[r] <= su && eu <= seg_e[r])
                acc += eu - su;
            else if (seg_s[r] <= su && su < seg_e[r])
                acc += seg_e[r] - su;
            else if (seg_s[r] < eu && eu <= seg_e[r])
                acc += eu - seg_s[r];
        }
        return (int64_t)(int32_t)acc;
    }
};

// getBestAnkerScore{,Len} (kmeranker.c:398-478)
int get_best_anker(std::vector<Anker> &V, int start_i, int lc,
                   int64_t *ties_out) {
    int n = (int)V.size();
    int i = start_i;
    while (i < n && (!V[i].alive || V[i].score == 0))
        ++i;
    if (i >= n) {
        *ties_out = 0;
        return -1;
    }
    int best = i;
    int64_t ties = 0;
    int j = i;
    while (j + 1 < n) {
        ++j;
        Anker &a = V[j];
        if (!a.alive || !a.score)
            continue;
        if (lc) {
            Anker &b = V[best];
            double score_len = a.score_len;
            if (a.len_len != b.len_len)
                score_len =
                    score_len / (double)a.len_len * (double)b.len_len;
            if (b.score_len < score_len) {
                best = j;
                ties = 0;
            } else if (b.score_len == score_len) {
                if (b.score_len < a.score_len) {
                    best = j;
                    ties = 0;
                } else if (b.score_len == a.score_len) {
                    best = j;
                    ties += 1;
                }
            }
        } else {
            if (V[best].score < a.score) {
                best = j;
                ties = 0;
            } else if (V[best].score == a.score) {
                best = j;
                ties += 1;
            }
        }
    }
    *ties_out = ties;
    return best;
}

// chooseChain (kmeranker.c:512-594); proxi widens the both-strands case
void choose_chain(const Anker *bf, const Anker *br, int cStart,
                  int cStart_r, double coverT, int *rc_out, int *start_out,
                  int *ln_out, double proxi = 1.0) {
    int rc;
    if (proxi == 1.0)
        rc = br->score < bf->score ? 1 : bf->score < br->score ? 2 : 3;
    else if (br->score <= bf->score)
        rc = proxi * (double)bf->score <= (double)br->score ? 3 : 1;
    else
        rc = proxi * (double)br->score <= (double)bf->score ? 3 : 2;
    int start, end;
    if (rc == 1) {
        start = cStart;
        end = bf->end;
    } else if (rc == 2) {
        start = cStart_r;
        end = br->end;
    } else {
        if (bf->end < cStart_r) {
            start = cStart;
            end = bf->end;
            rc = 1;
        } else if (br->end < cStart) {
            start = cStart_r;
            end = br->end;
            rc = 2;
        } else if (cStart <= cStart_r && br->end <= bf->end) {
            start = cStart;
            end = bf->end;
        } else if (cStart_r <= cStart && bf->end <= br->end) {
            start = cStart_r;
            end = br->end;
        } else if (br->end < bf->end) {
            int a = bf->end - cStart;
            int b = br->end - cStart_r;
            end = a < b ? a : b;
            start = cStart_r;
            if (coverT * end <= (double)(br->end - cStart)) {
                end = bf->end;
            } else {
                end = br->end;
                rc = 2;
            }
        } else {
            int a = bf->end - cStart;
            int b = br->end - cStart_r;
            end = a < b ? a : b;
            start = cStart;
            if (coverT * end <= (double)(bf->end - cStart_r)) {
                end = br->end;
            } else {
                end = bf->end;
                rc = 1;
            }
        }
    }
    *rc_out = rc;
    *start_out = start;
    *ln_out = end - start;
}

struct Ctx {
    KIdx x;
    std::vector<uint64_t> kmers;
    std::vector<uint8_t> ok;
    std::vector<int64_t> voffs; // lookup_voff_batch scratch
    std::vector<Anker> VF, VR;
    std::vector<int64_t> bestT, bestT_r, passT, adds;
    std::vector<uint8_t> rc;
    SegmentList segs;
    // -proxi state (kchain_set_proxi): <1.0 routes template selection
    // through getProxiChainTemplates semantics; soft = softProxi array
    double proxi_frac = 1.0;
    int64_t *soft = nullptr;
};

// dispatch: plain vs proxi template selection (kma.c:702-717 wiring)
inline int chain_templates(Ctx *c, std::vector<Anker> &V, int src_i,
                           int q_len, std::vector<int64_t> &bests,
                           int64_t *Score, int64_t *extendScore,
                           uint8_t *include, int lc) {
    if (c->proxi_frac < 1.0)
        return get_chain_templates_proxi(&c->x, V, src_i, q_len, bests,
                                         Score, extendScore, include, lc,
                                         c->proxi_frac, c->soft);
    return get_chain_templates(&c->x, V, src_i, q_len, bests, Score,
                               extendScore, include, lc);
}

// savekmers.c:5840-5880: one strand's next-chain selection
Anker *advance(Ctx *c, std::vector<Anker> &V, Anker *best, int *b_i,
               int q_len, std::vector<int64_t> &bests, int64_t *Score,
               int64_t *extendScore, uint8_t *include, int64_t minlen,
               double coverT, double mrs, int lc, int64_t *ties,
               int *cStart_out, bool *got_out) {
    *cStart_out = -1;
    *got_out = false;
    if (!best)
        return nullptr;
    if (best->score) {
        int cs = chain_templates(c, V, *b_i, q_len, bests, Score,
                                     extendScore, include, lc);
        if (cs >= 0) {
            int cStart = V[cs].start;
            *cStart_out = cStart;
            int64_t cover = c->segs.query(cStart, best->end);
            int64_t ln = best->end - cStart;
            if (minlen <= ln && (double)cover <= coverT * (double)ln &&
                mrs * (double)ln <= (double)best->score) {
                *got_out = true;
            } else {
                best->score = 0;
            }
        } else {
            best->score = 0;
        }
    }
    while (best && best->score == 0) {
        int64_t nties;
        int nb = get_best_anker(V, 0, lc, &nties);
        *ties = nties;
        if (nb < 0)
            return nullptr;
        best = &V[nb];
        *b_i = nb;
        if (c->x.k < best->score) {
            bests.clear();
            int cs = chain_templates(c, V, *b_i, q_len, bests,
                                         Score, extendScore, include, lc);
            if (cs >= 0) {
                int cStart = V[cs].start;
                *cStart_out = cStart;
                int64_t cover = c->segs.query(cStart, best->end);
                int64_t ln = best->end - cStart;
                if (minlen <= ln && (double)cover <= coverT * (double)ln &&
                    mrs * (double)ln <= (double)best->score) {
                    *got_out = true;
                    break;
                }
                best->score = 0;
            } else {
                best->score = 0;
            }
        } else {
            best->score = 0;
        }
    }
    return best;
}

// savekmers.c:5701-5781 equal-anker merging
void merge_ties(Ctx *c, std::vector<Anker> &V, int b_i, int start,
                int V_start, int64_t ln, double coverT, int q_len,
                std::vector<int64_t> &bests, int64_t *Score,
                int64_t *extendScore, uint8_t *include, int lc) {
    Anker &best = V[b_i];
    int stop = start > V_start ? start : V_start;
    int i = b_i;
    for (;;) {
        int found = -1;
        while (i > 0) {
            --i;
            Anker &a = V[i];
            if (a.start <= stop)
                break;
            if ((!lc && a.score == best.score) ||
                (lc && a.score_len == best.score_len &&
                 a.len_len == best.len_len)) {
                found = i;
                break;
            }
        }
        if (found < 0)
            break;
        Anker &a = V[found];
        if ((double)(a.end - start) < coverT * (double)ln)
            break;
        for (int64_t t : bests) {
            include[t] = 1;
            Score[t] = 0;
            extendScore[t] = 0;
        }
        c->adds.clear();
        chain_templates(c, V, found, q_len, c->adds, Score,
                            extendScore, include, lc);
        for (int64_t t : c->adds)
            bests.push_back(t);
    }
    for (int64_t t : bests) {
        include[t] = 0;
        Score[t] = 0;
        extendScore[t] = 0;
    }
}

} // namespace

extern "C" {

void *kchain_create(const void *exist, int exist_es, const void *key_index,
                    int key_es, const void *value_index, int vidx_es,
                    const void *values, int val_es,
                    unsigned long long null_index,
                    unsigned long long smask, unsigned long long mmask,
                    int mega, int use_murmur, int cmode, int k, int mlen,
                    const long long *template_lengths, long long M,
                    long long MM, long long U, long long W1, long long Wl) {
    Ctx *c = new Ctx();
    c->x.exist = exist;
    c->x.exist_es = exist_es;
    c->x.key_index = key_index;
    c->x.key_es = key_es;
    c->x.value_index = value_index;
    c->x.vidx_es = vidx_es;
    c->x.values = values;
    c->x.val_es = val_es;
    c->x.null_index = null_index;
    c->x.smask = smask;
    c->x.mmask = mmask;
    c->x.kroll = (k < 32) ? ((1ull << (2 * k)) - 1) : ~0ull;
    c->x.mega = mega;
    c->x.use_murmur = use_murmur;
    c->x.cmode = cmode;
    c->x.k = k;
    c->x.mlen = mlen;
    c->x.template_lengths = (const int64_t *)template_lengths;
    c->x.M = M;
    c->x.MM = MM;
    c->x.U = U;
    c->x.W1 = W1;
    c->x.Wl = Wl;
    return c;
}

void kchain_free(void *h) { delete (Ctx *)h; }

// -proxi wiring (kma.c:702-717; kmers.c:132-151): frac is |minFrac| as
// the scanners see it; soft is the softProxi accumulator or null
void kchain_set_proxi(void *h, double frac, long long *soft) {
    Ctx *c = (Ctx *)h;
    c->proxi_frac = frac;
    c->soft = (int64_t *)soft;
}

// chain_scan_read (save_kmers_chain, savekmers.c:5127-5944) for one read.
// Outputs per hit: rc emit kind (1 fw codes, 2 rc codes), sc (rc_flag),
// b0/b1 (kmer-bound ints appended to the header), template ids
// (signed; negatives = rc side of a merged emit) packed into tpl_flat at
// tpl_off.  Returns the hit count, or -1 if output caps were exceeded
// (caller retries with bigger buffers).
int kchain_scan_read_v(void *h, const uint8_t *codes, int seqlen,
                       const long long *voff_f, const long long *voff_r,
                       int exhaustive, long long minlen, double coverT,
                       double mrs, double mrc, int lc, long long *Score_,
                       long long *extendScore_, uint8_t *include,
                       uint8_t *hit_rc, long long *hit_sc_, int *hit_b0,
                       int *hit_b1, long long *tpl_off_, int *tpl_flat,
                       int cap_hits, long long cap_tpl) {
    int64_t *Score = (int64_t *)Score_;
    int64_t *extendScore = (int64_t *)extendScore_;
    int64_t *hit_sc = (int64_t *)hit_sc_;
    int64_t *tpl_off = (int64_t *)tpl_off_;
    tpl_off[0] = 0; // every return path leaves a valid 0-hit layout
    Ctx *c = (Ctx *)h;
    const KIdx *x = &c->x;
    int64_t k = x->k;
    if (seqlen < k)
        return 0;

    // device-fed voffs use the symmetric window layout; N-containing
    // reads need the host scan's reference-exact segment/quirk handling
    // (collect_ankers_ref), so bypass the precomputed rows for them
    if ((voff_f || voff_r) && !x->cmode
            && memchr(codes, 4, (size_t)seqlen)) {
        voff_f = nullptr;
        voff_r = nullptr;
    }
    collect_ankers(x, codes, seqlen, false, exhaustive != 0, c->kmers,
                   c->ok, c->VF, (const int64_t *)voff_f);
    c->rc.assign(codes, codes + seqlen);
    std::reverse(c->rc.begin(), c->rc.end());
    static const uint8_t CMP[6] = {3, 2, 1, 0, 4, 5};
    for (auto &b : c->rc)
        b = CMP[b];
    collect_ankers(x, c->rc.data(), seqlen, true, exhaustive != 0,
                   c->kmers, c->ok, c->VR, (const int64_t *)voff_r);
    std::vector<Anker> &VF = c->VF, &VR = c->VR;
    if (VF.empty() && VR.empty())
        return 0;

    BestState st;
    if (!VF.empty()) {
        st.best = &VF[0];
        st.best_l = &VF[0];
        VF[0].score = 0;
        VF[0].score_len = 0.0;
        VF[0].len_len = 1;
        chain_pass(x, VF, seqlen, Score, extendScore, include, st,
                   c->passT);
    }
    Anker *best_f = st.best;
    Anker *bl_f = st.best_l;
    st.best = VR.empty() ? nullptr : &VR[0];
    st.best_l = st.best;
    if (!VR.empty()) {
        VR[0].score = 0;
        VR[0].score_len = 0.0;
        VR[0].len_len = 1;
        chain_pass(x, VR, seqlen, Score, extendScore, include, st,
                   c->passT);
    }
    Anker *best_r = st.best;
    int64_t ties = st.ties;

    int64_t f_score = best_f ? best_f->score : 0;
    int64_t r_score = best_r ? best_r->score : 0;
    if (f_score < k && r_score < k)
        return 0;
    if (lc) {
        best_f = bl_f;
        best_r = st.best_l;
        ties = st.ties_l;
    }

    int VF_start = VF.empty() ? 0 : VF[0].start;
    int VR_start = VR.empty() ? 0 : VR[0].start;
    // prune (kmeranker.c:372-396)
    bool any_f = false, any_r = false;
    for (auto &a : VF) {
        if (a.score < k)
            a.alive = false;
        else
            any_f = true;
    }
    for (auto &a : VR) {
        if (a.score < k)
            a.alive = false;
        else
            any_r = true;
    }
    if (!any_f && best_f)
        best_f->score = 0;
    if (!any_r && best_r)
        best_r->score = 0;

    c->segs.clear();
    std::vector<int64_t> &bestT = c->bestT, &bestT_r = c->bestT_r;
    bestT.clear();
    bestT_r.clear();
    int bf_i = -1, br_i = -1;
    if (best_f && !VF.empty() && best_f >= &VF[0] &&
        best_f <= &VF[VF.size() - 1])
        bf_i = (int)(best_f - &VF[0]);
    if (best_r && !VR.empty() && best_r >= &VR[0] &&
        best_r <= &VR[VR.size() - 1])
        br_i = (int)(best_r - &VR[0]);

    int cStart = -1, cStart_r = -1;
    int rc, start;
    int64_t ln;
    if (!(best_f && best_f->score) || !(best_r && best_r->score)) {
        if (best_f && best_f->score) {
            int cs = chain_templates(c, VF, bf_i, seqlen, bestT, Score,
                                         extendScore, include, lc);
            cStart = cs >= 0 ? VF[cs].start : best_f->start;
            start = cStart;
            ln = best_f->end - start;
            rc = 1;
        } else {
            if (!best_r)
                return 0; // unreachable (f/r score gate above)
            int cs = chain_templates(c, VR, br_i, seqlen, bestT_r,
                                         Score, extendScore, include, lc);
            cStart_r = cs >= 0 ? VR[cs].start : best_r->start;
            start = cStart_r;
            ln = best_r->end - start;
            rc = 2;
        }
    } else {
        int cs = chain_templates(c, VF, bf_i, seqlen, bestT, Score,
                                     extendScore, include, lc);
        cStart = cs >= 0 ? VF[cs].start : best_f->start;
        cs = chain_templates(c, VR, br_i, seqlen, bestT_r, Score,
                                 extendScore, include, lc);
        cStart_r = cs >= 0 ? VR[cs].start : best_r->start;
        int lni;
        choose_chain(best_f, best_r, cStart, cStart_r, coverT, &rc, &start,
                     &lni, c->proxi_frac);
        ln = lni;
    }

    int64_t score = f_score > r_score ? f_score : r_score;
    if (ln < minlen || score < k)
        return 0;

    int n_hits = 0;
    int64_t tlen = 0;
    int fw_i = bf_i, rv_i = br_i;
    while (best_f || best_r) {
        if (ties) {
            if (rc & 1)
                merge_ties(c, VF, fw_i, start, VF_start, ln, coverT,
                           seqlen, bestT, Score, extendScore, include, lc);
            if (rc & 2)
                merge_ties(c, VR, rv_i, start, VR_start, ln, coverT,
                           seqlen, bestT_r, Score, extendScore, include,
                           lc);
        }

        // mapping-length filter (mrchain, kmeranker.c:57-81)
        int rc_pre = rc;
        if ((rc & 1) && mrc != 0.0 && (double)seqlen < mrc * (double)ln) {
            size_t w = 0;
            for (int64_t t : bestT)
                if (mrc * (double)ln <= (double)x->template_lengths[t])
                    bestT[w++] = t;
            bestT.resize(w);
            if (bestT.empty())
                rc ^= 1;
        }
        if ((rc & 2) && mrc != 0.0 && (double)seqlen < mrc * (double)ln) {
            size_t w = 0;
            for (int64_t t : bestT_r)
                if (mrc * (double)ln <= (double)x->template_lengths[t])
                    bestT_r[w++] = t;
            bestT_r.resize(w);
            if (bestT_r.empty())
                rc ^= 2;
        }
        if (!rc) {
            // livelock escape, mirrored from chain_scan.py: the
            // reference rebuilds the same mrchain-emptied chain forever
            // (savekmers.c:5786-5794); silence it so the scan advances
            if ((rc_pre & 1) && best_f)
                best_f->score = 0;
            if ((rc_pre & 2) && best_r)
                best_r->score = 0;
        }

        if (rc) {
            c->segs.grow(start, start + (int)ln);
            if (n_hits >= cap_hits)
                return -1;
            int b0, b1;
            if (rc & 1) {
                b0 = start;
                b1 = start + (int)ln;
            } else {
                b0 = seqlen - best_r->end;
                b1 = seqlen - start;
            }
            if (rc & 1) {
                int64_t need = (int64_t)bestT.size() +
                               ((rc & 2) ? (int64_t)bestT_r.size() : 0);
                if (tlen + need > cap_tpl)
                    return -1;
                int64_t sc = best_f->score;
                for (int64_t t : bestT)
                    tpl_flat[tlen++] = (int)t;
                if (rc & 2) {
                    for (int64_t t : bestT_r)
                        tpl_flat[tlen++] = -(int)t;
                    sc = -sc;
                    best_r->score = 0;
                    bestT_r.clear();
                }
                hit_rc[n_hits] = 1;
                hit_sc[n_hits] = sc;
                hit_b0[n_hits] = b0;
                hit_b1[n_hits] = b1;
                best_f->score = 0;
                bestT.clear();
            } else {
                if (tlen + (int64_t)bestT_r.size() > cap_tpl)
                    return -1;
                for (int64_t t : bestT_r)
                    tpl_flat[tlen++] = (int)t;
                hit_rc[n_hits] = 2;
                hit_sc[n_hits] = best_r->score;
                hit_b0[n_hits] = b0;
                hit_b1[n_hits] = b1;
                best_r->score = 0;
                bestT_r.clear();
            }
            ++n_hits;
            tpl_off[n_hits] = tlen;
        }

        // next chains (savekmers.c:5837-5939)
        ties = 0;
        rc = 0;
        bool got_f = false, got_r = false;
        best_f = advance(c, VF, best_f, &fw_i, seqlen, bestT, Score,
                         extendScore, include, minlen, coverT, mrs, lc,
                         &ties, &cStart, &got_f);
        if (got_f)
            rc |= 1;
        best_r = advance(c, VR, best_r, &rv_i, seqlen, bestT_r, Score,
                         extendScore, include, minlen, coverT, mrs, lc,
                         &ties, &cStart_r, &got_r);
        if (got_r)
            rc |= 2;

        if (!best_f && !best_r)
            return n_hits;
        if (best_f && best_r) {
            int lni;
            choose_chain(best_f, best_r, cStart, cStart_r, coverT, &rc,
                         &start, &lni, c->proxi_frac);
            ln = lni;
        } else if (best_f) {
            rc = 1;
            start = cStart;
            ln = best_f->end - start;
        } else {
            rc = 2;
            start = cStart_r;
            ln = best_r->end - start;
        }
    }
    return n_hits;
}


int kchain_scan_read(void *h, const uint8_t *codes, int seqlen,
                     int exhaustive, long long minlen, double coverT,
                     double mrs, double mrc, int lc, long long *Score,
                     long long *extendScore, uint8_t *include,
                     uint8_t *hit_rc, long long *hit_sc, int *hit_b0,
                     int *hit_b1, long long *tpl_off, int *tpl_flat,
                     int cap_hits, long long cap_tpl) {
    return kchain_scan_read_v(h, codes, seqlen, nullptr, nullptr,
                              exhaustive, minlen, coverT, mrs, mrc, lc,
                              Score, extendScore, include, hit_rc, hit_sc,
                              hit_b0, hit_b1, tpl_off, tpl_flat, cap_hits,
                              cap_tpl);
}

// Batched scan: codes_flat/codes_off pack n_reads reads; hit buffers are
// shared, tpl_off entries are GLOBAL offsets into tpl_flat, and
// hits_per_read[r] gives each read's hit count.  Returns the number of
// reads fully processed (< n_reads when the caps filled up -- the caller
// grows its buffers and resumes from that read).
int kchain_scan_batch(void *h, const uint8_t *codes_flat,
                      const long long *codes_off, int n_reads,
                      int exhaustive, long long minlen, double coverT,
                      double mrs, double mrc, int lc, long long *Score,
                      long long *extendScore, uint8_t *include,
                      int *hits_per_read, uint8_t *hit_rc,
                      long long *hit_sc, int *hit_b0, int *hit_b1,
                      long long *tpl_off, int *tpl_flat, int cap_hits,
                      long long cap_tpl) {
    int hcur = 0;
    long long tcur = 0;
    for (int r = 0; r < n_reads; ++r) {
        int n = kchain_scan_read(
            h, codes_flat + codes_off[r],
            (int)(codes_off[r + 1] - codes_off[r]), exhaustive, minlen,
            coverT, mrs, mrc, lc, Score, extendScore, include,
            hit_rc + hcur, hit_sc + hcur, hit_b0 + hcur, hit_b1 + hcur,
            tpl_off + hcur, tpl_flat + tcur, cap_hits - hcur,
            cap_tpl - tcur);
        if (n < 0) {
            // the failed read scribbled its local tpl_off[0..] over the
            // previous read's end boundary; restore it before resuming
            tpl_off[hcur] = tcur;
            return r;
        }
        for (int j = 0; j <= n; ++j)
            tpl_off[hcur + j] += tcur;
        hits_per_read[r] = n;
        hcur += n;
        tcur = tpl_off[hcur];
    }
    return n_reads;
}

// Device-fed batch (the device chain scanner's host half): voff_f/voff_r
// are [n_reads, stride] row-major per-window values offsets computed by
// the device hash lookup (mapping/chain_device.py); row r's valid
// entries span [0, len_r - k + 1).  Everything else as kchain_scan_batch.
int kchain_scan_batch_dev(void *h, const uint8_t *codes_flat,
                          const long long *codes_off, int n_reads,
                          const long long *voff_f, const long long *voff_r,
                          long long stride, int exhaustive,
                          long long minlen, double coverT, double mrs,
                          double mrc, int lc, long long *Score,
                          long long *extendScore, uint8_t *include,
                          int *hits_per_read, uint8_t *hit_rc,
                          long long *hit_sc, int *hit_b0, int *hit_b1,
                          long long *tpl_off, int *tpl_flat, int cap_hits,
                          long long cap_tpl) {
    int hcur = 0;
    long long tcur = 0;
    int64_t *toff = (int64_t *)tpl_off;
    for (int r = 0; r < n_reads; ++r) {
        int n = kchain_scan_read_v(
            h, codes_flat + codes_off[r],
            (int)(codes_off[r + 1] - codes_off[r]),
            voff_f + (long long)r * stride, voff_r + (long long)r * stride,
            exhaustive, minlen, coverT, mrs, mrc, lc, Score, extendScore,
            include, hit_rc + hcur, hit_sc + hcur, hit_b0 + hcur,
            hit_b1 + hcur, tpl_off + hcur, tpl_flat + tcur,
            cap_hits - hcur, cap_tpl - tcur);
        if (n < 0) {
            toff[hcur] = tcur;
            return r;
        }
        for (int j = 0; j <= n; ++j)
            toff[hcur + j] += tcur;
        hits_per_read[r] = n;
        hcur += n;
        tcur = toff[hcur];
    }
    return n_reads;
}


// get_kmers_for_pair (savekmers.c:427-688 / mapping/pair.py:21-131):
// score both strands of one mate into Score/Score_r (left FILLED for the
// pair combiners), collecting the touched template ids per strand.
// Returns bestSeqCount.
// voff_fw/voff_rc: optional device-precomputed per-window values
// offsets for each strand IN THAT STRAND'S window order (p ascending);
// nullptr = native lookups (the -device PE probe path).
int kchain_pair_mate_v(void *h, const uint8_t *codes, int seqlen,
                       int exhaustive, long long *Score_,
                       long long *Score_r_, long long *extendScore_,
                       uint8_t *include, int *bests_out, int *nb_out,
                       int *bests_r_out, int *nbr_out,
                       const long long *voff_fw, const long long *voff_rc) {
    Ctx *c = (Ctx *)h;
    const KIdx *x = &c->x;
    const int k = x->k;
    const int mlen = x->mlen;
    const int64_t M = x->M, MM = x->MM, U = x->U, W1 = x->W1;
    int64_t *Score = (int64_t *)Score_;
    int64_t *Score_r = (int64_t *)Score_r_;
    int64_t *extendScore = (int64_t *)extendScore_;
    *nb_out = 0;
    *nbr_out = 0;
    if (seqlen < k)
        return 0;
    extendScore[0] = 0; // clear the sparse-pair side flag (:455)

    // (Ms_add, MMs_add, Us_add, W1s_add) for kmersize < gaps
    // (savekmers.c:2536-2557 / scan.py:119-133)
    auto reconnect = [&](int64_t gaps, int64_t *ms, int64_t *mms,
                         int64_t *us, int64_t *w1s) {
        int64_t g = gaps - (k - 1);
        int64_t mm, m;
        if (g <= 2) {
            mm = g;
            m = 0;
        } else {
            mm = g / k + (g % k ? 1 : 0);
            if (mm < 2)
                mm = 2;
            m = g - mm;
            if (m > k)
                m = k;
            if (m > mm)
                m = mm;
        }
        if ((W1 + (g - 1) * U) <= (mm * MM + m * M)) {
            *ms = k + m;
            *mms = mm;
            *us = 0;
            *w1s = 0;
        } else {
            *ms = k;
            *mms = 0;
            *us = g - 1;
            *w1s = 1;
        }
    };

    int bestSeqCount = 0;
    for (int rc = 0; rc < 2; ++rc) {
        const uint8_t *cur;
        if (rc) {
            c->rc.assign(codes, codes + seqlen);
            std::reverse(c->rc.begin(), c->rc.end());
            static const uint8_t CMP[6] = {3, 2, 1, 0, 4, 5};
            for (auto &b : c->rc)
                b = CMP[b];
            cur = c->rc.data();
        } else {
            cur = codes;
        }
        int64_t *Scores = rc ? Score_r : Score;
        int *bests = rc ? bests_r_out : bests_out;
        int *nb = rc ? nbr_out : nb_out;

        int W = seqlen - k + 1;
        const long long *voffs = rc ? voff_rc : voff_fw;
        if (voffs) {
            // device probe: voffs[p] >= 0 iff window p is N-free AND the
            // hash hits -- identical to ok[p] && lookup (quick_hit shape)
            if (!exhaustive &&
                !quick_hit_voff(k, cur, seqlen, (const int64_t *)voffs,
                                false))
                continue;
        } else {
            window_kmers(x, cur, seqlen, c->kmers, c->ok);
            if (!exhaustive &&
                !quick_hit(x, cur, seqlen, c->kmers, c->ok))
                continue;
            if ((int)c->voffs.size() < W)
                c->voffs.resize(W);
            lookup_voff_batch(x, c->kmers.data(), c->ok.data(), W,
                              c->voffs.data());
        }

        int hitCounter = 0;
        int64_t last = -1, Ms = 0, MMs = 0, Us = 0, W1s = 0, HIT = 0;
        int64_t prev_j = 0;
        for (int p = 0; p < W; ++p) {
            int64_t v = voffs ? voffs[p] : c->voffs[p];
            if (v < 0)
                continue;
            int64_t j = p + k - 1; // reference scan index (:2516)
            int64_t gaps = hitCounter ? j - prev_j - 1 : 0;
            if (hitCounter && v == last) {
                if (gaps == 0) {
                    Ms += 1;
                } else if (mlen <= gaps && gaps <= k) {
                    Ms += k;
                    MMs += 1;
                } else if (k < gaps) {
                    int64_t ms, mms, us, w1s;
                    reconnect(gaps, &ms, &mms, &us, &w1s);
                    Ms += ms;
                    MMs += mms;
                    Us += us;
                    W1s += w1s;
                } else if (mlen != k) {
                    Ms += gaps;
                    MMs += 1;
                } else {
                    Ms += gaps;
                    W1s += 1;
                    Us += k - gaps;
                }
                HIT = j;
            } else if (hitCounter) {
                int64_t score = Ms * M + MMs * MM + Us * U + W1s * W1;
                int64_t cnt = val_at(x, last);
                for (int64_t i2 = last + 1; i2 <= last + cnt; ++i2) {
                    int64_t t = val_at(x, i2);
                    Scores[t] += score;
                    extendScore[t] = HIT;
                }
                HIT = j - 1;
                cnt = val_at(x, v);
                for (int64_t i2 = v + 1; i2 <= v + cnt; ++i2) {
                    int64_t t = val_at(x, i2);
                    if (include[t]) {
                        int64_t g = HIT - extendScore[t];
                        int64_t s2;
                        if (g == 0) {
                            s2 = M;
                        } else if (mlen <= g && g <= k) {
                            s2 = k * M + MM;
                        } else if (k < g) {
                            int64_t ms, mms, us, w1s;
                            reconnect(g, &ms, &mms, &us, &w1s);
                            s2 = k * M + (ms - k) * M + mms * MM +
                                 us * U + w1s * W1;
                        } else if (mlen != k) {
                            s2 = g * M + MM;
                        } else {
                            s2 = g * M + (k - g) * U + W1;
                        }
                        Scores[t] += s2;
                    } else {
                        Scores[t] = (int64_t)k * M;
                        include[t] = 1;
                        bests[(*nb)++] = (int)t;
                    }
                }
                last = v;
                HIT = j;
                Ms = MMs = Us = W1s = 0;
            } else {
                int64_t cnt = val_at(x, v);
                for (int64_t i2 = v + 1; i2 <= v + cnt; ++i2) {
                    int64_t t = val_at(x, i2);
                    Scores[t] = (int64_t)k * M;
                    include[t] = 1;
                    bests[(*nb)++] = (int)t;
                }
                last = v;
                HIT = j;
            }
            prev_j = j;
            ++hitCounter;
        }
        if (last >= 0) {
            int64_t score = Ms * M + MMs * MM + Us * U + W1s * W1;
            int64_t cnt = val_at(x, last);
            for (int64_t i2 = last + 1; i2 <= last + cnt; ++i2)
                Scores[val_at(x, i2)] += score;
            for (int i2 = 0; i2 < *nb; ++i2) {
                int64_t t = bests[i2];
                extendScore[t] = 0;
                include[t] = 0;
                if (Scores[t] < 0)
                    Scores[t] = 0;
            }
        }
        if (bestSeqCount < hitCounter)
            bestSeqCount = hitCounter;
    }
    return bestSeqCount;
}

int kchain_pair_mate(void *h, const uint8_t *codes, int seqlen,
                     int exhaustive, long long *Score_,
                     long long *Score_r_, long long *extendScore_,
                     uint8_t *include, int *bests_out, int *nb_out,
                     int *bests_r_out, int *nbr_out) {
    return kchain_pair_mate_v(h, codes, seqlen, exhaustive, Score_,
                              Score_r_, extendScore_, include, bests_out,
                              nb_out, bests_r_out, nbr_out, nullptr,
                              nullptr);
}



// ankerAndClean extension loops (savekmers.c:4623-4720 non-mem,
// :4852-5020 MEM; hmm_scan.py:_anker_and_clean): walk the region's
// window voffs [lo, hi], extend the regionTemplates array under the
// branch's coverage/proxi rules (including the reference's cursor-reset
// and no-rc-advance quirks), decrement scores, and pop consumed windows.
// mode: 0 = non-mem coverage, 1 = non-mem proxi, 2 = MEM proxi.
// state in/out: [0] cursor, [1] HIT, [2] bestCov bits (double).
long long kchain_hmm_extend(void *h, long long *VF, long long *VR,
                            long long n_windows, long long lo,
                            long long hi, long long *Score_,
                            long long *Score_r_, unsigned char *include,
                            long long DB_size, int mode,
                            double proxi_score_or_bestcov,
                            long long base_count, int *reg,
                            long long reg_len_in, long long *soft,
                            long long *state) {
    Ctx *c = (Ctx *)h;
    const KIdx *x = &c->x;
    int64_t *Score = (int64_t *)Score_;
    int64_t *Score_r = (int64_t *)Score_r_;
    const int64_t *tl = x->template_lengths;
    long long cursor = state[0];
    long long HIT = state[1];
    double bestCov;
    memcpy(&bestCov, &state[2], 8);
    double proxiScore = proxi_score_or_bestcov;
    long long reg_len = reg_len_in;
    auto reg_write = [&](long long pos, int val) {
        if (pos >= reg_len)
            reg_len = pos + 1;   // caller pre-zeroed the buffer
        reg[pos] = val;
    };
    if (lo < 0)
        lo = 0;
    if (hi > n_windows - 1)
        hi = n_windows - 1;
    for (long long kq = lo; kq <= hi; ++kq) {
        for (int strand = 0; strand < 2; ++strand) {
            long long *V = strand ? VR : VF;
            int64_t *Sc = strand ? Score_r : Score;
            long long v = V[kq];
            if (v < 0)
                continue;
            V[kq] = -1;
            int64_t cnt = val_at(x, v);
            for (int64_t i2 = v + 1; i2 <= v + cnt; ++i2) {
                int64_t t = val_at(x, i2);
                if (mode == 0) {
                    if (!include[t] && t != DB_size) {
                        double thisCov =
                            (double)Sc[t] / (double)tl[t];
                        if (thisCov > bestCov) {
                            include[t] = 1;
                            bestCov = thisCov;
                            cursor = base_count;
                            reg_write(cursor, strand ? -(int)t : (int)t);
                            if (strand)
                                HIT = -1;
                        } else if (thisCov == bestCov) {
                            include[t] = 1;
                            cursor += 1;
                            reg_write(cursor, strand ? -(int)t : (int)t);
                            if (strand)
                                HIT = -1;
                        }
                    }
                } else if (mode == 1) {
                    // non-mem proxi (savekmers.c:4631-4662): bestCov in
                    // holds proxiScore/bestHitsCov
                    int64_t score = Sc[t];
                    if (!include[t] && t != DB_size
                        && ((int64_t)proxiScore <= score
                            || bestCov * (double)tl[t] <= (double)score)) {
                        include[t] = 1;
                        if (!strand)
                            cursor += 1;  // quirk: rc never advances
                        reg_write(cursor, strand ? -(int)t : (int)t);
                        if (soft)
                            soft[t] += score;
                    }
                } else {
                    // MEM proxi (savekmers.c:4900-4960)
                    int64_t score = Sc[t];
                    if (!include[t] && (int64_t)proxiScore <= score
                        && t != DB_size) {
                        include[t] = 1;
                        cursor += 1;
                        reg_write(cursor, strand ? -(int)t : (int)t);
                        if (soft)
                            soft[t] += score;
                    }
                }
                Sc[t] -= 1;
            }
        }
    }
    state[0] = cursor;
    state[1] = HIT;
    memcpy(&state[2], &bestCov, 8);
    return reg_len;
}

// save_kmers (-1t1 scanner, savekmers.c:2442-3065 / mapping/scan.py
// _scan_strand + get_match): both strands scored with the reference's
// strand-asymmetric SNP reconnect, then getBestMatch / getProxiMatch
// selection (soft proxi accumulates into `soft`).  Workspaces return to
// zero.  best lists land in bests/bests_r with scores in bs_out[2].
void kchain_save_kmers(void *h, const uint8_t *codes, int seqlen,
                       int exhaustive, double proxi_frac, int use_proxi,
                       long long *Score_, long long *Score_r_,
                       long long *extendScore_, uint8_t *include,
                       long long *soft, int *bests_out, int *nb_out,
                       int *bests_r_out, int *nbr_out,
                       long long *bs_out) {
    Ctx *c = (Ctx *)h;
    const KIdx *x = &c->x;
    const int k = x->k;
    const int mlen = x->mlen;
    const int64_t M = x->M, MM = x->MM, U = x->U, W1 = x->W1;
    int64_t *extendScore = (int64_t *)extendScore_;
    *nb_out = 0;
    *nbr_out = 0;
    bs_out[0] = 0;
    bs_out[1] = 0;
    if (seqlen < k)
        return;

    auto reconnect = [&](int64_t gaps, int64_t *ms, int64_t *mms,
                         int64_t *us, int64_t *w1s) {
        int64_t g = gaps - (k - 1);
        int64_t mm, m;
        if (g <= 2) {
            mm = g;
            m = 0;
        } else {
            mm = g / k + (g % k ? 1 : 0);
            if (mm < 2)
                mm = 2;
            m = g - mm;
            if (m > k)
                m = k;
            if (m > mm)
                m = mm;
        }
        if ((W1 + (g - 1) * U) <= (mm * MM + m * M)) {
            *ms = k + m;
            *mms = mm;
            *us = 0;
            *w1s = 0;
        } else {
            *ms = k;
            *mms = 0;
            *us = g - 1;
            *w1s = 1;
        }
    };

    for (int rc = 0; rc < 2; ++rc) {
        const uint8_t *cur;
        if (rc) {
            c->rc.assign(codes, codes + seqlen);
            std::reverse(c->rc.begin(), c->rc.end());
            static const uint8_t CMP[6] = {3, 2, 1, 0, 4, 5};
            for (auto &b : c->rc)
                b = CMP[b];
            cur = c->rc.data();
        } else {
            cur = codes;
        }
        int64_t *Scores = (int64_t *)(rc ? Score_r_ : Score_);
        int *bests = rc ? bests_r_out : bests_out;
        int *nb = rc ? nbr_out : nb_out;

        int W = seqlen - k + 1;
        window_kmers(x, cur, seqlen, c->kmers, c->ok);
        if (!exhaustive && !quick_hit(x, cur, seqlen, c->kmers, c->ok))
            continue;
        if ((int)c->voffs.size() < W)
            c->voffs.resize(W);
        lookup_voff_batch(x, c->kmers.data(), c->ok.data(), W,
                          c->voffs.data());

        int hits = 0;
        int64_t last = -1, Ms = 0, MMs = 0, Us = 0, W1s = 0, HIT = 0;
        int64_t prev_j = 0;
        for (int p = 0; p < W; ++p) {
            int64_t v = c->voffs[p];
            if (v < 0)
                continue;
            int64_t j = p + k - 1;
            int64_t gaps = hits ? j - prev_j - 1 : 0;
            if (hits && v == last) {
                if (gaps == 0) {
                    Ms += 1;
                } else if (mlen <= gaps && gaps <= k) {
                    Ms += k;
                    MMs += 1;
                } else if (k < gaps) {
                    int64_t ms, mms, us, w1s;
                    reconnect(gaps, &ms, &mms, &us, &w1s);
                    Ms += ms;
                    MMs += mms;
                    Us += us;
                    W1s += w1s;
                } else if (mlen != k) {
                    Ms += gaps;
                    MMs += 1;
                } else {
                    Ms += gaps;
                    W1s += 1;
                    Us += k - gaps;
                }
                HIT = j;
            } else if (hits) {
                int64_t score = Ms * M + MMs * MM + Us * U + W1s * W1;
                int64_t cnt = val_at(x, last);
                for (int64_t i2 = last + 1; i2 <= last + cnt; ++i2) {
                    int64_t t = val_at(x, i2);
                    Scores[t] += score;
                    extendScore[t] = HIT;
                }
                HIT = j - 1;
                cnt = val_at(x, v);
                for (int64_t i2 = v + 1; i2 <= v + cnt; ++i2) {
                    int64_t t = val_at(x, i2);
                    if (include[t]) {
                        int64_t g = HIT - extendScore[t];
                        int64_t s2;
                        if (g == 0) {
                            s2 = M;
                        } else if (mlen <= g && g <= k) {
                            // strand-asymmetric SNP reconnect
                            // (savekmers.c:2597 fw vs :2908 rc)
                            s2 = rc ? (int64_t)k * M + MM : g * M + MM;
                        } else if (k < g) {
                            int64_t ms, mms, us, w1s;
                            reconnect(g, &ms, &mms, &us, &w1s);
                            s2 = (int64_t)k * M + (ms - k) * M + mms * MM +
                                 us * U + w1s * W1;
                        } else if (mlen != k) {
                            s2 = g * M + MM;
                        } else {
                            s2 = g * M + (k - g) * U + W1;
                        }
                        Scores[t] += s2;
                    } else {
                        Scores[t] = (int64_t)k * M;
                        include[t] = 1;
                        bests[(*nb)++] = (int)t;
                    }
                }
                last = v;
                HIT = j;
                Ms = MMs = Us = W1s = 0;
            } else {
                int64_t cnt = val_at(x, v);
                for (int64_t i2 = v + 1; i2 <= v + cnt; ++i2) {
                    int64_t t = val_at(x, i2);
                    Scores[t] = (int64_t)k * M;
                    include[t] = 1;
                    bests[(*nb)++] = (int)t;
                }
                last = v;
                HIT = j;
            }
            prev_j = j;
            ++hits;
        }
        if (!hits)
            continue;
        // final flush (savekmers.c:2707-2753)
        int64_t score = Ms * M + MMs * MM + Us * U + W1s * W1;
        int64_t cnt = val_at(x, last);
        for (int64_t i2 = last + 1; i2 <= last + cnt; ++i2) {
            int64_t t = val_at(x, i2);
            Scores[t] += score;
            extendScore[t] = HIT;
        }
        for (int i2 = 0; i2 < *nb; ++i2) {
            int64_t t = bests[i2];
            extendScore[t] = 0;
            include[t] = 0;
            if (Scores[t] < 0)
                Scores[t] = 0;
        }
        // getBestMatch / getProxiMatch (savekmers.c:273-340)
        int64_t bestScore = 0;
        int w = 0;
        if (!use_proxi) {
            for (int i2 = 0; i2 < *nb; ++i2) {
                int64_t t = bests[i2];
                int64_t s2 = Scores[t];
                if (s2 > bestScore) {
                    bestScore = s2;
                    w = 0;
                    bests[w++] = (int)t;
                } else if (s2 == bestScore) {
                    bests[w++] = (int)t;
                }
                Scores[t] = 0;
            }
        } else {
            for (int i2 = 0; i2 < *nb; ++i2)
                if (bestScore < Scores[bests[i2]])
                    bestScore = Scores[bests[i2]];
            int64_t proxi_score = (int64_t)(proxi_frac * (double)bestScore);
            for (int i2 = 0; i2 < *nb; ++i2) {
                int64_t t = bests[i2];
                int64_t s2 = Scores[t];
                if (proxi_score <= s2) {
                    bests[w++] = (int)t;
                    if (soft)
                        soft[t] += s2;
                }
                Scores[t] = 0;
            }
        }
        *nb = w;
        bs_out[rc] = bestScore;
    }
}


// ---- save_kmers_HMM helpers (mapping/hmm_scan.py keeps the carving
// logic; these remove the per-window/per-template Python loops) ----

// per-window voffs over an ALREADY-FOLDED strand (the HMM scanner packs
// N as base 0/3 and looks up EVERY window, savekmers.c:3975-3981)
// single-kmer probe (vr0 for the HMM hLenR emulation above)
long long kchain_lookup_kmer(void *h, unsigned long long kmer) {
    Ctx *c = (Ctx *)h;
    return (long long)lookup_voff(&c->x, kmer);
}

void kchain_lookup_windows(void *h, const uint8_t *fold, int seqlen,
                           long long *out) {
    Ctx *c = (Ctx *)h;
    const KIdx *x = &c->x;
    int k = x->k;
    int W = seqlen - k + 1;
    if (W <= 0)
        return;
    // windows are all "valid": no N-masking on the folded strand
    std::vector<uint64_t> &kmers = c->kmers;
    kmers.assign(W, 0);
    uint64_t km = 0;
    for (int i = 0; i < seqlen; ++i) {
        km = ((km << 2) | fold[i]) & x->kroll;
        int j = i - k + 1;
        if (j >= 0)
            kmers[j] = km;
    }
    if (x->cmode) {
        // reuse the cmer transform via the masked path
        c->ok.assign(W, 1);
        uint64_t mm = ((uint64_t)1 << (2 * x->mlen)) - 1;
        for (int j = 0; j < W; ++j) {
            uint64_t raw = kmers[j];
            if (x->cmode == 2) {
                uint64_t o = raw & mm, cur = raw;
                for (int t = 0; t < k - x->mlen; ++t) {
                    cur >>= 2;
                    if ((cur & mm) < o)
                        o = cur & mm;
                }
                kmers[j] = o;
            } else if (x->cmode == 1) {
                int hl;
                uint64_t hh = hmer_of(raw, k, &hl);
                kmers[j] = (k == 16) ? (hh & 0xFFFFFFFFull) : hh;
            } else {
                int hl;
                uint64_t hh = hmer_of(raw, k, &hl);
                uint64_t m = hh & mm;
                if (x->mlen < hl) {
                    uint64_t h2 = hh >> 2;
                    for (int t = 0; t < hl - x->mlen; ++t) {
                        if ((h2 & mm) < m)
                            m = h2 & mm;
                        h2 >>= 2;
                    }
                }
                kmers[j] = m;
            }
        }
    }
    lookup_voff_batch(x, kmers.data(), nullptr, W, (int64_t *)out);
}

// decrement every template of each values list (ankerAndClean's
// clear loops, savekmers.c:4731-4802)
void kchain_dec_voffs(void *h, const long long *voffs, long long n,
                      long long *Score_) {
    Ctx *c = (Ctx *)h;
    const KIdx *x = &c->x;
    int64_t *Score = (int64_t *)Score_;
    for (long long i = 0; i < n; ++i) {
        int64_t vo = voffs[i];
        int64_t cnt = val_at(x, vo);
        for (int64_t p = vo + 1; p <= vo + cnt; ++p)
            --Score[val_at(x, p)];
    }
}

// reps-compressed Score accumulation (savekmers.c:4313-4340):
// Score[t] += reps; first touch appends t to bt.  Returns new count.
int kchain_score_reps(void *h, long long voff, long long reps,
                      long long *Score_, int *bt, int nb) {
    Ctx *c = (Ctx *)h;
    const KIdx *x = &c->x;
    int64_t *Score = (int64_t *)Score_;
    int64_t cnt = val_at(x, voff);
    for (int64_t p = voff + 1; p <= voff + cnt; ++p) {
        int64_t t = val_at(x, p);
        Score[t] += reps;
        if (Score[t] == reps)
            bt[nb++] = (int)t;
    }
    return nb;
}


// One outer iteration of the save_kmers_HMM region finder
// (savekmers.c:3986-4283 / hmm_scan.py:188-369): stride seed search,
// then the 8-parameter log-space HMM extension in both directions,
// filling the window->voff maps.  state = {i, i_r, N} (in/out);
// out = {start, j, stop, hitCounter}.  Returns HIT.
// vr0/hfix: pure-minimizer DBs (flag==2) hit save_kmers_HMM's
// uninitialized hLenR (savekmers.c:3874 declares it; only hLen is set
// at :3935).  getMmerR then scans with *kmersize = stack garbage (a
// large stable value in the compiled oracle), and x86's mod-64 shifts
// make every rc SEED probe's cmer collapse to 0 -- until the first hit
// region runs an initCmer (stdnuc.c:250 initMmer writes *H_len), after
// which rc probes are true minimizers for the REST OF THE READ.  vr0 =
// lookup(kmer 0); *hfix starts 0 per read (1 disables the emulation)
// and flips at each point where the reference would have run an init.
int kchain_hmm_region(const long long *VFL_a, const long long *VRL_a,
                      long long *VFs, long long *VRs, const long long *NN,
                      int seqlen, int k, int exhaustive, const double *hp,
                      long long *state, long long *out,
                      long long vr0, long long *hfix) {
    long long i = state[0], i_r = state[1], N = state[2];
    int seqend = seqlen - k + 1;
    long long fixed = hfix ? *hfix : 1;
    auto VFL = [&](long long w) { return VFL_a[w]; };
    auto VR_at = [&](long long j) {
        return fixed ? VRL_a[seqlen - k - j] : vr0;
    };
    auto VR_true = [&](long long j) { return VRL_a[seqlen - k - j]; };

    // --- find a seed ---
    int HIT = 0;
    long long end;
    if (exhaustive) {
        if (i < seqend)
            fixed = 1;   // initCmer/initCmerR ran (savekmers.c:3985-3990)
        end = NN[N];
        i += k - 1;
        while (i < end && !HIT) {
            long long w = i - k + 1;
            if (VFL(w) >= 0 || VR_at(w) >= 0)
                HIT = 1;
            else {
                ++i;
                --i_r;
            }
        }
        i -= k - 1;
        end -= k - 1;
    } else {
        end = NN[N] - k + 1;
        while (i < end && !HIT) {
            if (VFL(i) >= 0 || VR_at(i) >= 0)
                HIT = 1;
            else {
                i += k;
                i_r -= k;
            }
        }
    }
    if (!HIT) {
        ++N;
        state[0] = i;
        state[1] = i_r;
        state[2] = N;
        if (hfix)
            *hfix = fixed;
        return 0;
    }

    long long hitCounter = 1;
    VFs[i] = VFL(i);
    VRs[i] = VR_at(i);

    // --- extend backward ---
    double Ms_prev = hp[7] + hp[2];
    double Ns_prev = hp[5] + hp[0];
    double Ms = 0.0, Ns = 0.0;
    long long j = i - 1;
    long long j_r = i_r + 1;
    long long n = N - 1;
    if (0 <= j)
        fixed = 1;   // backward-extension init (savekmers.c:4051-4056)
    long long Ncheck = n > 0 ? -1 : NN[n]; // reference quirk
    while (j >= 0) {
        if (j == Ncheck) {
            long long kk = j;
            while (kk >= k && kk < (j - k)) { // dead loop kept verbatim
                if (kk == Ncheck) {
                    j = Ncheck;
                    --n;
                    Ncheck = n > 0 ? -1 : NN[n];
                }
                if (Ns_prev + hp[0] + hp[4] >= Ms_prev + hp[3] + hp[4])
                    Ns = Ns_prev + hp[0] + hp[4];
                else
                    Ns = Ms_prev + hp[3] + hp[4];
                if (Ms_prev + hp[2] + hp[6] >= Ns_prev + hp[1] + hp[6]) {
                    Ms = Ms_prev + hp[2] + hp[6];
                } else {
                    Ms = Ns_prev + hp[1] + hp[6];
                    break;
                }
                --kk;
                Ns_prev = Ns;
                Ms_prev = Ms;
            }
            if (kk >= k && kk < (j - k)) {
                j = kk - 1;
                break;
            }
            j = kk - 1;
            j_r = seqlen - k - kk + 1;
            if (j != Ncheck)
                fixed = 1;   // re-init (savekmers.c:4095-4101)
        } else {
            long long vf = VFL(j);
            long long vr = VR_true(j);
            if (vf >= 0)
                VFs[j] = vf;
            if (vr >= 0)
                VRs[j] = vr;
            if (vf >= 0 || vr >= 0) {
                ++hitCounter;
                if (Ns_prev + hp[0] + hp[5] >= Ms_prev + hp[3] + hp[5])
                    Ns = Ns_prev + hp[0] + hp[5];
                else
                    Ns = Ms_prev + hp[3] + hp[5];
                if (Ms_prev + hp[2] + hp[7] >= Ns_prev + hp[1] + hp[7]) {
                    Ms = Ms_prev + hp[2] + hp[7];
                } else {
                    Ms = Ns_prev + hp[1] + hp[7];
                    --j;
                    break;
                }
            } else {
                if (Ns_prev + hp[0] + hp[4] >= Ms_prev + hp[3] + hp[4])
                    Ns = Ns_prev + hp[0] + hp[4];
                else
                    Ns = Ms_prev + hp[3] + hp[4];
                if (Ms_prev + hp[2] + hp[6] >= Ns_prev + hp[1] + hp[6]) {
                    Ms = Ms_prev + hp[2] + hp[6];
                } else {
                    Ms = Ns_prev + hp[1] + hp[6];
                    --j;
                    break;
                }
            }
            --j;
            ++j_r;
        }
        Ns_prev = Ns;
        Ms_prev = Ms;
    }
    long long start = j + 1;

    // --- extend forward ---
    Ms_prev = hp[7] + hp[2];
    Ns_prev = hp[5] + hp[0];
    j = i + 1;
    j_r = i_r - 1;
    Ncheck = NN[N] - k + 1;
    if (j != Ncheck)
        fixed = 1;   // forward-extension init (savekmers.c:4166-4173)
    while (j < seqend) {
        if (j == Ncheck) {
            long long kk = j;
            while (kk < seqend && kk < (j + k)) {
                if (kk == Ncheck) {
                    j = Ncheck;
                    ++N;
                    Ncheck = (N == NN[0]) ? seqlen : NN[N] - k + 1;
                }
                if (Ns_prev + hp[0] + hp[4] >= Ms_prev + hp[3] + hp[4])
                    Ns = Ns_prev + hp[0] + hp[4];
                else
                    Ns = Ms_prev + hp[3] + hp[4];
                if (Ms_prev + hp[2] + hp[6] >= Ns_prev + hp[1] + hp[6]) {
                    Ms = Ms_prev + hp[2] + hp[6];
                } else {
                    Ms = Ns_prev + hp[1] + hp[6];
                    break;
                }
                ++kk;
                Ns_prev = Ns;
                Ms_prev = Ms;
            }
            if (kk < seqend && kk < (j + k)) {
                j = kk;
                break;
            }
            j = kk;
            j_r = seqlen - k - kk;
            if (j != Ncheck)
                fixed = 1;   // re-init (savekmers.c:4215-4221)
        } else {
            long long vf = VFL(j);
            // unfixed (no init ran yet): the reference's rolling cmerR
            // is stuck at 0 with a ~32k-step Pos counter, so forward
            // rc lookups stay lookup(0) too
            long long vr = fixed ? VRL_a[j_r] : vr0;
            if (vf >= 0)
                VFs[j] = vf;
            if (vr >= 0)
                VRs[j] = vr;
            if (vf >= 0 || vr >= 0) {
                ++hitCounter;
                if (Ns_prev + hp[0] + hp[5] >= Ms_prev + hp[3] + hp[5])
                    Ns = Ns_prev + hp[0] + hp[5];
                else
                    Ns = Ms_prev + hp[3] + hp[5];
                if (Ms_prev + hp[2] + hp[7] >= Ns_prev + hp[1] + hp[7]) {
                    Ms = Ms_prev + hp[2] + hp[7];
                } else {
                    Ms = Ns_prev + hp[1] + hp[7];
                    ++j;
                    break;
                }
            } else {
                if (Ns_prev + hp[0] + hp[4] >= Ms_prev + hp[3] + hp[4])
                    Ns = Ns_prev + hp[0] + hp[4];
                else
                    Ns = Ms_prev + hp[3] + hp[4];
                if (Ms_prev + hp[2] + hp[6] >= Ns_prev + hp[1] + hp[6]) {
                    Ms = Ms_prev + hp[2] + hp[6];
                } else {
                    Ms = Ns_prev + hp[1] + hp[6];
                    ++j;
                    break;
                }
            }
            ++j;
            --j_r;
        }
        Ns_prev = Ns;
        Ms_prev = Ms;
    }
    long long stop = j + k - 1;

    state[0] = i;
    state[1] = i_r;
    state[2] = N;
    out[0] = start;
    out[1] = j;
    out[2] = stop;
    out[3] = hitCounter;
    if (hfix)
        *hfix = fixed;
    return 1;
}


// reps-run flushes over a raw window slice (savekmers.c:4304-4340): runs
// of identical voffs among the SET windows accumulate, misses don't
// break a run.  Returns the new bt count.
int kchain_score_window_runs(void *h, const long long *win, long long n,
                             long long *Score_, int *bt, int nb) {
    Ctx *c = (Ctx *)h;
    const KIdx *x = &c->x;
    int64_t *Score = (int64_t *)Score_;
    int64_t last = -1, reps = 0;
    auto flush = [&](int64_t vo, int64_t rp) {
        int64_t cnt = val_at(x, vo);
        for (int64_t p = vo + 1; p <= vo + cnt; ++p) {
            int64_t t = val_at(x, p);
            Score[t] += rp;
            if (Score[t] == rp)
                bt[nb++] = (int)t;
        }
    };
    for (long long i = 0; i < n; ++i) {
        int64_t v = win[i];
        if (v < 0)
            continue;
        if (v == last) {
            ++reps;
        } else {
            if (last >= 0)
                flush(last, reps);
            reps = 1;
            last = v;
        }
    }
    if (last >= 0)
        flush(last, reps);
    return nb;
}

// intpos_bin_contamination (hashmapkma.c:90-146) -- INCLUDING its
// count-slot false positive (pos can collapse to 0)
static int in_list_quirk(const KIdx *x, int64_t voff, int64_t tmpl) {
    int64_t up = val_at(x, voff);
    if (up == 0)
        return 0;
    int64_t down = 1;
    int64_t pos = (up + down) >> 1;
    while (0 < up - down) {
        int64_t t = val_at(x, voff + pos);
        if (t == tmpl)
            return 1;
        if (t < tmpl)
            down = pos + 1;
        else
            up = pos - 1;
        pos = (up + down) >> 1;
    }
    return val_at(x, voff + pos) == tmpl;
}

// cut limits of a region hit (savekmers.c:4411-4460): per region
// template, walk inward until a window containing it is found; the
// bound is re-read every step
void kchain_cut_limits(void *h, const long long *VFs, const long long *VRs,
                       long long start, long long jj, const int *region,
                       int nreg, long long *out2) {
    Ctx *c = (Ctx *)h;
    const KIdx *x = &c->x;
    long long start_cut = jj;
    for (int r = 0; r < nreg; ++r) {
        int64_t ta = region[r] < 0 ? -region[r] : region[r];
        long long el = start;
        while (el < start_cut) {
            if (VRs[el] >= 0 && in_list_quirk(x, VRs[el], ta))
                start_cut = el;
            if (VFs[el] >= 0 && in_list_quirk(x, VFs[el], ta))
                start_cut = el;
            ++el;
        }
    }
    long long end_cut = start_cut;
    for (int r = 0; r < nreg; ++r) {
        int64_t ta = region[r] < 0 ? -region[r] : region[r];
        long long el = jj;
        while (el > end_cut) {
            if (VRs[el] >= 0 && in_list_quirk(x, VRs[el], ta))
                end_cut = el;
            if (VFs[el] >= 0 && in_list_quirk(x, VFs[el], ta))
                end_cut = el;
            --el;
        }
    }
    out2[0] = start_cut;
    out2[1] = end_cut;
}


// translateToKmersAndDump (sparse.c:50-131) for one read: emit the
// prefix-gated k-mers of both strands, with the reference's
// short-segment skip quirks.  Returns the count written to out
// (capacity 2 * seqlen is always enough).
long long kchain_translate_read(const uint8_t *codes, int seqlen,
                                int kmersize, int prefix_len,
                                unsigned long long prefix,
                                unsigned long long *out) {
    long long n_out = 0;
    std::vector<uint8_t> rc(seqlen);
    static const uint8_t CMP[6] = {3, 2, 1, 0, 4, 5};
    for (int i = 0; i < seqlen; ++i)
        rc[i] = CMP[codes[seqlen - 1 - i]];
    uint64_t kmask = (kmersize < 32)
                         ? (((uint64_t)1 << (2 * kmersize)) - 1)
                         : ~(uint64_t)0;
    uint64_t pmask = prefix_len ? (((uint64_t)1 << (2 * prefix_len)) - 1)
                                : 0;
    for (int s2 = 0; s2 < 2; ++s2) {
        const uint8_t *str = s2 ? rc.data() : codes;
        long long i = 0;
        while (i < seqlen) {
            long long end = seqlen;
            for (long long t = i; t < seqlen; ++t)
                if (str[t] == 4) {
                    end = t;
                    break;
                }
            if (prefix_len) {
                if (i < end - kmersize - prefix_len) {
                    // prefix at [s-prefix_len, s), kmer at [s, s+kmersize)
                    uint64_t pk = 0, kk = 0;
                    // prime the rolling values at s = i + prefix_len
                    for (long long t = i; t < i + prefix_len; ++t)
                        pk = ((pk << 2) | str[t]) & pmask;
                    for (long long t = i + prefix_len;
                         t < i + prefix_len + kmersize; ++t)
                        kk = ((kk << 2) | str[t]) & kmask;
                    for (long long s3 = i + prefix_len;
                         s3 <= end - kmersize; ++s3) {
                        if (pk == prefix)
                            out[n_out++] = kk;
                        // roll both windows one position
                        if (s3 + 1 <= end - kmersize) {
                            pk = ((pk << 2) | str[s3]) & pmask;
                            kk = ((kk << 2) | str[s3 + kmersize]) & kmask;
                        }
                    }
                    i = end + 1;
                } else {
                    i = end + kmersize + 1;
                }
            } else {
                long long lo = i, hi = end - kmersize;
                if (lo <= hi) {
                    uint64_t kk = 0;
                    for (long long t = lo; t < lo + kmersize; ++t)
                        kk = ((kk << 2) | str[t]) & kmask;
                    for (long long s3 = lo; s3 <= hi; ++s3) {
                        out[n_out++] = kk;
                        if (s3 + 1 <= hi)
                            kk = ((kk << 2) | str[s3 + kmersize]) & kmask;
                    }
                }
                i = end + kmersize + 1;
            }
        }
    }
    return n_out;
}


// save_kmers_count (-ck scanner, savekmers.c:3067-3365 / scan.py
// _count_strand): pure repetition counting of identical value-list runs
// per strand (misses do not break a run); the rc strand reuses the
// FORWARD N segmentation (reference bug kept).  getMatch selection as
// in save_kmers.
void kchain_save_kmers_count(void *h, const uint8_t *codes, int seqlen,
                             const long long *npos, int n_np,
                             int exhaustive, double proxi_frac,
                             int use_proxi, long long *Score_,
                             long long *Score_r_, long long *soft,
                             int *bests_out, int *nb_out,
                             int *bests_r_out, int *nbr_out,
                             long long *bs_out) {
    Ctx *c = (Ctx *)h;
    const KIdx *x = &c->x;
    const int k = x->k;
    *nb_out = 0;
    *nbr_out = 0;
    bs_out[0] = 0;
    bs_out[1] = 0;
    if (seqlen < k)
        return;
    int seqend = seqlen - k + 1;

    for (int rc = 0; rc < 2; ++rc) {
        const uint8_t *cur;
        if (rc) {
            c->rc.assign(codes, codes + seqlen);
            std::reverse(c->rc.begin(), c->rc.end());
            static const uint8_t CMP[6] = {3, 2, 1, 0, 4, 5};
            for (auto &b : c->rc)
                b = CMP[b];
            cur = c->rc.data();
        } else {
            cur = codes;
        }
        int64_t *Scores = (int64_t *)(rc ? Score_r_ : Score_);
        int *bests = rc ? bests_r_out : bests_out;
        int *nb = rc ? nbr_out : nb_out;

        // quick stride-k probe per (FW) segment with RAW k-mers
        // (scan.py:368-381 _kmer_at folds N to base 0, no cmer)
        bool hit = exhaustive != 0;
        {
            long long j = 0;
            for (int si = 0; si <= n_np && !hit; ++si) {
                long long ni = si < n_np ? npos[si] : seqlen;
                long long end = ni - k + 1;
                while (j < end) {
                    uint64_t kk = 0;
                    for (int t = 0; t < k; ++t)
                        kk = (kk << 2) | (cur[j + t] & 3);
                    if (lookup_voff(x, kk) >= 0) {
                        hit = true;
                        break;
                    }
                    j += k;
                }
                j = ni + 1;
            }
        }
        if (!hit)
            continue;

        window_kmers(x, cur, seqlen, c->kmers, c->ok);
        int64_t hit_counter = 0;
        int64_t last = -1, reps = 0;
        auto flush = [&]() {
            int64_t cnt = val_at(x, last);
            for (int64_t p = last + 1; p <= last + cnt; ++p) {
                int64_t t = val_at(x, p);
                Scores[t] += reps;
                if (Scores[t] == reps)
                    bests[(*nb)++] = (int)t;
            }
            hit_counter += reps;
        };
        long long j = 0;
        for (int si = 0; si <= n_np; ++si) {
            if (j >= seqend)
                break;
            long long end = si < n_np ? npos[si] : seqlen;
            long long s2 = j;
            for (long long j2 = s2; j2 <= end - k; ++j2) {
                int64_t v = lookup_voff(x, c->kmers[j2]);
                if (v >= 0) {
                    if (v == last) {
                        ++reps;
                    } else {
                        if (last >= 0)
                            flush();
                        reps = 1;
                        last = v;
                    }
                }
            }
            j = end + 1;
        }
        if (last >= 0)
            flush();

        if (!hit_counter) {
            for (int i2 = 0; i2 < *nb; ++i2)
                Scores[bests[i2]] = 0;
            *nb = 0;
            continue;
        }
        // getMatch / getProxiMatch
        int64_t bestScore = 0;
        int w = 0;
        if (!use_proxi) {
            for (int i2 = 0; i2 < *nb; ++i2) {
                int64_t t = bests[i2];
                int64_t s3 = Scores[t];
                if (s3 > bestScore) {
                    bestScore = s3;
                    w = 0;
                    bests[w++] = (int)t;
                } else if (s3 == bestScore) {
                    bests[w++] = (int)t;
                }
                Scores[t] = 0;
            }
        } else {
            for (int i2 = 0; i2 < *nb; ++i2)
                if (bestScore < Scores[bests[i2]])
                    bestScore = Scores[bests[i2]];
            int64_t proxi_score =
                (int64_t)(proxi_frac * (double)bestScore);
            for (int i2 = 0; i2 < *nb; ++i2) {
                int64_t t = bests[i2];
                int64_t s3 = Scores[t];
                if (proxi_score <= s3) {
                    bests[w++] = (int)t;
                    if (soft)
                        ((int64_t *)soft)[t] += s3;
                }
                Scores[t] = 0;
            }
        }
        *nb = w;
        bs_out[rc] = bestScore;
    }
}

} // extern "C"
