// kma_cli — native CLI driver for the plain host-path mapping
// configurations (the reference's one-process C flow, kma.c:1250-1440 +
// runkma.c:130-908).  Covers SE / one-PE-pair fastq mapping against a
// frozen DB with the default output set (.res/.fsa/.aln/.frag.gz); any
// flag outside that envelope exits with code 113 so the bin/kma wrapper
// falls back to the Python CLI (which owns the in-process device
// paths, multihost, and every other tool).
//
// Build: g++ -O2 -march=native -o kma_cli kma_cli.cpp kma_run.cpp \
//        kma_chain.cpp kma_align.cpp kma_assem.cpp kma_io.cpp -lpthread -lz

#include <cctype>
#include <cmath>
#include <condition_variable>
#include <ctime>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <zlib.h>

#include "kma_devclient.h"

typedef long long ll;
typedef unsigned long long ull;

// ---- entry points of the sibling translation units -------------------------
extern "C" {
void kaln_set_circular(int v);
void *krun_create(const void *exist, int exist_es, const void *key_index,
                  int key_es, const void *value_index, int vidx_es,
                  const void *values, int val_es, ull null_index, ull smask,
                  ull mmask, int mega, int use_murmur, int cmode, int k,
                  int mlen, const long long *template_lengths, ll tlen_n,
                  ll db_size, ll M, ll MM, ll U, ll W1, ll Wl,
                  const int32_t *dmat, const char *seq_path, int mode,
                  int exhaustive, int minlen, int mq, double scoreT,
                  double mrc, double coverT, int lc, double aln_min_frac,
                  ll contamination, int n_threads);
void krun_free(void *hv);
void krun_set_pe(void *hv, ll pe);
void krun_set_mem(void *hv, int mem_mode);
void krun_set_proxi(void *hv, double scanner_min_frac, int soft_on);
ll krun_map_se_batch_hmm_dev(void *hv, const uint8_t *codes_flat,
                             const ll *coff, const uint8_t *hdr_flat,
                             const ll *hoff, const ll *ords, int n,
                             const ll *voff_f, const ll *voff_r,
                             ll stride);
void krun_set_sam(void *hv, int mask);
ll krun_sam_len(void *hv);
void krun_sam_fetch(void *hv, uint8_t *buf);
void krun_set_tsv(void *hv, ull mask);
ll krun_tsv_len(void *hv);
void krun_tsv_fetch(void *hv, uint8_t *buf);
void krun_set_xml(void *hv);
ll krun_xml_len(void *hv);
void krun_xml_fetch(void *hv, uint8_t *buf);
ll krun_map_se_batch(void *hv, const uint8_t *codes_flat, const ll *coff,
                     const uint8_t *hdr_flat, const ll *hoff,
                     const ll *ords, int n);
ll krun_map_se_batch_dev(void *hv, const uint8_t *codes_flat,
                         const ll *coff, const uint8_t *hdr_flat,
                         const ll *hoff, const ll *ords, int n,
                         const int32_t *dscores, const uint8_t *dmodes,
                         const uint8_t *dover, const int32_t *dcounts,
                         const int32_t *dflat);
ll krun_map_se_batch_chain_dev(void *hv, const uint8_t *codes_flat,
                               const ll *coff, const uint8_t *hdr_flat,
                               const ll *hoff, const ll *ords, int n,
                               const ll *voff_f, const ll *voff_r,
                               ll stride);
ll krun_map_pe_batch(void *hv, const uint8_t *a_flat, const ll *a_off,
                     const uint8_t *ha_flat, const ll *ha_off,
                     const uint8_t *b_flat, const ll *b_off,
                     const uint8_t *hb_flat, const ll *hb_off,
                     const uint8_t *b_present, const ll *ords, int n,
                     int pm, int fpm, const ll *va_f, const ll *va_r,
                     const ll *vb_f, const ll *vb_r, ll vstride);
void krun_conclave(void *hv, int version, int lc, ll *w_scores,
                   ll *fragment_counts, ll *read_counts,
                   ll template_tot_ulen, double scoreT, double evalue,
                   int cmpm, ll max_frag);
ll krun_output_all(void *hv, const ll *w_scores, const uint8_t *names_flat,
                   const ll *names_off, ll db_size, ll template_tot_ulen,
                   ll Nhits, double evalue, double score_t_gate,
                   int cmp_mode, double ID_t, double Depth_t, int bcd,
                   double support, int base_caller, int significant,
                   int ref_fsa, int want_fsa, int want_aln, int want_frag,
                   int want_matrix, int vcf_filt, int want_ef,
                   const ll *fragment_counts, const ll *read_counts,
                   int t_mod, int t_res, ll Wl_raw, int minlen, int mq, double scoreT, double mrc,
                   int circular, int ts, int skip_tails, int dense,
                   ll *o_res_len, ll *o_fsa_len, ll *o_aln_len,
                   ll *o_frag_len, ll *o_mat_len, ll *o_vcf_len,
                   ll *o_ef_len);
void krun_output_fetch(void *hv, uint8_t *res, uint8_t *fsa, uint8_t *aln,
                       uint8_t *frag, uint8_t *mat, uint8_t *vcf,
                       uint8_t *ef);
ll kio_parse_fastq(const unsigned char *buf, ll len, int last,
                   const unsigned char *to2bit, const double *prob,
                   int scale, int min_phred, int min_q, int hardmask_q,
                   ll min_len, ll max_len, unsigned char *codes_out,
                   ll cap_codes, ll *code_off, unsigned char *hdr_out,
                   ll cap_hdr, ll *hdr_off, int cap_reads, int *n_out,
                   int *status, int emit_all, unsigned char *passed);
ll kio_parse_fasta(const unsigned char *buf, ll len, int last,
                   const unsigned char *to2bit, ll min_len, ll max_len,
                   unsigned char *codes_out, ll cap_codes, ll *code_off,
                   unsigned char *hdr_out, ll cap_hdr, ll *hdr_off,
                   int cap_reads, int *n_out, int *status, int emit_all,
                   unsigned char *passed);
}

#define FALLBACK 113

static void die(const char *msg) {
    fprintf(stderr, "kma_cli: %s\n", msg);
    exit(1);
}

// ---- translation tables (io/seq.py TO2BIT / PROB; kma.c:219-250,1442) -----
static unsigned char TO2BIT[256];
static double PROB[256];
static void init_tables() {
    memset(TO2BIT, 8, sizeof TO2BIT);
    TO2BIT[(int)'\n'] = 16;
    const char *grp[] = {"Aa", "Cc", "Gg", "Tt", "Nn", "Rr", "Yy", "Ss",
                         "Ww", "Kk", "Mm", "Bb", "Dd", "Hh", "Vv", "Xx",
                         "Uu"};
    const int code[] = {0, 1, 2, 3, 4, 0, 1, 2, 3, 2, 0, 1, 0, 3, 2, 4, 3};
    for (size_t g = 0; g < sizeof(grp) / sizeof(*grp); g++)
        for (const char *c = grp[g]; *c; c++)
            TO2BIT[(int)(unsigned char)*c] = (unsigned char)code[g];
    for (int i = 0; i < 256; i++) {
        // "%.32f"-rounded pow like io/seq._phred_prob_table
        char tmp[64];
        snprintf(tmp, sizeof tmp, "%.32f", pow(10.0, -0.1 * i));
        PROB[i] = atof(tmp);
    }
}

// ---- index image (index/format.py load_comp_b; hashmapkma.c:275-455) -----
struct Index {
    // mmap of .comp.b
    uint8_t *map = (uint8_t *)MAP_FAILED;
    size_t map_len = 0;
    uint32_t db_size = 0, mlen = 0, prefix_len = 0;
    ull prefix = 0, size = 0, n = 0, v_index = 0, null_index = 0;
    uint32_t kmersize = 0, flag = 0;
    int mega = 0;
    const void *exist = nullptr;
    int exist_es = 0;
    const void *values = nullptr;
    int val_es = 0;
    const void *key_index = nullptr;
    int key_es = 0;
    const void *value_index = nullptr;
    int vidx_es = 0;
    std::vector<ll> tlen;          // .length.b as i64 ([0] = kmerindex)
    std::vector<uint8_t> names;    // .name raw bytes
    std::vector<ll> names_off;     // per template id (1-based), +1 entries
};

static bool load_index(const std::string &prefix, Index &ix) {
    std::string comp = prefix + ".comp.b";
    int fd = open(comp.c_str(), O_RDONLY);
    if (fd < 0)
        return false;
    struct stat stt;
    fstat(fd, &stt);
    ix.map_len = (size_t)stt.st_size;
    ix.map = (uint8_t *)mmap(nullptr, ix.map_len, PROT_READ, MAP_PRIVATE,
                             fd, 0);
    close(fd);
    if (ix.map == MAP_FAILED)
        return false;
    const uint8_t *p = ix.map;
    memcpy(&ix.db_size, p, 4);
    memcpy(&ix.mlen, p + 4, 4);
    memcpy(&ix.prefix_len, p + 8, 4);
    memcpy(&ix.prefix, p + 12, 8);
    memcpy(&ix.size, p + 20, 8);
    memcpy(&ix.n, p + 28, 8);
    memcpy(&ix.v_index, p + 36, 8);
    memcpy(&ix.null_index, p + 44, 8);
    size_t off = 52;
    ull mask = (1ull << (2 * ix.mlen)) - 1;
    ix.mega = (ix.size - 1) == mask;
    const ull U32MAX = 0xFFFFFFFFull;
    ix.exist_es = ix.mega ? (ix.v_index <= U32MAX ? 4 : 8)
                          : (ix.n <= U32MAX ? 4 : 8);
    ix.exist = p + off;
    off += (size_t)ix.exist_es * ix.size;
    ix.val_es = ix.db_size < 0xFFFF ? 2 : 4;
    ix.values = p + off;
    off += (size_t)ix.val_es * ix.v_index;
    if (!ix.mega) {
        ix.key_es = ix.mlen <= 16 ? 4 : 8;
        ix.key_index = p + off;
        off += (size_t)ix.key_es * (ix.n + 1);
        ix.vidx_es = ix.v_index < U32MAX ? 4 : 8;
        ix.value_index = p + off;
        off += (size_t)ix.vidx_es * ix.n;
    }
    if (off + 8 <= ix.map_len) {
        memcpy(&ix.kmersize, p + off, 4);
        memcpy(&ix.flag, p + off + 4, 4);
    } else {
        ix.kmersize = ix.mlen;
        ix.flag = 0;
    }

    // .length.b: i32 db_size then u32 lengths
    std::string lenp = prefix + ".length.b";
    FILE *lf = fopen(lenp.c_str(), "rb");
    if (!lf)
        return false;
    int32_t db2 = 0;
    if (fread(&db2, 4, 1, lf) != 1) { fclose(lf); return false; }
    std::vector<uint32_t> lens(db2);
    if (db2 && fread(lens.data(), 4, db2, lf) != (size_t)db2) {
        fclose(lf);
        return false;
    }
    fclose(lf);
    ix.tlen.assign(lens.begin(), lens.end());

    // .name lines, template t = line t-1
    std::string namep = prefix + ".name";
    FILE *nf = fopen(namep.c_str(), "rb");
    if (!nf)
        return false;
    fseek(nf, 0, SEEK_END);
    long nsz = ftell(nf);
    fseek(nf, 0, SEEK_SET);
    std::vector<uint8_t> raw(nsz);
    if (nsz && fread(raw.data(), 1, nsz, nf) != (size_t)nsz) {
        fclose(nf);
        return false;
    }
    fclose(nf);
    ix.names_off.push_back(0);   // template 0 placeholder (empty)
    ix.names_off.push_back(0);
    long i = 0;
    while (i < nsz) {
        long j = i;
        while (j < nsz && raw[j] != '\n')
            j++;
        ix.names.insert(ix.names.end(), raw.begin() + i, raw.begin() + j);
        ix.names_off.push_back((ll)ix.names.size());
        i = j + 1;
    }
    return true;
}

// fastq check: the native reader is fastq-only; fasta (and anything
// else) falls back to the Python CLI
static bool is_fastq(const char *path) {
    gzFile f = gzopen(path, "rb");
    if (!f)
        return false;
    int c = gzgetc(f);
    gzclose(f);
    return c == '@';
}

// 1 = fastq, 2 = fasta, 0 = unknown (openAndDetermine bits)
static int seq_format(const char *path) {
    gzFile f = gzopen(path, "rb");
    if (!f)
        return 0;
    int c = gzgetc(f);
    gzclose(f);
    return c == '@' ? 1 : c == '>' ? 2 : 0;
}

// ---- phred scale sniff (io/seq.sniff_phred_scale; seqparse.c:551-589) -----
static int sniff_phred(const char *path) {
    gzFile f = gzopen(path, "rb");
    if (!f)
        return 33;
    static std::vector<uint8_t> data(1 << 20);
    int n = gzread(f, data.data(), 1 << 20);
    gzclose(f);
    if (n <= 0)
        return 33;
    int scale = 33, maxlen = 0;
    long i = 0;
    while (i < n) {
        int seek = 3;
        while (seek && i < n - 1) {
            i++;
            if (data[i] == 0x0A)
                seek--;
        }
        int ln = 0;
        bool cont = i < n - 1;
        while (cont && i < n - 1) {
            i++;
            uint8_t c = data[i];
            if (c == 0x0A)
                cont = false;
            else if (c < 33)
                return 0;
            else if (53 < c && c < 59)
                return 33;
            else if (94 < c)
                scale = 64;
            if (cont)
                ln++;
        }
        if (maxlen < ln)
            maxlen = ln;
        if (i >= n - 1)
            break;
    }
    return maxlen <= 301 ? scale : 33;
}

// ---- streaming fastq batches (io/native_io.iter_fastq_native_batches) ----
struct FqStream {
    gzFile f = nullptr;
    std::vector<uint8_t> carry;
    std::vector<uint8_t> buf;
    bool eof = false;
    static const ll CHUNK = 8 << 20;

    bool open(const char *path) {
        f = gzopen(path, "rb");
        return f != nullptr;
    }
    ~FqStream() {
        if (f)
            gzclose(f);
    }
};

struct FqBatch {
    std::vector<uint8_t> codes, hdr, passed;
    std::vector<ll> coff, hoff;
    int n = 0;
};

// pull one parsed batch; returns false at end of stream
static bool next_batch(FqStream &s, int fmt, int scale, int min_phred,
                       int min_q, int hardmask_q, ll min_len, ll max_len,
                       int emit_all, FqBatch &out) {
    const int CAP_READS = 1 << 15;
    for (;;) {
        if (s.carry.empty() && !s.eof) {
            s.buf.resize(FqStream::CHUNK);
            int got = gzread(s.f, s.buf.data(), (unsigned)FqStream::CHUNK);
            if (got <= 0) {
                s.eof = true;
                s.buf.clear();
            } else {
                s.buf.resize(got);
            }
            s.carry.swap(s.buf);
            if (!s.eof) {
                // keep pulling until we have a decent chunk or EOF
            }
        } else if (!s.eof) {
            size_t base = s.carry.size();
            s.carry.resize(base + FqStream::CHUNK);
            int got = gzread(s.f, s.carry.data() + base,
                             (unsigned)FqStream::CHUNK);
            if (got <= 0) {
                s.eof = true;
                s.carry.resize(base);
            } else {
                s.carry.resize(base + got);
            }
        }
        if (s.carry.empty())
            return false;
        ll cap = (ll)s.carry.size();
        out.codes.resize(cap);
        // fasta headers keep '>' and gain a NUL: +1 byte per record
        out.hdr.resize(cap + CAP_READS);
        out.coff.resize(CAP_READS + 1);
        out.hoff.resize(CAP_READS + 1);
        out.passed.resize(CAP_READS);
        int n_out = 0, status = 0;
        ll consumed = fmt == 2
            ? kio_parse_fasta(
                  s.carry.data(), cap, s.eof ? 1 : 0, TO2BIT, min_len,
                  max_len, out.codes.data(), cap, out.coff.data(),
                  out.hdr.data(), cap + CAP_READS, out.hoff.data(),
                  CAP_READS, &n_out, &status, emit_all,
                  emit_all ? out.passed.data() : nullptr)
            : kio_parse_fastq(
                  s.carry.data(), cap, s.eof ? 1 : 0, TO2BIT, PROB, scale,
                  min_phred, min_q, hardmask_q, min_len, max_len,
                  out.codes.data(), cap, out.coff.data(), out.hdr.data(),
                  cap + CAP_READS, out.hoff.data(), CAP_READS, &n_out,
                  &status, emit_all,
                  emit_all ? out.passed.data() : nullptr);
        if (status != 0)
            die("malformed sequence record");
        s.carry.erase(s.carry.begin(), s.carry.begin() + consumed);
        out.n = n_out;
        if (n_out > 0)
            return true;
        if (s.eof && s.carry.empty())
            return false;
        if (s.eof && consumed == 0)
            return false;   // trailing garbage
    }
}

// ---- async batch reader (the reference's input thread, kmers.c) -----------
struct BatchQueue {
    std::mutex mu;
    std::condition_variable cv;
    std::deque<FqBatch> q;
    bool done = false;
    size_t cap = 3;

    void push(FqBatch&& b) {
        std::unique_lock<std::mutex> l(mu);
        cv.wait(l, [&] { return q.size() < cap; });
        q.push_back(std::move(b));
        cv.notify_all();
    }
    bool pop(FqBatch& out) {
        std::unique_lock<std::mutex> l(mu);
        cv.wait(l, [&] { return !q.empty() || done; });
        if (q.empty())
            return false;
        out = std::move(q.front());
        q.pop_front();
        cv.notify_all();
        return true;
    }
    void finish() {
        std::lock_guard<std::mutex> l(mu);
        done = true;
        cv.notify_all();
    }
};

static void reader_thread(const std::string path, int fmt, int scale,
                          int mp, int min_q, int hardmask_q, ll min_len,
                          ll max_len, int emit_all, BatchQueue* out) {
    FqStream s;
    if (!s.open(path.c_str())) {
        out->finish();
        return;
    }
    FqBatch b;
    while (next_batch(s, fmt, scale, mp, min_q, hardmask_q, min_len,
                      max_len, emit_all, b))
        out->push(std::move(b));
    out->finish();
}

// ---- gz writer (writers.open_gz: zlib level 1) ----------------------------
static void write_gz(const std::string &path, const uint8_t *data, ll n) {
    gzFile g = gzopen(path.c_str(), "wb1");
    if (!g)
        die("cannot open .frag.gz for writing");
    ll w = 0;
    while (w < n) {
        unsigned chunk = (unsigned)((n - w) > (1 << 28) ? (1 << 28)
                                                        : (n - w));
        if (gzwrite(g, data + w, chunk) != (int)chunk)
            die("gzwrite failed");
        w += chunk;
    }
    gzclose(g);
}

static void write_file(const std::string &path, const char *head,
                       const uint8_t *data, ll n) {
    FILE *f = fopen(path.c_str(), "wb");
    if (!f)
        die("cannot open output file");
    if (head)
        fwrite(head, 1, strlen(head), f);
    if (n)
        fwrite(data, 1, (size_t)n, f);
    fclose(f);
}

// ---- config (config.py defaults; kma.c:281-348) ---------------------------
struct Cfg {
    std::vector<std::string> in_se;
    std::vector<std::string> in_pe1, in_pe2;
    std::string t_db, out;
    bool one2one = false;
    bool hmm = false;              // -hmm probabilistic splicing scan
    int sam = 0;                   // -sam [mask]: SAM rows to stdout
    ull tsv = 0;                   // -tsv [mask]: .tsv stat table
    int xml = 0;                   // -xml [n]: BLAST-ish XML (2=stdout)
    int pm = 0, fpm = 0;           // 0 union, 1 penalty
    bool pe = false;
    bool mem_mode = false;
    bool device_on = false;        // -device on: devserve daemon scan
    int threads = 1;
    int min_phred = 20, hardmask_q = 0, min_q = 0;
    ll min_len = 16, max_len = 2147483647LL;
    double score_t = 0.5, mrc = 0.0, cover_t = 0.1;
    int mq = 0;
    double evalue = 0.05;
    double ID_t = 1.0, Depth_t = 0.0;
    int bcd = 1;
    double support = 0.0;
    int base_caller = 0;           // default
    int significant = 0;           // mcnemar
    bool print_matrix = false, ef = false;
    int vcf = 0;                   // 0 off, 1 default, 2 apply FT
    int nc = 0;                    // bit1 = no .fsa, bit2 = no .aln
    bool nf = false;               // no .frag.gz
    // penalties (kma.c:328-337)
    int M = 1, U = -1, W1 = -3, Wl = -6, Mn = 0, PE = 7, Ts = -2, Tv = -2;
    std::vector<std::string> in_int;   // -int interleaved PE files
    int conclave = 1;              // -ConClave 1/2
    long long max_frag = 1000000;  // -mf (kma.c:311,1045-1052)
    // preset / long-read machinery (kma.c:568-717, 1024-1248)
    double min_frac = 1.0;         // -proxi (negative = soft)
    int lc = 0;                    // -lc length-corrected selection
    int ts = 0;                    // -ts seed front trim
    int circular = 0;              // -ca circular templates
    int dense = 0;                 // -dense insertion-free pileup
    int ref_fsa = 0;               // -ref_fsa [n]
    int preset = 0;                // bitmask as kma.c keeps it
};

// score_matrix (config.Penalties.score_matrix; kma.c:1307-1328)
static void score_matrix(const Cfg &c, int32_t *d, int *MM_out) {
    int MM = (c.Ts + c.Tv - 1) / 2;   // C99 trunc division
    if ((c.Ts + c.Tv - 1) % 2 != 0 && (c.Ts + c.Tv - 1) < 0)
        MM = (c.Ts + c.Tv - 1) / 2;   // already truncates toward zero
    *MM_out = MM;
    for (int i = 0; i < 4; i++) {
        for (int j = 0; j < 4; j++)
            d[i * 5 + j] = c.Tv;
        d[i * 5 + 4] = c.Mn;
        int tr = (i - 2) < 0 ? i + 2 : i - 2;
        d[i * 5 + tr] = c.Ts;
        d[i * 5 + i] = c.M;
    }
    for (int j = 0; j < 5; j++)
        d[4 * 5 + j] = c.Mn;
    d[4 * 5 + 4] = 0;
}

int main(int argc, char **argv) {
    Cfg cfg;
    for (int i = 1; i < argc; i++) {
        std::string a = argv[i];
        // every value-taking flag below reads argv[i+1]
        static const char *valflags[] = {"-t_db", "-o", "-apm", "-pm",
                                         "-fpm", "-t", "-device", "-ID",
                                         "-md", "-bcd", "-mrs", "-mrc",
                                         "-ml", "-mp", "-e", "-p", "-mq",
                                         "-eq", "-mi", "-xl", "-5p", "-3p",
                                         "-reward", "-penalty", "-gapopen",
                                         "-gapextend", "-localopen",
                                         "-Npenalty", "-per",
                                         "-transition", "-transversion",
                                         "-ConClave", "-proxi", "-mct",
                                         "-ts"};
        bool needs_val = false;
        for (const char *v : valflags)
            if (a == v)
                needs_val = true;
        if (needs_val && i + 1 >= argc)
            return FALLBACK;
        if (a == "-i") {
            while (i + 1 < argc && argv[i + 1][0] != '-')
                cfg.in_se.push_back(argv[++i]);
        } else if (a == "-ipe") {
            // consume an even run of non-dash args as (R1, R2) pairs
            // (kma.c:395-420; repeatable and multi-pair)
            int n_pe = 0;
            while (i + 1 + n_pe < argc && argv[i + 1 + n_pe][0] != '-')
                ++n_pe;
            if (n_pe == 0 || (n_pe & 1))
                return FALLBACK;   // python prints the usage error
            for (int z = 0; z < n_pe; z += 2) {
                cfg.in_pe1.push_back(argv[i + 1 + z]);
                cfg.in_pe2.push_back(argv[i + 2 + z]);
            }
            i += n_pe;
            cfg.pe = true;
        } else if (a == "-int") {
            while (i + 1 < argc && argv[i + 1][0] != '-')
                cfg.in_int.push_back(argv[++i]);
            if (cfg.in_int.empty())
                return FALLBACK;   // python prints the usage error
            cfg.pe = true;         // pairing gates apply (kma.c:419-434)
        } else if (a == "-t_db") {
            cfg.t_db = argv[++i];
        } else if (a == "-o") {
            cfg.out = argv[++i];
        } else if (a == "-1t1") {
            cfg.one2one = true;
        } else if (a == "-hmm") {
            cfg.hmm = true;
            cfg.one2one = false;
        } else if (a == "-mem_mode") {
            cfg.mem_mode = true;
        } else if (a == "-apm") {
            std::string v = argv[++i];
            if (v == "u") { cfg.pm = 0; cfg.fpm = 0; }
            else if (v == "p") { cfg.pm = 1; cfg.fpm = 1; }
            else if (v == "f") { cfg.pm = 2; cfg.fpm = 2; }
            else return FALLBACK;
        } else if (a == "-pm") {
            std::string v = argv[++i];
            if (v == "u") cfg.pm = 0;
            else if (v == "p") cfg.pm = 1;
            else if (v == "f") cfg.pm = 2;
            else return FALLBACK;
        } else if (a == "-fpm") {
            std::string v = argv[++i];
            if (v == "u") cfg.fpm = 0;
            else if (v == "p") cfg.fpm = 1;
            else if (v == "f") cfg.fpm = 2;
            else return FALLBACK;
        } else if (a == "-t") {
            cfg.threads = atoi(argv[++i]);
            if (cfg.threads < 1) cfg.threads = 1;
        } else if (a == "-device") {
            std::string v = argv[++i];
            if (v == "on") cfg.device_on = true;
            else if (v != "off") return FALLBACK;
        } else if (a == "-bc") {
            if (i + 1 < argc && argv[i + 1][0] != '-') {
                cfg.support = atof(argv[++i]);
                cfg.significant = 2;   // support
            }
        } else if (a == "-bcNano") {
            if (cfg.significant == 0)
                cfg.significant = 1;   // and90
            cfg.base_caller = 3;       // nano
        } else if (a == "-bc90") {
            cfg.significant = 1;
        } else if (a == "-bcg") {
            cfg.base_caller = 1;
        } else if (a == "-ID") {
            cfg.ID_t = atof(argv[++i]);
        } else if (a == "-md") {
            cfg.Depth_t = atof(argv[++i]);
        } else if (a == "-bcd") {
            cfg.bcd = atoi(argv[++i]);
        } else if (a == "-mrs") {
            cfg.score_t = atof(argv[++i]);
        } else if (a == "-mrc") {
            cfg.mrc = atof(argv[++i]);
        } else if (a == "-ml") {
            cfg.min_len = atoll(argv[++i]);
        } else if (a == "-mp") {
            cfg.min_phred = atoi(argv[++i]);
        } else if (a == "-e" || a == "-p") {
            cfg.evalue = atof(argv[++i]);
        } else if (a == "-mq") {
            cfg.mq = atoi(argv[++i]);
        } else if (a == "-eq") {
            cfg.min_q = atoi(argv[++i]);
        } else if (a == "-mi") {
            cfg.hardmask_q = atoi(argv[++i]);
        } else if (a == "-xl") {
            cfg.max_len = atoll(argv[++i]);
        } else if (a == "-5p" || a == "-3p") {
            // parsed but unused in mapping mode (phredStat takes them
            // and never reads them, runinput.c:127; sparse-only)
            ++i;
        } else if (a == "-reward") {
            cfg.M = abs(atoi(argv[++i]));
        } else if (a == "-penalty") {
            // no-op quirk: rewards->MM set here is overwritten
            // unconditionally by (Ts+Tv-1)/2 at kma.c:1307
            ++i;
        } else if (a == "-gapopen") {
            int v = atoi(argv[++i]);
            cfg.W1 = v < -v ? v : -v;
        } else if (a == "-gapextend") {
            int v = atoi(argv[++i]);
            cfg.U = v < -v ? v : -v;
        } else if (a == "-localopen") {
            int v = atoi(argv[++i]);
            cfg.Wl = v < -v ? v : -v;
        } else if (a == "-Npenalty") {
            int v = atoi(argv[++i]);
            cfg.Mn = v < -v ? v : -v;
        } else if (a == "-per") {
            cfg.PE = abs(atoi(argv[++i]));
        } else if (a == "-transition") {
            int v = atoi(argv[++i]);
            cfg.Ts = v < -v ? v : -v;
        } else if (a == "-transversion") {
            int v = atoi(argv[++i]);
            cfg.Tv = v < -v ? v : -v;
        } else if (a == "-mf") {
            cfg.max_frag = atoll(argv[++i]);
        } else if (a == "-ConClave") {
            cfg.conclave = atoi(argv[++i]);
            if (cfg.conclave < 1 || 2 < cfg.conclave)
                return FALLBACK;   // python prints the usage error
        } else if (a == "-proxi") {
            cfg.min_frac = atof(argv[++i]);
            if (cfg.min_frac < -1 || 1 < cfg.min_frac)
                return FALLBACK;   // python prints the usage error
        } else if (a == "-lc") {
            cfg.lc = 1;
        } else if (a == "-mct") {
            cfg.cover_t = atof(argv[++i]);
        } else if (a == "-ts") {
            cfg.ts = atoi(argv[++i]);
        } else if (a == "-ca") {
            cfg.circular = 1;
        } else if (a == "-dense") {
            cfg.dense = 1;
        } else if (a == "-ref_fsa") {
            // optional numeric value; bare 0 means 2 (kma.c:671-683)
            cfg.ref_fsa = 1;
            if (i + 1 < argc && argv[i + 1][0] != '-') {
                cfg.ref_fsa = atoi(argv[++i]);
                if (cfg.ref_fsa == 0)
                    cfg.ref_fsa = 2;
            }
        } else if (a == "-cge") {
            // kma.c:1024-1030 (MM=-3 is overwritten by (Ts+Tv-1)/2)
            cfg.score_t = 0.5;
            cfg.M = 1;
            cfg.W1 = -5;
            cfg.U = -1;
            cfg.PE = 17;
        } else if (a == "-ont") {
            // kma.c:1115-1157: -bcNano -bc 0.7 -mct 0.1 -bcd 10
            // -proxi -0.9 -mrs 0.25 -mrc 0.7 -eq 10 -lc -ts 2
            cfg.preset |= 4;
            cfg.base_caller = 3;
            cfg.significant = 2;
            cfg.support = 0.7;
            cfg.cover_t = 0.1;
            cfg.bcd = 10;
            cfg.min_frac = -0.9;
            cfg.score_t = 0.25;
            cfg.mrc = 0.7;
            cfg.min_q = 10;
            cfg.lc = 1;
            cfg.ts = 2;
        } else if (a == "-ill") {
            // kma.c:1159-1201: -1t1 -mrc 0.1 -lc -proxi -0.98 -bc 0.9
            // -bcd 10 (the -cge and -apm p blocks are commented out)
            cfg.preset |= 8;
            cfg.one2one = true;
            cfg.mrc = 0.1;
            cfg.lc = 1;
            cfg.min_frac = -0.98;
            cfg.significant = 2;
            cfg.support = 0.9;
            cfg.bcd = 10;
        } else if (a == "-asm") {
            // kma.c:1203-1248: -bc 0.5 -p 0.5 -mct 0.1 -bcd 1
            // -proxi -0.9 -mrs 0.25 -mrc 0.7 -lc -ts 2
            cfg.preset |= 16;
            cfg.significant = 2;
            cfg.support = 0.5;
            cfg.evalue = 0.5;
            cfg.cover_t = 0.1;
            cfg.bcd = 1;
            cfg.min_frac = -0.9;
            cfg.score_t = 0.25;
            cfg.mrc = 0.7;
            cfg.lc = 1;
            cfg.ts = 2;
        } else if (a == "-mint2") {
            // kma.c:1069-1094: -1t1 -mem_mode -ca -cge -mq 1 -ref_fsa 2
            // -dense -bcg -bcd 10 -bc 0.9 -vcf -ef
            cfg.preset |= 1;
            cfg.one2one = true;
            cfg.mem_mode = true;
            cfg.circular = 1;
            cfg.score_t = 0.75;
            cfg.M = 1;
            cfg.W1 = -5;
            cfg.U = -1;
            cfg.PE = 17;
            cfg.mq = 1;
            cfg.ref_fsa = 2;
            cfg.dense = 1;
            cfg.base_caller = 1;
            cfg.bcd = 10;
            cfg.significant = 2;
            cfg.support = 0.9;
            cfg.vcf = 1;
            cfg.ef = true;
        } else if (a == "-mint3") {
            // kma.c:1095-1114: -1t1 -mem_mode -ca -mq 1 -ref_fsa 2
            // -dense -bcNano -bcd 10 -bc 0.7 -vcf -ef
            cfg.preset |= 2;
            cfg.one2one = true;
            cfg.mem_mode = true;
            cfg.circular = 1;
            cfg.mq = 1;
            cfg.ref_fsa = 2;
            cfg.dense = 1;
            cfg.base_caller = 3;
            cfg.bcd = 10;
            cfg.significant = 2;
            cfg.support = 0.7;
            cfg.vcf = 1;
            cfg.ef = true;
        } else if (a == "-matrix") {
            cfg.print_matrix = true;
        } else if (a == "-ef") {
            cfg.ef = true;
        } else if (a == "-xml") {
            if (i + 1 < argc && isdigit((unsigned char)argv[i + 1][0]))
                cfg.xml = atoi(argv[++i]);
            else
                cfg.xml = 1;
        } else if (a == "-tsv") {
            if (i + 1 < argc && isdigit((unsigned char)argv[i + 1][0]))
                cfg.tsv = strtoull(argv[++i], nullptr, 10);
            else
                cfg.tsv = ~0ull;
        } else if (a == "-sam") {
            if (i + 1 < argc && isdigit((unsigned char)argv[i + 1][0]))
                cfg.sam = atoi(argv[++i]);
            else
                cfg.sam = 1;
        } else if (a == "-vcf") {
            if (i + 1 < argc && isdigit((unsigned char)argv[i + 1][0]))
                cfg.vcf = atoi(argv[++i]);
            else
                cfg.vcf = 1;
        } else if (a == "-nc") {
            cfg.nc |= 2;   // kills .aln, not .fsa (kma.c:1018-1021)
        } else if (a == "-na") {
            cfg.nc |= 1;   // no-op alone: nc&2 re-opens .fsa
        } else if (a == "-nf") {
            cfg.nf = true;
        } else {
            return FALLBACK;   // anything else: Python owns it
        }
    }
    if (cfg.t_db.empty() || cfg.out.empty())
        return FALLBACK;
    if (cfg.in_se.empty() && !cfg.pe)
        return FALLBACK;
    // mixed SE+PE runs natively: SE files stream first, then the -ipe
    // pairs, frag ordinals continuous across both (kma.c:1559-1567)
    for (const std::string &p : cfg.in_se)
        if (!seq_format(p.c_str()))
            return FALLBACK;
    for (size_t z = 0; z < cfg.in_pe1.size(); z++)
        if (!seq_format(cfg.in_pe1[z].c_str())
            || !seq_format(cfg.in_pe2[z].c_str()))
            return FALLBACK;
    for (const std::string &p : cfg.in_int)
        if (!seq_format(p.c_str()))
            return FALLBACK;
    // -device on: the native envelope is the SE -1t1 dense-scan shape
    // (the daemon's dense op); everything else keeps the Python device
    // paths.  No live daemon -> Python decides (in-process device).
    if (cfg.hmm && cfg.pe && (cfg.sam || cfg.device_on))
        return FALLBACK;   // PE+HMM: sam/device combos stay on Python
    // -proxi envelope: the native proxi machinery covers the SE chain
    // scan (getProxiChainTemplates) and the SE -1t1 scan
    // (getProxiMatch); PE combiners (getF/R_Proxi), HMM, SAM and the
    // device scan stream keep the Python path.  -proxi +-1.0 keeps the
    // reference's no-op-pointer quirk on the Python path too.
    const bool proxi_active = cfg.min_frac != 1.0 && cfg.min_frac != -1.0;
    if (cfg.min_frac == -1.0)
        return FALLBACK;
    if (proxi_active && (cfg.hmm || cfg.sam || cfg.device_on))
        return FALLBACK;
    DevConn *dc = nullptr;
    if (cfg.device_on) {
        // native device envelope: SE -1t1 (dense scan op), the SE
        // chain modes, the HMM splicing scan (chain probe op over the
        // folded codes) and PE mate probes
        dc = kdev_connect(cfg.t_db.c_str());
        if (!dc)
            return FALLBACK;
        fprintf(stderr, "# device: using devserve session\n");
    }

    init_tables();
    // -ca: batched step-3 scorers chain circular (chainSeedsPtr role)
    kaln_set_circular(cfg.circular);
    fprintf(stderr, "# Running KMA.\n");
    const bool prof = getenv("KMA_RUN_PROF") != nullptr;
    auto now = [] {
        struct timespec ts;
        clock_gettime(CLOCK_MONOTONIC, &ts);
        return ts.tv_sec + 1e-9 * ts.tv_nsec;
    };
    double tw0 = now();
    Index ix;
    if (!load_index(cfg.t_db, ix))
        return FALLBACK;

    int32_t dmat[25];
    int MM;
    score_matrix(cfg, dmat, &MM);
    double db_t0 = 0.0;

    void *R = krun_create(
        ix.exist, ix.exist_es, ix.key_index, ix.key_es, ix.value_index,
        ix.vidx_es, ix.values, ix.val_es, ix.null_index, ix.size - 1,
        (1ull << (2 * ix.mlen)) - 1, ix.mega, ix.flag ? 1 : 0,
        (int)(ix.flag & 3), (int)ix.kmersize, (int)ix.mlen,
        ix.tlen.data(), (ll)ix.tlen.size(), (ll)ix.db_size, cfg.M, MM,
        cfg.U, cfg.W1, cfg.Wl, dmat, (cfg.t_db + ".seq.b").c_str(),
        cfg.hmm ? 2 : (cfg.one2one ? 0 : 1), 0, (int)cfg.min_len,
        cfg.mq, cfg.score_t,
        cfg.mrc, cfg.cover_t, cfg.lc,
        (cfg.preset & 16) && !cfg.mem_mode ? 1.0 : cfg.min_frac, -1,
        cfg.threads);
    if (!R)
        return FALLBACK;
    krun_set_pe(R, cfg.PE);
    if (cfg.mem_mode)
        krun_set_mem(R, 1);
    if (proxi_active) {
        // the scanners see |minFrac| (kmers.c:133-142); softProxi only
        // for mem_mode with a soft (negative) -proxi
        double sf = (!cfg.mem_mode && cfg.min_frac < 0) ? -cfg.min_frac
                                                        : cfg.min_frac;
        int soft_on = 0;
        if (sf < 0) {
            sf = -sf;
            soft_on = 1;
        }
        if (sf < 1.0)
            krun_set_proxi(R, sf, soft_on);
    }
    if (cfg.tsv)
        krun_set_tsv(R, cfg.tsv);
    if (cfg.xml)
        krun_set_xml(R);
    if (cfg.sam) {
        krun_set_sam(R, cfg.sam);
        // saminit (sam.c:100-112); CL echoes this invocation
        fputs("@HD\tVN:1.6\tGO:reference\n", stdout);
        fputs("@PG\tID:KMA\tPN:kma\tVN:1.5.1\tCL:kma", stdout);
        for (int ai = 1; ai < argc; ai++) {
            fputc(' ', stdout);
            fputs(argv[ai], stdout);
        }
        fputc('\n', stdout);
        for (uint32_t t = 1; t < ix.db_size; t++) {
            fputs("@SQ\tSN:", stdout);
            fwrite(ix.names.data() + ix.names_off[t],
                   1, (size_t)(ix.names_off[t + 1] - ix.names_off[t]),
                   stdout);
            fprintf(stdout, "\tLN:%lld\n", (long long)ix.tlen[t]);
        }
    }
    std::vector<uint8_t> samtmp;
    auto sam_drain = [&]() {
        if (!cfg.sam)
            return;
        ll n = krun_sam_len(R);
        if (!n)
            return;
        samtmp.resize((size_t)n);
        krun_sam_fetch(R, samtmp.data());
        fwrite(samtmp.data(), 1, (size_t)n, stdout);
    };

    int mp = cfg.min_phred;
    if (mp < cfg.hardmask_q) mp = cfg.hardmask_q;   // kma.c:1554-1556

    ll n_frags = 0;
    std::vector<ll> ords;
    if (!cfg.in_se.empty()) {
        // device-scan plumbing: reader batches are sliced into daemon
        // requests a few thousand reads wide and pipelined 2 deep, so
        // the chip's scan of slice k+1/k+2 overlaps the native
        // step-3/spool work on slice k
        struct DevBatch {
            FqBatch b;
            std::vector<ll> ords;
        };
        struct DevSlice {
            std::shared_ptr<DevBatch> db;
            int start, n;
        };
        // slice width (reads per daemon request) / pipeline depth
        int DEVSLICE = 8192;
        if (const char *e = getenv("KMA_DEVSLICE"))
            DEVSLICE = atoi(e) > 0 ? atoi(e) : DEVSLICE;
        int DEVDEPTH = 3;
        if (const char *e = getenv("KMA_DEVDEPTH"))
            DEVDEPTH = atoi(e) > 0 ? atoi(e) : DEVDEPTH;
        const bool chain_dev = !cfg.one2one;   // chain probe op
        std::deque<DevSlice> inflight;
        std::vector<uint8_t> dcodes;
        std::vector<int32_t> dlens, dscores, dcounts, dflat;
        std::vector<uint8_t> dmodes, dover;
        std::vector<ll> dvf, dvr;
        auto pad_len = [](int mx) {
            int Lb = 128;
            while (Lb < mx)
                Lb = (Lb * 3 / 2 + 63) / 64 * 64;
            return Lb;
        };
        auto dev_send = [&](const DevSlice &s) {
            const FqBatch &b = s.db->b;
            int mx = 1;
            for (int i = s.start; i < s.start + s.n; i++) {
                int l = (int)(b.coff[i + 1] - b.coff[i]);
                if (l > mx)
                    mx = l;
            }
            // the Python DeviceScanStream's length buckets, so client
            // runs share the daemon's warmed compile shapes
            int Lb = pad_len(mx);
            // chain slices: power-of-two row counts bound the daemon's
            // per-(B, L) compile-shape set
            int rows = s.n;
            if (chain_dev) {
                rows = 64;
                while (rows < s.n)
                    rows <<= 1;
            }
            dcodes.assign((size_t)rows * Lb, 4);
            dlens.assign(rows, 0);
            for (int i = 0; i < s.n; i++) {
                ll off = b.coff[s.start + i];
                ll l = b.coff[s.start + i + 1] - off;
                uint8_t *dst = dcodes.data() + (size_t)i * Lb;
                memcpy(dst, b.codes.data() + off, (size_t)l);
                if (cfg.hmm)
                    for (ll z = 0; z < l; z++)
                        dst[z] &= 3;   // savekmers.c:3941 N fold
                dlens[i] = (int32_t)l;
            }
            if (chain_dev)
                return kdev_chain_send(dc, dcodes.data(), dlens.data(),
                                       rows, Lb);
            return kdev_dense_send(dc, dcodes.data(), dlens.data(), s.n,
                                   Lb, (int)cfg.M, MM, (int)cfg.U,
                                   (int)cfg.W1, false, false, 0.0);
        };
        auto dev_finish = [&](DevSlice &s) {
            const FqBatch &b = s.db->b;
            if (dc && chain_dev) {
                ll W = 0;
                if (kdev_chain_recv(dc, dvf, dvr, &W)
                    && (ll)dvf.size() >= (ll)s.n * W) {
                    ll rc2 = cfg.hmm
                        ? krun_map_se_batch_hmm_dev(
                              R, b.codes.data(), b.coff.data() + s.start,
                              b.hdr.data(), b.hoff.data() + s.start,
                              s.db->ords.data() + s.start, s.n,
                              dvf.data(), dvr.data(), W)
                        : krun_map_se_batch_chain_dev(
                              R, b.codes.data(), b.coff.data() + s.start,
                              b.hdr.data(), b.hoff.data() + s.start,
                              s.db->ords.data() + s.start, s.n,
                              dvf.data(), dvr.data(), W);
                    if (rc2 < 0)
                        die("mapping failed");
                    return;
                }
            } else if (dc) {
                if (kdev_dense_recv(dc, dscores, dmodes, dover, dcounts,
                                    dflat)
                    && (int)dmodes.size() == s.n) {
                    if (krun_map_se_batch_dev(
                            R, b.codes.data(), b.coff.data() + s.start,
                            b.hdr.data(), b.hoff.data() + s.start,
                            s.db->ords.data() + s.start, s.n,
                            dscores.data(), dmodes.data(), dover.data(),
                            dcounts.data(), dflat.data()) < 0)
                        die("mapping failed");
                    return;
                }
            }
            // -device on: the device does the work or the run fails
            die("-device on: devserve lost mid-run (no reply to a scan "
                "request)");
        };
        FqBatch b;
        for (const std::string &path : cfg.in_se) {
            fprintf(stderr, "# Reading inputfile: \t%s\n", path.c_str());
            int fmt = seq_format(path.c_str());
            int scale = fmt == 2 ? 33 : sniff_phred(path.c_str());
            if (fmt != 2)
                fprintf(stderr, "# Phred scale:\t%d\n", scale);
            BatchQueue bq;
            std::thread rd(reader_thread, path, fmt, scale, mp,
                           cfg.min_q, cfg.hardmask_q, cfg.min_len,
                           cfg.max_len, 0, &bq);
            while (bq.pop(b)) {
                ords.resize(b.n);
                for (int i = 0; i < b.n; i++)
                    ords[i] = n_frags + i;
                n_frags += b.n;
                if (dc) {
                    auto db = std::make_shared<DevBatch>();
                    db->b = std::move(b);
                    db->ords = ords;
                    for (int st = 0; st < db->b.n;) {
                        // slice width: fixed for short reads, cell-
                        // budget-bounded for chain (ONT) reads
                        int en = st, mx = 1;
                        const ll CELLS = 8ll << 20;
                        while (en < db->b.n && en - st < DEVSLICE) {
                            int l = (int)(db->b.coff[en + 1]
                                          - db->b.coff[en]);
                            int m2 = l > mx ? l : mx;
                            if (en > st
                                && (ll)(en - st + 1) * pad_len(m2) > CELLS)
                                break;
                            mx = m2;
                            ++en;
                        }
                        DevSlice s{db, st, en - st};
                        st = en;
                        if (!dev_send(s))
                            die("-device on: devserve lost mid-run (scan "
                                "request not sent)");
                        inflight.push_back(std::move(s));
                        while ((int)inflight.size() > DEVDEPTH) {
                            dev_finish(inflight.front());
                            inflight.pop_front();
                        }
                    }
                    b = FqBatch();
                    continue;
                }
                if (krun_map_se_batch(R, b.codes.data(), b.coff.data(),
                                      b.hdr.data(), b.hoff.data(),
                                      ords.data(), b.n) < 0)
                    die("mapping failed");
            }
            // end of this file's stream: the daemon defers each dense
            // response until the next request, so release the last one
            // with a flush, drain the slice responses, then eat the ack
            bool flushed = false;
            if (dc && !chain_dev && !inflight.empty())
                flushed = kdev_flush_send(dc);
            while (!inflight.empty()) {
                dev_finish(inflight.front());
                inflight.pop_front();
            }
            if (dc && flushed && !kdev_flush_recv(dc))
                die("-device on: devserve lost mid-run (flush)");
            sam_drain();
            rd.join();
        }
    }
    // shared pair-stream consumer: the -ipe loop feeds it two file
    // readers; the -int loop feeds it the even/odd splitter of one
    // interleaved stream (run_input_INT role, runinput.c:608-731)
    auto run_pair_streams = [&](const std::function<bool(FqBatch&)> &pop1,
                                const std::function<bool(FqBatch&)> &pop2) {
        FqBatch b1, b2;
        int i1 = 0, i2 = 0;   // record cursors into b1/b2
        bool h1 = pop1(b1);
        bool h2 = pop2(b2);
        std::vector<uint8_t> af, bf, haf, hbf, bp;
        std::vector<ll> ao, bo, hao, hbo;
        while (h1 || h2) {
            // lockstep over both streams; a stream at EOF contributes
            // failed empties so the other's records run as singles (the
            // reference's OR loop, runinput.c:517/649)
            int a1 = h1 ? b1.n - i1 : 0;
            int a2 = h2 ? b2.n - i2 : 0;
            int n = (h1 && h2) ? (a1 < a2 ? a1 : a2)
                               : (a1 > a2 ? a1 : a2);
            // count pairs where either mate survived trimming
            af.clear(); bf.clear(); haf.clear(); hbf.clear(); bp.clear();
            ao.assign(1, 0); bo.assign(1, 0);
            hao.assign(1, 0); hbo.assign(1, 0);
            ords.clear();
            for (int t = 0; t < n; t++) {
                bool p1 = t < a1 && b1.passed[i1 + t] != 0;
                bool p2 = t < a2 && b2.passed[i2 + t] != 0;
                if (!p1 && !p2)
                    continue;
                const uint8_t *c1 = nullptr, *hd1 = nullptr;
                const uint8_t *c2 = nullptr, *hd2 = nullptr;
                ll l1 = 0, hl1 = 0, l2 = 0, hl2 = 0;
                if (t < a1) {
                    c1 = b1.codes.data() + b1.coff[i1 + t];
                    l1 = b1.coff[i1 + t + 1] - b1.coff[i1 + t];
                    hd1 = b1.hdr.data() + b1.hoff[i1 + t];
                    hl1 = b1.hoff[i1 + t + 1] - b1.hoff[i1 + t];
                }
                if (t < a2) {
                    c2 = b2.codes.data() + b2.coff[i2 + t];
                    l2 = b2.coff[i2 + t + 1] - b2.coff[i2 + t];
                    hd2 = b2.hdr.data() + b2.hoff[i2 + t];
                    hl2 = b2.hoff[i2 + t + 1] - b2.hoff[i2 + t];
                }
                if (p1) {
                    af.insert(af.end(), c1, c1 + l1);
                    haf.insert(haf.end(), hd1, hd1 + hl1);
                    if (p2) {
                        bf.insert(bf.end(), c2, c2 + l2);
                        hbf.insert(hbf.end(), hd2, hd2 + hl2);
                        bp.push_back(1);
                    } else {
                        bp.push_back(0);
                    }
                } else {
                    // surviving mate becomes "a" (runinput.c lockstep)
                    af.insert(af.end(), c2, c2 + l2);
                    haf.insert(haf.end(), hd2, hd2 + hl2);
                    bp.push_back(0);
                }
                ao.push_back((ll)af.size());
                bo.push_back((ll)bf.size());
                hao.push_back((ll)haf.size());
                hbo.push_back((ll)hbf.size());
                ords.push_back(n_frags++);
            }
            int nk = (int)bp.size();
            if (nk && dc) {
                // device mate probes (the chain op, both mates): one
                // padded request per mate, voffs remapped to the pair
                // combiners' per-strand window order
                int mx = 1;
                for (int i = 0; i < nk; ++i) {
                    int la_ = (int)(ao[i + 1] - ao[i]);
                    int lb_ = (int)(bo[i + 1] - bo[i]);
                    if (la_ > mx) mx = la_;
                    if (lb_ > mx) mx = lb_;
                }
                int Lb = 128;
                while (Lb < mx)
                    Lb = (Lb * 3 / 2 + 63) / 64 * 64;
                int rows = 64;
                while (rows < nk)
                    rows <<= 1;
                static std::vector<uint8_t> pc;
                static std::vector<int32_t> pl;
                static std::vector<ll> raf, rar, rbf, rbr;
                auto send_mate = [&](const std::vector<uint8_t> &flat,
                                     const std::vector<ll> &off) {
                    pc.assign((size_t)rows * Lb, 4);
                    pl.assign(rows, 0);
                    for (int i = 0; i < nk; ++i) {
                        ll l = off[i + 1] - off[i];
                        memcpy(pc.data() + (size_t)i * Lb,
                               flat.data() + off[i], (size_t)l);
                        pl[i] = (int32_t)l;
                    }
                    return kdev_chain_send(dc, pc.data(), pl.data(),
                                           rows, Lb);
                };
                ll W = 0, Wb = 0;
                bool ok = send_mate(af, ao) && send_mate(bf, bo)
                          && kdev_chain_recv(dc, raf, rar, &W)
                          && kdev_chain_recv(dc, rbf, rbr, &Wb)
                          && W == Wb;
                if (ok) {
                    int kk = (int)ix.kmersize;
                    // rc window p maps to fw window len-k-p
                    static std::vector<ll> var, vbr2;
                    var.assign((size_t)nk * W, -1);
                    vbr2.assign((size_t)nk * W, -1);
                    for (int i = 0; i < nk; ++i) {
                        ll la_ = ao[i + 1] - ao[i];
                        ll lb_ = bo[i + 1] - bo[i];
                        for (ll p = 0; p < W; ++p) {
                            ll q = la_ - kk - p;
                            if (q >= 0)
                                var[(size_t)i * W + p] =
                                    rar[(size_t)i * W + q];
                            q = lb_ - kk - p;
                            if (q >= 0)
                                vbr2[(size_t)i * W + p] =
                                    rbr[(size_t)i * W + q];
                        }
                    }
                    if (krun_map_pe_batch(
                            R, af.data(), ao.data(), haf.data(),
                            hao.data(), bf.data(), bo.data(), hbf.data(),
                            hbo.data(), bp.data(), ords.data(), nk,
                            cfg.pm, cfg.fpm, raf.data(), var.data(),
                            rbf.data(), vbr2.data(), W) < 0)
                        die("PE mapping failed");
                } else {
                    die("-device on: devserve lost mid-run (mate probes)");
                }
            } else if (nk) {
                if (krun_map_pe_batch(
                        R, af.data(), ao.data(), haf.data(), hao.data(),
                        bf.data(), bo.data(), hbf.data(), hbo.data(),
                        bp.data(), ords.data(), nk, cfg.pm, cfg.fpm,
                        nullptr, nullptr, nullptr, nullptr, 0) < 0)
                    die("PE mapping failed");
            }
            i1 += n < a1 ? n : a1;
            i2 += n < a2 ? n : a2;
            if (h1 && i1 >= b1.n) {
                h1 = pop1(b1);
                i1 = 0;
            }
            if (h2 && i2 >= b2.n) {
                h2 = pop2(b2);
                i2 = 0;
            }
        }
        // drain so the producers can exit their push waits
        while (h1 || pop1(b1))
            h1 = false;
        while (h2 || pop2(b2))
            h2 = false;
    };
    if (cfg.pe) for (size_t pi = 0; pi < cfg.in_pe1.size(); ++pi) {
        const std::string &pe1 = cfg.in_pe1[pi], &pe2 = cfg.in_pe2[pi];
        fprintf(stderr, "# Reading inputfile: \t%s %s\n", pe1.c_str(),
                pe2.c_str());
        int f1 = seq_format(pe1.c_str()), f2 = seq_format(pe2.c_str());
        int scale = f1 == 2 ? 33 : sniff_phred(pe1.c_str());
        if (!scale)
            scale = sniff_phred(pe2.c_str());
        if (f1 != 2 || f2 != 2)
            fprintf(stderr, "# Phred scale:\t%d\n", scale);
        BatchQueue bq1, bq2;
        std::thread rd1(reader_thread, pe1, f1, scale, mp, cfg.min_q,
                        cfg.hardmask_q, cfg.min_len, cfg.max_len, 1, &bq1);
        std::thread rd2(reader_thread, pe2, f2, scale, mp, cfg.min_q,
                        cfg.hardmask_q, cfg.min_len, cfg.max_len, 1, &bq2);
        run_pair_streams([&](FqBatch &o) { return bq1.pop(o); },
                         [&](FqBatch &o) { return bq2.pop(o); });
        rd1.join();
        rd2.join();
    }
    // -int: one interleaved stream, consecutive records pair up
    // (run_input_INT, runinput.c:608-731).  A splitter de-interleaves
    // reader batches into even/odd sub-batches feeding the same
    // pair consumer; an odd record at a batch edge carries over.
    for (size_t ii = 0; ii < cfg.in_int.size(); ++ii) {
        const std::string &path = cfg.in_int[ii];
        fprintf(stderr, "# Reading inputfile: \t%s\n", path.c_str());
        int fmt = seq_format(path.c_str());
        int scale = fmt == 2 ? 33 : sniff_phred(path.c_str());
        if (fmt != 2)
            fprintf(stderr, "# Phred scale:\t%d\n", scale);
        BatchQueue bq;
        std::thread rd(reader_thread, path, fmt, scale, mp, cfg.min_q,
                       cfg.hardmask_q, cfg.min_len, cfg.max_len, 1, &bq);
        struct Split {
            BatchQueue *src;
            std::deque<FqBatch> evq, odq;
            FqBatch carry;
            bool have_carry = false, done = false;
            static void put(FqBatch &dst, const FqBatch &srcb, int i) {
                ll c0 = srcb.coff[i], c1 = srcb.coff[i + 1];
                ll h0 = srcb.hoff[i], h1 = srcb.hoff[i + 1];
                dst.codes.insert(dst.codes.end(),
                                 srcb.codes.begin() + c0,
                                 srcb.codes.begin() + c1);
                dst.hdr.insert(dst.hdr.end(), srcb.hdr.begin() + h0,
                               srcb.hdr.begin() + h1);
                dst.coff.push_back((ll)dst.codes.size());
                dst.hoff.push_back((ll)dst.hdr.size());
                dst.passed.push_back(srcb.passed[i]);
                dst.n++;
            }
            static FqBatch empty_batch() {
                FqBatch b;
                b.n = 0;
                b.coff.assign(1, 0);
                b.hoff.assign(1, 0);
                return b;
            }
            bool fill() {
                FqBatch b;
                if (done || !src->pop(b)) {
                    done = true;
                    if (have_carry) {
                        // trailing unpaired record runs as a single
                        // (the reference's OR loop, runinput.c:649)
                        have_carry = false;
                        evq.push_back(std::move(carry));
                        odq.push_back(empty_batch());
                        return true;
                    }
                    return false;
                }
                FqBatch ev = empty_batch(), od = empty_batch();
                int i = 0;
                if (have_carry && b.n > 0) {
                    put(ev, carry, 0);
                    put(od, b, 0);
                    have_carry = false;
                    i = 1;
                }
                for (; i + 1 < b.n; i += 2) {
                    put(ev, b, i);
                    put(od, b, i + 1);
                }
                if (i < b.n) {
                    carry = empty_batch();
                    put(carry, b, i);
                    have_carry = true;
                }
                if (ev.n) {
                    evq.push_back(std::move(ev));
                    odq.push_back(std::move(od));
                }
                return true;
            }
            bool pop_ev(FqBatch &out) {
                while (evq.empty())
                    if (!fill())
                        return false;
                out = std::move(evq.front());
                evq.pop_front();
                return true;
            }
            bool pop_od(FqBatch &out) {
                while (odq.empty())
                    if (!fill())
                        return false;
                out = std::move(odq.front());
                odq.pop_front();
                return true;
            }
        };
        Split sp;
        sp.src = &bq;
        run_pair_streams([&](FqBatch &o) { return sp.pop_ev(o); },
                         [&](FqBatch &o) { return sp.pop_od(o); });
        rd.join();
    }

    if (prof)
        fprintf(stderr, "# cli prof: load+map %.3f s\n", now() - tw0);
    // stage lines (kmaPipe order, non -status variants)
    fprintf(stderr,
            "#\n# Total number of query fragment after trimming:\t%lld\n"
            "#\n",
            n_frags);
    fprintf(stderr, "# Query converted\n#\n");
    fprintf(stderr, "#\n# Total time used for DB loading: %.2f s.\n#\n",
            db_t0);
    fprintf(stderr, "# Finding k-mer ankers\n");
    fprintf(stderr, "# Query ankered\n#\n");
    fprintf(stderr, "# KMA mapping done\n#\n");
    fprintf(stderr, "# Sort, output and select KMA alignments.\n");

    // ---- ConClave + output ------------------------------------------------
    std::vector<ll> w_scores(ix.db_size, 0), fc(ix.db_size, 0),
        rc(ix.db_size, 0);
    ll tot_ulen = 0;
    for (uint32_t t = 1; t < ix.db_size; t++)
        tot_ulen += ix.tlen[t];
    double tw1 = now();
    krun_conclave(R, cfg.conclave, cfg.lc, w_scores.data(), fc.data(),
                  rc.data(), tot_ulen,
                  cfg.score_t, cfg.evalue, 0, cfg.max_frag);
    if (prof)
        fprintf(stderr, "# cli prof: conclave %.3f s\n", now() - tw1);
    ll Nhits = 0;
    for (uint32_t t = 1; t < ix.db_size; t++)
        Nhits += w_scores[t];
    if (!Nhits)
        Nhits = 1;
    fprintf(stderr,
            "# Total time for sorting and outputting KMA alignment\t"
            "%.2f s.\n#\n"
            "# Doing local assemblies of found templates, and output "
            "results\n",
            0.0);

    int want_fsa = (cfg.nc & 1) == 0 || (cfg.nc & 2) == 0;
    int want_aln = (cfg.nc & 2) == 0;
    ll lr = 0, lf = 0, la = 0, lg = 0, lm = 0, lv = 0, le = 0;
    if (krun_output_all(R, w_scores.data(), ix.names.data(),
                        ix.names_off.data(), (ll)ix.db_size, tot_ulen,
                        Nhits, cfg.evalue, cfg.score_t, 0, cfg.ID_t,
                        cfg.Depth_t, cfg.bcd, cfg.support, cfg.base_caller,
                        cfg.significant, cfg.ref_fsa, want_fsa, want_aln,
                        cfg.nf ? 0 : 1, cfg.print_matrix ? 1 : 0, cfg.vcf,
                        cfg.ef ? 1 : 0, fc.data(), rc.data(), 1, 0, cfg.Wl,
                        (int)cfg.min_len, cfg.mq, cfg.score_t, cfg.mrc,
                        cfg.circular, cfg.ts, 0, cfg.dense,
                        &lr, &lf, &la, &lg, &lm, &lv, &le) < 0)
        die("output failed");
    std::vector<uint8_t> res(lr ? lr : 1), fsa(lf ? lf : 1),
        aln(la ? la : 1), frag(lg ? lg : 1), mat(lm ? lm : 1),
        vcfb(lv ? lv : 1), efb(le ? le : 1);
    krun_output_fetch(R, res.data(), fsa.data(), aln.data(), frag.data(),
                      mat.data(), vcfb.data(), efb.data());
    sam_drain();
    if (cfg.sam)
        fflush(stdout);
    if (cfg.xml) {
        FILE *xf = cfg.xml == 2 ? stdout
                                : fopen((cfg.out + ".xml").c_str(), "w");
        if (!xf)
            die("cannot open .xml");
        // initXML (xml.c:30-51)
        fprintf(xf, "<?xml version=\"1.0\"?>\n");
        fprintf(xf,
                "<!DOCTYPE BlastOutput PUBLIC \"-//NCBI//NCBI "
                "BlastOutput/EN\" \"http://www.ncbi.nlm.nih.gov/dtd/"
                "NCBI_BlastOutput.dtd\">\n");
        fprintf(xf, "<BlastOutput>\n");
        fprintf(xf, "\t<BlastOutput_program>kma</BlastOutput_program>\n");
        fprintf(xf,
                "\t<BlastOutput_version>KMA 1.5.1</BlastOutput_version>\n");
        fprintf(xf,
                "\t<BlastOutput_reference>Philip T.L.C. Clausen, Frank "
                "M. Aarestrup & Ole Lund, \"Rapid and precise alignment "
                "of raw reads against redundant databases with KMA\", "
                "BMC Bioinformatics, 2018;19:307.</BlastOutput_"
                "reference>\n");
        fprintf(xf, "\t<BlastOutput_db>%s</BlastOutput_db>\n",
                cfg.t_db.c_str());
        fprintf(xf,
                "\t<BlastOutput_query-ID>kma-%s-%lld"
                "</BlastOutput_query-ID>\n",
                cfg.t_db.c_str(), (long long)time(0));
        fprintf(xf,
                "\t<BlastOutput_query-def>nucl</BlastOutput_query-def>\n");
        fprintf(xf, "\t<BlastOutput_query-len>%lld"
                    "</BlastOutput_query-len>\n",
                (long long)n_frags);
        fprintf(xf, "\t<BlastOutput_param>\n\t\t<Parameters>\n");
        fprintf(xf, "\t\t\t<Parameters_cmd>kma");
        for (int ai = 1; ai < argc; ai++)
            fprintf(xf, " %s", argv[ai]);
        fprintf(xf, "</Parameters_cmd>\n");
        fprintf(xf, "\t\t</Parameters>\n\t</BlastOutput_param>\n");
        fprintf(xf, "<BlastOutput_iterations>\n");
        ll xl = krun_xml_len(R);
        std::vector<uint8_t> xbuf((size_t)(xl ? xl : 1));
        krun_xml_fetch(R, xbuf.data());
        fwrite(xbuf.data(), 1, (size_t)xl, xf);
        fprintf(xf, "</BlastOutput_iterations>\n</BlastOutput>\n");
        if (cfg.xml != 2)
            fclose(xf);
        else
            fflush(xf);
    }
    if (cfg.tsv) {
        // initsv (tsv.c:26-47) + the per-template rows
        static const char *TSVF[16] = {
            "Template_Name", "Template_Length", "Template_Identity",
            "Template_Coverage", "Template_Depth", "Query_Identity",
            "Query_Coverage", "Query_Depth", "Read_Count_Map",
            "Read_Count_Aln", "Score", "Expected", "q_value", "p_value",
            "ConClave_Score", "ConClave_Quality"};
        FILE *tf = fopen((cfg.out + ".tsv").c_str(), "w");
        if (!tf)
            die("cannot open .tsv");
        ull fl = cfg.tsv & 65535ull;
        for (int fi = 0; fi < 16; fi++) {
            if (fl & 1) {
                fl >>= 1;
                fprintf(tf, "%s%c", TSVF[fi], fl ? '\t' : '\n');
            } else {
                fl >>= 1;
            }
        }
        ll tl2 = krun_tsv_len(R);
        std::vector<uint8_t> tbuf((size_t)(tl2 ? tl2 : 1));
        krun_tsv_fetch(R, tbuf.data());
        fwrite(tbuf.data(), 1, (size_t)tl2, tf);
        fclose(tf);
    }
    // gz compression is the expensive tail: the three gz artifacts are
    // independent files, so deflate them on parallel threads while the
    // main thread writes the plain-text outputs
    std::vector<std::thread> gzw;
    if (!cfg.nf)
        gzw.emplace_back([&] {
            write_gz(cfg.out + ".frag.gz", frag.data(), lg);
        });
    if (cfg.print_matrix)
        gzw.emplace_back([&] {
            write_gz(cfg.out + ".mat.gz", mat.data(), lm);
        });
    write_file(cfg.out + ".res",
               "#Template\tScore\tExpected\tTemplate_length\t"
               "Template_Identity\tTemplate_Coverage\tQuery_Identity\t"
               "Query_Coverage\tDepth\tq_value\tp_value\n",
               res.data(), lr);
    if (want_fsa)
        write_file(cfg.out + ".fsa", nullptr, fsa.data(), lf);
    if (want_aln)
        write_file(cfg.out + ".aln", nullptr, aln.data(), la);
    if (cfg.vcf) {
        // initialiseVcf (vcf.c:46-95) — same lines as out/vcf.vcf_header
        const char *slash = strrchr(cfg.t_db.c_str(), '/');
        std::string base = slash ? slash + 1 : cfg.t_db;
        std::string head =
            "##fileformat=VCFv4.2\n##kmaVersion=1.5.1\n"
            "##FILTER=<ID=LowQual,Description=\"Low quality\">\n"
            "##INFO=<ID=DP,Number=1,Type=Integer,"
            "Description=\"Total Depth\">\n"
            "##INFO=<ID=AD,Number=1,Type=Integer,"
            "Description=\"Allele Depth\">\n"
            "##INFO=<ID=AF,Number=1,Type=Float,"
            "Description=\"Allele Fraction\">\n"
            "##INFO=<ID=RAF,Number=1,Type=Float,"
            "Description=\"Revised Allele Fraction\">\n"
            "##INFO=<ID=DEL,Number=1,Type=Float,Description=\"Fraction "
            "of Reads Containing Spanning Deletions\">\n"
            "##INFO=<ID=AD6,Number=6,Type=Integer,Description=\"Count of "
            "all alternative alleles: A,C,G,T,N,-\">\n"
            "##FORMAT=<ID=Q,Number=1,Type=Float,"
            "Description=\"McNemar quantile\">\n"
            "##FORMAT=<ID=P,Number=1,Type=Float,"
            "Description=\"McNemar p-value\">\n"
            "##FORMAT=<ID=FT,Number=1,Type=String,"
            "Description=\"Filter\">\n"
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
            + base + "\n";
        static std::string vcf_head;   // outlives the writer thread
        vcf_head = head;
        gzw.emplace_back([&, lv] {
            gzFile g = gzopen((cfg.out + ".vcf.gz").c_str(), "wb1");
            if (!g)
                die("cannot open .vcf.gz for writing");
            if (gzwrite(g, vcf_head.data(), (unsigned)vcf_head.size())
                    != (int)vcf_head.size())
                die("gzwrite failed");
            ll w = 0;
            while (w < lv) {
                unsigned chunk = (unsigned)(
                    (lv - w) > (1 << 28) ? (1 << 28) : (lv - w));
                if (gzwrite(g, vcfb.data() + w, chunk) != (int)chunk)
                    die("gzwrite failed");
                w += chunk;
            }
            gzclose(g);
        });
    }
    if (cfg.ef) {
        // initExtendedFeatures (ef.c:30-46) — writers.mapstat_header
        const char *slash = strrchr(cfg.t_db.c_str(), '/');
        std::string base = slash ? slash + 1 : cfg.t_db;
        std::string cmd = "kma";
        for (int i = 1; i < argc; i++) {
            cmd += " ";
            cmd += argv[i];
        }
        char date[32];
        time_t now = time(nullptr);
        struct tm lt;
        localtime_r(&now, &lt);
        strftime(date, sizeof date, "%Y-%m-%d", &lt);
        std::string head =
            "## method\tKMA\n## version\t1.5.1\n## database\t" + base
            + "\n## fragmentCount\t" + std::to_string(n_frags)
            + "\n## date\t" + date + "\n## command\t" + cmd + "\n"
            "# refSequence\treadCount\tfragmentCount\tmapScoreSum\t"
            "refCoveredPositions\trefConsensusSum\tbpTotal\t"
            "depthVariance\tnucHighDepthVariance\tdepthMax\tsnpSum\t"
            "insertSum\tdeletionSum\treadCountAln\tfragmentCountAln\n";
        FILE *f = fopen((cfg.out + ".mapstat").c_str(), "wb");
        if (!f)
            die("cannot open .mapstat");
        fwrite(head.data(), 1, head.size(), f);
        if (le)
            fwrite(efb.data(), 1, (size_t)le, f);
        fclose(f);
    }
    for (auto &th : gzw)
        th.join();
    if (prof)
        fprintf(stderr, "# cli prof: output %.3f s, total %.3f s\n",
                now() - tw1, now() - tw0);
    fprintf(stderr,
            "# Total time used for local assembly: %.2f s.\n#\n"
            "# Closing files\n",
            0.0);
    krun_free(R);
    return 0;
}
