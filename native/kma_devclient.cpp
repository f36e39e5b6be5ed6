// devserve socket client (see kma_devclient.h).  Wire format mirrors
// kma_tpu/devserve.py: u64 header_len | header JSON | raw array bytes;
// header = {"meta": {...}, "arrays": [[name, dtype, shape], ...]}.
#include "kma_devclient.h"

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>

#include <errno.h>
#include <fcntl.h>
#include <limits.h>
#include <poll.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/time.h>
#include <sys/un.h>
#include <unistd.h>

namespace {

// Deadlines: a wedged daemon must cost a bounded slice of wall time,
// after which the caller ends the run with the cause (a -device on run
// does not fall back to the host).  The hello handshake gets a short
// deadline (a healthy daemon answers in milliseconds); scan requests
// get a longer one that still bounds the worst case (one cold compile
// of an unwarmed shape).
double env_secs(const char *name, double dflt) {
    const char *v = getenv(name);
    if (!v || !*v)
        return dflt;
    char *end = nullptr;
    double d = strtod(v, &end);
    return (end && end != v && d > 0) ? d : dflt;
}

void set_deadline(int fd, double secs) {
    struct timeval tv;
    tv.tv_sec = (time_t)secs;
    tv.tv_usec = (suseconds_t)((secs - (double)tv.tv_sec) * 1e6);
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
}

// connect() with its own deadline (non-blocking + poll)
bool connect_deadline(int fd, const struct sockaddr *addr, socklen_t len,
                      double secs) {
    int fl = fcntl(fd, F_GETFL, 0);
    fcntl(fd, F_SETFL, fl | O_NONBLOCK);
    int rc = connect(fd, addr, len);
    bool ok = rc == 0;
    if (!ok && errno == EINPROGRESS) {
        struct pollfd pfd{fd, POLLOUT, 0};
        if (poll(&pfd, 1, (int)(secs * 1000)) == 1) {
            int err = 0;
            socklen_t elen = sizeof(err);
            ok = getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &elen) == 0
                 && err == 0;
        }
    }
    fcntl(fd, F_SETFL, fl);
    return ok;
}

// ---- tiny JSON reader (the fixed subset json.dumps emits) -----------------
struct JVal {
    enum Kind { NUL, NUM, STR, LIST, DICT } kind = NUL;
    double num = 0;
    std::string str;
    std::vector<JVal> list;
    std::vector<std::pair<std::string, JVal>> dict;

    const JVal *get(const char *key) const {
        for (auto &kv : dict)
            if (kv.first == key)
                return &kv.second;
        return nullptr;
    }
};

struct JParser {
    const char *p, *e;
    bool fail = false;

    void ws() {
        while (p < e && (*p == ' ' || *p == '\t' || *p == '\n'
                         || *p == '\r' || *p == ','))
            ++p;
    }
    bool lit(const char *s) {
        size_t n = strlen(s);
        if ((size_t)(e - p) >= n && !memcmp(p, s, n)) {
            p += n;
            return true;
        }
        return false;
    }
    std::string pstr() {
        std::string out;
        if (p >= e || *p != '"') {
            fail = true;
            return out;
        }
        ++p;
        while (p < e && *p != '"') {
            if (*p == '\\' && p + 1 < e) {
                ++p;
                switch (*p) {
                case 'n': out += '\n'; break;
                case 't': out += '\t'; break;
                case 'u': p += 4; out += '?'; break; // lossy, err text only
                default: out += *p;
                }
            } else {
                out += *p;
            }
            ++p;
        }
        if (p < e)
            ++p;
        return out;
    }
    JVal val() {
        JVal v;
        ws();
        if (p >= e) {
            fail = true;
            return v;
        }
        if (*p == '"') {
            v.kind = JVal::STR;
            v.str = pstr();
        } else if (*p == '[') {
            ++p;
            v.kind = JVal::LIST;
            ws();
            while (p < e && *p != ']') {
                v.list.push_back(val());
                if (fail)
                    return v;
                ws();
            }
            if (p < e)
                ++p;
        } else if (*p == '{') {
            ++p;
            v.kind = JVal::DICT;
            ws();
            while (p < e && *p != '}') {
                std::string k = pstr();
                ws();
                if (p < e && *p == ':')
                    ++p;
                v.dict.emplace_back(std::move(k), val());
                if (fail)
                    return v;
                ws();
            }
            if (p < e)
                ++p;
        } else if (lit("null") || lit("NaN")) {
            v.kind = JVal::NUL;
        } else if (lit("true")) {
            v.kind = JVal::NUM;
            v.num = 1;
        } else if (lit("false")) {
            v.kind = JVal::NUM;
        } else {
            char *end = nullptr;
            v.kind = JVal::NUM;
            v.num = strtod(p, &end);
            if (end == p)
                fail = true;
            p = end;
        }
        return v;
    }
};

uint64_t fnv1a64(const char *s) {
    uint64_t h = 0xCBF29CE484222325ull;
    for (; *s; ++s)
        h = (h ^ (uint8_t)*s) * 0x100000001B3ull;
    return h;
}

bool send_all(int fd, const void *buf, size_t n) {
    const char *p = (const char *)buf;
    while (n) {
        ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
        if (w <= 0) {
            if (w < 0 && errno == EINTR)
                continue;
            return false;   // incl. EAGAIN from the SO_SNDTIMEO deadline
        }
        p += w;
        n -= (size_t)w;
    }
    return true;
}

bool recv_all(int fd, void *buf, size_t n) {
    char *p = (char *)buf;
    while (n) {
        ssize_t r = ::recv(fd, p, n, 0);
        if (r <= 0) {
            if (r < 0 && errno == EINTR)
                continue;
            return false;   // incl. EAGAIN from the SO_RCVTIMEO deadline
        }
        p += r;
        n -= (size_t)r;
    }
    return true;
}

size_t dtype_size(const std::string &dt) {
    // numpy dtype.str: '|u1', '<i4', '<i8', '<f8', ...
    if (dt.size() < 3)
        return 0;
    return (size_t)atoi(dt.c_str() + 2);
}

} // namespace

struct DevConn {
    int fd = -1;
    // reply scratch
    JVal hdr;
    std::vector<std::vector<uint8_t>> payloads;
    // hello payload: list id -> values offset (chain/PE probes)
    std::vector<long long> voff_map;

    bool send_frame(const std::string &hdr_json,
                    const std::vector<std::pair<const void *, size_t>>
                        &arrays) {
        uint64_t hl = hdr_json.size();
        if (!send_all(fd, &hl, 8))
            return false;
        if (!send_all(fd, hdr_json.data(), hdr_json.size()))
            return false;
        for (auto &a : arrays)
            if (!send_all(fd, a.first, a.second))
                return false;
        return true;
    }

    // receive one frame; payloads[i] matches hdr["arrays"][i]
    bool recv_frame() {
        uint64_t hl = 0;
        if (!recv_all(fd, &hl, 8) || hl > (64u << 20))
            return false;
        std::string js(hl, '\0');
        if (!recv_all(fd, js.data(), hl))
            return false;
        JParser jp{js.data(), js.data() + js.size()};
        hdr = jp.val();
        if (jp.fail || hdr.kind != JVal::DICT)
            return false;
        const JVal *arrs = hdr.get("arrays");
        if (!arrs || arrs->kind != JVal::LIST)
            return false;
        payloads.clear();
        for (const JVal &d : arrs->list) {
            if (d.kind != JVal::LIST || d.list.size() != 3)
                return false;
            size_t esz = dtype_size(d.list[1].str);
            uint64_t n = 1;
            for (const JVal &dim : d.list[2].list)
                n *= (uint64_t)d_max(dim.num, 0.0);
            uint64_t bytes = n * esz;
            if (bytes > (1ull << 33))
                return false;
            payloads.emplace_back(bytes);
            if (bytes && !recv_all(fd, payloads.back().data(), bytes))
                return false;
        }
        return true;
    }

    static double d_max(double a, double b) { return a > b ? a : b; }

    int ok() const {
        const JVal *m = hdr.get("meta");
        const JVal *o = m ? m->get("ok") : nullptr;
        return o && o->num != 0;
    }

    const std::vector<uint8_t> *payload(const char *name) const {
        const JVal *arrs = hdr.get("arrays");
        if (!arrs)
            return nullptr;
        for (size_t i = 0; i < arrs->list.size(); ++i)
            if (arrs->list[i].list.size() == 3
                && arrs->list[i].list[0].str == name)
                return &payloads[i];
        return nullptr;
    }
};

DevConn *kdev_connect(const char *db_prefix) {
    char realbuf[PATH_MAX];
    if (!realpath(db_prefix, realbuf)) {
        // the prefix itself is not a file; resolve its directory
        std::string s(db_prefix);
        size_t cut = s.find_last_of('/');
        std::string dir = cut == std::string::npos ? "." : s.substr(0, cut);
        std::string base = cut == std::string::npos ? s : s.substr(cut + 1);
        char dbuf[PATH_MAX];
        if (!realpath(dir.c_str(), dbuf))
            return nullptr;
        snprintf(realbuf, sizeof(realbuf), "%s/%s", dbuf, base.c_str());
    }
    std::string sock_path;
    const char *env = getenv("KMA_DEVSERVE_SOCKET");
    if (env && *env) {
        sock_path = env;
    } else {
        const char *dir = getenv("KMA_DEVSERVE_DIR");
        char dbuf[128];
        if (!dir || !*dir) {
            const char *tmp = getenv("TMPDIR");
            snprintf(dbuf, sizeof(dbuf), "%s/kma_devserve_%u",
                     tmp && *tmp ? tmp : "/tmp", (unsigned)getuid());
            dir = dbuf;
        }
        char hex[32];
        snprintf(hex, sizeof(hex), "%016llx",
                 (unsigned long long)fnv1a64(realbuf));
        sock_path = std::string(dir) + "/" + hex + ".sock";
    }
    struct sockaddr_un addr;
    if (sock_path.size() >= sizeof(addr.sun_path))
        return nullptr;
    int fd = socket(AF_UNIX, SOCK_STREAM, 0);
    if (fd < 0)
        return nullptr;
    memset(&addr, 0, sizeof(addr));
    addr.sun_family = AF_UNIX;
    memcpy(addr.sun_path, sock_path.c_str(), sock_path.size());
    if (!connect_deadline(fd, (struct sockaddr *)&addr, sizeof(addr),
                          env_secs("KMA_DEVSERVE_CONNECT_TIMEOUT", 5))) {
        close(fd);
        return nullptr;
    }
    // hello must come back promptly from a healthy daemon
    set_deadline(fd, env_secs("KMA_DEVSERVE_HELLO_TIMEOUT", 15));
    // hello: db identity = resolved prefix + size/mtime of the frozen
    // hashmap (devserve.db_signature)
    const char *ext = ".comp.b";
    struct stat st;
    std::string hp = std::string(realbuf) + ext;
    if (stat(hp.c_str(), &st) != 0) {
        ext = ".b";
        hp = std::string(realbuf) + ext;
        if (stat(hp.c_str(), &st) != 0) {
            close(fd);
            return nullptr;
        }
    }
    char js[PATH_MAX + 256];
    int jn = snprintf(js, sizeof(js),
                      "{\"meta\": {\"op\": \"hello\", \"db\": \"%s\", "
                      "\"sig\": [\"%s\", %lld, %lld]}, \"arrays\": []}",
                      realbuf, ext, (long long)st.st_size,
                      (long long)st.st_mtime);
    DevConn *c = new DevConn;
    c->fd = fd;
    if (jn <= 0 || !c->send_frame(std::string(js, jn), {})
        || !c->recv_frame() || !c->ok()) {
        kdev_close(c);
        return nullptr;
    }
    const std::vector<uint8_t> *vm = c->payload("voff_map");
    if (vm && vm->size() % 8 == 0) {
        c->voff_map.resize(vm->size() / 8);
        memcpy(c->voff_map.data(), vm->data(), vm->size());
    }
    // per-request deadline for the scan ops: bounds the damage of a
    // wedged daemon; on expiry recv_all fails and the caller ends the run
    set_deadline(fd, env_secs("KMA_DEVSERVE_CALL_TIMEOUT", 300));
    return c;
}

void kdev_close(DevConn *c) {
    if (!c)
        return;
    if (c->fd >= 0)
        close(c->fd);
    delete c;
}

bool kdev_dense_send(DevConn *c, const uint8_t *codes,
                     const int32_t *lengths, int n, int l, int M, int MM,
                     int U, int W1, bool exhaustive, bool has_proxi,
                     double proxi) {
    char js[512];
    char prox[48];
    if (has_proxi)
        snprintf(prox, sizeof(prox), "%.17g", proxi);
    else
        snprintf(prox, sizeof(prox), "null");
    int jn = snprintf(
        js, sizeof(js),
        "{\"meta\": {\"op\": \"dense\", \"M\": %d, \"MM\": %d, "
        "\"U\": %d, \"W1\": %d, \"exhaustive\": %s, "
        "\"proxi_frac\": %s, \"pipeline\": true}, "
        "\"arrays\": [[\"codes\", \"|u1\", [%d, %d]], "
        "[\"lengths\", \"<i4\", [%d]]]}",
        M, MM, U, W1, exhaustive ? "true" : "false", prox, n, l, n);
    if (jn <= 0)
        return false;
    return c->send_frame(
        std::string(js, jn),
        {{codes, (size_t)n * l}, {lengths, (size_t)n * 4}});
}

bool kdev_flush_send(DevConn *c) {
    const char *js = "{\"meta\": {\"op\": \"flush\"}, \"arrays\": []}";
    return c->send_frame(js, {});
}

bool kdev_flush_recv(DevConn *c) {
    return c->recv_frame() && c->ok();
}

bool kdev_chain_send(DevConn *c, const uint8_t *codes,
                     const int32_t *lengths, int n, int l) {
    char js[256];
    int jn = snprintf(
        js, sizeof(js),
        "{\"meta\": {\"op\": \"chain\"}, "
        "\"arrays\": [[\"codes\", \"|u1\", [%d, %d]], "
        "[\"lengths\", \"<i4\", [%d]]]}",
        n, l, n);
    if (jn <= 0)
        return false;
    return c->send_frame(
        std::string(js, jn),
        {{codes, (size_t)n * l}, {lengths, (size_t)n * 4}});
}

bool kdev_chain_recv(DevConn *c, std::vector<long long> &voff_f,
                     std::vector<long long> &voff_r, long long *w_out) {
    if (!c->recv_frame() || !c->ok())
        return false;
    const std::vector<uint8_t> *pf = c->payload("rows_f");
    const std::vector<uint8_t> *pr = c->payload("rows_rc");
    if (!pf || !pr || pf->size() != pr->size() || pf->size() % 4)
        return false;
    // rows are [n, W] i32 list ids; W comes from the descriptor
    const JVal *arrs = c->hdr.get("arrays");
    long long W = 0;
    for (const JVal &d : arrs->list)
        if (d.list.size() == 3 && d.list[0].str == "rows_f"
            && d.list[2].list.size() == 2)
            W = (long long)d.list[2].list[1].num;
    if (W <= 0)
        return false;
    *w_out = W;
    size_t total = pf->size() / 4;
    voff_f.resize(total);
    voff_r.resize(total);
    const int32_t *rf = (const int32_t *)pf->data();
    const int32_t *rr = (const int32_t *)pr->data();
    long long nv = (long long)c->voff_map.size();
    for (size_t i = 0; i < total; ++i) {
        int32_t a = rf[i];
        voff_f[i] = (a >= 0 && a < nv) ? c->voff_map[a] : -1;
        int32_t b = rr[i];
        voff_r[i] = (b >= 0 && b < nv) ? c->voff_map[b] : -1;
    }
    return true;
}

bool kdev_dense_recv(DevConn *c, std::vector<int32_t> &scores,
                     std::vector<uint8_t> &modes,
                     std::vector<uint8_t> &over,
                     std::vector<int32_t> &counts,
                     std::vector<int32_t> &flat) {
    if (!c->recv_frame() || !c->ok())
        return false;
    const std::vector<uint8_t> *ps = c->payload("scores");
    const std::vector<uint8_t> *pm = c->payload("modes");
    const std::vector<uint8_t> *po = c->payload("over");
    const std::vector<uint8_t> *pc = c->payload("counts");
    const std::vector<uint8_t> *pf = c->payload("flat");
    if (!ps || !pm || !po || !pc || !pf)
        return false;
    size_t n = pm->size();
    if (ps->size() != 4 * n || po->size() != n || pc->size() != 4 * n)
        return false;
    scores.resize(n);
    memcpy(scores.data(), ps->data(), 4 * n);
    modes.assign(pm->begin(), pm->end());
    over.assign(po->begin(), po->end());
    counts.resize(n);
    memcpy(counts.data(), pc->data(), 4 * n);
    flat.resize(pf->size() / 4);
    memcpy(flat.data(), pf->data(), pf->size());
    return true;
}
