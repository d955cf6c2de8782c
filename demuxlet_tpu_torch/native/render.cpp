// Native .single/.sing2/.best renderer for the compact decision path.
//
// Byte-identical to models/outputs.py::write_single and
// write_pass2_compact (themselves the behavioral mirror of the
// reference's output loops, cmd_cram_demuxlet.cpp:713-875). Each field is
// written in place: strings by memcpy, integers and doubles by
// std::to_chars, whose floating-point overloads with a precision are
// defined as printf's %.Nf / %.Ng in the C locale, and CPython's
// %-formatting of doubles is the same correctly-rounded conversion.
// Pinned by tests/test_torch_render.py against the Python renderer and the
// JAX package's snprintf renderer.
//
// The rows of a call's `order` are split into min(kMaxStripes,
// ceil(rows / kRowsPerStripe)) contiguous stripes; stripes 1.. run on their
// own threads (the ctypes call has released the GIL), stripe 0 on the
// caller's, each into its own buffer, joined in stripe order. A call of at
// most kRowsPerStripe rows is one stripe and starts no thread. Build:
// python demuxlet_tpu_torch/native/build.py (produces _render.so; the
// package falls back to the Python renderer when absent).
//
// dmx_bc_order gives both renders their row order (native/order.py): the
// cell ids sorted as Python's sorted((barcode, id) ...) sorts them. Each
// barcode's first 16 UTF-8 bytes are two big-endian words of a (key, id)
// record, so most comparisons touch no string; the records are sorted in
// the same stripes, then merged.

#include <algorithm>
#include <atomic>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <system_error>
#include <thread>
#include <vector>

namespace {

// The engine's prep pool is 4 threads wide, and idle while a job renders.
constexpr int64_t kMaxStripes = 4;
constexpr int64_t kRowsPerStripe = 2048;

// Worst-case widths of one field, so that a line's room is known before it
// is written and no field is ever cut short.
constexpr size_t kInt = 24;     // an int64_t in decimal, sign included
constexpr size_t kFixed = 330;  // %.5f of -DBL_MAX: sign, 309 digits, point, 5
constexpr size_t kGen = 32;     // %.3g: "-1.23e-308", inf, nan
constexpr size_t kCounts = 4 * (kInt + 1) + 1;  // "\t<t>\t<p>\t<u>\t<ns>\t"

std::atomic<int64_t> g_calls{0}, g_stripes{0};
std::atomic<int64_t> g_order_calls{0}, g_order_barcodes{0};

// A growable malloc'd byte buffer.
struct Buf {
    char *data = nullptr;
    size_t len = 0, cap = 0;
    ~Buf() { free(data); }
    // Room for `need` more bytes after end(); false when malloc cannot
    // give it.
    bool reserve(size_t need) {
        if (data && len + need <= cap) return true;
        size_t cap2 = std::max(cap * 2, len + need + 1);
        char *d = (char *)realloc(data, cap2);
        if (!d) return false;
        data = d;
        cap = cap2;
        return true;
    }
    char *end() { return data + len; }
    void end_at(const char *p) { len = (size_t)(p - data); }
};

char *put(char *p, const char *s, size_t n) {
    memcpy(p, s, n);
    return p + n;
}
char *put_int(char *p, int64_t v) { return std::to_chars(p, p + kInt, v).ptr; }
// CPython prints NaN as "nan" whatever its sign, where to_chars and glibc
// print "-nan" when the sign bit is set (x86's 0.0/0.0 sets it). So a NaN
// is written here, never by to_chars: clearing the sign with fabs does not
// hold, as GCC drops a fabs of exp(), whose result it takes as nonnegative.
char *put_nan(char *p) { return put(p, "nan", 3); }
char *put_fixed(char *p, double v, int places) {  // %.<places>f
    if (std::isnan(v)) return put_nan(p);
    return std::to_chars(p, p + kFixed, v, std::chars_format::fixed, places)
        .ptr;
}
char *put_gen(char *p, double v) {  // %.3g
    if (std::isnan(v)) return put_nan(p);
    return std::to_chars(p, p + kGen, v, std::chars_format::general, 3).ptr;
}
// "\t<totl>\t<pass>\t<uniq>\t<nsnp>\t"
char *put_counts(char *p, int64_t t, int64_t pp, int64_t u, int64_t ns) {
    *p++ = '\t';
    for (int64_t v : {t, pp, u, ns}) {
        p = put_int(p, v);
        *p++ = '\t';
    }
    return p;
}

const char *str_at(const char *concat, const int64_t *off, int64_t i) {
    return concat + off[i];  // entries are NUL-terminated by the caller
}

// The sample IDs of a call, their lengths, their sum and the longest.
struct Names {
    std::vector<const char *> s;
    std::vector<size_t> n;
    size_t total = 0, longest = 0;
    Names(const char *concat, const int64_t *off, int64_t nv) {
        for (int64_t j = 0; j < nv; ++j) {
            s.push_back(str_at(concat, off, j));
            n.push_back(strlen(s.back()));
            total += n.back();
            longest = std::max(longest, n.back());
        }
    }
};

// One line a sample of .single/.sing2 for one barcode: barcode, sample,
// the barcode's counts and, after the sample's LLK, its constant field
// (`tail`: "\t<llk0>\t"), then the posterior. `llk[j]` and `post(j)` give
// the sample's values. Returns false when the buffer cannot grow.
template <class Post>
bool put_sample_lines(Buf &b, const char *bc, size_t bcn, const Names &sm,
                      int64_t nv, const char *counts, size_t countsn,
                      const double *llk, int places, const char *tail,
                      size_t tailn, Post post) {
    if (!b.reserve((size_t)nv * (bcn + countsn + kFixed + tailn + kGen + 3) +
                   sm.total))
        return false;
    char *p = b.end();
    for (int64_t j = 0; j < nv; ++j) {
        p = put(p, bc, bcn);
        *p++ = '\t';
        p = put(p, sm.s[j], sm.n[j]);
        p = put(p, counts, countsn);
        p = put_fixed(p, llk[j], places);
        p = put(p, tail, tailn);
        p = put_gen(p, post(j));
        *p++ = '\n';
    }
    b.end_at(p);
    return true;
}

// Runs work(s, r0, r1) on each stripe s of rows [r0, r1) of n rows:
// stripes 1.. on threads, stripe 0 here. Returns the stripe count.
template <class Work>
int64_t on_stripes(int64_t n, Work work) {
    int64_t k = std::clamp<int64_t>((n + kRowsPerStripe - 1) / kRowsPerStripe,
                                    1, kMaxStripes);
    std::thread ts[kMaxStripes];
    for (int64_t s = 1; s < k; ++s) {
        try {
            ts[s] = std::thread(work, s, n * s / k, n * (s + 1) / k);
        } catch (const std::system_error &) {  // no thread to be had
            work(s, n * s / k, n * (s + 1) / k);
        }
    }
    work(0, 0, n / k);
    for (std::thread &t : ts)
        if (t.joinable()) t.join();
    return k;
}

// on_stripes for a render call, counted by dmx_render_counts.
template <class Render>
int64_t striped(int64_t n, Render render) {
    int64_t k = on_stripes(n, render);
    g_calls.fetch_add(1);
    g_stripes.fetch_add(k);
    return k;
}

// A barcode's sort record: its first 16 bytes, zero-padded, as two
// big-endian words (unsigned byte order is code-point order in UTF-8),
// and its cell id.
struct BcKey {
    uint64_t hi, lo;
    int64_t id;
};

uint64_t be_word(const unsigned char *b) {
    uint64_t w;
    memcpy(&w, b, 8);
    return __builtin_bswap64(w);  // from a little-endian load (x86-64)
}

BcKey bc_key(const char *concat, const int64_t *off, int64_t i) {
    unsigned char b[16] = {};
    memcpy(b, concat + off[i],
           (size_t)std::min<int64_t>(off[i + 1] - off[i] - 1, 16));
    return {be_word(b), be_word(b + 8), i};
}

// Python's order of (barcode, id) tuples: bytes, then the shorter of a
// prefix pair, then the id. The full strings are read on equal keys only.
struct BcLess {
    const char *concat;
    const int64_t *off;
    bool operator()(const BcKey &a, const BcKey &b) const {
        if (a.hi != b.hi) return a.hi < b.hi;
        if (a.lo != b.lo) return a.lo < b.lo;
        int64_t na = off[a.id + 1] - off[a.id] - 1;
        int64_t nb = off[b.id + 1] - off[b.id] - 1;
        int c = memcmp(concat + off[a.id], concat + off[b.id],
                       (size_t)std::min(na, nb));
        if (c != 0) return c < 0;
        if (na != nb) return na < nb;
        return a.id < b.id;
    }
};

// Joins the stripes' buffers, in order, into one malloc'd NUL-terminated
// output. Returns 0, or -1 when a stripe or the output could not allocate.
int join(const Buf *parts, const bool *ok, int64_t k, char **out,
         int64_t *len) {
    size_t total = 0;
    for (int64_t s = 0; s < k; ++s) {
        if (!ok[s]) return -1;
        total += parts[s].len;
    }
    char *o = (char *)malloc(total + 1);
    if (!o) return -1;
    char *p = o;
    for (int64_t s = 0; s < k; ++s)
        if (parts[s].len) p = put(p, parts[s].data, parts[s].len);
    *p = '\0';
    *out = o;
    *len = (int64_t)total;
    return 0;
}

}  // namespace

extern "C" {

void dmx_render_free(char *p) { free(p); }

// Renders .sing2 and .best bodies (headers written by the caller).
// order: barcode-sorted cell ids (stats.bc_order()). Returns 0 on
// success; *out2/*outb are malloc'd (caller frees via dmx_render_free).
int dmx_render_pass2_compact(
    int64_t n_order, const int64_t *order,
    const char *bc_concat, const int64_t *bc_off,
    const char *sm_concat, const int64_t *sm_off,
    int64_t nv, int64_t na, const double *grid_alpha, double doublet_prior,
    const int64_t *totl, const int64_t *pass_, const int64_t *uniq,
    const int64_t *nsnp,
    const double *max_llk, const double *sum_single,
    const double *sum_double,
    const double *sing_col,  /* (n, nv) */
    const double *llk00,     /* (n, na) */
    const int64_t *i_sing1, const int64_t *i_sing2, const int64_t *best_flat,
    const double *max_sing2, const double *pair_llk12,
    const double *pair_llk10, const double *pair_llk20,
    int64_t min_total, int64_t min_uniq, int64_t min_snp,
    char **out2, int64_t *len2, char **outb, int64_t *lenb) {
    const Names sm(sm_concat, sm_off, nv);
    // a .best line: barcode, counts, the call (at most "AMB-" and four
    // IDs, or "DBL-", two IDs and an alpha), four IDs, eleven fixed-format
    // and two %g fields, separators
    const size_t best_room =
        kCounts + 8 * sm.longest + 11 * kFixed + 2 * kGen + 32;
    Buf parts2[kMaxStripes], partsb[kMaxStripes];
    bool ok[kMaxStripes] = {};
    int64_t k = striped(n_order, [&](int64_t s, int64_t r0, int64_t r1) {
        Buf &b2 = parts2[s], &bb = partsb[s];
        ok[s] = b2.reserve((size_t)(r1 - r0) * nv * 128) &&
                bb.reserve((size_t)(r1 - r0) * 256);
        char counts[kCounts], tail[kFixed + 2];
        for (int64_t r = r0; ok[s] && r < r1; ++r) {
            int64_t i = order[r];
            int64_t t = totl[i], u = uniq[i], ns = nsnp[i];
            if (t < min_total || u < min_uniq || ns < min_snp) continue;
            if (ns == 0) continue;
            const char *bc = str_at(bc_concat, bc_off, i);
            const size_t bcn = strlen(bc);
            double mx = max_llk[i];
            double ssum = sum_single[i];
            double dsum = sum_double[i];
            const double *sing = sing_col + i * nv;
            double z0_0 = llk00[i * na];
            const size_t countsn =
                (size_t)(put_counts(counts, t, pass_[i], u, ns) - counts);
            char *q = tail;
            *q++ = '\t';
            q = put_fixed(q, z0_0, 4);
            *q++ = '\t';
            ok[s] = put_sample_lines(
                        b2, bc, bcn, sm, nv, counts, countsn, sing, 4, tail,
                        (size_t)(q - tail),
                        [&](int64_t j) {
                            return exp(sing[j] - mx) * (1.0 - doublet_prior) /
                                   (double)nv / ssum;
                        }) &&
                    bb.reserve(bcn + best_room);
            if (!ok[s]) break;
            int64_t i1 = i_sing1[i], i2 = i_sing2[i], best = best_flat[i];
            int64_t j_best = best / (nv * na);
            int64_t k_best = (best / na) % nv;
            int64_t a_best = best % na;
            double sing_llk1 = sing[i1];
            double sing_llk2 = max_sing2[i];
            double p12 = pair_llk12[i];
            double p1 = sing[j_best];
            double p2 = sing[k_best];
            double post_dbl = dsum / (ssum + dsum);
            double post_sng = exp(sing_llk1 - mx) * (1.0 - doublet_prior) /
                              (double)nv / ssum;
            char *p = put(bb.end(), bc, bcn);
            p = put(p, counts, countsn);
            auto id = [&](int64_t j) { return put(p, sm.s[j], sm.n[j]); };
            if (p12 > p1 && p12 > p2 && p12 > sing_llk1 + 2) {
                p = put(p, "DBL-", 4);
                p = id(j_best);
                *p++ = '-';
                p = id(k_best);
                *p++ = '-';
                p = put_fixed(p, grid_alpha[a_best], 3);
            } else if (sing_llk1 > sing_llk2 + 2) {
                p = put(p, "SNG-", 4);
                p = id(i1);
            } else {
                p = put(p, "AMB-", 4);
                p = id(i1);
                *p++ = '-';
                p = id(i2);
                *p++ = '-';
                p = id(j_best);
                *p++ = '/';
                p = id(k_best);
            }
            *p++ = '\t';
            p = id(i1);
            *p++ = '\t';
            p = put_fixed(p, sing_llk1, 4);
            *p++ = '\t';
            p = id(i2);
            *p++ = '\t';
            p = put_fixed(p, sing_llk2, 4);
            p = put(p, tail, (size_t)(q - tail));  // "\t<z0_0>\t"
            p = id(j_best);
            *p++ = '\t';
            p = id(k_best);
            *p++ = '\t';
            p = put_fixed(p, grid_alpha[a_best], 3);
            for (double v : {p12, p1, p2, pair_llk10[i], pair_llk20[i],
                             llk00[i * na + a_best]}) {
                *p++ = '\t';
                p = put_fixed(p, v, 4);
            }
            *p++ = '\t';
            p = put_gen(p, post_dbl);
            *p++ = '\t';
            p = put_gen(p, post_sng);
            *p++ = '\n';
            bb.end_at(p);
        }
    });
    if (join(parts2, ok, k, out2, len2) != 0) return -1;
    if (join(partsb, ok, k, outb, lenb) != 0) {
        free(*out2);
        return -1;
    }
    return 0;
}

// Renders the .single body (header written by the caller): per-cell
// sequential log-sum-exp over the singlet LLKs (reference order,
// cmd_cram_demuxlet.cpp pass 1) then one line per sample. Same libm
// exp/log as CPython's math module -> identical doubles.
int dmx_render_single(
    int64_t n_order, const int64_t *order,
    const char *bc_concat, const int64_t *bc_off,
    const char *sm_concat, const int64_t *sm_off, int64_t nv,
    const int64_t *totl, const int64_t *pass_, const int64_t *uniq,
    const int64_t *nsnp,
    const double *llks, /* (n, nv) */ const double *llk0s,
    int64_t min_total, int64_t min_uniq, int64_t min_snp,
    char **out, int64_t *len) {
    const Names sm(sm_concat, sm_off, nv);
    Buf parts[kMaxStripes];
    bool ok[kMaxStripes] = {};
    int64_t k = striped(n_order, [&](int64_t s, int64_t r0, int64_t r1) {
        Buf &b = parts[s];
        ok[s] = b.reserve((size_t)(r1 - r0) * nv * 128);
        char counts[kCounts], tail[kFixed + 2];
        for (int64_t r = r0; ok[s] && r < r1; ++r) {
            int64_t i = order[r];
            int64_t t = totl[i], u = uniq[i], ns = nsnp[i];
            if (t < min_total || u < min_uniq || ns < min_snp) continue;
            const char *bc = str_at(bc_concat, bc_off, i);
            const double *row = llks + i * nv;
            double sum_llk = -1e300;
            for (int64_t j = 0; j < nv; ++j) {
                double cur = row[j];
                if (sum_llk > cur)
                    sum_llk = sum_llk + log(1.0 + exp(cur - sum_llk));
                else
                    sum_llk = cur + log(1.0 + exp(sum_llk - cur));
            }
            const size_t countsn =
                (size_t)(put_counts(counts, t, pass_[i], u, ns) - counts);
            char *q = tail;
            *q++ = '\t';
            q = put_fixed(q, llk0s[i], 5);
            *q++ = '\t';
            ok[s] = put_sample_lines(
                b, bc, strlen(bc), sm, nv, counts, countsn, row, 5, tail,
                (size_t)(q - tail),
                [&](int64_t j) { return exp(row[j] - sum_llk); });
        }
    });
    return join(parts, ok, k, out, len);
}

// Render calls and the stripes they used, since the library was loaded.
void dmx_render_counts(int64_t *calls, int64_t *stripes) {
    *calls = g_calls.load();
    *stripes = g_stripes.load();
}

// Fills order[0..n) with the cell ids sorted as Python's
// sorted((b, i) for i, b in enumerate(barcodes)): barcode i is the
// NUL-terminated UTF-8 at bc_concat + bc_off[i], bc_off[i + 1] - bc_off[i]
// - 1 bytes long. Each stripe sorts its records on its own thread, then the
// sorted stripes are merged pairwise. Returns 0, or -1 when the records
// cannot be allocated.
int dmx_bc_order(int64_t n, const char *bc_concat, const int64_t *bc_off,
                 int64_t *order) {
    std::vector<BcKey> keys;
    try {
        keys.resize((size_t)n);
    } catch (const std::bad_alloc &) {
        return -1;
    }
    const BcLess less{bc_concat, bc_off};
    int64_t k = on_stripes(n, [&](int64_t, int64_t r0, int64_t r1) {
        for (int64_t i = r0; i < r1; ++i)
            keys[i] = bc_key(bc_concat, bc_off, i);
        std::sort(keys.begin() + r0, keys.begin() + r1, less);
    });
    auto at = [&](int64_t s) { return keys.begin() + n * std::min(s, k) / k; };
    for (int64_t w = 1; w < k; w *= 2)
        for (int64_t s = 0; s + w < k; s += 2 * w)
            std::inplace_merge(at(s), at(s + w), at(s + 2 * w), less);
    for (int64_t r = 0; r < n; ++r) order[r] = keys[r].id;
    g_order_calls.fetch_add(1);
    g_order_barcodes.fetch_add(n);
    return 0;
}

// Barcode orders built and the barcodes they sorted, since the library was
// loaded.
void dmx_order_counts(int64_t *calls, int64_t *barcodes) {
    *calls = g_order_calls.load();
    *barcodes = g_order_barcodes.load();
}

}  // extern "C"
