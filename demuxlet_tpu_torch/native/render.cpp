// Native .sing2/.best renderer for the compact decision path.
//
// Byte-identical port of models/outputs.py::write_pass2_compact (itself
// the behavioral mirror of the reference's output loops,
// cmd_cram_demuxlet.cpp:713-875): CPython's %-formatting of doubles and
// glibc printf are both correctly-rounded David-Gay-style conversions,
// so the same format strings produce the same bytes — pinned by
// tests/test_native_render.py against the Python renderer, and
// transitively by the golden-reference harness.
//
// The Python renderer costs ~50 us/row at 100K cells (4-6 s of the
// end-to-end output phase); this one runs ~1-2 us/row. Build:
// python demuxlet_tpu_torch/native/build.py (produces _render.so; the package
// falls back to the Python renderer when absent).

#include <cmath>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>

namespace {

struct Buf {
    std::string s;
    void appendf(const char *fmt, ...) {
        char tmp[512];
        va_list ap;
        va_start(ap, fmt);
        int n = vsnprintf(tmp, sizeof tmp, fmt, ap);
        va_end(ap);
        if (n >= (int)sizeof tmp) {  // oversized field (absurd barcodes)
            std::string big(n + 1, '\0');
            va_start(ap, fmt);
            vsnprintf(&big[0], n + 1, fmt, ap);
            va_end(ap);
            s.append(big.data(), n);
        } else {
            s.append(tmp, n);
        }
    }
};

const char *str_at(const char *concat, const int64_t *off, int64_t i) {
    return concat + off[i];  // entries are NUL-terminated by the caller
}

// CPython prints NaN as "nan" regardless of sign; glibc prints "-nan"
// when the sign bit is set (x86 0.0/0.0 does set it). fabs clears it.
double F(double x) { return std::isnan(x) ? fabs(x) : x; }

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
    Buf b2, bb;
    b2.s.reserve((size_t)n_order * nv * 64);
    bb.s.reserve((size_t)n_order * 160);
    for (int64_t r = 0; r < n_order; ++r) {
        int64_t i = order[r];
        int64_t t = totl[i], u = uniq[i], ns = nsnp[i];
        if (t < min_total || u < min_uniq || ns < min_snp) continue;
        if (ns == 0) continue;
        const char *bc = str_at(bc_concat, bc_off, i);
        int64_t p = pass_[i];
        double mx = max_llk[i];
        double ssum = sum_single[i];
        double dsum = sum_double[i];
        const double *sing = sing_col + i * nv;
        double z0_0 = llk00[i * na];
        for (int64_t j = 0; j < nv; ++j) {
            double v = sing[j];
            b2.appendf("%s\t%s\t%lld\t%lld\t%lld\t%lld\t%.4f\t%.4f\t%.3g\n",
                       bc, str_at(sm_concat, sm_off, j), (long long)t,
                       (long long)p, (long long)u, (long long)ns, F(v),
                       F(z0_0),
                       F(exp(v - mx) * (1.0 - doublet_prior) / (double)nv /
                         ssum));
        }
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
        double post_sng =
            exp(sing_llk1 - mx) * (1.0 - doublet_prior) / (double)nv / ssum;
        // Buf::appendf (oversized-field fallback), not a fixed char array:
        // long sample IDs (4 names + alpha in one AMB string) must render
        // identically to the Python path, never silently truncate.
        Buf cb;
        if (p12 > p1 && p12 > p2 && p12 > sing_llk1 + 2) {
            cb.appendf("DBL-%s-%s-%.3f",
                       str_at(sm_concat, sm_off, j_best),
                       str_at(sm_concat, sm_off, k_best), grid_alpha[a_best]);
        } else if (sing_llk1 > sing_llk2 + 2) {
            cb.appendf("SNG-%s", str_at(sm_concat, sm_off, i1));
        } else {
            cb.appendf("AMB-%s-%s-%s/%s",
                       str_at(sm_concat, sm_off, i1),
                       str_at(sm_concat, sm_off, i2),
                       str_at(sm_concat, sm_off, j_best),
                       str_at(sm_concat, sm_off, k_best));
        }
        const char *call = cb.s.c_str();
        bb.appendf(
            "%s\t%lld\t%lld\t%lld\t%lld\t%s\t%s\t%.4f\t%s\t%.4f\t%.4f"
            "\t%s\t%s\t%.3f\t%.4f\t%.4f\t%.4f\t%.4f\t%.4f\t%.4f\t%.3g\t%.3g"
            "\n",
            bc, (long long)t, (long long)p, (long long)u, (long long)ns,
            call, str_at(sm_concat, sm_off, i1), F(sing_llk1),
            str_at(sm_concat, sm_off, i2), F(sing_llk2), F(z0_0),
            str_at(sm_concat, sm_off, j_best), str_at(sm_concat, sm_off, k_best),
            grid_alpha[a_best], F(p12), F(p1), F(p2), F(pair_llk10[i]),
            F(pair_llk20[i]), F(llk00[i * na + a_best]), F(post_dbl),
            F(post_sng));
    }
    *len2 = (int64_t)b2.s.size();
    *lenb = (int64_t)bb.s.size();
    *out2 = (char *)malloc(b2.s.size() + 1);
    *outb = (char *)malloc(bb.s.size() + 1);
    if (!*out2 || !*outb) return -1;
    memcpy(*out2, b2.s.data(), b2.s.size() + 1);
    memcpy(*outb, bb.s.data(), bb.s.size() + 1);
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
    Buf b;
    b.s.reserve((size_t)n_order * nv * 64);
    for (int64_t r = 0; r < n_order; ++r) {
        int64_t i = order[r];
        int64_t t = totl[i], u = uniq[i], ns = nsnp[i];
        if (t < min_total || u < min_uniq || ns < min_snp) continue;
        const char *bc = str_at(bc_concat, bc_off, i);
        int64_t p = pass_[i];
        const double *row = llks + i * nv;
        double llk0 = llk0s[i];
        double sum_llk = -1e300;
        for (int64_t j = 0; j < nv; ++j) {
            double cur = row[j];
            if (sum_llk > cur)
                sum_llk = sum_llk + log(1.0 + exp(cur - sum_llk));
            else
                sum_llk = cur + log(1.0 + exp(sum_llk - cur));
        }
        for (int64_t j = 0; j < nv; ++j) {
            b.appendf("%s\t%s\t%lld\t%lld\t%lld\t%lld\t%.5f\t%.5f\t%.3g\n",
                      bc, str_at(sm_concat, sm_off, j), (long long)t,
                      (long long)p, (long long)u, (long long)ns, F(row[j]),
                      F(llk0), F(exp(row[j] - sum_llk)));
        }
    }
    *len = (int64_t)b.s.size();
    *out = (char *)malloc(b.s.size() + 1);
    if (!*out) return -1;
    memcpy(*out, b.s.data(), b.s.size() + 1);
    return 0;
}

}  // extern "C"
