// Native pass over all of a pileup's observations for the engine's set-up.
//
// One walk over the cells' CSR observations gives what the set-up's two
// numpy passes give (host/csr.py::CsrPileup._n_snps_all_impl and the code
// pass of host/wire.py::choose_cfg), with no temporaries:
//   * each cell's count of distinct SNPs: the runs of equal obs_snp within
//     the cell, so an empty cell counts 0
//   * the histogram of code = allele * (cap_bq + 1) + min(bq, cap_bq) over
//     every observation, of length 3 * (cap_bq + 1) + 1; allele == 2 rows
//     are counted (the caller drops them)
// Pinned by tests/test_torch_obs_pass.py against both numpy passes.
//
// The histogram is counted by key = allele << 8 | bq, which needs neither
// the multiply nor the min, in kSub interleaved sub-histograms, and folded
// into codes at the end; a cell with an allele above 2 is not counted and
// flags the call. Compiled at -O3, which vectorizes the runs and the
// allele check.
//
// The cells are split into min(kMaxStripes, ceil(nobs / kObsPerStripe))
// contiguous stripes of about equal observation counts; stripes 1.. run on
// their own threads (the ctypes call has released the GIL), stripe 0 on
// the caller's, each into its own histogram, summed in stripe order. A
// pass over at most kObsPerStripe observations is one stripe and starts no
// thread. Built into _prep.so beside prep.cpp (native/prep.py).

#pragma GCC optimize("O3")

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <system_error>
#include <thread>
#include <vector>

namespace {

// The engine's prep pool is 4 threads wide, and idle during the set-up.
constexpr int64_t kMaxStripes = 4;
constexpr int64_t kObsPerStripe = 1 << 18;
// Interleaved sub-histograms: consecutive observations often share a key,
// and one counter bumped back to back waits on its own store.
constexpr int64_t kSub = 4;  // h0..h3 below
constexpr int64_t kKeys = 3 << 8;  // allele 0..2, bq 0..255

std::atomic<int64_t> g_calls{0}, g_stripes{0};

// Cells [c0, c1): their distinct-SNP counts into nsnp, their keys into the
// kSub sub-histograms of kKeys counts at hist. Returns 1 when an allele
// above 2 was seen, else 0.
int pass_cells(const int64_t *cell_ptr, const int32_t *snp,
               const uint8_t *allele, const uint8_t *bq, int64_t c0,
               int64_t c1, int64_t *nsnp, int64_t *hist) {
    int bad = 0;
    int64_t *h0 = hist, *h1 = hist + kKeys, *h2 = hist + 2 * kKeys,
            *h3 = hist + 3 * kKeys;
    for (int64_t c = c0; c < c1; ++c) {
        const int64_t a = cell_ptr[c], b = cell_ptr[c + 1];
        int64_t runs = a < b;
        for (int64_t i = a + 1; i < b; ++i) runs += snp[i] != snp[i - 1];
        nsnp[c] = runs;
        uint8_t high = 0;
        for (int64_t i = a; i < b; ++i) high |= allele[i] > 2;
        if (high) {
            bad = 1;
            continue;
        }
        int64_t i = a;
        for (; i + kSub <= b; i += kSub) {
            ++h0[allele[i] << 8 | bq[i]];
            ++h1[allele[i + 1] << 8 | bq[i + 1]];
            ++h2[allele[i + 2] << 8 | bq[i + 2]];
            ++h3[allele[i + 3] << 8 | bq[i + 3]];
        }
        for (; i < b; ++i) ++h0[allele[i] << 8 | bq[i]];
    }
    return bad;
}

}  // namespace

extern "C" {

// Both results of the pass over ncells cells of nobs observations:
// out_nsnp (ncells) and out_counts (3 * (cap_bq + 1) + 1). Returns 0, or
// a flag for input the numpy passes would treat otherwise, with the
// outputs then undefined: 1 an allele above 2, 2 a cell_ptr that does not
// rise from 0 to nobs, 4 a cap_bq outside [0, 255].
int dmx_obs_pass(const int64_t *cell_ptr, const int32_t *obs_snp,
                 const uint8_t *obs_allele, const uint8_t *obs_bq,
                 int64_t ncells, int64_t nobs, int64_t cap_bq,
                 int64_t *out_nsnp, int64_t *out_counts) {
    if (cap_bq < 0 || cap_bq > 255) return 4;
    if (cell_ptr[0] != 0 || cell_ptr[ncells] != nobs) return 2;
    for (int64_t c = 0; c < ncells; ++c)
        if (cell_ptr[c + 1] < cell_ptr[c]) return 2;
    const int64_t k = std::clamp<int64_t>(
        (nobs + kObsPerStripe - 1) / kObsPerStripe, 1, kMaxStripes);
    // stripe s: cells [cut[s], cut[s + 1]), from the first cell that
    // starts at or past observation nobs * s / k
    int64_t cut[kMaxStripes + 1];
    cut[0] = 0;
    cut[k] = ncells;
    for (int64_t s = 1; s < k; ++s)
        cut[s] = std::lower_bound(cell_ptr, cell_ptr + ncells,
                                  nobs * s / k) - cell_ptr;
    std::vector<int64_t> hist(k * kSub * kKeys, 0);
    int bad[kMaxStripes] = {0};
    auto stripe = [&](int64_t s) {
        bad[s] = pass_cells(cell_ptr, obs_snp, obs_allele, obs_bq, cut[s],
                            cut[s + 1], out_nsnp,
                            hist.data() + s * kSub * kKeys);
    };
    std::thread ts[kMaxStripes];
    for (int64_t s = 1; s < k; ++s) {
        try {
            ts[s] = std::thread(stripe, s);
        } catch (const std::system_error &) {  // no thread to be had
            stripe(s);
        }
    }
    stripe(0);
    for (std::thread &t : ts)
        if (t.joinable()) t.join();
    g_calls.fetch_add(1);
    g_stripes.fetch_add(k);
    const int64_t nq = cap_bq + 1;
    std::fill(out_counts, out_counts + 3 * nq + 1, 0);
    int flags = 0;
    for (int64_t s = 0; s < k; ++s) flags |= bad[s];
    for (int64_t h = 0; h < k * kSub; ++h)
        for (int64_t key = 0; key < kKeys; ++key) {
            const int64_t q = std::min<int64_t>(key & 255, cap_bq);
            out_counts[(key >> 8) * nq + q] += hist[h * kKeys + key];
        }
    return flags;
}

// Passes and the stripes they used, since the library was loaded.
void dmx_obs_counts(int64_t *calls, int64_t *stripes) {
    *calls = g_calls.load();
    *stripes = g_stripes.load();
}

}  // extern "C"
