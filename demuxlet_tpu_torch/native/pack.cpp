// Wire-v2 block packer of the engine's prefetch pool.
//
// dmx_pack3_dims and dmx_pack3_fill take the inputs of native/prep.cpp's
// dmx_pack2_dims and dmx_pack2_fill and give the same outputs, byte for
// byte (host/wire.py is the layout; pinned by tests/test_torch_pack.py
// against both), in fewer instructions a slot:
//   * dims: each cell counts its real codes in a histogram by the bit
//     width of their lane; a candidate U0 = 2^j's tail entries are the
//     codes at lanes >= 2^j, a suffix sum of that histogram taken once a
//     cell, where the pinned pass compared every code's lane with every
//     candidate;
//   * fill: the code, tail-code and delta bit streams go through a 64-bit
//     accumulator stored a word at a time, where the pinned fill ORs each
//     field into one to three bytes of a zeroed buffer; a slot's dense
//     lanes are one field where they fit 64 bits, made without a loop
//     where the slot has one observation (most slots); pad slots and pad tail entries are copies
//     of a repeating byte pattern; every byte of a row is written once, so
//     the buffer is not cleared first.
// dmx_pack_counts counts the blocks filled here and those the wrapper
// (native/pack.py) handed to the numpy packer instead. Built into
// _prep.so beside prep.cpp and obs.cpp (native/prep.py).

#pragma GCC optimize("O3")

#include <atomic>
#include <cstdint>
#include <cstring>

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "the wire's bit streams are stored as little-endian words");

namespace {

std::atomic<int64_t> g_calls{0}, g_fallbacks{0};

// bit_width(occ) + 1, which is >= j + 2 exactly when occ >= 2^j
inline int lane_class(int64_t occ) {
    return 64 - __builtin_clzll(static_cast<uint64_t>(occ) << 1 | 1);
}

// Bytes of a repeating-pattern copy: a whole number of fields of every
// width that divides 384 (code widths 4, 6, 8 and 16; delta widths 4, 6,
// 8 and 16).
constexpr int kPat = 48;

// A little-endian bit stream at p, as host/wire.py's pack_bits lays out
// fields of one width: fields go into a 64-bit accumulator, stored a word
// at a time.
struct Bits {
    uint8_t *p;
    uint64_t acc = 0;
    int n = 0;  // bits held in acc

    explicit Bits(uint8_t *dst) : p(dst) {}

    void put(uint64_t v, int w) {  // 1 <= w <= 64
        acc |= v << n;
        n += w;
        if (n >= 64) {
            memcpy(p, &acc, 8);
            p += 8;
            n -= 64;
            acc = n ? v >> (w - n) : 0;
        }
    }

    void flush() {  // the bytes held, the last one partly
        const int bytes = (n + 7) >> 3;
        memcpy(p, &acc, bytes);
        p += bytes;
        acc = 0;
        n = 0;
    }

    // count fields of value v: one by one to the next byte boundary, then
    // whole copies of pat (kPat bytes of v's fields from bit 0; null: none
    // for this width), then one by one
    void fill(uint64_t v, int w, int64_t count, const uint8_t *pat) {
        while (count > 0 && (n & 7)) {
            put(v, w);
            --count;
        }
        if (pat != nullptr && count > 0) {
            flush();
            const int64_t per = kPat * 8 / w;
            for (; count >= per; count -= per) {
                memcpy(p, pat, kPat);
                p += kPat;
            }
        }
        for (; count > 0; --count) put(v, w);
    }
};

// kPat bytes of value v's w-bit fields, or false where w does not divide
// kPat * 8
bool pattern(uint64_t v, int w, uint8_t *pat) {
    if ((kPat * 8) % w) return false;
    Bits b(pat);
    for (int i = 0; i < kPat * 8 / w; ++i) b.put(v, w);
    b.flush();
    return true;
}

}  // namespace

extern "C" {

// dmx_pack2_dims's statistics: out = smax, umax, kmax, flags, then the
// block max of tail entries at U0 = u0_cands[c] for each candidate. The
// candidates must be 1, 2, 4, ..., 2^(n_cand - 1), n_cand <= 62 (the
// wrapper's); returns 1, with out untouched, for others, else 0.
int dmx_pack3_dims(const int64_t *cell_ptr, const int32_t *obs_snp,
                   const uint8_t *obs_allele, const int64_t *ids,
                   int64_t B, int64_t E, const int64_t *u0_cands,
                   int64_t n_cand, int64_t *out) {
    if (n_cand < 0 || n_cand > 62) return 1;
    for (int64_t c = 0; c < n_cand; ++c)
        if (u0_cands[c] != int64_t{1} << c) return 1;
    int64_t smax = 0, umax = 0, kmax = 0, flags = 0;
    int64_t *tails_max = out + 4;
    for (int64_t c = 0; c < n_cand; ++c) tails_max[c] = 0;
    int64_t hist[65];
    for (int64_t r = 0; r < B; ++r) {
        const int64_t a = cell_ptr[ids[r]], b = cell_ptr[ids[r] + 1];
        int64_t nslots = a < b, nesc = 0, occ = 0, occmax = 0;
        int32_t prev = a < b ? obs_snp[a] : 0;
        memset(hist, 0, sizeof hist);
        for (int64_t i = a; i < b; ++i) {
            const int32_t s = obs_snp[i];
            if (s != prev) {
                const int64_t d = (int64_t)s - (int64_t)prev;
                flags |= d < 0;
                nesc += d > E;
                ++nslots;
                if (occ > occmax) occmax = occ;
                occ = 0;
                prev = s;
            }
            // a real code at lane occ, counting dropped allele == 2 holes;
            // lane 0 is no candidate's tail
            if (occ) hist[lane_class(occ)] += obs_allele[i] < 2;
            ++occ;
        }
        if (occ > occmax) occmax = occ;
        if (nslots > smax) smax = nslots;
        if (occmax > umax) umax = occmax;
        if (nesc > kmax) kmax = nesc;
        int64_t tail = 0;  // codes at lanes >= 2^(k - 2)
        for (int64_t k = 64; k >= 2; --k) {
            tail += hist[k];
            if (k - 2 < n_cand && tail > tails_max[k - 2])
                tails_max[k - 2] = tail;
        }
    }
    out[0] = smax;
    out[1] = umax;
    out[2] = kmax;
    out[3] = flags;
    return 0;
}

// dmx_pack2_fill's (Bp, W) int32 wire rows, every byte written. A slot's
// U0 dense lanes go out as one field where they fit 64 bits, else one
// field a lane. Returns 1, with nothing written, for U0 < 1, else 0.
int dmx_pack3_fill(const int64_t *cell_ptr, const int32_t *obs_snp,
                   const uint8_t *obs_allele, const uint8_t *obs_bq,
                   const int64_t *ids, int64_t B, int64_t cap_bq,
                   const uint8_t *lut /* (256,) */, int64_t n_real,
                   int64_t cw, int64_t dw, int64_t Sp, int64_t U,
                   int64_t U0, int64_t K2p, int64_t Kp, int64_t tw,
                   int64_t Bp, int32_t *wire /* (Bp, W) */, int64_t W) {
    if (U0 < 1) return 1;
    g_calls.fetch_add(1);
    const int64_t nq = cap_bq + 1;
    const uint64_t none = (uint64_t)(n_real + 1);
    const uint64_t marker = (uint64_t)n_real;
    const int64_t E = ((int64_t)1 << dw) - 1;
    const int64_t codes_b = Sp * U0 * cw / 8;
    const int64_t tpos_b = K2p * (tw / 8);
    const int64_t tcode_b = K2p * cw / 8;
    const int64_t delta_b = Sp * dw / 8;
    uint8_t none_pat[kPat], zero_pat[kPat];
    const uint8_t *none_p = pattern(none, (int)cw, none_pat) ? none_pat
                                                            : nullptr;
    const uint8_t *zero_p = pattern(0, (int)dw, zero_pat) ? zero_pat
                                                         : nullptr;
    // wire code by min(allele, 2) << 8 | bq: the lut's code at
    // allele * (cap_bq + 1) + min(bq, cap_bq), and the marker for a dropped
    // observation (lane 0 of a slot whose one observation is dropped)
    uint64_t code[3 << 8];
    for (int64_t key = 0; key < (3 << 8); ++key) {
        const int64_t al = key >> 8, bq = key & 255;
        const int64_t i = al * nq + (bq < cap_bq ? bq : cap_bq);
        code[key] = al == 2 ? marker : i < 256 ? lut[i] : none;
    }
    const bool word = U0 * cw <= 64;  // a slot's dense lanes in one field
    const int Uw = (int)(U0 * cw);
    const uint64_t lane0 = (uint64_t{1} << cw) - 1;
    uint64_t none_lanes = 0;
    for (int64_t k = 0; word && k < U0; ++k) none_lanes |= none << (k * cw);
    const uint64_t none_hi = none_lanes & ~lane0;  // lanes 1.. none
    for (int64_t r = 0; r < Bp; ++r) {
        uint8_t *row = reinterpret_cast<uint8_t *>(wire + r * W);
        uint8_t *tpos8 = row + codes_b;
        uint8_t *tcode8 = tpos8 + tpos_b;
        uint8_t *delta8 = tcode8 + tcode_b;
        uint8_t *base8 = delta8 + delta_b;
        uint16_t *fixp = reinterpret_cast<uint16_t *>(base8 + 4);
        int32_t *fixv = reinterpret_cast<int32_t *>(
            reinterpret_cast<uint8_t *>(fixp) + Kp * 2);
        Bits codes(row), tcodes(tcode8), deltas(delta8);
        int64_t s = 0, ntail = 0, nfix = 0;  // s: slots written
        const int64_t a = r < B ? cell_ptr[ids[r]] : 0;
        const int64_t b = r < B ? cell_ptr[ids[r] + 1] : 0;
        int32_t prev = a < b ? obs_snp[a] : 0;  // slot 0's delta is 0
        const int32_t base = prev;
        for (int64_t i = a; i < b; ++s) {
            const int32_t snp = obs_snp[i];
            int64_t j = i + 1;  // the slot's observations: [i, j)
            while (j < b && obs_snp[j] == snp) ++j;
            const int64_t d = (int64_t)snp - (int64_t)prev;
            if (d > E && nfix < Kp) {
                fixp[nfix] = (uint16_t)s;
                fixv[nfix] = (int32_t)(d - E);
                ++nfix;
            }
            deltas.put((uint64_t)(d > E ? E : d), (int)dw);
            prev = snp;
            // observation k of the slot has lane k, a dropped one (allele
            // 2) leaving a hole; lane 0 takes the marker where no dense
            // lane has a code
            const int64_t m = j - i < U0 ? j - i : U0;
            if (!word) {  // one field a lane
                bool dense = false;
                for (int64_t k = 0; k < m; ++k) dense |= obs_allele[i + k] < 2;
                for (int64_t k = 0; k < m; ++k)
                    codes.put(obs_allele[i + k] < 2
                                  ? code[obs_allele[i + k] << 8 | obs_bq[i + k]]
                              : k == 0 && !dense ? marker
                                                 : none,
                              (int)cw);
                codes.fill(none, (int)cw, U0 - m, none_p);
            } else if (j == i + 1) {  // most slots: lane 0 a code or marker
                const int al = obs_allele[i] < 2 ? obs_allele[i] : 2;
                codes.put(none_hi | code[al << 8 | obs_bq[i]], Uw);
            } else {
                uint64_t lanes = none_lanes;
                bool dense = false;
                for (int64_t k = 0; k < m; ++k) {
                    if (obs_allele[i + k] >= 2) continue;
                    const int64_t sh = k * cw;
                    lanes = (lanes & ~(lane0 << sh)) |
                            code[obs_allele[i + k] << 8 | obs_bq[i + k]] << sh;
                    dense = true;
                }
                if (!dense) lanes = (lanes & ~lane0) | marker;
                codes.put(lanes, Uw);
            }
            for (int64_t k = U0; k < j - i && ntail < K2p; ++k) {
                if (obs_allele[i + k] >= 2) continue;
                const int64_t pos = s * (U - U0) + (k - U0);
                if (tw == 16) {
                    reinterpret_cast<uint16_t *>(tpos8)[ntail] =
                        (uint16_t)pos;
                } else if (tw == 24) {  // (slot u16, lane u8) planes
                    reinterpret_cast<uint16_t *>(tpos8)[ntail] = (uint16_t)s;
                    (tpos8 + K2p * 2)[ntail] = (uint8_t)(k - U0);
                } else {
                    reinterpret_cast<int32_t *>(tpos8)[ntail] = (int32_t)pos;
                }
                tcodes.put(code[obs_allele[i + k] << 8 | obs_bq[i + k]],
                           (int)cw);
                ++ntail;
            }
            i = j;
        }
        // pad slots: codes none, deltas 0
        codes.fill(none, (int)cw, (Sp - s) * U0, none_p);
        codes.flush();
        deltas.fill(0, (int)dw, Sp - s, zero_p);
        deltas.flush();
        // pad tail entries: position past the tail plane, code none
        if (tw == 16) {
            memset(tpos8 + ntail * 2, 0xFF, (size_t)((K2p - ntail) * 2));
        } else if (tw == 24) {  // slot = Sp, lane 0
            for (int64_t t = ntail; t < K2p; ++t) {
                reinterpret_cast<uint16_t *>(tpos8)[t] = (uint16_t)Sp;
                (tpos8 + K2p * 2)[t] = 0;
            }
        } else {
            for (int64_t t = ntail; t < K2p; ++t)
                reinterpret_cast<int32_t *>(tpos8)[t] =
                    (int32_t)(Sp * (U - U0));
        }
        tcodes.fill(none, (int)cw, K2p - ntail, none_p);
        tcodes.flush();
        memcpy(base8, &base, 4);
        memset(fixp + nfix, 0, (size_t)((Kp - nfix) * 2));
        memset(fixv + nfix, 0, (size_t)((Kp - nfix) * 4));
    }
    return 0;
}

// A block the wrapper handed to the numpy packer.
void dmx_pack3_fallback(void) { g_fallbacks.fetch_add(1); }

// Blocks filled by dmx_pack3_fill and blocks handed to the numpy packer,
// since the library was loaded.
void dmx_pack_counts(int64_t *calls, int64_t *fallbacks) {
    *calls = g_calls.load();
    *fallbacks = g_fallbacks.load();
}

}  // extern "C"
