// Native single-pass block prep for the device fast/exact wire path.
//
// Replaces host/csr.py::build_codes_block + engine._shrink_codes_blk on
// the production path: one walk over the block's CSR observation slice
// emits the SHRUNK form directly — per-UMI codes (u8, 255 = none, 254 =
// the empty-valid marker), u8 slot-id deltas with a sparse >255 fix list,
// and the per-cell base id. The numpy pipeline makes ~10 temporary
// array passes per block (measured 215 ms/2048-cell block at 1000
// slots/cell) and was the warm end-to-end bottleneck
// (benchmarks/probe_block_marginal.py: prep 279 ms vs H2D+step 167 ms).
//
// Semantics mirror the Python path BIT-FOR-BIT (pinned by
// tests/test_native.py::test_native_prep_matches_python), including
// code placement: a code lands at its observation's index within the
// slot counted over ALL observations, so dropped allele==2 entries
// leave 255 holes exactly like build_codes_block. Identical arrays in
// guarantee identical device results in BOTH modes on any host, with
// or without the native library (the exact pair-LUT front pairs codes
// two-at-a-time, so even hole-position changes would shift df ulps).
//   * slots = runs of equal snp id within a (cell,snp)-sorted CSR slice
//     (sc_drop_seq.cpp:62-65's dual map, flattened)
//   * allele==2 observations are dropped; a valid slot left with no
//     codes carries 254 in lane 0 (uniform-GL term,
//     cmd_cram_demuxlet.cpp:435 semantics)
//   * code = allele * (cap_bq+1) + min(bq, cap_bq)
//   * d8[s] = min(snp[s] - snp[s-1], 255), fixes restore the excess
//
// dmx_prep_dims returns the block's slot/umi/fix maxima; the caller
// buckets them (Sp, U, Kp) and calls dmx_prep_fill into preallocated
// arrays. flags bit0 = a negative delta was seen (unsorted input —
// caller must fall back to the Python path).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

int dmx_prep_dims(const int64_t* cell_ptr, const int32_t* obs_snp,
                  const uint8_t* obs_allele, const int64_t* ids,
                  int64_t B, int64_t* out /* smax, umax, kmax, flags */) {
    int64_t smax = 0, umax = 0, kmax = 0, flags = 0;
    for (int64_t r = 0; r < B; ++r) {
        const int64_t a = cell_ptr[ids[r]], b = cell_ptr[ids[r] + 1];
        int64_t nslots = 0, nover = 0, run = 0, runmax = 0;
        int32_t prev = 0;
        for (int64_t i = a; i < b; ++i) {
            const int32_t s = obs_snp[i];
            if (i == a || s != prev) {
                if (nslots > 0) {
                    const int64_t d = (int64_t)s - (int64_t)prev;
                    if (d < 0) flags |= 1;
                    if (d > 255) ++nover;
                }
                ++nslots;
                if (run > runmax) runmax = run;
                run = 0;
                prev = s;
            }
            /* UMI width counts ALL slot observations (incl. dropped
             * allele==2) — matches build_codes_block's occ, keeping the
             * U bucket and code placement bit-identical to Python */
            ++run;
        }
        if (run > runmax) runmax = run;
        if (nslots > smax) smax = nslots;
        if (runmax > umax) umax = runmax;
        if (nover > kmax) kmax = nover;
    }
    out[0] = smax;
    out[1] = umax;
    out[2] = kmax;
    out[3] = flags;
    return 0;
}

int dmx_prep_fill(const int64_t* cell_ptr, const int32_t* obs_snp,
                  const uint8_t* obs_allele, const uint8_t* obs_bq,
                  const int64_t* ids, int64_t B,
                  int64_t cap_bq, int64_t Sp, int64_t U, int64_t Kp,
                  int64_t Bp,
                  uint8_t* codes /* (Bp, Sp, U) */,
                  uint8_t* d8 /* (Bp, Sp) */,
                  int32_t* base /* (Bp,) */,
                  int32_t* fix_pos /* (Bp, Kp) */,
                  int32_t* fix_val /* (Bp, Kp) */) {
    const uint8_t cap = (uint8_t)cap_bq;
    const int64_t nq = cap_bq + 1;
    memset(codes, 0xFF, (size_t)(Bp * Sp * U));
    memset(d8, 0, (size_t)(Bp * Sp));
    memset(base, 0, (size_t)(Bp * 4));
    memset(fix_pos, 0, (size_t)(Bp * Kp * 4));
    memset(fix_val, 0, (size_t)(Bp * Kp * 4));
    for (int64_t r = 0; r < B; ++r) {
        const int64_t a = cell_ptr[ids[r]], b = cell_ptr[ids[r] + 1];
        uint8_t* crow = codes + r * Sp * U;
        uint8_t* drow = d8 + r * Sp;
        int32_t* fprow = fix_pos + r * Kp;
        int32_t* fvrow = fix_val + r * Kp;
        int64_t s = -1, occ = 0, k = 0;
        int32_t prev = 0;
        bool has_code = false;
        for (int64_t i = a; i < b; ++i) {
            const int32_t snp = obs_snp[i];
            if (s < 0 || snp != prev) {
                if (s >= 0) {
                    if (!has_code) crow[s * U] = 254;
                    const int64_t d = (int64_t)snp - (int64_t)prev;
                    drow[s + 1] = (uint8_t)(d > 255 ? 255 : d);
                    if (d > 255) {
                        fprow[k] = (int32_t)(s + 1);
                        fvrow[k] = (int32_t)(d - 255);
                        ++k;
                    }
                } else {
                    base[r] = snp;
                }
                ++s;
                occ = 0;
                has_code = false;
                prev = snp;
            }
            const uint8_t al = obs_allele[i];
            if (al < 2) {
                const uint8_t q = obs_bq[i] > cap ? cap : obs_bq[i];
                crow[s * U + occ] = (uint8_t)(al * nq + q);
                has_code = true;
            }
            ++occ; /* every observation advances the lane (255 holes) */
        }
        if (s >= 0 && !has_code) crow[s * U] = 254;
    }
    return 0;
}

}  // extern "C"

/* ---------------------------------------------------------------- v2 pack
 *
 * Single-pass emission of the wire-v2 packed block (host/wire.py is the
 * layout reference and the fallback: dmx_pack2_fill must produce
 * BYTE-IDENTICAL buffers to pack_wire_block — pinned by
 * tests/test_native.py). The Python packer materializes the dense
 * (B, S, U) code tensor and re-walks it ~5 times; on realistic deep-U
 * blocks that is ~270M u8 elements and 2.4-3.0 s/block of the round-5
 * e2e's prep phase. Here each cell's observations stream once.
 *
 * dmx_pack2_dims: per-block statistics for the Python wrapper's static
 * choices (slot max, UMI-lane max incl. dropped-obs holes, per-U0
 * tail-entry maxima over real codes at hole-aware lanes, delta-escape
 * max at E = 2^delta_w - 1).
 * dmx_pack2_fill: emit the (Bp, W) i32 wire rows.
 */

static inline void put_bits(uint8_t* dst, int64_t* bitpos, uint32_t v,
                            int width) {
  /* little-endian bit stream, matching host/wire.py pack_bits for
   * widths 4/6/8/16 (4: lo nibble first; 6: 4 codes -> 3 bytes;
   * verified by the byte-parity test) */
  int64_t byte = *bitpos >> 3;
  int sh = (int)(*bitpos & 7);
  dst[byte] |= (uint8_t)(v << sh);
  if (sh + width > 8) {
    dst[byte + 1] |= (uint8_t)(v >> (8 - sh));
    if (sh + width > 16) dst[byte + 2] |= (uint8_t)(v >> (16 - sh));
  }
  *bitpos += width;
}

extern "C" {

int dmx_pack2_dims(const int64_t* cell_ptr, const int32_t* obs_snp,
                   const uint8_t* obs_allele, const int64_t* ids,
                   int64_t B, int64_t E,
                   const int64_t* u0_cands, int64_t n_cand,
                   int64_t* out /* smax, umax, kmax, flags,
                                   tails_max[n_cand] */) {
  int64_t smax = 0, umax = 0, kmax = 0, flags = 0;
  int64_t* tails_max = out + 4;
  for (int64_t c = 0; c < n_cand; ++c) tails_max[c] = 0;
  std::vector<int64_t> tails((size_t)n_cand);
  for (int64_t r = 0; r < B; ++r) {
    const int64_t a = cell_ptr[ids[r]], b = cell_ptr[ids[r] + 1];
    int64_t nslots = 0, nesc = 0, occ = 0, occmax = 0;
    for (int64_t c = 0; c < n_cand; ++c) tails[c] = 0;
    int32_t prev = 0;
    for (int64_t i = a; i < b; ++i) {
      const int32_t s = obs_snp[i];
      if (i == a || s != prev) {
        if (nslots > 0) {
          const int64_t d = (int64_t)s - (int64_t)prev;
          if (d < 0) flags |= 1;
          if (d > E) ++nesc;
        }
        ++nslots;
        if (occ > occmax) occmax = occ;
        occ = 0;
        prev = s;
      }
      if (obs_allele[i] < 2) {
        /* real code at hole-aware lane `occ` */
        for (int64_t c = 0; c < n_cand; ++c)
          if (occ >= u0_cands[c]) ++tails[c];
      }
      ++occ;
    }
    if (occ > occmax) occmax = occ;
    if (nslots > smax) smax = nslots;
    if (occmax > umax) umax = occmax;
    if (nesc > kmax) kmax = nesc;
    for (int64_t c = 0; c < n_cand; ++c)
      if (tails[c] > tails_max[c]) tails_max[c] = tails[c];
  }
  out[0] = smax;
  out[1] = umax;
  out[2] = kmax;
  out[3] = flags;
  return 0;
}

int dmx_pack2_fill(const int64_t* cell_ptr, const int32_t* obs_snp,
                   const uint8_t* obs_allele, const uint8_t* obs_bq,
                   const int64_t* ids, int64_t B,
                   int64_t cap_bq, const uint8_t* lut /* (256,) */,
                   int64_t n_real, int64_t cw, int64_t dw,
                   int64_t Sp, int64_t U, int64_t U0,
                   int64_t K2p, int64_t Kp, int64_t tw, int64_t Bp,
                   int32_t* wire /* (Bp, W) */, int64_t W) {
  const uint8_t cap = (uint8_t)cap_bq;
  const int64_t nq = cap_bq + 1;
  const uint32_t none = (uint32_t)(n_real + 1);
  const uint32_t marker = (uint32_t)n_real;
  const int64_t E = ((int64_t)1 << dw) - 1;
  const int64_t codes_b = Sp * U0 * cw / 8;
  const int64_t tpos_b = K2p * (tw / 8);
  const int64_t tcode_b = K2p * cw / 8;
  const int64_t delta_b = Sp * dw / 8;
  memset(wire, 0, (size_t)(Bp * W * 4));
  std::vector<uint32_t> lanes((size_t)(U0 > 0 ? U0 : 1));
  for (int64_t r = 0; r < Bp; ++r) {
    uint8_t* row = reinterpret_cast<uint8_t*>(wire + r * W);
    uint8_t* codes8 = row;
    uint8_t* tpos8 = row + codes_b;
    uint8_t* tcode8 = tpos8 + tpos_b;
    uint8_t* delta8 = tcode8 + tcode_b;
    int32_t* base = reinterpret_cast<int32_t*>(delta8 + delta_b);
    uint16_t* fixp = reinterpret_cast<uint16_t*>(base + 1);
    int32_t* fixv = reinterpret_cast<int32_t*>(
        reinterpret_cast<uint8_t*>(fixp) + Kp * 2);
    int64_t cbit = 0, dbit = 0, ntail = 0, nfix = 0;
    const int64_t a = r < B ? cell_ptr[ids[r]] : 0;
    const int64_t b = r < B ? cell_ptr[ids[r] + 1] : 0;
    int64_t s = -1, occ = 0;
    int32_t prev = 0;
    bool has_dense = false;

    auto flush_slot = [&]() {
      if (s < 0) return;
      if (!has_dense) lanes[0] = marker;  /* 254-rule + tail-only rule */
      for (int64_t u = 0; u < U0; ++u)
        put_bits(codes8, &cbit, lanes[u], (int)cw);
    };

    for (int64_t i = a; i < b; ++i) {
      const int32_t snp = obs_snp[i];
      if (s < 0 || snp != prev) {
        flush_slot();
        if (s >= 0) {
          const int64_t d = (int64_t)snp - (int64_t)prev;
          int64_t stored = d > E ? E : d;
          if (d > E && nfix < Kp) {
            fixp[nfix] = (uint16_t)(s + 1);
            fixv[nfix] = (int32_t)(d - E);
            ++nfix;
          }
          put_bits(delta8, &dbit, (uint32_t)stored, (int)dw);
        } else {
          *base = snp;
          put_bits(delta8, &dbit, 0, (int)dw); /* slot 0 delta = 0 */
        }
        ++s;
        occ = 0;
        has_dense = false;
        for (int64_t u = 0; u < U0; ++u) lanes[u] = none;
        prev = snp;
      }
      if (obs_allele[i] < 2) {
        const uint8_t q = obs_bq[i] > cap ? cap : obs_bq[i];
        const uint32_t wc = lut[obs_allele[i] * nq + q];
        if (occ < U0) {
          lanes[occ] = wc;
          has_dense = true;
        } else if (ntail < K2p) {
          const int64_t pos = s * (U - U0) + (occ - U0);
          if (tw == 16)
            reinterpret_cast<uint16_t*>(tpos8)[ntail] = (uint16_t)pos;
          else if (tw == 24) { /* (slot u16, lane u8) planes */
            reinterpret_cast<uint16_t*>(tpos8)[ntail] = (uint16_t)s;
            (tpos8 + K2p * 2)[ntail] = (uint8_t)(occ - U0);
          } else
            reinterpret_cast<int32_t*>(tpos8)[ntail] = (int32_t)pos;
          int64_t tbit = ntail * cw;
          put_bits(tcode8, &tbit, wc, (int)cw);
          ++ntail;
        }
      }
      ++occ;
    }
    flush_slot();
    ++s; /* slots written */
    /* padding: remaining slots' codes = none, deltas = 0 (memset) */
    for (int64_t sp = s < 0 ? 0 : s; sp < Sp; ++sp)
      for (int64_t u = 0; u < U0; ++u)
        put_bits(codes8, &cbit, none, (int)cw);
    /* delta padding is zeros — already memset */
    /* tail padding: pos = OOB sentinel, code = none */
    for (int64_t t = ntail; t < K2p; ++t) {
      if (tw == 16)
        reinterpret_cast<uint16_t*>(tpos8)[t] = 0xFFFF;
      else if (tw == 24) /* slot = Sp sentinel; lane plane is memset 0 */
        reinterpret_cast<uint16_t*>(tpos8)[t] = (uint16_t)Sp;
      else
        reinterpret_cast<int32_t*>(tpos8)[t] = (int32_t)(Sp * (U - U0));
      int64_t tbit = t * cw;
      put_bits(tcode8, &tbit, none, (int)cw);
    }
    /* fix padding is zeros — already memset */
  }
  return 0;
}

}  // extern "C"
