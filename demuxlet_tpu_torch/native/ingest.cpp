// Native host-ingest: BGZF/BAM streaming pileup for demuxlet-tpu.
//
// TPU-native replacement for the reference's ingest stack
// (sam_filtered_reader.cpp + hts_utils.cpp:279-359 + sc_drop_seq.cpp), built
// from scratch without htslib:
//   * a zlib BGZF block reader with a bounded-window prefetching inflate
//     pool (blocks are independent gzip members),
//   * a BAM record parser,
//   * a BAI index parser (virtual-offset chromosome segments),
//   * a single-pass coordinate-sweep pileup with streaming per-SNP
//     finalization (the reference instead keeps every (snp,cell)->umi map
//     alive for the whole run),
//   * optional per-chromosome parallel scan: with a .bai present, each
//     chromosome's file segment is scanned by its own thread with private
//     pileup state; results merge in chromosome order, reproducing the
//     sequential first-seen barcode ids and counters exactly (reads never
//     span chromosomes, so UMI dedup state never crosses a segment).
//
// Semantics mirrored exactly (parity contract, see io/bam.py + host/pileup.py
// which implement the same rules in Python and are cross-checked by tests):
//   * MQ/flag filter: mapq < minMQ || (flag & exclFlag)  -> skip
//   * CIGAR walk per (read, SNP): only 'M' consumes read+ref; 'D'/'N' consume
//     ref (no base); 'S'/'I' consume read; 'H','P','=','X' advance nothing
//     (quirk of hts_utils.cpp:304-328 kept for parity).
//   * skip base 'N'; BQ < minBQ; tail-distance (rpos < minTD-1 ||
//     rpos+minTD > l_qseq); allele = ref?0 : alt?1 : 2; bq = min(BQ, capBQ)
//   * UMI dedup: first (snp, cell, umi) occurrence wins; repeats counted as
//     redundant; per-read accounting counters identical to
//     cmd_cram_demuxlet.cpp:295-361.

#include <dlfcn.h>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <zlib.h>

#include <algorithm>
#include <array>
#include <ctime>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

// ---------------------------------------------------------------- errors
struct IngestError {
  std::string msg;
};

static void fail(const std::string& m) { throw IngestError{m}; }

// ---------------------------------------------------------------- file
// Read-only mmap view: RSS stays bounded by the page cache (the kernel
// evicts cold pages), so a 100+ GB BAM never has to fit in RAM — unlike a
// whole-file slurp.
struct FileBuf {
  const uint8_t* data = nullptr;
  size_t size = 0;
  int fd = -1;

  explicit FileBuf(const char* path) {
    fd = open(path, O_RDONLY);
    if (fd < 0) fail(std::string("cannot open ") + path);
    struct stat st;
    if (fstat(fd, &st) != 0) {
      close(fd);
      fd = -1;
      fail(std::string("cannot stat ") + path);
    }
    size = (size_t)st.st_size;
    if (size > 0) {
      void* m = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
      if (m == MAP_FAILED) {
        close(fd);
        fd = -1;
        fail(std::string("cannot mmap ") + path);
      }
      data = (const uint8_t*)m;
    }
  }

  FileBuf(const FileBuf&) = delete;
  FileBuf& operator=(const FileBuf&) = delete;

  ~FileBuf() {
    if (data) munmap((void*)data, size);
    if (fd >= 0) close(fd);
  }
};

// ---------------------------------------------------------------- BGZF
struct BgzfBlock {
  size_t file_off;   // offset of the gzip member in the file
  size_t comp_off;   // offset of deflate payload
  size_t comp_len;   // CDATA length
  uint32_t isize;    // uncompressed size
};

static void parse_bgzf_blocks(const uint8_t* buf, size_t n,
                              const char* path,
                              std::vector<BgzfBlock>* blocks) {
  size_t off = 0;
  while (off + 18 <= n) {
    const uint8_t* p = &buf[off];
    if (p[0] != 0x1f || p[1] != 0x8b)
      fail(std::string(path) + ": bad gzip magic");
    const uint8_t flg = p[3];
    size_t hdr = 10;
    uint32_t bsize = 0;
    if (flg & 4) {  // FEXTRA
      uint16_t xlen = (uint16_t)(p[10] | (p[11] << 8));
      size_t xoff = 12, xend = 12 + xlen;
      while (xoff + 4 <= xend) {
        uint8_t si1 = p[xoff], si2 = p[xoff + 1];
        uint16_t slen = (uint16_t)(p[xoff + 2] | (p[xoff + 3] << 8));
        if (si1 == 'B' && si2 == 'C' && slen == 2)
          bsize = (uint32_t)(p[xoff + 4] | (p[xoff + 5] << 8)) + 1;
        xoff += 4 + slen;
      }
      hdr = xend;
    }
    if (bsize == 0) fail(std::string(path) + ": not BGZF (no BC subfield)");
    if (off + bsize > n) fail(std::string(path) + ": truncated BGZF block");
    const uint8_t* tail = &buf[off + bsize - 4];
    uint32_t isize = (uint32_t)(tail[0] | (tail[1] << 8) | (tail[2] << 16) |
                                ((uint32_t)tail[3] << 24));
    blocks->push_back({off, off + hdr, bsize - hdr - 8, isize});
    off += bsize;
  }
}

// libdeflate whole-buffer raw-DEFLATE decompressor, bound from
// libdeflate.so.0 at runtime via its stable public ABI (the image ships
// the shared library but no headers, same situation as libbz2 for CRAM).
// BGZF blocks are independent members with a known uncompressed size —
// exactly the one-shot shape libdeflate is built for; measured ~2-3x
// faster than zlib streaming inflate. Falls back to zlib when absent.
struct LibDeflate {
  void* (*alloc)(void) = nullptr;
  int (*decomp)(void*, const void*, size_t, void*, size_t, size_t*) =
      nullptr;
  void (*free_d)(void*) = nullptr;

  static const LibDeflate& get() {
    static LibDeflate ld = [] {
      LibDeflate r;
      if (getenv("DEMUX_NO_LIBDEFLATE")) return r;  // A/B + escape hatch
      void* h = dlopen("libdeflate.so.0", RTLD_NOW);
      if (!h) h = dlopen("libdeflate.so", RTLD_NOW);
      if (h) {
        r.alloc = reinterpret_cast<void* (*)(void)>(
            dlsym(h, "libdeflate_alloc_decompressor"));
        r.decomp = reinterpret_cast<int (*)(void*, const void*, size_t,
                                            void*, size_t, size_t*)>(
            dlsym(h, "libdeflate_deflate_decompress"));
        r.free_d = reinterpret_cast<void (*)(void*)>(
            dlsym(h, "libdeflate_free_decompressor"));
        if (!r.alloc || !r.decomp || !r.free_d)
          r.alloc = nullptr;  // partial symbols: treat as absent
      }
      return r;
    }();
    return ld;
  }

  bool ok() const { return alloc != nullptr; }
};

// Bounded-window prefetching BGZF stream: worker threads inflate blocks
// ahead of the consumer; memory = WINDOW blocks (~4 MB), not the whole file.
class BgzfStream {
 public:
  static constexpr size_t WINDOW = 64;

  BgzfStream(const uint8_t* file,
             const std::vector<BgzfBlock>& blocks, size_t first_block,
             size_t end_block, int n_threads)
      : file_(file),
        blocks_(blocks),
        begin_(first_block),
        end_(end_block == 0 ? blocks.size() : end_block),
        next_claim_(first_block),
        consumed_(first_block) {
    slots_.resize(WINDOW);
    int nw = std::max(1, n_threads);
    for (int i = 0; i < nw; ++i)
      workers_.emplace_back([this]() { work(); });
  }

  ~BgzfStream() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_space_.notify_all();
    for (auto& t : workers_) t.join();
  }

  // Returns the next inflated block (or nullptr at end). Valid until the
  // following call.
  const std::vector<uint8_t>* next_block() {
    if (consumed_ >= end_) return nullptr;
    size_t i = consumed_;
    Slot& s = slots_[i % WINDOW];
    {
      std::unique_lock<std::mutex> lk(mu_);
      cv_ready_.wait(lk, [&] { return s.ready_for == i && s.done; });
      if (s.error) fail("BGZF inflate failed");
    }
    cur_ = std::move(s.data);
    {
      std::lock_guard<std::mutex> lk(mu_);
      s.done = false;
      s.ready_for = SIZE_MAX;
      consumed_ = i + 1;
    }
    cv_space_.notify_all();
    return &cur_;
  }

 private:
  struct Slot {
    std::vector<uint8_t> data;
    size_t ready_for = SIZE_MAX;
    bool done = false;
    bool error = false;
  };

  void work() {
    const LibDeflate& ld = LibDeflate::get();
    void* dd = ld.ok() ? ld.alloc() : nullptr;
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (!dd && inflateInit2(&zs, -15) != Z_OK) return;
    for (;;) {
      size_t i = next_claim_.fetch_add(1);
      if (i >= end_) break;
      Slot& s = slots_[i % WINDOW];
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_space_.wait(lk, [&] {
          return stop_ || consumed_ + WINDOW > i;
        });
        if (stop_) break;
      }
      const BgzfBlock& b = blocks_[i];
      std::vector<uint8_t> out(b.isize);
      bool err = false;
      if (b.isize > 0) {
        if (dd) {
          size_t got = 0;
          int rc = ld.decomp(dd, file_ + b.comp_off, b.comp_len,
                             out.data(), b.isize, &got);
          err = (rc != 0 || got != b.isize);
        } else {
          inflateReset(&zs);
          zs.next_in = const_cast<Bytef*>(file_ + b.comp_off);
          zs.avail_in = (uInt)b.comp_len;
          zs.next_out = out.data();
          zs.avail_out = b.isize;
          int rc = inflate(&zs, Z_FINISH);
          err = (rc != Z_STREAM_END || zs.avail_out != 0);
        }
      }
      {
        std::lock_guard<std::mutex> lk(mu_);
        s.data = std::move(out);
        s.error = err;
        s.ready_for = i;
        s.done = true;
      }
      cv_ready_.notify_all();
    }
    if (dd)
      ld.free_d(dd);
    else
      inflateEnd(&zs);
  }

  const uint8_t* file_;
  const std::vector<BgzfBlock>& blocks_;
  size_t begin_, end_;
  std::atomic<size_t> next_claim_;
  size_t consumed_;
  std::vector<Slot> slots_;
  std::vector<std::thread> workers_;
  std::vector<uint8_t> cur_;
  std::mutex mu_;
  std::condition_variable cv_ready_, cv_space_;
  bool stop_ = false;
};

// Record-oriented reader over a BgzfStream: stitches records that span
// block boundaries; tracks virtual offsets for segment bounds.
class RecordReader {
 public:
  RecordReader(const uint8_t* file,
               const std::vector<BgzfBlock>& blocks, size_t first_block,
               uint32_t first_uoffset, int n_threads)
      : stream_(file, blocks, first_block, 0, n_threads),
        blocks_(blocks) {
    skip_ = first_uoffset;
  }

  // Pull `n` bytes into an internal contiguous buffer; returns pointer
  // (valid until the next pull) or nullptr at EOF.
  const uint8_t* pull(size_t n) {
    trim();
    while (buf_.size() - pos_ < n) {
      const std::vector<uint8_t>* blk = stream_.next_block();
      if (!blk) return nullptr;
      size_t drop = skip_;
      skip_ = 0;
      if (drop >= blk->size()) continue;
      buf_.insert(buf_.end(), blk->begin() + drop, blk->end());
    }
    const uint8_t* p = &buf_[pos_];
    pos_ += n;
    return p;
  }

  void unread(size_t n) { pos_ -= n; }

 private:
  void trim() {
    if (pos_ > (1u << 20)) {
      buf_.erase(buf_.begin(), buf_.begin() + pos_);
      pos_ = 0;
    }
  }

  BgzfStream stream_;
  const std::vector<BgzfBlock>& blocks_;
  std::vector<uint8_t> buf_;
  size_t pos_ = 0;
  size_t skip_ = 0;
};

// ---------------------------------------------------------------- BAI
// Per-reference smallest virtual offset, from the linear index (and chunk
// list as fallback). Used to partition the file into per-chromosome
// segments for the parallel scan.
static bool parse_bai_starts(const std::string& bam_path, int n_ref,
                             std::vector<uint64_t>* starts,
                             std::vector<std::vector<uint64_t>>* linear =
                                 nullptr) {
  std::string p1 = bam_path + ".bai";
  FILE* f = fopen(p1.c_str(), "rb");
  if (!f) {
    std::string p2 = bam_path;
    size_t dot = p2.rfind(".bam");
    if (dot != std::string::npos) p2 = p2.substr(0, dot) + ".bai";
    f = fopen(p2.c_str(), "rb");
    if (!f) return false;
  }
  auto rd_u32 = [&](uint32_t* v) { return fread(v, 4, 1, f) == 1; };
  auto rd_u64 = [&](uint64_t* v) { return fread(v, 8, 1, f) == 1; };
  char magic[4];
  if (fread(magic, 1, 4, f) != 4 || memcmp(magic, "BAI\1", 4) != 0) {
    fclose(f);
    return false;
  }
  uint32_t nref;
  if (!rd_u32(&nref)) {
    fclose(f);
    return false;
  }
  starts->assign(n_ref, UINT64_MAX);
  if (linear) linear->assign(n_ref, {});
  for (uint32_t r = 0; r < nref && r < (uint32_t)n_ref; ++r) {
    uint32_t n_bin;
    if (!rd_u32(&n_bin)) break;
    uint64_t mn = UINT64_MAX;
    for (uint32_t b = 0; b < n_bin; ++b) {
      uint32_t bin, n_chunk;
      rd_u32(&bin);
      rd_u32(&n_chunk);
      for (uint32_t c = 0; c < n_chunk; ++c) {
        uint64_t beg, end;
        rd_u64(&beg);
        rd_u64(&end);
        if (bin != 37450 && beg < mn) mn = beg;  // skip pseudo-bin
      }
    }
    uint32_t n_intv;
    rd_u32(&n_intv);
    for (uint32_t i = 0; i < n_intv; ++i) {
      uint64_t io;
      rd_u64(&io);
      if (io && io < mn) mn = io;
      if (linear) (*linear)[r].push_back(io);
    }
    (*starts)[r] = mn;
  }
  fclose(f);
  return true;
}

// ---------------------------------------------------------------- CSI
// CSI fallback when no .bai exists (large chromosomes >2^29 bp can only
// be indexed as CSI; htslib reads either, so must we). Same consumer
// contract as parse_bai_starts: per-ref smallest virtual offset plus a
// synthetic 16kb-granular linear index. CSI carries no linear index —
// each bin instead records loff, the virtual offset of its first
// overlapping record — so the 16kb windows are filled from leaf-bin
// loffs (a leaf covers 2^min_shift bp; seeking to the loff of the leaf
// containing a window start can only land earlier, never skip reads).
// CSI files are BGZF-compressed, unlike raw BAI.
static bool parse_csi_starts(const std::string& bam_path, int n_ref,
                             std::vector<uint64_t>* starts,
                             std::vector<std::vector<uint64_t>>* linear =
                                 nullptr) {
  std::string p1 = bam_path + ".csi";
  FILE* probe = fopen(p1.c_str(), "rb");
  if (!probe) {
    size_t dot = bam_path.rfind(".bam");
    if (dot == std::string::npos) return false;
    p1 = bam_path.substr(0, dot) + ".csi";
    probe = fopen(p1.c_str(), "rb");
    if (!probe) return false;
  }
  fclose(probe);
  std::string bytes;
  try {
    FileBuf f(p1.c_str());
    std::vector<BgzfBlock> blocks;
    parse_bgzf_blocks(f.data, f.size, p1.c_str(), &blocks);
    for (const auto& b : blocks) {
      if (b.isize == 0) continue;
      size_t at = bytes.size();
      bytes.resize(at + b.isize);
      z_stream zs;
      memset(&zs, 0, sizeof(zs));
      if (inflateInit2(&zs, -15) != Z_OK) return false;
      zs.next_in = const_cast<Bytef*>(f.data + b.comp_off);
      zs.avail_in = (uInt)b.comp_len;
      zs.next_out = (Bytef*)&bytes[at];
      zs.avail_out = b.isize;
      int rc = inflate(&zs, Z_FINISH);
      inflateEnd(&zs);
      if (rc != Z_STREAM_END) return false;
    }
  } catch (const IngestError&) {
    return false;
  }
  size_t pos = 0;
  auto rd_u32 = [&](uint32_t* v) {
    if (pos + 4 > bytes.size()) return false;
    memcpy(v, &bytes[pos], 4);
    pos += 4;
    return true;
  };
  auto rd_u64 = [&](uint64_t* v) {
    if (pos + 8 > bytes.size()) return false;
    memcpy(v, &bytes[pos], 8);
    pos += 8;
    return true;
  };
  if (bytes.size() < 4 || memcmp(bytes.data(), "CSI\1", 4) != 0) return false;
  pos = 4;
  uint32_t min_shift, depth, l_aux, nref;
  if (!rd_u32(&min_shift) || !rd_u32(&depth) || !rd_u32(&l_aux)) return false;
  if (min_shift < 4 || min_shift > 31 || depth > 10) return false;
  pos += l_aux;
  if (!rd_u32(&nref)) return false;
  const uint64_t leaf0 = ((1ull << (3 * depth)) - 1) / 7;
  const uint64_t max_bin = ((1ull << (3 * (depth + 1))) - 1) / 7;
  starts->assign(n_ref, UINT64_MAX);
  if (linear) linear->assign(n_ref, {});
  for (uint32_t r = 0; r < nref && r < (uint32_t)n_ref; ++r) {
    uint32_t n_bin;
    if (!rd_u32(&n_bin)) return false;
    uint64_t mn = UINT64_MAX;
    for (uint32_t b = 0; b < n_bin; ++b) {
      uint32_t bin, n_chunk;
      uint64_t loff;
      if (!rd_u32(&bin) || !rd_u64(&loff) || !rd_u32(&n_chunk)) return false;
      const bool pseudo = bin > max_bin;  // htslib metadata pseudo-bin
      for (uint32_t c = 0; c < n_chunk; ++c) {
        uint64_t beg, end;
        if (!rd_u64(&beg) || !rd_u64(&end)) return false;
        if (!pseudo && beg < mn) mn = beg;
      }
      if (pseudo || !linear || loff == 0 || bin < leaf0) continue;
      const uint64_t leaf = bin - leaf0;
      uint64_t w0, w1;
      if (min_shift >= 14) {
        w0 = (leaf << min_shift) >> 14;
        w1 = ((leaf + 1) << min_shift) >> 14;
      } else {
        w0 = leaf >> (14 - min_shift);
        w1 = w0 + 1;
      }
      auto& lin = (*linear)[r];
      if (lin.size() < w1) lin.resize(w1, 0);
      for (uint64_t w = w0; w < w1; ++w)
        if (lin[w] == 0 || loff < lin[w]) lin[w] = loff;
    }
    (*starts)[r] = mn;
  }
  return true;
}

// Either index flavor: BAI preferred (has the real linear index), CSI
// otherwise.
static bool parse_index_starts(const std::string& bam_path, int n_ref,
                               std::vector<uint64_t>* starts,
                               std::vector<std::vector<uint64_t>>* linear =
                                   nullptr) {
  return parse_bai_starts(bam_path, n_ref, starts, linear) ||
         parse_csi_starts(bam_path, n_ref, starts, linear);
}

// ---------------------------------------------------------------- pileup
constexpr const char* kSeqNt16 = "=ACMGRSVTWYHKDBN";

struct Obs {
  int32_t cell;
  int32_t snp;
  uint8_t allele;
  uint8_t bq;
};

struct PairHash {
  size_t operator()(const std::pair<int64_t, uint64_t>& k) const {
    uint64_t h = (uint64_t)k.first * 0x9E3779B97F4A7C15ull;
    h ^= k.second + 0x9E3779B97F4A7C15ull + (h << 6) + (h >> 2);
    return (size_t)h;
  }
};

static uint64_t hash_bytes(const uint8_t* s, size_t n) {
  uint64_t h = 1469598103934665603ull;  // FNV-1a 64
  for (size_t i = 0; i < n; ++i) {
    h ^= s[i];
    h *= 1099511628211ull;
  }
  return h;
}

struct ActiveSnp {
  std::unordered_map<std::pair<int64_t, uint64_t>, uint16_t, PairHash> umis;
};

struct Counters {
  int64_t n_read = 0, n_skip = 0, n_skip_bcd = 0, n_tmp = 0, n_multi_snps = 0;
  int64_t n_pass = 0, n_redundant = 0, n_lq = 0, n_n = 0;
  int64_t n_no_gtag = 0, n_no_utag = 0;
};

struct Result {
  std::vector<std::string> barcodes;
  std::vector<int64_t> cell_totl, cell_pass, cell_uniq;
  std::vector<Obs> obs;
  Counters ctr;
};

struct SnpPanel {
  std::unordered_map<std::string, int> chrom_index;
  const int64_t* chrom_ptr;
  const int64_t* snp_pos;
  const int32_t* snp_ids;
  const uint8_t* snp_ref;
  const uint8_t* snp_alt;
};

struct Params {
  int cap_bq, min_bq, min_td, min_mq, excl_flag;
  bool has_group_tag = false, has_umi_tag = false;
  char tg[2] = {0, 0}, tu[2] = {0, 0};
  bool use_group_set = false;
  std::unordered_set<std::string> group_set;
  int32_t n_shards = 1, shard_id = 0;  // crc32(barcode) % n_shards stripe
  int64_t sam_verbose = 0;  // 0 = quiet; else notice every N reads
  // genome-shard regions (panel chrom idx, beg0, end0-exclusive), genome
  // order; empty = whole genome. Reads are OWNED (counted) by the region
  // containing their start; observations partition exactly by SNP pos.
  std::vector<std::array<int64_t, 3>> regions;
};

// Shared (cross-thread) progress counters for --sam-verbose notices.
struct Progress {
  std::atomic<int64_t> reads{0};
  std::atomic<int64_t> skips{0};
};

// Reference-format timestamped progress notice
// (sam_filtered_reader.cpp:182-189 semantics, Error.cpp:71-86 format).
static void progress_notice(int64_t n_read, int64_t n_skip, bool unmapped,
                            const char* chrom, int64_t pos1) {
  char buff[64];
  time_t t = time(nullptr);
  struct tm tmv;
  localtime_r(&t, &tmv);
  strftime(buff, sizeof(buff), "%Y/%m/%d %H:%M:%S", &tmv);
  if (unmapped)
    fprintf(stderr, "NOTICE [%s] - Reading %lld reads (unmapped) and skipping %lld\n",
            buff, (long long)n_read, (long long)n_skip);
  else
    fprintf(stderr, "NOTICE [%s] - Reading %lld reads at %s:%lld and skipping %lld\n",
            buff, (long long)n_read, chrom, (long long)pos1,
            (long long)n_skip);
  fflush(stderr);
}

class Ingest {
 public:
  Ingest(const SnpPanel& panel, const Params& prm,
         const std::vector<int>& tid_to_chrom,
         int32_t tid_max = INT32_MAX, Progress* progress = nullptr,
         const std::vector<std::string>* ref_names = nullptr)
      : p_(panel), prm_(prm), tid_to_chrom_(tid_to_chrom),
        tid_max_(tid_max), progress_(progress), ref_names_(ref_names) {}

  // Restrict this scan to ONE region segment (BAI-seeked): reads are
  // counted only when owned (pos in [own_beg, own_end)), observations are
  // clamped to SNPs in the same range, and the scan stops past stop_pos.
  void set_region(int chrom, int32_t tid, int64_t beg0, int64_t end0) {
    seg_chrom_ = chrom;
    tid_max_ = tid;
    stop_pos_ = end0;
    own_beg_ = beg0;
    own_end_ = end0;
  }

  // Sequential multi-region mode (no BAI): ownership via region lookup.
  void set_region_list(const std::vector<std::array<int64_t, 3>>* regs) {
    region_list_ = regs;
  }

  // Process records until EOF or (segment mode, tid_max < INT32_MAX) the
  // first record with tid > tid_max — tids ascend in a sorted BAM, and the
  // unmapped tail (tid == -1) belongs to the final segment only.
  void scan(RecordReader& rr) {
    const bool bounded = tid_max_ != INT32_MAX;
    for (;;) {
      const uint8_t* hd = rr.pull(4);
      if (!hd) break;
      uint32_t block_size;
      memcpy(&block_size, hd, 4);
      const uint8_t* rec = rr.pull(block_size);
      if (!rec) fail("truncated BAM record");
      if (bounded) {
        int32_t tid;
        memcpy(&tid, rec, 4);
        if (tid > tid_max_ || tid < 0) {
          rr.unread(block_size + 4);
          break;
        }
        if (stop_pos_ != INT64_MAX && tid == tid_max_) {
          int32_t pos;
          memcpy(&pos, rec + 4, 4);
          if ((int64_t)pos >= stop_pos_) {
            rr.unread(block_size + 4);
            break;
          }
        }
      }
      process_record(rec, block_size);
    }
    finalize_all();
  }

  Result take() {
    finalize_all();  // idempotent; the CRAM path feeds records without scan()
    return std::move(res_);
  }

 private:
  int32_t cell_id(const std::string& bcd) {
    auto it = bc_map_.find(bcd);
    if (it != bc_map_.end()) return it->second;
    int32_t id = (int32_t)res_.barcodes.size();
    bc_map_.emplace(bcd, id);
    res_.barcodes.push_back(bcd);
    res_.cell_totl.push_back(0);
    res_.cell_pass.push_back(0);
    res_.cell_uniq.push_back(0);
    return id;
  }

  void finalize_before(int chrom, int64_t pos) {
    while (active_head_ < active_order_.size()) {
      auto [c, k] = active_order_[active_head_];
      if (c > chrom || (c == chrom && p_.snp_pos[k] >= pos)) break;
      flush_snp(c, k);
      ++active_head_;
    }
  }

  void flush_snp(int chrom, int64_t k) {
    auto it = active_.find(((int64_t)chrom << 40) | k);
    if (it == active_.end()) return;
    const int32_t sid = p_.snp_ids[k];
    for (auto& kv : it->second.umis) {
      res_.obs.push_back({(int32_t)kv.first.first, sid,
                          (uint8_t)(kv.second >> 8),
                          (uint8_t)(kv.second & 0xff)});
    }
    active_.erase(it);
  }

  void finalize_all() {
    for (size_t i = active_head_; i < active_order_.size(); ++i)
      flush_snp(active_order_[i].first, active_order_[i].second);
    active_order_.clear();
    active_head_ = 0;
  }

  static bool base_at(const uint8_t* cig, uint32_t n_cigar, int64_t read_pos,
                      int64_t gpos, int32_t l_qseq, const uint8_t* seq4,
                      const uint8_t* qual, char* base, int* bq,
                      int32_t* rpos) {
    int64_t cpos = read_pos;
    int64_t rp = 0;
    for (uint32_t i = 0; i < n_cigar; ++i) {
      uint32_t c;
      memcpy(&c, cig + 4 * i, 4);
      const uint32_t op = c & 0xF, ln = c >> 4;
      bool brk = false;
      switch (op) {
        case 0:  // M
          if (cpos <= gpos && gpos <= cpos + (int64_t)ln - 1) {
            rp += gpos - cpos;
            brk = true;
            break;
          }
          cpos += ln;
          rp += ln;
          break;
        case 2:  // D
        case 3:  // N
          if (cpos <= gpos && gpos <= cpos + (int64_t)ln - 1) {
            rp = -1;
            brk = true;
            break;
          }
          cpos += ln;
          break;
        case 1:  // I
        case 4:  // S
          rp += ln;
          break;
        default:  // H, P, =, X: advance nothing (parity quirk)
          break;
      }
      if (brk) break;
    }
    if (rp < 0 || rp >= l_qseq) {
      *rpos = -1;
      return false;
    }
    uint8_t code = (rp & 1) ? (seq4[rp >> 1] & 0xF) : (seq4[rp >> 1] >> 4);
    *base = kSeqNt16[code];
    *bq = qual[rp];
    *rpos = (int32_t)rp;
    return true;
  }

  void process_record(const uint8_t* r, uint32_t len) {
    int32_t tid, pos, l_seq;
    memcpy(&tid, r, 4);
    memcpy(&pos, r + 4, 4);
    const uint8_t l_read_name = r[8];
    const uint8_t mapq = r[9];
    uint16_t n_cigar, flag;
    memcpy(&n_cigar, r + 12, 2);
    memcpy(&flag, r + 14, 2);
    memcpy(&l_seq, r + 16, 4);

    const uint8_t* cig = r + 32 + l_read_name;
    const uint8_t* seq4 = cig + 4 * n_cigar;
    const uint8_t* qual = seq4 + (l_seq + 1) / 2;
    const uint8_t* tags = qual + l_seq;
    const uint8_t* end = r + len;

    const uint8_t* cb = nullptr;
    size_t cb_len = 0;
    const uint8_t* ub = nullptr;
    size_t ub_len = 0;
    const uint8_t* cg = nullptr;
    uint32_t cg_n = 0;
    scan_tags(tags, end, &cb, &cb_len, &ub, &ub_len, &cg, &cg_n);

    // long-CIGAR records (>65535 ops): BAM stores a dummy `l_seqS spanN`
    // CIGAR and the real one in a CG:B,I aux tag; htslib (the
    // reference's reader) restores it transparently (sam.c) — the dummy
    // soft-clip would otherwise silently mis-pile every covered SNP.
    // Trigger condition mirrors htslib exactly.
    const uint8_t* cig_eff = cig;
    uint32_t n_cigar_eff = n_cigar;
    if (cg && cg_n && n_cigar == 2) {
      uint32_t c0, c1;
      memcpy(&c0, cig, 4);
      memcpy(&c1, cig + 4, 4);
      if ((c0 & 0xF) == 4 && (int32_t)(c0 >> 4) == l_seq &&
          (c1 & 0xF) == 3) {
        cig_eff = cg;
        n_cigar_eff = cg_n;
      }
    }

    int64_t rlen = 0;
    for (uint32_t i = 0; i < n_cigar_eff; ++i) {
      uint32_t c;
      memcpy(&c, cig_eff + 4 * i, 4);
      const uint32_t op = c & 0xF;
      if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) rlen += c >> 4;
    }
    const int64_t endpos = pos + (rlen ? rlen : 1);

    auto resolver = [&](int64_t gpos, char /*ref_c*/, char* base, int* bq,
                        int32_t* rpos) {
      return base_at(cig_eff, n_cigar_eff, pos, gpos, l_seq, seq4, qual,
                     base, bq, rpos);
    };
    process_generic(tid, pos, endpos, mapq, flag, l_seq, cb, cb_len, ub,
                    ub_len, resolver);
  }

  // Shared record logic (filters, barcode/UMI, SNP loop, counters) for any
  // alignment source; `resolve` yields (base, qual, read-pos) at a genomic
  // position given the panel REF char (CRAM resolves matches through it).
 public:
  template <class ResolveFn>
  void process_generic(int32_t tid, int32_t pos, int64_t endpos,
                       uint8_t mapq, uint16_t flag, int32_t l_seq,
                       const uint8_t* cb, size_t cb_len, const uint8_t* ub,
                       size_t ub_len, ResolveFn&& resolve) {
    const int chrom = (tid >= 0 && tid < (int32_t)tid_to_chrom_.size())
                          ? tid_to_chrom_[tid]
                          : -1;
    // In genome-sharded mode, a read belongs to (is counted by) the shard
    // whose region contains its start; other shards may still SCAN it at
    // region boundaries but only emit observations for their own SNPs.
    const bool owned = owns_read(chrom, pos);
    if (owned) res_.ctr.n_read++;
    if (owned && progress_ && prm_.sam_verbose > 0) {
      int64_t n =
          progress_->reads.fetch_add(1, std::memory_order_relaxed);
      if (n % prm_.sam_verbose == 0) {
        const bool unmapped = (flag & 0x04) || tid < 0 ||
                              !ref_names_ ||
                              tid >= (int32_t)ref_names_->size();
        progress_notice(
            n, progress_->skips.load(std::memory_order_relaxed), unmapped,
            unmapped ? "" : (*ref_names_)[tid].c_str(), (int64_t)pos + 1);
      }
    }
    if (mapq < prm_.min_mq || (flag & prm_.excl_flag)) {
      if (owned) {
        res_.ctr.n_skip++;
        if (progress_)
          progress_->skips.fetch_add(1, std::memory_order_relaxed);
      }
      return;
    }
    if (chrom < 0) return;
    if (seg_chrom_ >= 0 && chrom != seg_chrom_) return;

    int32_t ibcd;
    if (!prm_.has_group_tag) {
      ibcd = cell_id(".");
    } else {
      std::string sbcd;
      if (cb)
        sbcd.assign((const char*)cb, cb_len);
      else {
        if (owned) res_.ctr.n_no_gtag++;
        sbcd = ".";
      }
      if (prm_.use_group_set && !prm_.group_set.count(sbcd)) {
        if (owned) res_.ctr.n_skip_bcd++;
        return;
      }
      if (prm_.n_shards > 1) {
        uint32_t h = (uint32_t)crc32(0L, (const Bytef*)sbcd.data(),
                                     (uInt)sbcd.size());
        if ((int32_t)(h % (uint32_t)prm_.n_shards) != prm_.shard_id) {
          if (owned) res_.ctr.n_skip_bcd++;
          return;
        }
      }
      ibcd = cell_id(sbcd);
    }
    if (owned) res_.ctr.n_tmp++;

    uint64_t umih;
    if (!prm_.has_umi_tag) {
      umih = umi_counter_++;
    } else if (ub) {
      umih = hash_bytes(ub, ub_len);
    } else {
      if (owned) res_.ctr.n_no_utag++;
      umih = hash_bytes((const uint8_t*)".", 1);
    }

    if (owned) res_.cell_totl[ibcd]++;

    finalize_before(chrom, pos);

    // observations partition exactly by SNP position: in segment mode only
    // this region's SNPs are emitted (boundary reads are scanned by two
    // segments but their SNPs split disjointly)
    int64_t obs_beg = pos, obs_end = endpos;
    if (seg_chrom_ >= 0) {
      if (obs_beg < own_beg_) obs_beg = own_beg_;
      if (obs_end > own_end_) obs_end = own_end_;
    }
    const int64_t lo0 = p_.chrom_ptr[chrom], hi0 = p_.chrom_ptr[chrom + 1];
    int64_t lo = lower_bound(lo0, hi0, obs_beg);
    int64_t hi = lower_bound(lo, hi0, obs_end);

    int nv_pass = 0, nv_redundant = 0, nv_valid = 0;
    for (int64_t k = lo; k < hi; ++k) {
      char base;
      int bq;
      int32_t rpos;
      const int32_t sid = p_.snp_ids[k];
      const char refc = (char)p_.snp_ref[sid];
      if (!resolve(p_.snp_pos[k], refc, &base, &bq, &rpos)) continue;
      if (base == 'N') continue;
      nv_valid++;
      if (bq < prm_.min_bq) continue;
      if (rpos < prm_.min_td - 1) continue;
      if (rpos + prm_.min_td > l_seq) continue;
      const char altc = (char)p_.snp_alt[sid];
      const uint8_t allele = base == refc ? 0 : (base == altc ? 1 : 2);
      const uint8_t cbq =
          (uint8_t)(bq > prm_.cap_bq ? prm_.cap_bq : bq);
      if (add_umi(chrom, k, ibcd, umih, allele, cbq))
        nv_pass++;
      else
        nv_redundant++;
    }
    if (owned) {
      if (nv_pass > 1) res_.ctr.n_multi_snps++;
      if (nv_pass > 0)
        res_.ctr.n_pass++;
      else if (nv_redundant > 0)
        res_.ctr.n_redundant++;
      else if (nv_valid > 0)
        res_.ctr.n_lq++;
      else
        res_.ctr.n_n++;
    }
  }

  bool add_umi(int chrom, int64_t k, int32_t cell, uint64_t umih,
               uint8_t allele, uint8_t bq) {
    res_.cell_pass[cell]++;
    const int64_t key = ((int64_t)chrom << 40) | k;
    auto [it, inserted] = active_.try_emplace(key);
    if (inserted) active_order_.emplace_back(chrom, k);
    auto [uit, fresh] = it->second.umis.try_emplace(
        {cell, umih}, (uint16_t)(((uint16_t)allele << 8) | bq));
    if (!fresh) return false;
    res_.cell_uniq[cell]++;
    return true;
  }

  int64_t lower_bound(int64_t lo, int64_t hi, int64_t val) const {
    while (lo < hi) {
      int64_t mid = (lo + hi) >> 1;
      if (p_.snp_pos[mid] < val)
        lo = mid + 1;
      else
        hi = mid;
    }
    return lo;
  }

  void scan_tags(const uint8_t* p, const uint8_t* end, const uint8_t** cb,
                 size_t* cb_len, const uint8_t** ub, size_t* ub_len,
                 const uint8_t** cg = nullptr, uint32_t* cg_n = nullptr) {
    while (p + 3 <= end) {
      const uint8_t t0 = p[0], t1 = p[1];
      const char typ = (char)p[2];
      p += 3;
      size_t vlen = 0;
      switch (typ) {
        case 'Z':
        case 'H': {
          const uint8_t* z = p;
          while (z < end && *z) ++z;
          if (typ == 'Z') {
            if (prm_.has_group_tag && t0 == prm_.tg[0] && t1 == prm_.tg[1]) {
              *cb = p;
              *cb_len = (size_t)(z - p);
            } else if (prm_.has_umi_tag && t0 == prm_.tu[0] &&
                       t1 == prm_.tu[1]) {
              *ub = p;
              *ub_len = (size_t)(z - p);
            }
          }
          p = z + 1;
          continue;
        }
        case 'A':
        case 'c':
        case 'C':
          vlen = 1;
          break;
        case 's':
        case 'S':
          vlen = 2;
          break;
        case 'i':
        case 'I':
        case 'f':
          vlen = 4;
          break;
        case 'B': {
          if (p + 5 > end) return;
          const char sub = (char)p[0];
          uint32_t cnt;
          memcpy(&cnt, p + 1, 4);
          size_t esz = (sub == 'c' || sub == 'C')   ? 1
                       : (sub == 's' || sub == 'S') ? 2
                                                    : 4;
          vlen = 5 + (size_t)cnt * esz;
          if (cg && t0 == 'C' && t1 == 'G' && sub == 'I' &&
              p + vlen <= end) {
            *cg = p + 5;  // long-CIGAR restore array (see process_record)
            *cg_n = cnt;
          }
          break;
        }
        default:
          return;  // unknown tag type: stop scanning (matches Python)
      }
      p += vlen;
    }
  }

  const SnpPanel& p_;
  const Params& prm_;
  const std::vector<int>& tid_to_chrom_;
  int32_t tid_max_;
  Progress* progress_;
  const std::vector<std::string>* ref_names_;
  int seg_chrom_ = -1;  // >= 0: single-region segment mode
  int64_t stop_pos_ = INT64_MAX;
  int64_t own_beg_ = 0, own_end_ = INT64_MAX;
  const std::vector<std::array<int64_t, 3>>* region_list_ = nullptr;

  bool owns_read(int chrom, int64_t pos) const {
    if (seg_chrom_ >= 0)
      return chrom == seg_chrom_ && pos >= own_beg_ && pos < own_end_;
    if (region_list_) {
      for (const auto& r : *region_list_)
        if ((int)r[0] == chrom && pos >= r[1] && pos < r[2]) return true;
      return false;
    }
    return true;
  }
  std::unordered_map<std::string, int> bc_map_;
  uint64_t umi_counter_ = 0;
  std::unordered_map<int64_t, ActiveSnp> active_;
  std::vector<std::pair<int, int64_t>> active_order_;
  size_t active_head_ = 0;
  Result res_;
};

// ---------------------------------------------------------------- driver
struct BamHeaderInfo {
  std::vector<int> tid_to_chrom;
  std::vector<std::string> ref_names;
  int n_ref = 0;
  size_t header_bytes = 0;  // uncompressed length of magic+header+refs
};

static BamHeaderInfo parse_bam_header(RecordReader& rr,
                                      const SnpPanel& panel) {
  BamHeaderInfo info;
  const uint8_t* p = rr.pull(8);
  if (!p || memcmp(p, "BAM\1", 4) != 0) fail("not a BAM file (bad magic)");
  int32_t l_text;
  memcpy(&l_text, p + 4, 4);
  if (l_text > 0 && !rr.pull((size_t)l_text)) fail("truncated BAM header");
  const uint8_t* q = rr.pull(4);
  if (!q) fail("truncated BAM header");
  int32_t n_ref;
  memcpy(&n_ref, q, 4);
  info.n_ref = n_ref;
  info.tid_to_chrom.assign(n_ref, -1);
  for (int32_t i = 0; i < n_ref; ++i) {
    const uint8_t* a = rr.pull(4);
    int32_t l_name;
    memcpy(&l_name, a, 4);
    const uint8_t* nm = rr.pull((size_t)l_name + 4);
    std::string name((const char*)nm, (size_t)(l_name - 1));
    auto it = panel.chrom_index.find(name);
    if (it != panel.chrom_index.end()) info.tid_to_chrom[i] = it->second;
    info.ref_names.push_back(std::move(name));
  }
  return info;
}

#include "cram_reader.inc"

static Result merge_results(std::vector<Result>& parts) {
  Result out;
  std::unordered_map<std::string, int32_t> bc_map;
  for (auto& part : parts) {
    std::vector<int32_t> remap(part.barcodes.size());
    for (size_t i = 0; i < part.barcodes.size(); ++i) {
      auto it = bc_map.find(part.barcodes[i]);
      int32_t gid;
      if (it == bc_map.end()) {
        gid = (int32_t)out.barcodes.size();
        bc_map.emplace(part.barcodes[i], gid);
        out.barcodes.push_back(part.barcodes[i]);
        out.cell_totl.push_back(0);
        out.cell_pass.push_back(0);
        out.cell_uniq.push_back(0);
      } else {
        gid = it->second;
      }
      remap[i] = gid;
      out.cell_totl[gid] += part.cell_totl[i];
      out.cell_pass[gid] += part.cell_pass[i];
      out.cell_uniq[gid] += part.cell_uniq[i];
    }
    for (auto& o : part.obs)
      out.obs.push_back({remap[o.cell], o.snp, o.allele, o.bq});
    part.obs.clear();
    Counters& c = out.ctr;
    const Counters& d = part.ctr;
    c.n_read += d.n_read;
    c.n_skip += d.n_skip;
    c.n_skip_bcd += d.n_skip_bcd;
    c.n_tmp += d.n_tmp;
    c.n_multi_snps += d.n_multi_snps;
    c.n_pass += d.n_pass;
    c.n_redundant += d.n_redundant;
    c.n_lq += d.n_lq;
    c.n_n += d.n_n;
    c.n_no_gtag += d.n_no_gtag;
    c.n_no_utag += d.n_no_utag;
  }
  return out;
}

static size_t block_index_for_coffset(const std::vector<BgzfBlock>& blocks,
                                      uint64_t coffset) {
  size_t lo = 0, hi = blocks.size();
  while (lo < hi) {
    size_t mid = (lo + hi) / 2;
    if (blocks[mid].file_off < coffset)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;  // first block with file_off >= coffset (expects exact match)
}

// Full-file ingest; parallel per-chromosome when a .bai is present and
// n_threads > 1, else sequential streaming.
static Result run_ingest(const char* path, const SnpPanel& panel,
                         const Params& prm, int n_threads) {
  FileBuf file(path);
  std::vector<BgzfBlock> blocks;
  parse_bgzf_blocks(file.data, file.size, path, &blocks);

  RecordReader hdr_rr(file.data, blocks, 0, 0, std::max(1, n_threads));
  BamHeaderInfo info = parse_bam_header(hdr_rr, panel);

  Progress progress;
  if (!prm.regions.empty()) {
    // Genome-sharded scan: only this shard's regions. Reads are counted by
    // the region owning their START; observations clamp to the region span
    // (boundary reads are scanned by two shards, SNPs split disjointly).
    // With a .bai, each region seeks via the linear index (reading
    // ~|regions|/|genome| of the file); without one, a full sequential
    // scan applies the same ownership via the region list.
    std::vector<uint64_t> starts;
    std::vector<std::vector<uint64_t>> linear;
    if (!parse_index_starts(path, info.n_ref, &starts, &linear)) {
      Ingest ing(panel, prm, info.tid_to_chrom, INT32_MAX, &progress,
                 &info.ref_names);
      ing.set_region_list(&prm.regions);
      ing.scan(hdr_rr);
      return ing.take();
    }
    std::vector<int> chrom_to_tid;
    for (int t = 0; t < info.n_ref; ++t) {
      int c = info.tid_to_chrom[t];
      if (c >= 0) {
        if ((int)chrom_to_tid.size() <= c) chrom_to_tid.resize(c + 1, -1);
        chrom_to_tid[c] = t;
      }
    }
    const int n_reg = (int)prm.regions.size();
    std::vector<Result> reg_parts(n_reg);
    std::atomic<int> next_reg{0};
    std::atomic<bool> reg_bad{false};
    std::string reg_err;
    std::mutex reg_mu;
    auto reg_work = [&]() {
      for (;;) {
        int ri = next_reg.fetch_add(1);
        if (ri >= n_reg) break;
        try {
          const auto& rg = prm.regions[ri];
          const int c = (int)rg[0];
          const int tid = (c >= 0 && c < (int)chrom_to_tid.size())
                              ? chrom_to_tid[c]
                              : -1;
          if (tid < 0 || starts[tid] == UINT64_MAX) continue;  // no reads
          // first 16kb linear-index window overlapping the region start;
          // a zero ioffset means "no data recorded" — fall back to the
          // chromosome's first read (correct, just scans from its start)
          uint64_t vo = starts[tid];
          const size_t win = (size_t)(rg[1] >> 14);
          if (win < linear[tid].size() && linear[tid][win] != 0 &&
              linear[tid][win] > vo)
            vo = linear[tid][win];
          size_t bi = block_index_for_coffset(blocks, vo >> 16);
          RecordReader rr(file.data, blocks, bi, (uint32_t)(vo & 0xffff), 1);
          Ingest ing(panel, prm, info.tid_to_chrom, INT32_MAX, &progress,
                     &info.ref_names);
          ing.set_region(c, tid, rg[1], rg[2]);
          ing.scan(rr);
          reg_parts[ri] = ing.take();
        } catch (const IngestError& e) {
          std::lock_guard<std::mutex> lk(reg_mu);
          reg_err = e.msg;
          reg_bad = true;
        }
      }
    };
    int nw = std::min(std::max(1, n_threads), n_reg);
    std::vector<std::thread> rts;
    for (int i = 0; i < nw; ++i) rts.emplace_back(reg_work);
    for (auto& t : rts) t.join();
    if (reg_bad.load()) fail(reg_err);
    return merge_results(reg_parts);
  }

  std::vector<uint64_t> starts;
  bool have_bai =
      n_threads > 1 && parse_index_starts(path, info.n_ref, &starts);

  if (!have_bai) {
    Ingest ing(panel, prm, info.tid_to_chrom, INT32_MAX, &progress,
               &info.ref_names);
    ing.scan(hdr_rr);  // continue from the header position
    return ing.take();
  }

  // Per-chromosome segments: (tid, voffset). Refs without reads are skipped.
  struct Seg {
    int tid;
    uint64_t voffset;
  };
  std::vector<Seg> segs;
  for (int t = 0; t < info.n_ref; ++t)
    if (starts[t] != UINT64_MAX) segs.push_back({t, starts[t]});
  std::sort(segs.begin(), segs.end(),
            [](const Seg& a, const Seg& b) { return a.voffset < b.voffset; });

  if (segs.empty()) {
    Ingest ing(panel, prm, info.tid_to_chrom, INT32_MAX, &progress,
               &info.ref_names);
    ing.scan(hdr_rr);
    return ing.take();
  }

  // Each worker scans [seg.voffset, next_seg.voffset) by tid bound; the
  // last worker runs to EOF and also handles the unmapped tail.
  const int n_seg = (int)segs.size();
  std::vector<Result> parts(n_seg);
  std::atomic<int> next{0};
  std::atomic<bool> bad{false};
  std::string err_msg;
  std::mutex err_mu;
  auto work = [&]() {
    for (;;) {
      int si = next.fetch_add(1);
      if (si >= n_seg) break;
      try {
        const Seg& s = segs[si];
        int32_t tid_max =
            (si + 1 < n_seg) ? segs[si + 1].tid - 1 : INT32_MAX;
        size_t bi = block_index_for_coffset(blocks, s.voffset >> 16);
        RecordReader rr(file.data, blocks, bi,
                        (uint32_t)(s.voffset & 0xffff), 1);
        Ingest ing(panel, prm, info.tid_to_chrom, tid_max, &progress,
                   &info.ref_names);
        ing.scan(rr);
        parts[si] = ing.take();
      } catch (const IngestError& e) {
        std::lock_guard<std::mutex> lk(err_mu);
        err_msg = e.msg;
        bad = true;
      }
    }
  };
  int nw = std::min(n_threads, n_seg);
  std::vector<std::thread> ts;
  for (int i = 0; i < nw; ++i) ts.emplace_back(work);
  for (auto& t : ts) t.join();
  if (bad.load()) fail(err_msg);
  return merge_results(parts);
}

}  // namespace

// ---------------------------------------------------------------- C API
extern "C" {

struct DmxHandle {
  Result res;
  std::string err;
};

DmxHandle* dmx_ingest_bam(
    const char* path, int32_t n_chroms, const char* chrom_concat,
    const int64_t* chrom_off, const int64_t* chrom_ptr, const int64_t* snp_pos,
    const int32_t* snp_ids, const uint8_t* snp_ref, const uint8_t* snp_alt,
    const char* tag_group, const char* tag_umi, int32_t cap_bq, int32_t min_bq,
    int32_t min_td, int32_t min_mq, int32_t excl_flag, const char* grp_concat,
    const int64_t* grp_off, int64_t n_group, int32_t n_threads,
    int32_t n_shards, int32_t shard_id, int64_t sam_verbose,
    int64_t n_regions, const int32_t* reg_chrom, const int64_t* reg_beg0,
    const int64_t* reg_end0) {
  DmxHandle* h = new DmxHandle();
  try {
    SnpPanel panel;
    for (int i = 0; i < n_chroms; ++i)
      panel.chrom_index.emplace(
          std::string(chrom_concat + chrom_off[i],
                      (size_t)(chrom_off[i + 1] - chrom_off[i])),
          i);
    panel.chrom_ptr = chrom_ptr;
    panel.snp_pos = snp_pos;
    panel.snp_ids = snp_ids;
    panel.snp_ref = snp_ref;
    panel.snp_alt = snp_alt;

    Params prm;
    prm.cap_bq = cap_bq;
    prm.min_bq = min_bq;
    prm.min_td = min_td;
    prm.min_mq = min_mq;
    prm.excl_flag = excl_flag;
    prm.has_group_tag = tag_group && tag_group[0];
    prm.has_umi_tag = tag_umi && tag_umi[0];
    if (prm.has_group_tag) memcpy(prm.tg, tag_group, 2);
    if (prm.has_umi_tag) memcpy(prm.tu, tag_umi, 2);
    prm.n_shards = n_shards < 1 ? 1 : n_shards;
    prm.shard_id = shard_id;
    prm.sam_verbose = sam_verbose;
    for (int64_t i = 0; i < n_regions; ++i)
      prm.regions.push_back(std::array<int64_t, 3>{
          (int64_t)reg_chrom[i], reg_beg0[i], reg_end0[i]});
    if (grp_concat && n_group > 0) {
      prm.use_group_set = true;
      for (int64_t i = 0; i < n_group; ++i)
        prm.group_set.emplace(std::string(
            grp_concat + grp_off[i], (size_t)(grp_off[i + 1] - grp_off[i])));
    }
    {
      // dispatch by magic: CRAM files go through the native CRAM reader
      FileBuf probe(path);
      const bool is_cram =
          probe.size >= 4 && memcmp(probe.data, "CRAM", 4) == 0;
      if (is_cram)
        h->res = run_ingest_cram(path, panel, prm);
      else
        h->res = run_ingest(path, panel, prm, n_threads < 1 ? 1 : n_threads);
    }
  } catch (const IngestError& e) {
    h->err = e.msg;
  } catch (const std::exception& e) {
    h->err = e.what();
  }
  return h;
}

const char* dmx_error(DmxHandle* h) {
  return h->err.empty() ? nullptr : h->err.c_str();
}

int64_t dmx_n_cells(DmxHandle* h) { return (int64_t)h->res.barcodes.size(); }
int64_t dmx_n_obs(DmxHandle* h) { return (int64_t)h->res.obs.size(); }

const char* dmx_barcode(DmxHandle* h, int64_t i) {
  return h->res.barcodes[(size_t)i].c_str();
}

void dmx_get_cell_counters(DmxHandle* h, int64_t* totl, int64_t* pass,
                           int64_t* uniq) {
  const size_t n = h->res.barcodes.size();
  memcpy(totl, h->res.cell_totl.data(), n * 8);
  memcpy(pass, h->res.cell_pass.data(), n * 8);
  memcpy(uniq, h->res.cell_uniq.data(), n * 8);
}

void dmx_get_obs(DmxHandle* h, int32_t* cell, int32_t* snp, uint8_t* allele,
                 uint8_t* bq) {
  const size_t n = h->res.obs.size();
  for (size_t i = 0; i < n; ++i) {
    cell[i] = h->res.obs[i].cell;
    snp[i] = h->res.obs[i].snp;
    allele[i] = h->res.obs[i].allele;
    bq[i] = h->res.obs[i].bq;
  }
}

void dmx_get_counters(DmxHandle* h, int64_t* out11) {
  const Counters& c = h->res.ctr;
  out11[0] = c.n_read;
  out11[1] = c.n_skip;
  out11[2] = c.n_skip_bcd;
  out11[3] = c.n_tmp;
  out11[4] = c.n_multi_snps;
  out11[5] = c.n_pass;
  out11[6] = c.n_redundant;
  out11[7] = c.n_lq;
  out11[8] = c.n_n;
  out11[9] = c.n_no_gtag;
  out11[10] = c.n_no_utag;
}

void dmx_free(DmxHandle* h) { delete h; }
}
