// Zstandard decoder (RFC 8878) and CRC32C, for the orbax checkpoint reader
// (utils/ocdbt.py, utils/zarr2.py): OCDBT manifests and B-tree nodes and
// the zarr chunks of a JAX checkpoint are zstd frames, and the checksums
// of the OCDBT nodes are CRC32C.  Written from the RFC's text; exposed via
// ctypes (native/codec.py).
//
// Covered: frames of every header flag combination (a dictionary ID other
// than 0 is refused: no dictionary is ever given), the optional XXH64
// content checksum (verified), skippable frames, frames back to back; raw,
// RLE and compressed blocks; literals raw, RLE, Huffman with 1 or 4
// streams and treeless, Huffman weights direct or FSE-compressed;
// sequences with predefined, RLE, FSE and repeated tables and the repeat
// offsets.  Malformed input and a too small output buffer return an error
// with the input's byte offset; nothing is written past `dst_cap`.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// What the decoder has met since the last `zstd_census` call, for tests
// that show a corpus covers every part of the format (one relaxed add per
// frame, block, section or table, none per symbol).
enum Feature {
  F_FRAME, F_SINGLE_SEGMENT, F_FCS0, F_FCS1, F_FCS2, F_FCS4, F_FCS8, F_DICT_ID_ZERO, F_CHECKSUM, F_SKIPPABLE,
  F_BLOCK_RAW, F_BLOCK_RLE, F_BLOCK_COMPRESSED, F_LIT_RAW, F_LIT_RLE, F_LIT_HUF1, F_LIT_HUF4, F_LIT_TREELESS,
  F_HUF_DIRECT, F_HUF_FSE, F_SEQ_NONE, F_TABLE_PREDEFINED, F_TABLE_RLE, F_TABLE_FSE, F_TABLE_REPEAT,
  F_REP_OFFSET, F_REP_SHIFTED, F_COUNT
};
std::atomic<int64_t> CENSUS[F_COUNT];
inline void seen(Feature f) { CENSUS[f].fetch_add(1, std::memory_order_relaxed); }

struct ZError {
  int64_t offset;
  std::string what;
};

[[noreturn]] void fail(int64_t offset, const std::string& what) { throw ZError{offset, what}; }

inline uint32_t read_le(const uint8_t* p, int n) {
  uint32_t v = 0;
  for (int i = 0; i < n; ++i) v |= (uint32_t)p[i] << (8 * i);
  return v;
}

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

// ---- XXH64 (the content checksum) -------------------------------------------

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL, P3 = 1609587929392839161ULL,
                   P4 = 9650029242287828579ULL, P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xxh_round(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xxh_merge(uint64_t acc, uint64_t v) { return (acc ^ xxh_round(0, v)) * P1 + P4; }
inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}

uint64_t xxh64(const uint8_t* p, size_t len) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xxh_round(v1, load64(p));
      v2 = xxh_round(v2, load64(p + 8));
      v3 = xxh_round(v3, load64(p + 16));
      v4 = xxh_round(v4, load64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxh_merge(xxh_merge(xxh_merge(xxh_merge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += (uint64_t)len;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xxh_round(0, load64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ ((uint64_t)read_le(p, 4) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---- bit streams -------------------------------------------------------------

// A backward bit stream (RFC 8878 4.1): read from the last byte towards the
// first; the last byte's highest set bit marks its start.  `pos` is the
// number of bits not yet read; bits below 0 read as zeros and drive `pos`
// negative, which the callers check.
struct BackStream {
  const uint8_t* p;
  int64_t size;   // bytes
  int64_t pos;    // bits left
  int64_t where;  // input offset of the stream, for errors

  BackStream(const uint8_t* p_, int64_t size_, int64_t where_) : p(p_), size(size_), where(where_) {
    if (size <= 0) fail(where, "empty bit stream");
    uint8_t last = p[size - 1];
    if (last == 0) fail(where + size - 1, "bit stream's last byte is zero (no start marker)");
    pos = size * 8 - 8 + highbit(last);
  }

  // bits [at, at + n) as an integer (bit at + n - 1 the highest); n <= 56
  inline uint64_t bits_at(int64_t at, int n) const {
    if (n == 0) return 0;
    uint64_t mask = (n == 64) ? ~0ULL : ((1ULL << n) - 1);
    if (at >= 0 && (at >> 3) + 8 <= size) return (load64(p + (at >> 3)) >> (at & 7)) & mask;
    uint64_t v = 0;
    for (int i = 0; i < n; ++i) {
      int64_t b = at + i;
      if (b >= 0 && (b >> 3) < size) v |= (uint64_t)((p[b >> 3] >> (b & 7)) & 1) << i;
    }
    return v;
  }
  inline uint64_t read(int n) {
    pos -= n;
    return bits_at(pos, n);
  }
  inline uint64_t peek(int n) const { return bits_at(pos - n, n); }
};

// A forward little-endian bit reader over [p, p + size): used for the FSE
// table descriptions.
struct FwdBits {
  const uint8_t* p;
  int64_t size;
  int64_t bit = 0;
  inline uint32_t peek(int n) const {
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) {
      int64_t b = bit + i;
      if ((b >> 3) < size) v |= (uint32_t)((p[b >> 3] >> (b & 7)) & 1) << i;
    }
    return v;
  }
  inline void skip(int n) { bit += n; }
};

// ---- FSE ---------------------------------------------------------------------

struct FseEntry {
  uint16_t symbol;
  uint8_t nbits;
  uint32_t baseline;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> t;
};

// Normalised counts -> decoding table (RFC 8878 4.1.1).
void fse_build(FseTable& table, const int16_t* norm, int nsym, int log, int64_t where) {
  int size = 1 << log;
  table.log = log;
  table.t.assign(size, FseEntry{0, 0, 0});
  std::vector<uint32_t> next(nsym);
  int high = size - 1;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      if (high < 0) fail(where, "FSE table: too many low-probability symbols");
      table.t[high--].symbol = (uint16_t)s;
      next[s] = 1;
    } else {
      next[s] = (uint32_t)norm[s];
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      table.t[pos].symbol = (uint16_t)s;
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  if (pos != 0) fail(where, "FSE table: probabilities do not fill the table");
  for (int u = 0; u < size; ++u) {
    uint16_t s = table.t[u].symbol;
    uint32_t ns = next[s]++;
    int nb = log - highbit(ns);
    table.t[u].nbits = (uint8_t)nb;
    table.t[u].baseline = (ns << nb) - size;
  }
}

// An FSE table description at p[0, size) -> table; returns bytes used.
int64_t fse_read(FseTable& table, const uint8_t* p, int64_t size, int max_log, int max_sym, int64_t where) {
  if (size < 1) fail(where, "FSE table description truncated");
  FwdBits r{p, size};
  int log = (int)r.peek(4) + 5;
  r.skip(4);
  if (log > max_log) fail(where, "FSE accuracy log " + std::to_string(log) + " above " + std::to_string(max_log));
  int16_t norm[256];
  int remaining = (1 << log) + 1, threshold = 1 << log, nb = log + 1, sym = 0;
  bool prev0 = false;
  while (remaining > 1) {
    if (prev0) {
      int n0 = sym;
      for (;;) {
        int rep = (int)r.peek(2);
        r.skip(2);
        n0 += rep;
        if (rep != 3) break;
      }
      if (n0 > max_sym + 1) fail(where, "FSE table description: too many symbols");
      while (sym < n0) norm[sym++] = 0;
    }
    if (sym > max_sym) fail(where, "FSE table description: too many symbols");
    int max = 2 * threshold - 1 - remaining;
    int count;
    uint32_t v = r.peek(nb);
    if ((int)(v & (threshold - 1)) < max) {
      count = (int)(v & (threshold - 1));
      r.skip(nb - 1);
    } else {
      count = (int)(v & (2 * threshold - 1));
      if (count >= threshold) count -= max;
      r.skip(nb);
    }
    --count;
    remaining -= count < 0 ? -count : count;
    norm[sym++] = (int16_t)count;
    prev0 = count == 0;
    while (remaining < threshold && nb > 1) {
      --nb;
      threshold >>= 1;
    }
    if ((r.bit >> 3) > size) fail(where, "FSE table description truncated");
  }
  if (remaining != 1) fail(where, "FSE table description: probabilities do not sum to the table size");
  int64_t used = (r.bit + 7) >> 3;
  if (used > size) fail(where, "FSE table description truncated");
  fse_build(table, norm, sym, log, where);
  return used;
}

void fse_rle(FseTable& table, int symbol) {
  table.log = 0;
  table.t.assign(1, FseEntry{(uint16_t)symbol, 0, 0});
}

// ---- Huffman -------------------------------------------------------------------

struct HufEntry {
  uint8_t symbol;
  uint8_t nbits;
};

struct HufTable {
  int max_bits = 0;
  std::vector<HufEntry> t;
};

// A Huffman tree description at p[0, size) -> table; returns bytes used.
int64_t huf_read(HufTable& table, const uint8_t* p, int64_t size, int64_t where) {
  if (size < 1) fail(where, "Huffman tree description truncated");
  uint8_t weights[256] = {0};
  int n = 0;
  int64_t used;
  int h = p[0];
  if (h >= 128) {  // direct: 4 bits per weight
    seen(F_HUF_DIRECT);
    n = h - 127;
    used = 1 + (n + 1) / 2;
    if (used > size) fail(where, "Huffman weights truncated");
    for (int i = 0; i < n; ++i) weights[i] = (i & 1) ? (p[1 + i / 2] & 15) : (p[1 + i / 2] >> 4);
  } else {  // FSE-compressed weights, two interleaved states
    seen(F_HUF_FSE);
    used = 1 + h;
    if (used > size || h == 0) fail(where, "Huffman weights truncated");
    FseTable ft;
    int64_t desc = fse_read(ft, p + 1, h, 6, 15, where + 1);
    if (desc >= h) fail(where + 1, "Huffman weights: no bit stream after the FSE table");
    BackStream bs(p + 1 + desc, h - desc, where + 1 + desc);
    uint32_t s1 = (uint32_t)bs.read(ft.log), s2 = (uint32_t)bs.read(ft.log);
    for (;;) {
      if (n > 254) fail(where, "Huffman weights: more than 255");
      const FseEntry& e1 = ft.t[s1];
      weights[n++] = (uint8_t)e1.symbol;
      s1 = e1.baseline + (uint32_t)bs.read(e1.nbits);
      if (bs.pos < 0) {
        weights[n++] = (uint8_t)ft.t[s2].symbol;
        break;
      }
      if (n > 254) fail(where, "Huffman weights: more than 255");
      const FseEntry& e2 = ft.t[s2];
      weights[n++] = (uint8_t)e2.symbol;
      s2 = e2.baseline + (uint32_t)bs.read(e2.nbits);
      if (bs.pos < 0) {
        weights[n++] = (uint8_t)ft.t[s1].symbol;
        break;
      }
    }
  }
  if (n > 255) fail(where, "Huffman weights: more than 255");
  uint32_t total = 0;
  for (int i = 0; i < n; ++i) {
    if (weights[i] > 11) fail(where, "Huffman weight above 11");
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  if (total == 0) fail(where, "Huffman weights all zero");
  int max_bits = highbit(total) + 1;
  if (max_bits > 11) fail(where, "Huffman code longer than 11 bits");
  uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) fail(where, "Huffman weights do not complete a tree");
  weights[n++] = (uint8_t)(highbit(rest) + 1);
  // codes: lowest weight (longest code) first, by symbol within a weight
  uint32_t start[13] = {0};
  uint32_t count[13] = {0};
  for (int i = 0; i < n; ++i) count[weights[i]]++;
  uint32_t next = 0;
  for (int w = 1; w <= max_bits; ++w) {
    start[w] = next;
    next += count[w] << (w - 1);
  }
  if (next != (1u << max_bits)) fail(where, "Huffman weights do not complete a tree");
  table.max_bits = max_bits;
  table.t.assign(1u << max_bits, HufEntry{0, 0});
  for (int s = 0; s < n; ++s) {
    int w = weights[s];
    if (!w) continue;
    uint32_t len = 1u << (w - 1);
    for (uint32_t u = start[w]; u < start[w] + len; ++u) table.t[u] = HufEntry{(uint8_t)s, (uint8_t)(max_bits + 1 - w)};
    start[w] += len;
  }
  return used;
}

// Five symbols (at most 55 bits) from one 64-bit load of the 56 bits
// below `pos`, which lies inside the stream while pos >= 56.
inline void huf5(const HufEntry* t, int mb, BackStream& bs, uint8_t* out) {
  int64_t at = bs.pos - 56;
  uint64_t w = load64(bs.p + (at >> 3)) >> (at & 7);
  const uint64_t mask = (1ULL << mb) - 1;
  int top = 56;
  for (int k = 0; k < 5; ++k) {
    const HufEntry& e = t[(w >> (top - mb)) & mask];
    out[k] = e.symbol;
    top -= e.nbits;
  }
  bs.pos = at + top;
}

// Symbols [i, n) of one stream, then the check that it was consumed exactly.
void huf_rest(const HufTable& table, BackStream& bs, uint8_t* out, int64_t i, int64_t n) {
  const int mb = table.max_bits;
  const HufEntry* t = table.t.data();
  for (; i + 5 <= n && bs.pos >= 56; i += 5) huf5(t, mb, bs, out + i);
  for (; i < n; ++i) {
    const HufEntry& e = t[bs.peek(mb)];
    out[i] = e.symbol;
    bs.pos -= e.nbits;
  }
  if (bs.pos != 0) fail(bs.where, "Huffman stream not consumed exactly (" + std::to_string(bs.pos) + " bits left)");
}

void huf_stream(const HufTable& table, const uint8_t* p, int64_t size, uint8_t* out, int64_t n, int64_t where) {
  BackStream bs(p, size, where);
  huf_rest(table, bs, out, 0, n);
}

// Four streams in lockstep (their loads and lookups overlap), each then
// finished alone.
void huf_streams4(const HufTable& table, BackStream* bs, uint8_t* const* out, const int64_t* n) {
  const int mb = table.max_bits;
  const HufEntry* t = table.t.data();
  int64_t i = 0;
  int64_t common = std::min(std::min(n[0], n[1]), std::min(n[2], n[3]));
  for (; i + 5 <= common && bs[0].pos >= 56 && bs[1].pos >= 56 && bs[2].pos >= 56 && bs[3].pos >= 56; i += 5) {
    huf5(t, mb, bs[0], out[0] + i);
    huf5(t, mb, bs[1], out[1] + i);
    huf5(t, mb, bs[2], out[2] + i);
    huf5(t, mb, bs[3], out[3] + i);
  }
  for (int k = 0; k < 4; ++k) huf_rest(table, bs[k], out[k], i, n[k]);
}

// ---- sequences' code tables (RFC 8878 3.1.1.3.2.1) ---------------------------

const uint32_t LL_BASE[36] = {0,  1,  2,  3,  4,  5,  6,  7,  8,   9,   10,  11,   12,   13,   14,   15,   16,    18,
                              20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,  15,  16,   17,   18,   19,   20,
                              21, 22, 23, 24, 25, 26, 27, 28, 29, 30,  31,  32,  33,  34,   35,   37,   39,   41,
                              43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

constexpr int64_t BLOCK_MAX = 128 * 1024;

// The state of one frame's decoding that blocks carry over.
struct Frame {
  HufTable huf;
  bool have_huf = false;
  FseTable ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint32_t rep[3] = {1, 4, 8};
  int64_t window = 0;  // matches reach back at most this far
  std::vector<uint8_t> lit;
  Frame() : lit(BLOCK_MAX + 32) {}
};

// Literals section at p[0, size) -> f.lit[0, *nlit); returns bytes used.
int64_t literals(Frame& f, const uint8_t* p, int64_t size, int64_t where, int64_t* nlit) {
  if (size < 1) fail(where, "literals section truncated");
  int type = p[0] & 3, fmt = (p[0] >> 2) & 3;
  if (type <= 1) {  // raw or RLE
    int hdr = (fmt == 0 || fmt == 2) ? 1 : fmt == 1 ? 2 : 3;
    if (size < hdr) fail(where, "literals header truncated");
    int64_t n = hdr == 1 ? p[0] >> 3 : hdr == 2 ? (p[0] >> 4) + ((int64_t)p[1] << 4)
                                                : (p[0] >> 4) + ((int64_t)p[1] << 4) + ((int64_t)p[2] << 12);
    if (n > BLOCK_MAX) fail(where, "literals larger than a block");
    *nlit = n;
    seen(type == 0 ? F_LIT_RAW : F_LIT_RLE);
    if (type == 0) {
      if (hdr + n > size) fail(where, "raw literals truncated");
      memcpy(f.lit.data(), p + hdr, n);
      return hdr + n;
    }
    if (hdr + 1 > size) fail(where, "RLE literals truncated");
    memset(f.lit.data(), p[hdr], n);
    return hdr + 1;
  }
  // compressed (2) or treeless (3)
  int hdr = fmt <= 1 ? 3 : fmt == 2 ? 4 : 5;
  if (size < hdr) fail(where, "literals header truncated");
  uint64_t v = 0;
  for (int i = 0; i < hdr; ++i) v |= (uint64_t)p[i] << (8 * i);
  int bits = hdr == 3 ? 10 : hdr == 4 ? 14 : 18;
  int64_t regen = (int64_t)((v >> 4) & ((1u << bits) - 1));
  int64_t comp = (int64_t)((v >> (4 + bits)) & ((1u << bits) - 1));
  int streams = fmt == 0 ? 1 : 4;
  if (regen > BLOCK_MAX) fail(where, "literals larger than a block");
  if (hdr + comp > size) fail(where, "compressed literals truncated");
  const uint8_t* q = p + hdr;
  int64_t qw = where + hdr, left = comp;
  if (type == 2) {
    int64_t used = huf_read(f.huf, q, left, qw);
    f.have_huf = true;
    q += used;
    qw += used;
    left -= used;
  } else if (!f.have_huf) {
    fail(where, "treeless literals with no earlier Huffman table in the frame");
  } else {
    seen(F_LIT_TREELESS);
  }
  seen(streams == 1 ? F_LIT_HUF1 : F_LIT_HUF4);
  *nlit = regen;
  if (streams == 1) {
    huf_stream(f.huf, q, left, f.lit.data(), regen, qw);
  } else {
    if (left < 6) fail(qw, "literals jump table truncated");
    int64_t s1 = read_le(q, 2), s2 = read_le(q + 2, 2), s3 = read_le(q + 4, 2);
    int64_t s4 = left - 6 - s1 - s2 - s3;
    if (s4 < 1) fail(qw, "literals jump table points past the section");
    int64_t per = (regen + 3) / 4, last = regen - 3 * per;
    if (last < 0) fail(qw, "literals too short for 4 streams");
    const uint8_t* base = q + 6;
    int64_t bw = qw + 6;
    BackStream bs[4] = {BackStream(base, s1, bw), BackStream(base + s1, s2, bw + s1),
                        BackStream(base + s1 + s2, s3, bw + s1 + s2),
                        BackStream(base + s1 + s2 + s3, s4, bw + s1 + s2 + s3)};
    uint8_t* outs[4] = {f.lit.data(), f.lit.data() + per, f.lit.data() + 2 * per, f.lit.data() + 3 * per};
    int64_t ns[4] = {per, per, per, last};
    huf_streams4(f.huf, bs, outs, ns);
  }
  return hdr + comp;
}

// One table of the sequences section: mode 0 predefined, 1 RLE, 2 FSE, 3 repeat.
int64_t seq_table(FseTable& table, bool& have, int mode, const uint8_t* p, int64_t size, int64_t where,
                  const int16_t* def, int ndef, int def_log, int max_log, int max_sym, const char* name) {
  seen((Feature)(F_TABLE_PREDEFINED + mode));
  if (mode == 0) {
    fse_build(table, def, ndef, def_log, where);
    have = true;
    return 0;
  }
  if (mode == 1) {
    if (size < 1) fail(where, std::string(name) + " RLE table truncated");
    if (p[0] > max_sym) fail(where, std::string(name) + " RLE symbol out of range");
    fse_rle(table, p[0]);
    have = true;
    return 1;
  }
  if (mode == 2) {
    int64_t used = fse_read(table, p, size, max_log, max_sym, where);
    have = true;
    return used;
  }
  if (!have) fail(where, std::string(name) + " table repeated with none before it in the frame");
  return 0;
}

// Copy `len` bytes from op - off to op (they may overlap).
inline void match_copy(uint8_t* op, uint32_t off, uint32_t len, const uint8_t* end) {
  const uint8_t* src = op - off;
  if (off >= 8 && op + len + 8 <= end) {
    for (uint32_t i = 0; i < len; i += 8) memcpy(op + i, src + i, 8);
  } else {
    for (uint32_t i = 0; i < len; ++i) op[i] = src[i];
  }
}

// A compressed block at p[0, size) -> dst[*op, ...); fstart: the frame's
// first output byte.
void compressed_block(Frame& f, const uint8_t* p, int64_t size, int64_t where, uint8_t* dst, int64_t cap,
                      int64_t fstart, int64_t* op) {
  int64_t nlit = 0;
  int64_t used = literals(f, p, size, where, &nlit);
  p += used;
  where += used;
  size -= used;
  if (size < 1) fail(where, "sequences section truncated");
  int64_t nseq = p[0], hdr = 1;
  if (nseq >= 128) {
    if (nseq < 255) {
      if (size < 2) fail(where, "sequences header truncated");
      nseq = ((nseq - 128) << 8) + p[1];
      hdr = 2;
    } else {
      if (size < 3) fail(where, "sequences header truncated");
      nseq = p[1] + ((int64_t)p[2] << 8) + 0x7F00;
      hdr = 3;
    }
  }
  const uint8_t* lit = f.lit.data();
  int64_t out = *op, block_start = out;
  if (nseq == 0) {
    seen(F_SEQ_NONE);
    if (hdr != size) fail(where, "bytes after an empty sequences section");
    if (out + nlit > cap) fail(where, "output larger than dst_capacity");
    memcpy(dst + out, lit, nlit);
    *op = out + nlit;
    return;
  }
  if (size < hdr + 1) fail(where, "sequences header truncated");
  int modes = p[hdr];
  if (modes & 3) fail(where + hdr, "reserved bits of the sequences' modes set");
  int64_t q = hdr + 1;
  q += seq_table(f.ll, f.have_ll, modes >> 6, p + q, size - q, where + q, LL_DEFAULT, 36, 6, 9, 35, "literal lengths");
  q += seq_table(f.of, f.have_of, (modes >> 4) & 3, p + q, size - q, where + q, OF_DEFAULT, 29, 5, 8, 31, "offsets");
  q += seq_table(f.ml, f.have_ml, (modes >> 2) & 3, p + q, size - q, where + q, ML_DEFAULT, 53, 6, 9, 52,
                 "match lengths");
  if (q >= size) fail(where + q, "sequences bit stream missing");
  BackStream bs(p + q, size - q, where + q);
  const FseEntry* llt = f.ll.t.data();
  const FseEntry* oft = f.of.t.data();
  const FseEntry* mlt = f.ml.t.data();
  uint32_t sll = (uint32_t)bs.read(f.ll.log), sof = (uint32_t)bs.read(f.of.log), sml = (uint32_t)bs.read(f.ml.log);
  int64_t lp = 0;
  uint32_t* rep = f.rep;
  const uint8_t* end = dst + cap;
  for (int64_t i = 0; i < nseq; ++i) {
    uint32_t llc = llt[sll].symbol, ofc = oft[sof].symbol, mlc = mlt[sml].symbol;
    if (llc > 35 || mlc > 52 || ofc > 31) fail(where + q, "sequence code out of range");
    uint32_t ofv = (1u << ofc) + (uint32_t)bs.read(ofc);
    uint32_t ml = ML_BASE[mlc] + (uint32_t)bs.read(ML_BITS[mlc]);
    uint32_t ll = LL_BASE[llc] + (uint32_t)bs.read(LL_BITS[llc]);
    uint32_t off;
    if (ofv > 3) {
      off = ofv - 3;
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = off;
    } else {
      uint32_t r = ofv + (ll == 0 ? 1 : 0);
      seen(ll == 0 ? F_REP_SHIFTED : F_REP_OFFSET);
      if (r == 1) {
        off = rep[0];
      } else {
        off = r == 2 ? rep[1] : r == 3 ? rep[2] : rep[0] - 1;
        if (r != 2) rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = off;
      }
    }
    if (i + 1 < nseq) {
      sll = llt[sll].baseline + (uint32_t)bs.read(llt[sll].nbits);
      sml = mlt[sml].baseline + (uint32_t)bs.read(mlt[sml].nbits);
      sof = oft[sof].baseline + (uint32_t)bs.read(oft[sof].nbits);
    }
    if (bs.pos < 0) fail(where + q, "sequences bit stream overrun");
    if (lp + ll > nlit) fail(where + q, "sequence takes more literals than the block has");
    if (out + (int64_t)ll + ml > cap) fail(where + q, "output larger than dst_capacity");
    if (off == 0 || off > out + ll - fstart) fail(where + q, "match offset before the frame's start");
    if (off > f.window) fail(where + q, "match offset beyond the window");
    memcpy(dst + out, lit + lp, ll);
    lp += ll;
    out += ll;
    match_copy(dst + out, off, ml, end);
    out += ml;
  }
  if (bs.pos != 0) fail(where + q, "sequences bit stream not consumed exactly");
  int64_t rest = nlit - lp;
  if (out + rest > cap) fail(where + q, "output larger than dst_capacity");
  memcpy(dst + out, lit + lp, rest);
  out += rest;
  if (out - block_start > BLOCK_MAX) fail(where, "block decodes to more than 128 KiB");
  *op = out;
}

// One zstd frame at src[*ip, n) -> dst[*op, cap).
void frame(const uint8_t* src, int64_t n, int64_t* ip, uint8_t* dst, int64_t cap, int64_t* op) {
  int64_t i = *ip, fstart = *op, out = *op;
  int64_t start = i;
  if (n - i < 5) fail(i, "frame header truncated");
  i += 4;
  int fhd = src[i++];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1, did_flag = fhd & 3;
  if (fhd & 8) fail(i - 1, "reserved bit of the frame header set");
  seen(F_FRAME);
  if (single) seen(F_SINGLE_SEGMENT);
  if (checksum) seen(F_CHECKSUM);
  int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : fcs_flag == 1 ? 2 : fcs_flag == 2 ? 4 : 8;
  int did_size = did_flag == 0 ? 0 : did_flag == 1 ? 1 : did_flag == 2 ? 2 : 4;
  int64_t need = (single ? 0 : 1) + did_size + fcs_size;
  if (n - i < need) fail(i, "frame header truncated");
  int64_t window = -1;  // single segment: the content size
  if (!single) {
    int wd = src[i++];
    if ((wd >> 3) > 31 - 10) fail(i - 1, "window larger than 2 GiB");
    int64_t base = (int64_t)1 << (10 + (wd >> 3));
    window = base + (base >> 3) * (wd & 7);
  }
  if (did_size) {
    uint32_t did = read_le(src + i, did_size);
    if (did != 0) fail(i, "frame needs dictionary " + std::to_string(did) + "; none is available");
    seen(F_DICT_ID_ZERO);
    i += did_size;
  }
  int64_t content = -1;
  if (fcs_size) {
    uint64_t v = 0;
    for (int k = 0; k < fcs_size; ++k) v |= (uint64_t)src[i + k] << (8 * k);
    if (fcs_size == 2) v += 256;
    if (v > (uint64_t)INT64_MAX) fail(i, "frame content size out of range");
    content = (int64_t)v;
    i += fcs_size;
  }
  if (single) window = content;
  seen(fcs_size == 0 ? F_FCS0 : fcs_size == 1 ? F_FCS1 : fcs_size == 2 ? F_FCS2 : fcs_size == 4 ? F_FCS4 : F_FCS8);
  if (content >= 0 && out + content > cap) fail(start, "frame content size " + std::to_string(content) + " exceeds dst_capacity");
  Frame f;
  f.window = window;
  for (;;) {
    if (n - i < 3) fail(i, "block header truncated");
    uint32_t bh = read_le(src + i, 3);
    int last = bh & 1, type = (bh >> 1) & 3;
    int64_t size = bh >> 3;
    i += 3;
    if (type < 3) seen((Feature)(F_BLOCK_RAW + type));
    if (type == 0) {
      if (n - i < size) fail(i, "raw block truncated");
      if (size > BLOCK_MAX) fail(i - 3, "block larger than 128 KiB");
      if (out + size > cap) fail(i, "output larger than dst_capacity");
      memcpy(dst + out, src + i, size);
      out += size;
      i += size;
    } else if (type == 1) {
      if (n - i < 1) fail(i, "RLE block truncated");
      if (size > BLOCK_MAX) fail(i - 3, "block larger than 128 KiB");
      if (out + size > cap) fail(i, "output larger than dst_capacity");
      memset(dst + out, src[i], size);
      out += size;
      i += 1;
    } else if (type == 2) {
      if (n - i < size) fail(i, "compressed block truncated");
      if (size > BLOCK_MAX) fail(i - 3, "block larger than 128 KiB");
      compressed_block(f, src + i, size, i, dst, cap, fstart, &out);
      i += size;
    } else {
      fail(i - 3, "reserved block type");
    }
    if (last) break;
  }
  if (content >= 0 && out - fstart != content)
    fail(start, "frame decodes to " + std::to_string(out - fstart) + " bytes, its header says " + std::to_string(content));
  if (checksum) {
    if (n - i < 4) fail(i, "content checksum truncated");
    uint32_t want = read_le(src + i, 4);
    uint32_t got = (uint32_t)xxh64(dst + fstart, (size_t)(out - fstart));
    if (want != got) fail(i, "content checksum mismatch");
    i += 4;
  }
  *ip = i;
  *op = out;
}

int64_t decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  int64_t i = 0, out = 0;
  if (n == 0) fail(0, "no frame");
  while (i < n) {
    if (n - i < 4) fail(i, "trailing bytes after the last frame");
    uint32_t magic = read_le(src + i, 4);
    if (magic == 0xFD2FB528u) {
      frame(src, n, &i, dst, cap, &out);
    } else if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (n - i < 8) fail(i, "skippable frame header truncated");
      int64_t size = read_le(src + i + 4, 4);
      if (n - i - 8 < size) fail(i, "skippable frame truncated");
      seen(F_SKIPPABLE);
      i += 8 + size;
    } else {
      fail(i, "not a zstd frame (magic " + std::to_string(magic) + ")");
    }
  }
  return out;
}

uint32_t CRC_TABLE[8][256];
bool crc_ready = false;

void crc_init() {
  for (uint32_t b = 0; b < 256; ++b) {
    uint32_t c = b;
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
    CRC_TABLE[0][b] = c;
  }
  for (int t = 1; t < 8; ++t)
    for (uint32_t b = 0; b < 256; ++b) CRC_TABLE[t][b] = (CRC_TABLE[t - 1][b] >> 8) ^ CRC_TABLE[0][CRC_TABLE[t - 1][b] & 255];
  crc_ready = true;
}

}  // namespace

extern "C" {

// Decode the zstd frames in src[0, n) into dst[0, cap).  Returns the bytes
// written, or -1 with "<offset>: <message>" in err[0, err_len).
int64_t zstd_decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap, char* err, int err_len) {
  try {
    return decompress(src, n, dst, cap);
  } catch (const ZError& e) {
    snprintf(err, err_len, "%lld: %s", (long long)e.offset, e.what.c_str());
  } catch (const std::exception& e) {
    snprintf(err, err_len, "0: %s", e.what());
  }
  return -1;
}

// Copy the census into out[0, min(n, F_COUNT)) and reset it; returns F_COUNT.
int zstd_census(int64_t* out, int n) {
  for (int k = 0; k < F_COUNT; ++k) {
    int64_t v = CENSUS[k].exchange(0, std::memory_order_relaxed);
    if (k < n) out[k] = v;
  }
  return F_COUNT;
}

// CRC32C (Castagnoli, reflected, init and final xor ~0).
uint32_t crc32c(const uint8_t* p, int64_t n) {
  if (!crc_ready) crc_init();  // idempotent: racing callers write the same table
  uint32_t c = ~0u;
  int64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    uint64_t v = load64(p + i) ^ c;
    c = CRC_TABLE[7][v & 255] ^ CRC_TABLE[6][(v >> 8) & 255] ^ CRC_TABLE[5][(v >> 16) & 255] ^
        CRC_TABLE[4][(v >> 24) & 255] ^ CRC_TABLE[3][(v >> 32) & 255] ^ CRC_TABLE[2][(v >> 40) & 255] ^
        CRC_TABLE[1][(v >> 48) & 255] ^ CRC_TABLE[0][v >> 56];
  }
  for (; i < n; ++i) c = (c >> 8) ^ CRC_TABLE[0][(c ^ p[i]) & 255];
  return ~c;
}

}  // extern "C"
