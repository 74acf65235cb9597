// A Zstandard decoder written from RFC 8878, with the two checksums the
// checkpoint reader needs (XXH64 for zstd frames, CRC-32C for OCDBT
// manifests and nodes).  C ABI, bound by checkpoint/zstd.py with ctypes.
//
// Covered: concatenated and skippable frames; the frame header (window
// descriptor, frame content size, single segment; a dictionary ID is
// refused); the content checksum (XXH64, low 32 bits); raw, RLE and
// compressed blocks; raw, RLE, Huffman-compressed and treeless literals in
// 1 or 4 streams, Huffman weights FSE-coded or direct; sequences with
// predefined, RLE, FSE-compressed and repeat tables, the three repeat
// offsets, tables carried between the blocks of a frame.
//
// Input is untrusted: every read and write is bounds-checked, and a
// corrupt or truncated input returns an error naming the input offset
// where it was found; nothing reads or writes outside the buffers.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <new>
#include <string>
#include <vector>

namespace {

struct DecodeError {
  std::string msg;
  size_t offset;
};

[[noreturn]] void fail(const char* msg, size_t offset) {
  throw DecodeError{msg, offset};
}

inline uint32_t rd16(const uint8_t* p) { return p[0] | (uint32_t(p[1]) << 8); }
inline uint32_t rd24(const uint8_t* p) { return rd16(p) | (uint32_t(p[2]) << 16); }
inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

inline int highest_bit(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

constexpr size_t kBlockMax = 128 * 1024;
constexpr int kHufMaxBits = 11;

// ---------------------------------------------------------------- XXH64
constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;
inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) {
  return rotl64(acc + in * P2, 31) * P1;
}
inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  return (acc ^ xround(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = xmerge(h, v1);
    h = xmerge(h, v2);
    h = xmerge(h, v3);
    h = xmerge(h, v4);
  } else {
    h = seed + P5;
  }
  h += n;
  while (p + 8 <= end) {
    h ^= xround(0, rd64(p));
    h = rotl64(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= uint64_t(rd32(p)) * P1;
    h = rotl64(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= uint64_t(*p++) * P5;
    h = rotl64(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// --------------------------------------------------------------- CRC-32C
struct Crc32cTable {
  uint32_t t[8][256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[0][i] = c;
    }
    for (int s = 1; s < 8; s++)
      for (uint32_t i = 0; i < 256; i++)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xff];
  }
};

uint32_t crc32c(const uint8_t* p, size_t n, uint32_t crc) {
  static const Crc32cTable tab;
  const auto& t = tab.t;
  crc = ~crc;
  while (n >= 8) {
    uint64_t v = rd64(p) ^ crc;
    crc = t[7][v & 0xff] ^ t[6][(v >> 8) & 0xff] ^ t[5][(v >> 16) & 0xff] ^
          t[4][(v >> 24) & 0xff] ^ t[3][(v >> 32) & 0xff] ^
          t[2][(v >> 40) & 0xff] ^ t[1][(v >> 48) & 0xff] ^ t[0][v >> 56];
    p += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ t[0][(crc ^ *p++) & 0xff];
  return ~crc;
}

// ---------------------------------------------------------------- output
// The caller's fixed buffer, or a malloc'd one that grows.
struct Out {
  uint8_t* p = nullptr;
  size_t cap = 0, len = 0;
  bool grow = false;

  void need(size_t extra, size_t at) {
    if (extra <= cap - len) return;
    if (!grow) fail("the output buffer is too small for the decoded data", at);
    size_t want = len + extra;
    if (want < len) fail("output size overflows", at);
    size_t nc = cap ? cap : 4096;
    while (nc < want) nc = nc > (SIZE_MAX / 2) ? want : nc * 2;
    uint8_t* q = static_cast<uint8_t*>(std::realloc(p, nc));
    if (!q) fail("out of memory for the decoded data", at);
    p = q;
    cap = nc;
  }
};

// ------------------------------------------------------ bit readers
// Forward reader (FSE table descriptions): little-endian bits from the
// start; bits past the end read as zeros and `pos()` says where it got.
struct FwdBits {
  const uint8_t* p;
  size_t n;       // bytes available
  size_t bit = 0;
  size_t base;    // input offset of p, for errors

  uint32_t read(int nb) {
    uint32_t v = 0;
    for (int i = 0; i < nb; i++, bit++) {
      size_t byte = bit >> 3;
      if (byte < n && ((p[byte] >> (bit & 7)) & 1)) v |= 1u << i;
    }
    return v;
  }
  void rewind(int nb) { bit -= nb; }
  size_t aligned_bytes() const { return (bit + 7) >> 3; }
};

// Backward reader (Huffman streams, FSE bitstreams): the stream ends with
// a 1 bit of padding in its last byte, and bits are read from there
// towards the start.  `off` is the number of unread bits; it may go below
// 0, where bits read as zeros (the decoders check where it ends).
struct BackBits {
  const uint8_t* p;
  size_t n;
  int64_t off;
  size_t base;

  BackBits(const uint8_t* src, size_t len, size_t at) : p(src), n(len), base(at) {
    if (len == 0) fail("empty bitstream", at);
    uint8_t last = src[len - 1];
    if (last == 0) fail("bitstream's last byte is 0 (no end mark)", at + len - 1);
    off = int64_t(len) * 8 - 8 + highest_bit(last);
  }

  inline uint64_t read(int nb) {
    if (nb == 0) return 0;
    off -= nb;
    if (off >= 0) {
      size_t byte = size_t(off) >> 3;
      int sh = int(off & 7);
      uint64_t v;
      if (byte + 8 <= n) {
        v = rd64(p + byte) >> sh;
      } else {
        v = 0;
        for (size_t i = byte; i < n; i++) v |= uint64_t(p[i]) << (8 * (i - byte));
        v >>= sh;
      }
      return v & ((uint64_t(1) << nb) - 1);
    }
    int have = nb + int(off);  // bits of the stream left, the rest zeros
    if (have <= 0) return 0;
    uint64_t v = 0;
    size_t bytes = (size_t(have) + 7) >> 3;
    for (size_t i = 0; i < bytes && i < n; i++) v |= uint64_t(p[i]) << (8 * i);
    v &= (uint64_t(1) << have) - 1;
    return v << (-off);
  }
};

// ------------------------------------------------------------------- FSE
struct FseTable {
  int log = -1;  // -1: no table
  std::vector<uint8_t> sym, nbits;
  std::vector<uint16_t> base;
};

void fse_build(FseTable& t, const int16_t* norm, int nsym, int log, size_t at) {
  size_t size = size_t(1) << log;
  t.log = log;
  t.sym.assign(size, 0);
  t.nbits.assign(size, 0);
  t.base.assign(size, 0);
  std::vector<uint16_t> next(nsym > 0 ? nsym : 1, 0);
  size_t high = size;
  for (int s = 0; s < nsym; s++) {
    if (norm[s] == -1) {
      if (high == 0) fail("FSE table: too many low-probability symbols", at);
      t.sym[--high] = uint8_t(s);
      next[s] = 1;
    }
  }
  size_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (int s = 0; s < nsym; s++) {
    if (norm[s] <= 0) continue;
    next[s] = uint16_t(norm[s]);
    for (int i = 0; i < norm[s]; i++) {
      t.sym[pos] = uint8_t(s);
      do {
        pos = (pos + step) & mask;
      } while (pos >= high);
    }
  }
  if (pos != 0) fail("FSE table: the distribution does not fill the table", at);
  for (size_t i = 0; i < size; i++) {
    uint16_t d = next[t.sym[i]]++;
    if (d == 0) fail("FSE table: a cell of a symbol with no probability", at);
    int nb = log - highest_bit(d);
    if (nb < 0 || nb > log) fail("FSE table: bad state", at);
    t.nbits[i] = uint8_t(nb);
    t.base[i] = uint16_t((uint32_t(d) << nb) - size);
  }
}

void fse_rle(FseTable& t, uint8_t s) {
  t.log = 0;
  t.sym.assign(1, s);
  t.nbits.assign(1, 0);
  t.base.assign(1, 0);
}

// Reads an FSE table description; returns the bytes it took.
size_t fse_read_header(FseTable& t, const uint8_t* p, size_t n, size_t at,
                       int max_log, int max_symbol) {
  if (n == 0) fail("truncated FSE table description", at);
  FwdBits br{p, n, 0, at};
  int log = int(br.read(4)) + 5;
  if (log > max_log) fail("FSE accuracy log too large", at);
  int32_t remaining = 1 << log;
  int16_t freq[256];
  int symb = 0;
  while (remaining > 0 && symb < 256) {
    int bits = highest_bit(uint32_t(remaining + 1)) + 1;
    uint32_t val = br.read(bits);
    uint32_t lower_mask = (1u << (bits - 1)) - 1;
    uint32_t threshold = (1u << bits) - 1 - uint32_t(remaining + 1);
    if ((val & lower_mask) < threshold) {
      br.rewind(1);
      val &= lower_mask;
    } else if (val > lower_mask) {
      val -= threshold;
    }
    int proba = int(val) - 1;
    remaining -= proba < 0 ? -proba : proba;
    freq[symb++] = int16_t(proba);
    if (proba == 0) {
      uint32_t repeat = br.read(2);
      while (true) {
        for (uint32_t i = 0; i < repeat && symb < 256; i++) freq[symb++] = 0;
        if (repeat == 3) {
          if (br.aligned_bytes() > n) break;
          repeat = br.read(2);
        } else {
          break;
        }
      }
    }
    if (br.aligned_bytes() > n) fail("truncated FSE table description", at + n);
  }
  size_t used = br.aligned_bytes();
  if (used > n) fail("truncated FSE table description", at + n);
  if (remaining != 0) fail("FSE table description: probabilities do not sum to the table size", at);
  if (symb - 1 > max_symbol) fail("FSE table description: symbol out of range", at);
  fse_build(t, freq, symb, log, at);
  return used;
}

// --------------------------------------------------------------- Huffman
struct HufTable {
  int max_bits = 0;  // 0: no table
  std::vector<uint8_t> sym, nbits;
};

// The weights of a Huffman tree description -> the decoding table.
void huf_build(HufTable& t, const uint8_t* w, int nw, size_t at) {
  uint32_t total = 0;
  for (int i = 0; i < nw; i++) {
    if (w[i] > kHufMaxBits) fail("Huffman weight too large", at);
    if (w[i]) total += 1u << (w[i] - 1);
  }
  if (total == 0) fail("Huffman tree has no symbols", at);
  int max_bits = highest_bit(total) + 1;
  if (max_bits > kHufMaxBits) fail("Huffman tree too deep", at);
  uint32_t left = (1u << max_bits) - total;
  if (left == 0 || (left & (left - 1))) fail("Huffman weights do not complete a tree", at);
  int nsym = nw + 1;
  if (nsym > 256) fail("too many Huffman symbols", at);
  uint8_t bits[256];
  for (int i = 0; i < nw; i++) bits[i] = w[i] ? uint8_t(max_bits + 1 - w[i]) : 0;
  bits[nw] = uint8_t(max_bits + 1 - (highest_bit(left) + 1));
  size_t size = size_t(1) << max_bits;
  t.max_bits = max_bits;
  t.sym.assign(size, 0);
  t.nbits.assign(size, 0);
  uint32_t rank_count[kHufMaxBits + 2] = {0};
  for (int i = 0; i < nsym; i++) rank_count[bits[i]]++;
  uint32_t rank_idx[kHufMaxBits + 2] = {0};
  rank_idx[max_bits] = 0;
  for (int i = max_bits; i >= 1; i--) {
    rank_idx[i - 1] = rank_idx[i] + rank_count[i] * (1u << (max_bits - i));
    if (rank_idx[i - 1] > size) fail("Huffman table overflow", at);
    std::memset(&t.nbits[rank_idx[i]], i, rank_idx[i - 1] - rank_idx[i]);
  }
  if (rank_idx[0] != size) fail("Huffman table does not fill", at);
  for (int i = 0; i < nsym; i++) {
    if (!bits[i]) continue;
    uint32_t code = rank_idx[bits[i]];
    uint32_t len = 1u << (max_bits - bits[i]);
    std::memset(&t.sym[code], i, len);
    rank_idx[bits[i]] += len;
  }
}

// Reads a Huffman tree description; returns the bytes it took.
size_t huf_read_tree(HufTable& t, const uint8_t* p, size_t n, size_t at) {
  if (n == 0) fail("truncated Huffman tree description", at);
  uint8_t weights[256];
  int nw = 0;
  uint8_t hb = p[0];
  size_t used;
  if (hb < 128) {
    size_t csize = hb;
    if (csize == 0 || 1 + csize > n) fail("truncated Huffman tree description", at);
    FseTable ft;
    size_t h = fse_read_header(ft, p + 1, csize, at + 1, 6, 255);
    if (h >= csize) fail("Huffman weights: no bitstream after the FSE table", at + 1);
    BackBits br(p + 1 + h, csize - h, at + 1 + h);
    uint32_t s1 = uint32_t(br.read(ft.log)), s2 = uint32_t(br.read(ft.log));
    while (true) {
      if (nw >= 255) fail("too many Huffman weights", at);
      weights[nw++] = ft.sym[s1];
      s1 = ft.base[s1] + uint32_t(br.read(ft.nbits[s1]));
      if (br.off < 0) {
        if (nw >= 255) fail("too many Huffman weights", at);
        weights[nw++] = ft.sym[s2];
        break;
      }
      if (nw >= 255) fail("too many Huffman weights", at);
      weights[nw++] = ft.sym[s2];
      s2 = ft.base[s2] + uint32_t(br.read(ft.nbits[s2]));
      if (br.off < 0) {
        if (nw >= 255) fail("too many Huffman weights", at);
        weights[nw++] = ft.sym[s1];
        break;
      }
    }
    used = 1 + csize;
  } else {
    nw = hb - 127;
    size_t bytes = (size_t(nw) + 1) / 2;
    if (1 + bytes > n) fail("truncated Huffman tree description", at);
    for (int i = 0; i < nw; i++) {
      uint8_t b = p[1 + i / 2];
      weights[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
    used = 1 + bytes;
  }
  huf_build(t, weights, nw, at);
  return used;
}

// A Huffman stream decoded by peeking: the next max_bits bits below `pos`
// (the stream read backwards, zeros past its start) index the table, whose
// entry gives the symbol and how many of those bits it used.  The stream is
// consumed exactly when `pos` reaches 0 as its last symbol is written
// (RFC 8878 4.2.2: the decoder's state is always the next max_bits bits).
struct HufStream {
  const uint8_t* p;
  size_t n;
  int64_t pos;  // bits not yet used
  size_t at;

  HufStream(const uint8_t* src, size_t len, size_t at_) : p(src), n(len), at(at_) {
    if (len == 0) fail("empty Huffman stream", at_);
    uint8_t last = src[len - 1];
    if (last == 0) fail("Huffman stream's last byte is 0 (no end mark)", at_ + len - 1);
    pos = int64_t(len) * 8 - 8 + highest_bit(last);
  }

  // one 64-bit load holds the max_bits bits below pos
  inline bool fast(int mb) const {
    int64_t q = pos - mb;
    return q >= 0 && (size_t(q) >> 3) + 8 <= n;
  }
  inline uint32_t peek_fast(int mb, uint32_t mask) const {
    int64_t q = pos - mb;
    return uint32_t(rd64(p + (size_t(q) >> 3)) >> (q & 7)) & mask;
  }
  uint32_t peek(int mb, uint32_t mask) const {
    if (fast(mb)) return peek_fast(mb, mask);
    int64_t q = pos - mb;
    uint64_t v = 0;
    if (q >= 0) {
      size_t byte = size_t(q) >> 3;
      for (size_t i = byte; i < n && i < byte + 8; i++) v |= uint64_t(p[i]) << (8 * (i - byte));
      return uint32_t(v >> (q & 7)) & mask;
    }
    if (pos <= 0) return 0;
    for (size_t i = 0; i < (size_t(pos) + 7) >> 3 && i < n; i++) v |= uint64_t(p[i]) << (8 * i);
    v &= (uint64_t(1) << pos) - 1;
    return uint32_t(v << (-q)) & mask;
  }
};

// Decodes stream `s` into out[i, count) while its next bits lie in the
// last 8 bytes (the slow peek); returns the new i.
size_t huf_tail(const HufTable& t, HufStream& s, uint8_t* out, size_t i, size_t count) {
  const int mb = t.max_bits;
  const uint32_t mask = (1u << mb) - 1;
  while (s.pos > 0 && !s.fast(mb) && i < count) {
    uint32_t idx = s.peek(mb, mask);
    out[i++] = t.sym[idx];
    s.pos -= t.nbits[idx];
  }
  return i;
}

// Decodes the rest of stream `s` into out[i, count).
void huf_finish(const HufTable& t, HufStream& s, uint8_t* out, size_t i, size_t count) {
  const int mb = t.max_bits;
  const uint32_t mask = (1u << mb) - 1;
  const uint8_t* sym = t.sym.data();
  const uint8_t* nbits = t.nbits.data();
  while (s.pos > 0) {
    if (i == count) fail("Huffman stream holds more symbols than its size", s.at);
    uint32_t idx = s.peek(mb, mask);
    out[i++] = sym[idx];
    s.pos -= nbits[idx];
  }
  if (s.pos != 0) fail("Huffman stream not consumed exactly", s.at);
  if (i != count) fail("Huffman stream holds fewer symbols than its size", s.at);
}

void huf_stream(const HufTable& t, const uint8_t* p, size_t n, size_t at,
                uint8_t* out, size_t count) {
  HufStream s(p, n, at);
  const int mb = t.max_bits;
  const uint32_t mask = (1u << mb) - 1;
  size_t i = huf_tail(t, s, out, 0, count);
  while (i < count && s.fast(mb)) {
    uint32_t idx = s.peek_fast(mb, mask);
    out[i++] = t.sym[idx];
    s.pos -= t.nbits[idx];
  }
  huf_finish(t, s, out, i, count);
}

// Four streams: each past its last 8 bytes alone, then one symbol of
// each in turn while all four are in the middle of their bytes
// (independent chains the CPU overlaps), then each to its end.
void huf_4streams(const HufTable& t, HufStream* s, uint8_t* const* out,
                  const size_t* count) {
  const int mb = t.max_bits;
  const uint32_t mask = (1u << mb) - 1;
  const uint8_t* sym = t.sym.data();
  const uint8_t* nbits = t.nbits.data();
  size_t i[4];
  for (int k = 0; k < 4; k++) i[k] = huf_tail(t, s[k], out[k], 0, count[k]);
  while (i[0] < count[0] && i[1] < count[1] && i[2] < count[2] && i[3] < count[3] &&
         s[0].fast(mb) && s[1].fast(mb) && s[2].fast(mb) && s[3].fast(mb)) {
    uint32_t a = s[0].peek_fast(mb, mask), b = s[1].peek_fast(mb, mask),
             c = s[2].peek_fast(mb, mask), d = s[3].peek_fast(mb, mask);
    out[0][i[0]++] = sym[a];
    out[1][i[1]++] = sym[b];
    out[2][i[2]++] = sym[c];
    out[3][i[3]++] = sym[d];
    s[0].pos -= nbits[a];
    s[1].pos -= nbits[b];
    s[2].pos -= nbits[c];
    s[3].pos -= nbits[d];
  }
  for (int k = 0; k < 4; k++) huf_finish(t, s[k], out[k], i[k], count[k]);
}

// ------------------------------------------------------------- sequences
const uint32_t LL_BASE[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13,  14,  15,   16,   17,   18,   19,   20,
                              21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31,  32,  33,   34,   35,   37,   39,   41,
                              43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct FrameState {
  HufTable huf;
  FseTable ll, of, ml;
  uint32_t rep[3] = {1, 4, 8};
  size_t frame_start = 0;  // output offset where this frame began
};

// One of the three tables of a sequences section; returns the bytes it took.
size_t seq_table(FseTable& t, int mode, const uint8_t* p, size_t n, size_t at,
                 const int16_t* def, int ndef, int def_log, int max_log, int max_symbol) {
  switch (mode) {
    case 0:
      fse_build(t, def, ndef, def_log, at);
      return 0;
    case 1:
      if (n < 1) fail("truncated RLE table", at);
      if (p[0] > max_symbol) fail("RLE table symbol out of range", at);
      fse_rle(t, p[0]);
      return 1;
    case 2:
      return fse_read_header(t, p, n, at, max_log, max_symbol);
    default:
      if (t.log < 0) fail("repeat table mode with no previous table", at);
      return 0;
  }
}

void decode_block(const uint8_t* b, size_t size, size_t at, FrameState& fs,
                  std::vector<uint8_t>& litbuf, Out& out) {
  // ---- literals section
  if (size < 1) fail("empty compressed block", at);
  uint8_t b0 = b[0];
  int lit_type = b0 & 3, sf = (b0 >> 2) & 3;
  size_t pos, regen;
  const uint8_t* lit;
  if (lit_type < 2) {
    size_t hs;
    if (sf == 0 || sf == 2) {
      hs = 1;
      regen = b0 >> 3;
    } else if (sf == 1) {
      hs = 2;
      if (size < 2) fail("truncated literals header", at);
      regen = (b0 >> 4) + (size_t(b[1]) << 4);
    } else {
      hs = 3;
      if (size < 3) fail("truncated literals header", at);
      regen = (b0 >> 4) + (size_t(b[1]) << 4) + (size_t(b[2]) << 12);
    }
    if (regen > kBlockMax) fail("literals larger than a block", at);
    if (lit_type == 0) {
      if (hs + regen > size) fail("truncated raw literals", at + hs);
      lit = b + hs;
      pos = hs + regen;
    } else {
      if (hs + 1 > size) fail("truncated RLE literals", at + hs);
      std::memset(litbuf.data(), b[hs], regen);
      lit = litbuf.data();
      pos = hs + 1;
    }
  } else {
    size_t hs;
    int bits, streams;
    if (sf < 2) {
      hs = 3;
      bits = 10;
      streams = sf == 0 ? 1 : 4;
    } else {
      hs = sf == 2 ? 4 : 5;
      bits = sf == 2 ? 14 : 18;
      streams = 4;
    }
    if (size < hs) fail("truncated literals header", at);
    uint64_t hdr = 0;
    for (size_t i = 0; i < hs; i++) hdr |= uint64_t(b[i]) << (8 * i);
    uint64_t mask = (uint64_t(1) << bits) - 1;
    regen = (hdr >> 4) & mask;
    size_t csize = (hdr >> (4 + bits)) & mask;
    if (regen > kBlockMax) fail("literals larger than a block", at);
    if (hs + csize > size) fail("truncated compressed literals", at + hs);
    size_t tree = 0;
    if (lit_type == 2) {
      tree = huf_read_tree(fs.huf, b + hs, csize, at + hs);
    } else if (fs.huf.max_bits == 0) {
      fail("treeless literals with no previous Huffman table", at);
    }
    const uint8_t* s = b + hs + tree;
    size_t slen = csize - tree;
    size_t sat = at + hs + tree;
    uint8_t* dst = litbuf.data();
    if (streams == 1) {
      huf_stream(fs.huf, s, slen, sat, dst, regen);
    } else {
      if (slen < 6) fail("truncated 4-stream jump table", sat);
      size_t l1 = rd16(s), l2 = rd16(s + 2), l3 = rd16(s + 4);
      if (6 + l1 + l2 + l3 > slen) fail("4-stream jump table past the literals", sat);
      size_t l4 = slen - 6 - l1 - l2 - l3;
      size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) fail("4-stream literals too short", sat);
      size_t counts[4] = {seg, seg, seg, regen - 3 * seg};
      HufStream streams[4] = {HufStream(s + 6, l1, sat + 6),
                              HufStream(s + 6 + l1, l2, sat + 6 + l1),
                              HufStream(s + 6 + l1 + l2, l3, sat + 6 + l1 + l2),
                              HufStream(s + 6 + l1 + l2 + l3, l4, sat + 6 + l1 + l2 + l3)};
      uint8_t* outs[4] = {dst, dst + seg, dst + 2 * seg, dst + 3 * seg};
      huf_4streams(fs.huf, streams, outs, counts);
    }
    lit = litbuf.data();
    pos = hs + csize;
  }

  // ---- sequences section
  if (pos >= size) fail("truncated sequences section", at + pos);
  size_t nseq;
  uint8_t c0 = b[pos];
  if (c0 == 0) {
    nseq = 0;
    pos += 1;
  } else if (c0 < 128) {
    nseq = c0;
    pos += 1;
  } else if (c0 < 255) {
    if (pos + 2 > size) fail("truncated sequence count", at + pos);
    nseq = (size_t(c0 - 128) << 8) + b[pos + 1];
    pos += 2;
  } else {
    if (pos + 3 > size) fail("truncated sequence count", at + pos);
    nseq = b[pos + 1] + (size_t(b[pos + 2]) << 8) + 0x7F00;
    pos += 3;
  }
  size_t lit_left = regen;
  if (nseq == 0) {
    if (pos != size) fail("bytes after a block with no sequences", at + pos);
    out.need(regen, at);
    std::memcpy(out.p + out.len, lit, regen);
    out.len += regen;
    return;
  }
  if (pos >= size) fail("truncated sequence modes", at + pos);
  uint8_t modes = b[pos];
  if (modes & 3) fail("reserved bits set in the sequence modes", at + pos);
  pos += 1;
  pos += seq_table(fs.ll, modes >> 6, b + pos, size - pos, at + pos, LL_DEFAULT, 36, 6, 9, 35);
  pos += seq_table(fs.of, (modes >> 4) & 3, b + pos, size - pos, at + pos, OF_DEFAULT, 29, 5, 8, 31);
  pos += seq_table(fs.ml, (modes >> 2) & 3, b + pos, size - pos, at + pos, ML_DEFAULT, 53, 6, 9, 52);
  if (pos >= size) fail("no sequence bitstream", at + pos);
  BackBits br(b + pos, size - pos, at + pos);
  uint32_t sll = uint32_t(br.read(fs.ll.log));
  uint32_t sof = uint32_t(br.read(fs.of.log));
  uint32_t sml = uint32_t(br.read(fs.ml.log));
  const size_t sat = at + pos;
  for (size_t i = 0; i < nseq; i++) {
    uint8_t of_code = fs.of.sym[sof], ll_code = fs.ll.sym[sll], ml_code = fs.ml.sym[sml];
    if (ll_code > 35 || ml_code > 52 || of_code > 31) fail("sequence code out of range", sat);
    uint32_t ofv = (1u << of_code) + uint32_t(br.read(of_code));
    size_t ml = ML_BASE[ml_code] + size_t(br.read(ML_BITS[ml_code]));
    size_t ll = LL_BASE[ll_code] + size_t(br.read(LL_BITS[ll_code]));
    if (i + 1 < nseq) {
      sll = fs.ll.base[sll] + uint32_t(br.read(fs.ll.nbits[sll]));
      sml = fs.ml.base[sml] + uint32_t(br.read(fs.ml.nbits[sml]));
      sof = fs.of.base[sof] + uint32_t(br.read(fs.of.nbits[sof]));
    }
    if (br.off < 0) fail("sequence bitstream overrun", sat);
    uint32_t offset;
    if (ofv > 3) {
      offset = ofv - 3;
      fs.rep[2] = fs.rep[1];
      fs.rep[1] = fs.rep[0];
      fs.rep[0] = offset;
    } else {
      uint32_t idx = ofv - 1 + (ll == 0 ? 1 : 0);
      if (idx == 0) {
        offset = fs.rep[0];
      } else {
        offset = idx < 3 ? fs.rep[idx] : fs.rep[0] - 1;
        if (idx > 1) fs.rep[2] = fs.rep[1];
        fs.rep[1] = fs.rep[0];
        fs.rep[0] = offset;
      }
    }
    if (ll > lit_left) fail("sequence takes more literals than the block has", sat);
    out.need(ll + ml, sat);
    std::memcpy(out.p + out.len, lit, ll);
    lit += ll;
    lit_left -= ll;
    out.len += ll;
    if (offset == 0 || offset > out.len - fs.frame_start)
      fail("match offset before the start of the frame", sat);
    uint8_t* d = out.p + out.len;
    const uint8_t* s = d - offset;
    if (offset >= ml) {
      std::memcpy(d, s, ml);
    } else {
      for (size_t k = 0; k < ml; k++) d[k] = s[k];
    }
    out.len += ml;
  }
  if (br.off != 0) fail("sequence bitstream not consumed exactly", sat);
  out.need(lit_left, at);
  std::memcpy(out.p + out.len, lit, lit_left);
  out.len += lit_left;
}

// Decodes one zstd frame whose magic ends at `pos`; returns the offset
// after the frame.
size_t decode_frame(const uint8_t* src, size_t n, size_t pos, Out& out,
                    std::vector<uint8_t>& litbuf) {
  size_t start = pos - 4;
  if (pos >= n) fail("truncated frame header", pos);
  uint8_t fhd = src[pos++];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
      did_flag = fhd & 3;
  if (fhd & 8) fail("reserved bit set in the frame header", pos - 1);
  uint64_t window = 0;
  if (!single) {
    if (pos >= n) fail("truncated frame header", pos);
    uint8_t wd = src[pos++];
    int wlog = 10 + (wd >> 3);
    if (wlog > 41) fail("window too large", pos - 1);
    uint64_t wbase = uint64_t(1) << wlog;
    window = wbase + (wbase / 8) * (wd & 7);
  }
  static const int did_size[4] = {0, 1, 2, 4};
  size_t ds = did_size[did_flag];
  if (pos + ds > n) fail("truncated frame header", pos);
  uint32_t did = 0;
  for (size_t i = 0; i < ds; i++) did |= uint32_t(src[pos + i]) << (8 * i);
  if (did != 0) fail("frames that need a dictionary are not supported", pos);
  pos += ds;
  size_t fs_size = fcs_flag == 0 ? (single ? 1 : 0) : (size_t(1) << fcs_flag);
  if (pos + fs_size > n) fail("truncated frame header", pos);
  uint64_t fcs = 0;
  for (size_t i = 0; i < fs_size; i++) fcs |= uint64_t(src[pos + i]) << (8 * i);
  if (fs_size == 2) fcs += 256;
  pos += fs_size;
  if (single) window = fcs;
  bool has_fcs = fs_size > 0;
  FrameState fs;
  fs.frame_start = out.len;
  if (has_fcs) {
    // a frame cannot make more than a block for every 3 bytes left
    if (fcs > (uint64_t(n - pos) / 3 + 1) * kBlockMax)
      fail("frame content size larger than the input can hold", start);
    out.need(size_t(fcs), start);
  }
  uint64_t block_max = window < kBlockMax ? window : kBlockMax;
  while (true) {
    if (pos + 3 > n) fail("truncated block header", pos);
    uint32_t bh = rd24(src + pos);
    size_t hat = pos;
    pos += 3;
    int last = bh & 1, type = (bh >> 1) & 3;
    size_t bsize = bh >> 3;
    if (type == 3) fail("reserved block type", hat);
    if (bsize > block_max) fail("block larger than the window or 128 KiB", hat);
    if (type == 0) {
      if (pos + bsize > n) fail("truncated raw block", pos);
      out.need(bsize, pos);
      std::memcpy(out.p + out.len, src + pos, bsize);
      out.len += bsize;
      pos += bsize;
    } else if (type == 1) {
      if (pos + 1 > n) fail("truncated RLE block", pos);
      out.need(bsize, pos);
      std::memset(out.p + out.len, src[pos], bsize);
      out.len += bsize;
      pos += 1;
    } else {
      if (pos + bsize > n) fail("truncated compressed block", pos);
      decode_block(src + pos, bsize, pos, fs, litbuf, out);
      pos += bsize;
    }
    if (has_fcs && out.len - fs.frame_start > fcs) fail("frame larger than its content size", hat);
    if (last) break;
  }
  if (has_fcs && out.len - fs.frame_start != fcs)
    fail("frame smaller than its content size", pos);
  if (checksum) {
    if (pos + 4 > n) fail("truncated content checksum", pos);
    uint32_t want = rd32(src + pos);
    uint32_t got = uint32_t(xxh64(out.p + fs.frame_start, out.len - fs.frame_start, 0));
    if (want != got) fail("content checksum mismatch", pos);
    pos += 4;
  }
  return pos;
}

void decode_all(const uint8_t* src, size_t n, Out& out) {
  thread_local std::vector<uint8_t> litbuf(kBlockMax + 64);
  size_t pos = 0;
  while (pos < n) {
    if (n - pos < 4) fail("truncated frame magic", pos);
    uint32_t magic = rd32(src + pos);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (n - pos < 8) fail("truncated skippable frame", pos);
      uint32_t sz = rd32(src + pos + 4);
      if (sz > n - pos - 8) fail("truncated skippable frame", pos);
      pos += 8 + size_t(sz);
      continue;
    }
    if (magic != 0xFD2FB528u) fail("not a zstd frame (bad magic)", pos);
    pos = decode_frame(src, n, pos + 4, out, litbuf);
  }
}

void set_error(char* err, size_t cap, const char* msg, size_t off) {
  if (err && cap) std::snprintf(err, cap, "%s (at input offset %zu)", msg, off);
}

}  // namespace

extern "C" {

// Decodes every frame of src into dst[0, cap); *out_len gets the bytes
// written.  Returns 0, or 1 with a message in err.
int byol_zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap,
                         size_t* out_len, char* err, size_t errcap) {
  Out out;
  out.p = dst;
  out.cap = cap;
  try {
    decode_all(src, n, out);
  } catch (const DecodeError& e) {
    set_error(err, errcap, e.msg.c_str(), e.offset);
    return 1;
  } catch (const std::bad_alloc&) {
    set_error(err, errcap, "out of memory", 0);
    return 1;
  }
  *out_len = out.len;
  return 0;
}

// The same into a buffer that grows, malloc'd: free it with byol_zstd_free.
int byol_zstd_decompress_alloc(const uint8_t* src, size_t n, uint8_t** dst,
                               size_t* out_len, char* err, size_t errcap) {
  Out out;
  out.grow = true;
  try {
    decode_all(src, n, out);
  } catch (const DecodeError& e) {
    std::free(out.p);
    set_error(err, errcap, e.msg.c_str(), e.offset);
    return 1;
  } catch (const std::bad_alloc&) {
    std::free(out.p);
    set_error(err, errcap, "out of memory", 0);
    return 1;
  }
  *dst = out.p;
  *out_len = out.len;
  return 0;
}

void byol_zstd_free(uint8_t* p) { std::free(p); }

// The sum of the content sizes the frames declare (skippable frames add
// 0): >= 0, -1 when a frame does not declare its size, -2 on an input
// whose frame headers cannot be walked (decoding it says why).
int64_t byol_zstd_content_size(const uint8_t* src, size_t n) {
  size_t pos = 0;
  uint64_t total = 0;
  bool unknown = false;
  while (pos < n) {
    if (n - pos < 4) return -2;
    uint32_t magic = rd32(src + pos);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (n - pos < 8) return -2;
      uint32_t sz = rd32(src + pos + 4);
      if (sz > n - pos - 8) return -2;
      pos += 8 + size_t(sz);
      continue;
    }
    if (magic != 0xFD2FB528u || n - pos < 5) return -2;
    size_t p = pos + 4;
    uint8_t fhd = src[p++];
    int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1;
    static const int did_size[4] = {0, 1, 2, 4};
    p += (single ? 0 : 1) + did_size[fhd & 3];
    size_t fs_size = fcs_flag == 0 ? (single ? 1 : 0) : (size_t(1) << fcs_flag);
    if (p + fs_size > n) return -2;
    if (fs_size == 0) {
      unknown = true;
    } else {
      uint64_t fcs = 0;
      for (size_t i = 0; i < fs_size; i++) fcs |= uint64_t(src[p + i]) << (8 * i);
      if (fs_size == 2) fcs += 256;
      if (fcs > (uint64_t(n - p) / 3 + 1) * kBlockMax) return -2;
      total += fcs;
    }
    p += fs_size;
    // walk the blocks to the next frame
    while (true) {
      if (p + 3 > n) return -2;
      uint32_t bh = rd24(src + p);
      p += 3;
      size_t bsize = bh >> 3;
      int type = (bh >> 1) & 3;
      size_t skip = type == 1 ? 1 : bsize;
      if (type == 3 || p + skip > n) return -2;
      p += skip;
      if (bh & 1) break;
    }
    p += checksum ? 4 : 0;
    if (p > n) return -2;
    pos = p;
  }
  return unknown ? -1 : int64_t(total);
}

uint32_t byol_crc32c(const uint8_t* p, size_t n, uint32_t crc) { return crc32c(p, n, crc); }

}  // extern "C"
