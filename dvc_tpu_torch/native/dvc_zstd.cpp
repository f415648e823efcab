// dvc_zstd — a Zstandard frame decoder (RFC 8878) and the two checksums an
// OCDBT store needs (CRC-32C over its manifests and B-tree nodes, XXH64 for
// zstd's content checksum), written from the format descriptions so the
// port reads orbax checkpoints without libzstd or tensorstore.
//
// The decoder takes a buffer holding one or more frames (skippable frames
// are stepped over) and returns the concatenated content.  It decodes raw,
// RLE and compressed blocks: Huffman literals (direct or FSE-coded weights,
// one or four streams, and the treeless form that reuses the previous
// block's table), FSE sequences in predefined, RLE, compressed and repeat
// modes, repeat offsets, and checks the window, the frame content size and,
// when the frame carries one, the XXH64 content checksum.  Every read is
// bounds-checked: a malformed or truncated frame raises, it never returns
// partial output.  Dictionaries are refused (no writer this port reads
// uses one).

#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

using u8 = uint8_t;
using u16 = uint16_t;
using u32 = uint32_t;
using u64 = uint64_t;
using i64 = int64_t;

struct ZstdError : std::runtime_error {
  explicit ZstdError(const std::string& m) : std::runtime_error(m) {}
};

[[noreturn]] void fail(const char* what) { throw ZstdError(what); }

int highest_bit(u64 v) {  // index of the highest set bit, v > 0
  return 63 - __builtin_clzll(v);
}

// ---------------------------------------------------------------- checksums

u64 rotl64(u64 x, int r) { return (x << r) | (x >> (64 - r)); }

constexpr u64 P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL,
              P3 = 0x165667B19E3779F9ULL, P4 = 0x85EBCA77C2B2AE63ULL,
              P5 = 0x27D4EB2F165667C5ULL;

u64 rd64(const u8* p) { u64 v; std::memcpy(&v, p, 8); return v; }  // little-endian host
u32 rd32(const u8* p) { u32 v; std::memcpy(&v, p, 4); return v; }

u64 xxh_round(u64 acc, u64 in) { acc += in * P2; acc = rotl64(acc, 31); return acc * P1; }
u64 xxh_merge(u64 acc, u64 v) { acc ^= xxh_round(0, v); return acc * P1 + P4; }

u64 xxh64(const u8* p, size_t n, u64 seed) {
  const u8* end = p + n;
  u64 h;
  if (n >= 32) {
    u64 v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    while (end - p >= 32) {
      v1 = xxh_round(v1, rd64(p)); v2 = xxh_round(v2, rd64(p + 8));
      v3 = xxh_round(v3, rd64(p + 16)); v4 = xxh_round(v4, rd64(p + 24));
      p += 32;
    }
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = xxh_merge(h, v1); h = xxh_merge(h, v2); h = xxh_merge(h, v3); h = xxh_merge(h, v4);
  } else {
    h = seed + P5;
  }
  h += (u64)n;
  while (end - p >= 8) { h ^= xxh_round(0, rd64(p)); h = rotl64(h, 27) * P1 + P4; p += 8; }
  if (end - p >= 4) { h ^= (u64)rd32(p) * P1; h = rotl64(h, 23) * P2 + P3; p += 4; }
  while (p < end) { h ^= (u64)(*p) * P5; h = rotl64(h, 11) * P1; ++p; }
  h ^= h >> 33; h *= P2; h ^= h >> 29; h *= P3; h ^= h >> 32;
  return h;
}

struct Crc32cTable {
  u32 t[8][256];
  Crc32cTable() {
    for (u32 i = 0; i < 256; ++i) {
      u32 c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1u)));
      t[0][i] = c;
    }
    for (u32 i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

u32 crc32c(const u8* p, size_t n, u32 crc) {  // slicing-by-8
  static const Crc32cTable tab;
  crc = ~crc;
  while (n >= 8) {
    u64 v = rd64(p) ^ crc;
    crc = tab.t[7][v & 0xFF] ^ tab.t[6][(v >> 8) & 0xFF] ^ tab.t[5][(v >> 16) & 0xFF] ^
          tab.t[4][(v >> 24) & 0xFF] ^ tab.t[3][(v >> 32) & 0xFF] ^ tab.t[2][(v >> 40) & 0xFF] ^
          tab.t[1][(v >> 48) & 0xFF] ^ tab.t[0][v >> 56];
    p += 8; n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ tab.t[0][(crc ^ *p++) & 0xFF];
  return ~crc;
}

// ------------------------------------------------------------- bit readers

// Forward little-endian bit reader (FSE table descriptions).
struct ForwardBits {
  const u8* p; size_t n; size_t bit = 0;
  ForwardBits(const u8* p_, size_t n_) : p(p_), n(n_) {}
  u32 read(int nb) {
    if (nb == 0) return 0;
    if (bit + nb > n * 8) fail("truncated FSE table description");
    u64 v = 0;
    size_t first = bit >> 3, last = (bit + nb - 1) >> 3;
    for (size_t i = last + 1; i-- > first;) v = (v << 8) | p[i];
    v >>= (bit & 7);
    bit += nb;
    return (u32)(v & ((1ULL << nb) - 1));
  }
  void rewind(int nb) { bit -= nb; }
  size_t bytes_used() const { return (bit + 7) >> 3; }
};

// Backward bit stream (Huffman literal streams, FSE bitstreams): read from
// the end toward the start; the last byte's highest set bit marks the start.
// Reads past the first byte yield zeros and leave `off` negative, which the
// callers use to detect the end.
struct BackBits {
  const u8* p; size_t n; i64 off;
  BackBits(const u8* p_, size_t n_) : p(p_), n(n_) {
    if (n == 0) fail("empty bitstream");
    u8 last = p[n - 1];
    if (last == 0) fail("bitstream without its end mark");
    off = (i64)n * 8 - 8 + highest_bit(last);
  }
  u64 read(int nb) {
    if (nb == 0) return 0;
    off -= nb;
    i64 start = off, count = nb;
    if (start < 0) { count += start; start = 0; }
    u64 v = 0;
    if (count > 0) {
      size_t first = (size_t)start >> 3, last = (size_t)(start + count - 1) >> 3;
      for (size_t i = last + 1; i-- > first;) v = (v << 8) | p[i];
      v >>= (start & 7);
      v &= (count >= 64) ? ~0ULL : ((1ULL << count) - 1);
    }
    if (off < 0) v <<= -off;
    return v;
  }
};

// -------------------------------------------------------------------- FSE

struct FseTable {
  int log = -1;  // -1: no table yet
  std::vector<u8> sym, nbits;
  std::vector<u16> base;
};

void fse_build(FseTable& t, const int16_t* freq, int nsym, int log) {
  const u32 size = 1u << log;
  t.log = log;
  t.sym.assign(size, 0); t.nbits.assign(size, 0); t.base.assign(size, 0);
  std::vector<u32> next(nsym, 0);
  u32 high = size;
  for (int s = 0; s < nsym; ++s)
    if (freq[s] == -1) { t.sym[--high] = (u8)s; next[s] = 1; }
  const u32 step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  u32 pos = 0;
  for (int s = 0; s < nsym; ++s) {
    if (freq[s] <= 0) continue;
    next[s] = freq[s];
    for (int i = 0; i < freq[s]; ++i) {
      t.sym[pos] = (u8)s;
      do { pos = (pos + step) & mask; } while (pos >= high);
    }
  }
  if (pos != 0) fail("corrupt FSE distribution");
  for (u32 i = 0; i < size; ++i) {
    u32 desc = next[t.sym[i]]++;
    int nb = log - highest_bit(desc);
    t.nbits[i] = (u8)nb;
    t.base[i] = (u16)((desc << nb) - size);
  }
}

void fse_rle(FseTable& t, u8 symbol) {
  t.log = 0; t.sym.assign(1, symbol); t.nbits.assign(1, 0); t.base.assign(1, 0);
}

// Reads an FSE table description; returns the bytes it used.
size_t fse_read_table(FseTable& t, const u8* p, size_t n, int max_log, int max_sym) {
  ForwardBits in(p, n);
  int log = 5 + (int)in.read(4);
  if (log > max_log) fail("FSE accuracy log too large");
  int remaining = 1 << log, s = 0;
  int16_t freq[256];
  while (remaining > 0 && s <= max_sym) {
    int bits = highest_bit((u64)remaining + 1) + 1;
    u32 val = in.read(bits);
    u32 lower = (1u << (bits - 1)) - 1;
    u32 thresh = (1u << bits) - 1 - (u32)(remaining + 1);
    if ((val & lower) < thresh) { in.rewind(1); val &= lower; }
    else if (val > lower) { val -= thresh; }
    int proba = (int)val - 1;
    remaining -= proba < 0 ? -proba : proba;
    freq[s++] = (int16_t)proba;
    if (proba == 0) {
      int rep = (int)in.read(2);
      for (;;) {
        for (int i = 0; i < rep; ++i) {
          if (s > max_sym) fail("FSE symbol out of range");
          freq[s++] = 0;
        }
        if (rep != 3) break;
        rep = (int)in.read(2);
      }
    }
  }
  if (remaining != 0 || s > max_sym + 1) fail("corrupt FSE table description");
  fse_build(t, freq, s, log);
  return in.bytes_used();
}

struct FseState {
  const FseTable* t; u32 state;
  void init(const FseTable& tab, BackBits& b) { t = &tab; state = (u32)b.read(tab.log); }
  u8 peek() const { return t->sym[state]; }
  void update(BackBits& b) { state = t->base[state] + (u32)b.read(t->nbits[state]); }
};

// ---------------------------------------------------------------- Huffman

struct HufTable {
  int max_bits = 0;  // 0: no table yet
  std::vector<u8> sym, nbits;
};

void huf_from_weights(HufTable& h, const u8* w, int nw) {
  // the last symbol's weight is implied: the weights' 2^(w-1) sum to a power of 2
  if (nw < 1 || nw > 255) fail("bad Huffman weight count");
  u32 sum = 0;
  for (int i = 0; i < nw; ++i) {
    if (w[i] > 11) fail("Huffman weight too large");
    if (w[i]) sum += 1u << (w[i] - 1);
  }
  if (sum == 0) fail("Huffman weights all zero");
  int max_bits = highest_bit(sum) + 1;
  u32 left = (1u << max_bits) - sum;
  if (left & (left - 1)) fail("Huffman weights do not close to a power of two");
  if (max_bits > 11) fail("Huffman code too long");
  int nsym = nw + 1;
  std::vector<u8> bits(nsym);
  for (int i = 0; i < nw; ++i) bits[i] = w[i] ? (u8)(max_bits + 1 - w[i]) : 0;
  bits[nw] = (u8)(max_bits + 1 - (highest_bit(left) + 1));
  u32 rank_count[13] = {0}, rank_idx[13] = {0};
  for (int i = 0; i < nsym; ++i) rank_count[bits[i]]++;
  const u32 size = 1u << max_bits;
  h.max_bits = max_bits;
  h.sym.assign(size, 0); h.nbits.assign(size, 0);
  rank_idx[max_bits] = 0;
  for (int i = max_bits; i >= 1; --i) {
    rank_idx[i - 1] = rank_idx[i] + rank_count[i] * (1u << (max_bits - i));
    if (rank_idx[i - 1] > size) fail("corrupt Huffman table");
    std::memset(&h.nbits[rank_idx[i]], i, rank_idx[i - 1] - rank_idx[i]);
  }
  if (rank_idx[0] != size) fail("corrupt Huffman table");
  for (int i = 0; i < nsym; ++i) {
    if (!bits[i]) continue;
    u32 code = rank_idx[bits[i]], len = 1u << (max_bits - bits[i]);
    std::memset(&h.sym[code], i, len);
    rank_idx[bits[i]] += len;
  }
}

// Reads a Huffman tree description; returns its size in bytes.
size_t huf_read_table(HufTable& h, const u8* p, size_t n) {
  if (n < 1) fail("truncated Huffman tree description");
  u8 header = p[0];
  u8 w[256];
  int nw = 0;
  if (header >= 128) {  // direct: 4 bits a weight
    nw = header - 127;
    size_t bytes = (size_t)(nw + 1) / 2;
    if (1 + bytes > n) fail("truncated Huffman weights");
    for (int i = 0; i < nw; ++i) {
      u8 b = p[1 + i / 2];
      w[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
    huf_from_weights(h, w, nw);
    return 1 + bytes;
  }
  size_t csize = header;
  if (csize == 0 || 1 + csize > n) fail("truncated Huffman weights");
  const u8* src = p + 1;
  FseTable t;
  size_t used = fse_read_table(t, src, csize, 6, 255);
  if (used >= csize) fail("Huffman weights without a bitstream");
  BackBits b(src + used, csize - used);
  FseState s1, s2;
  s1.init(t, b); s2.init(t, b);
  for (;;) {
    if (nw >= 255) fail("too many Huffman weights");
    w[nw++] = s1.peek(); s1.update(b);
    if (b.off < 0) { if (nw >= 255) fail("too many Huffman weights"); w[nw++] = s2.peek(); break; }
    if (nw >= 255) fail("too many Huffman weights");
    w[nw++] = s2.peek(); s2.update(b);
    if (b.off < 0) { if (nw >= 255) fail("too many Huffman weights"); w[nw++] = s1.peek(); break; }
  }
  huf_from_weights(h, w, nw);
  return 1 + csize;
}

void huf_decode_stream(const HufTable& h, const u8* p, size_t n, u8* out, size_t count) {
  BackBits b(p, n);
  const u32 mask = (1u << h.max_bits) - 1;
  u32 state = (u32)b.read(h.max_bits);
  size_t k = 0;
  while (b.off > -h.max_bits) {
    if (k >= count) fail("Huffman stream longer than its literals");
    u8 nb = h.nbits[state];
    out[k++] = h.sym[state];
    state = ((state << nb) + (u32)b.read(nb)) & mask;
  }
  if (b.off != -h.max_bits || k != count) fail("Huffman stream size mismatch");
}

// ------------------------------------------------------------- sequences

const u32 LL_BASE[36] = {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,    10,   11,
                         12, 13, 14, 15, 16, 18, 20, 22, 24, 28,   32,   40,
                         48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const u8 LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                        1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const u32 ML_BASE[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16,
                         17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
                         31, 32, 33, 34, 35, 37, 39, 41, 43, 47, 51, 59, 67, 83,
                         99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const u8 ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                        0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                        2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
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
  u32 rep[3] = {1, 4, 8};
  u64 window = 0;
  size_t frame_start = 0;  // where this frame's output begins in `out`
};

// Reads one table of a sequences section; returns bytes used.
size_t seq_table(FseTable& t, int mode, const u8* p, size_t n, const int16_t* def, int ndef,
                 int def_log, int max_log, int max_sym) {
  switch (mode) {
    case 0: fse_build(t, def, ndef, def_log); return 0;
    case 1:
      if (n < 1) fail("truncated RLE sequence table");
      if (p[0] > max_sym) fail("RLE sequence symbol out of range");
      fse_rle(t, p[0]);
      return 1;
    case 2: return fse_read_table(t, p, n, max_log, max_sym);
    default:
      if (t.log < 0) fail("repeat sequence table with no previous table");
      return 0;
  }
}

void decode_compressed_block(FrameState& fs, const u8* p, size_t n, std::vector<u8>& out) {
  // literals section
  if (n < 1) fail("empty compressed block");
  const int ltype = p[0] & 3, sfmt = (p[0] >> 2) & 3;
  size_t regen = 0, csize = 0, hdr = 0;
  int nstreams = 1;
  if (ltype < 2) {
    if ((sfmt & 1) == 0) { hdr = 1; regen = p[0] >> 3; }
    else if (sfmt == 1) { hdr = 2; if (n < 2) fail("truncated literals header"); regen = (p[0] >> 4) + ((size_t)p[1] << 4); }
    else { hdr = 3; if (n < 3) fail("truncated literals header"); regen = (p[0] >> 4) + ((size_t)p[1] << 4) + ((size_t)p[2] << 12); }
  } else {
    hdr = sfmt < 2 ? 3 : (sfmt == 2 ? 4 : 5);
    if (n < hdr) fail("truncated literals header");
    u64 v = 0;
    for (size_t i = hdr; i-- > 0;) v = (v << 8) | p[i];
    int nb = sfmt < 2 ? 10 : (sfmt == 2 ? 14 : 18);
    regen = (size_t)((v >> 4) & ((1ULL << nb) - 1));
    csize = (size_t)((v >> (4 + nb)) & ((1ULL << nb) - 1));
    nstreams = sfmt == 0 ? 1 : 4;
  }
  if (regen > (128u << 10)) fail("literals larger than a block");
  std::vector<u8> lit(regen);
  size_t pos = hdr;
  if (ltype == 0) {
    if (pos + regen > n) fail("truncated raw literals");
    if (regen) std::memcpy(lit.data(), p + pos, regen);
    pos += regen;
  } else if (ltype == 1) {
    if (pos + 1 > n) fail("truncated RLE literals");
    std::memset(lit.data(), p[pos], regen);
    pos += 1;
  } else {
    if (pos + csize > n) fail("truncated compressed literals");
    const u8* q = p + pos;
    size_t qn = csize;
    if (ltype == 2) {
      size_t used = huf_read_table(fs.huf, q, qn);
      q += used; qn -= used;
    } else if (fs.huf.max_bits == 0) {
      fail("treeless literals with no previous Huffman table");
    }
    if (nstreams == 1) {
      huf_decode_stream(fs.huf, q, qn, lit.data(), regen);
    } else {
      if (qn < 6) fail("truncated literal jump table");
      size_t s1 = q[0] | (q[1] << 8), s2 = q[2] | (q[3] << 8), s3 = q[4] | (q[5] << 8);
      if (6 + s1 + s2 + s3 > qn) fail("literal streams exceed their section");
      size_t s4 = qn - 6 - s1 - s2 - s3;
      size_t per = (regen + 3) / 4;
      if (3 * per > regen) fail("too few literals for four streams");
      const u8* st = q + 6;
      huf_decode_stream(fs.huf, st, s1, lit.data(), per);
      huf_decode_stream(fs.huf, st + s1, s2, lit.data() + per, per);
      huf_decode_stream(fs.huf, st + s1 + s2, s3, lit.data() + 2 * per, per);
      huf_decode_stream(fs.huf, st + s1 + s2 + s3, s4, lit.data() + 3 * per, regen - 3 * per);
    }
    pos += csize;
  }

  // sequences section
  if (pos >= n) fail("truncated sequences section");
  size_t nseq = p[pos];
  if (nseq == 0) {
    pos += 1;
    if (pos != n) fail("bytes after a block's literals");
    out.insert(out.end(), lit.begin(), lit.end());
    return;
  }
  if (nseq < 128) { pos += 1; }
  else if (nseq < 255) { if (pos + 2 > n) fail("truncated sequence count"); nseq = ((nseq - 128) << 8) + p[pos + 1]; pos += 2; }
  else { if (pos + 3 > n) fail("truncated sequence count"); nseq = p[pos + 1] + ((size_t)p[pos + 2] << 8) + 0x7F00; pos += 3; }
  if (pos >= n) fail("truncated sequence modes");
  const u8 modes = p[pos++];
  if (modes & 3) fail("reserved sequence mode bits set");
  pos += seq_table(fs.ll, modes >> 6, p + pos, n - pos, LL_DEFAULT, 36, 6, 9, 35);
  pos += seq_table(fs.of, (modes >> 4) & 3, p + pos, n - pos, OF_DEFAULT, 29, 5, 8, 31);
  pos += seq_table(fs.ml, (modes >> 2) & 3, p + pos, n - pos, ML_DEFAULT, 53, 6, 9, 52);
  if (pos >= n) fail("sequences without a bitstream");
  BackBits b(p + pos, n - pos);
  FseState ll, of, ml;
  ll.init(fs.ll, b); of.init(fs.of, b); ml.init(fs.ml, b);
  size_t lp = 0;
  const size_t block_start = out.size();
  for (size_t i = 0; i < nseq; ++i) {
    u8 ofc = of.peek(), mlc = ml.peek(), llc = ll.peek();
    if (ofc > 31 || mlc > 52 || llc > 35) fail("sequence code out of range");
    u32 ofv = (u32)((1ULL << ofc) + b.read(ofc));
    u32 mlen = ML_BASE[mlc] + (u32)b.read(ML_BITS[mlc]);
    u32 llen = LL_BASE[llc] + (u32)b.read(LL_BITS[llc]);
    if (i + 1 < nseq) { ll.update(b); ml.update(b); of.update(b); }
    if (b.off < 0) fail("sequence bitstream overread");
    u32 offset;
    if (ofv > 3) {
      offset = ofv - 3;
      fs.rep[2] = fs.rep[1]; fs.rep[1] = fs.rep[0]; fs.rep[0] = offset;
    } else {
      u32 idx = ofv - 1 + (llen == 0 ? 1 : 0);
      if (idx == 0) {
        offset = fs.rep[0];
      } else {
        offset = idx < 3 ? fs.rep[idx] : fs.rep[0] - 1;
        if (idx > 1) fs.rep[2] = fs.rep[1];
        fs.rep[1] = fs.rep[0];
        fs.rep[0] = offset;
      }
    }
    if (lp + llen > regen) fail("sequence reads past the literals");
    out.insert(out.end(), lit.begin() + lp, lit.begin() + lp + llen);
    lp += llen;
    const size_t have = out.size() - fs.frame_start;
    if (offset == 0 || offset > have || offset > fs.window) fail("match offset out of the window");
    size_t from = out.size() - offset;
    out.resize(out.size() + mlen);
    u8* o = out.data();
    size_t to = out.size() - mlen;
    for (u32 k = 0; k < mlen; ++k) o[to + k] = o[from + k];
    if (out.size() - block_start > (128u << 10)) fail("block content larger than 128 KiB");
  }
  if (b.off != 0) fail("sequence bitstream not fully consumed");
  out.insert(out.end(), lit.begin() + lp, lit.end());
  if (out.size() - block_start > (128u << 10)) fail("block content larger than 128 KiB");
}

// Decodes one frame at p (magic included); returns the bytes it took.
size_t decode_frame(const u8* p, size_t n, std::vector<u8>& out) {
  if (n < 5) fail("truncated frame header");
  size_t pos = 4;
  const u8 fhd = p[pos++];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
            did_flag = fhd & 3;
  if (fhd & 8) fail("reserved frame header bit set");
  FrameState fs;
  fs.frame_start = out.size();
  u64 window = 0;
  if (!single) {
    if (pos >= n) fail("truncated frame header");
    u8 wd = p[pos++];
    int wlog = 10 + (wd >> 3);
    u64 wbase = 1ULL << wlog;
    window = wbase + (wbase / 8) * (wd & 7);
  }
  const int did_bytes[4] = {0, 1, 2, 4};
  if (pos + did_bytes[did_flag] > n) fail("truncated frame header");
  u32 did = 0;
  for (int i = did_bytes[did_flag]; i-- > 0;) did = (did << 8) | p[pos + i];
  pos += did_bytes[did_flag];
  if (did != 0) fail("frame needs a dictionary");
  const int fcs_bytes[4] = {single ? 1 : 0, 2, 4, 8};
  const int fb = fcs_bytes[fcs_flag];
  if (pos + fb > n) fail("truncated frame header");
  u64 fcs = 0;
  bool has_fcs = fb > 0;
  for (int i = fb; i-- > 0;) fcs = (fcs << 8) | p[pos + i];
  if (fb == 2) fcs += 256;
  pos += fb;
  if (single) window = fcs;
  fs.window = window;
  const u64 block_max = window < (128u << 10) ? window : (128u << 10);
  for (;;) {
    if (pos + 3 > n) fail("truncated block header");
    u32 bh = p[pos] | (p[pos + 1] << 8) | (p[pos + 2] << 16);
    pos += 3;
    const int last = bh & 1, btype = (bh >> 1) & 3;
    const size_t bsize = bh >> 3;
    if (btype == 3) fail("reserved block type");
    const size_t stored = btype == 1 ? 1 : bsize;
    if (pos + stored > n) fail("truncated block");
    if (bsize > block_max) fail("block larger than the frame allows");
    if (btype == 0) {
      out.insert(out.end(), p + pos, p + pos + bsize);
    } else if (btype == 1) {
      out.insert(out.end(), bsize, p[pos]);
    } else {
      decode_compressed_block(fs, p + pos, bsize, out);
    }
    pos += stored;
    if (has_fcs && out.size() - fs.frame_start > fcs) fail("frame content larger than declared");
    if (last) break;
  }
  const size_t got = out.size() - fs.frame_start;
  if (has_fcs && got != fcs) fail("frame content size mismatch");
  if (checksum) {
    if (pos + 4 > n) fail("truncated content checksum");
    u32 want = rd32(p + pos);
    u32 have = (u32)xxh64(out.data() + fs.frame_start, got, 0);
    if (want != have) fail("content checksum mismatch");
    pos += 4;
  }
  return pos;
}

void decompress(const u8* p, size_t n, std::vector<u8>& out) {
  if (n == 0) fail("no zstd frame");
  size_t pos = 0;
  while (pos < n) {
    if (n - pos < 4) fail("truncated frame magic");
    u32 magic = rd32(p + pos);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable frame
      if (n - pos < 8) fail("truncated skippable frame");
      u64 len = rd32(p + pos + 4);
      if (len > n - pos - 8) fail("truncated skippable frame");
      pos += 8 + len;
      continue;
    }
    if (magic != 0xFD2FB528u) fail("not a zstd frame");
    pos += decode_frame(p + pos, n - pos, out);
  }
}

void set_err(char* err, size_t errlen, const char* msg) {
  if (err && errlen) {
    std::strncpy(err, msg, errlen - 1);
    err[errlen - 1] = 0;
  }
}

}  // namespace

extern "C" {

// Decodes every frame of src into a malloc'd buffer (*out, *out_n; free it
// with dvc_zstd_free).  Returns 0, or -1 with the reason in err.
int dvc_zstd_decompress(const uint8_t* src, size_t n, uint8_t** out, size_t* out_n,
                        char* err, size_t errlen) {
  *out = nullptr;
  *out_n = 0;
  try {
    std::vector<u8> buf;
    decompress(src, n, buf);
    u8* mem = (u8*)std::malloc(buf.size() ? buf.size() : 1);
    if (!mem) { set_err(err, errlen, "out of memory"); return -1; }
    if (!buf.empty()) std::memcpy(mem, buf.data(), buf.size());
    *out = mem;
    *out_n = buf.size();
    return 0;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return -1;
  }
}

void dvc_zstd_free(uint8_t* p) { std::free(p); }

uint32_t dvc_crc32c(const uint8_t* p, size_t n, uint32_t crc) { return crc32c(p, n, crc); }

uint64_t dvc_xxh64(const uint8_t* p, size_t n, uint64_t seed) { return xxh64(p, n, seed); }

}  // extern "C"
