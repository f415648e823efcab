// dvc_flac — native FLAC decoder for the data-loading engine.
//
// The reference's LibriSpeech path decodes flac through librosa/soundfile
// (libsndfile C) at preprocessing/encoder/preprocess.py:141,150; neither is
// a dependency here.  This is a self-contained decoder for the FLAC subset
// every libFLAC encoder emits:
//   * STREAMINFO parsing, all other metadata blocks skipped;
//   * frames with UTF-8 coded frame numbers, all block-size/sample-rate
//     header codes;
//   * CONSTANT / VERBATIM / FIXED (orders 0-4) / LPC (any order) subframes,
//     wasted-bits, 4- and 5-bit Rice partitions with escape codes;
//   * channel assignments: independent, left/side, right/side, mid/side.
// CRCs and MD5 are not verified (frames are trusted); bit depths 8/16/24/32.
//
// A copy of dvc_tpu/native/dvc_flac.cpp for the PyTorch port.
//
// Exported C ABI (ctypes-bound in dvc_tpu_torch/native/flac.py):
//   dvc_flac_info(buf, n, &sample_rate, &channels, &total_samples)
//   dvc_flac_decode(buf, n, out, out_capacity)  -> samples written (mono,
//     channel-averaged float32 in [-1, 1]) or -1 on parse error.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte = 0;
  int bit = 0;  // bits consumed in current byte (0..7)
  bool error = false;

  BitReader(const uint8_t* d, size_t n) : data(d), size(n) {}

  bool eof() const { return byte >= size; }

  void align() {
    if (bit) {
      bit = 0;
      ++byte;
    }
  }

  uint32_t read_bit() {
    if (byte >= size) {
      error = true;
      return 0;
    }
    uint32_t v = (data[byte] >> (7 - bit)) & 1u;
    if (++bit == 8) {
      bit = 0;
      ++byte;
    }
    return v;
  }

  uint64_t read_bits(int n) {
    uint64_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | read_bit();
    return v;
  }

  int64_t read_signed(int n) {
    uint64_t v = read_bits(n);
    if (n > 0 && (v & (1ull << (n - 1)))) v -= (1ull << n);
    return static_cast<int64_t>(v);
  }

  uint32_t read_unary() {
    uint32_t q = 0;
    while (!error && read_bit() == 0) ++q;
    return q;
  }
};

int64_t zigzag(uint64_t v) {
  return static_cast<int64_t>(v >> 1) ^ -static_cast<int64_t>(v & 1);
}

// UTF-8-style coded number (frame/sample index) — up to 7 bytes.
bool read_utf8(BitReader& br, uint64_t* out) {
  uint32_t b0 = static_cast<uint32_t>(br.read_bits(8));
  if (br.error) return false;
  int extra;
  uint64_t v;
  if ((b0 & 0x80) == 0) {
    *out = b0;
    return true;
  } else if ((b0 & 0xE0) == 0xC0) {
    extra = 1;
    v = b0 & 0x1F;
  } else if ((b0 & 0xF0) == 0xE0) {
    extra = 2;
    v = b0 & 0x0F;
  } else if ((b0 & 0xF8) == 0xF0) {
    extra = 3;
    v = b0 & 0x07;
  } else if ((b0 & 0xFC) == 0xF8) {
    extra = 4;
    v = b0 & 0x03;
  } else if ((b0 & 0xFE) == 0xFC) {
    extra = 5;
    v = b0 & 0x01;
  } else if (b0 == 0xFE) {
    extra = 6;
    v = 0;
  } else {
    return false;
  }
  for (int i = 0; i < extra; ++i) {
    uint32_t b = static_cast<uint32_t>(br.read_bits(8));
    if (br.error || (b & 0xC0) != 0x80) return false;
    v = (v << 6) | (b & 0x3F);
  }
  *out = v;
  return true;
}

bool decode_residual(BitReader& br, int blocksize, int order,
                     std::vector<int64_t>& x) {
  uint32_t method = static_cast<uint32_t>(br.read_bits(2));
  if (method > 1) return false;
  int param_bits = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 0xF : 0x1F;
  uint32_t porder = static_cast<uint32_t>(br.read_bits(4));
  uint32_t n_part = 1u << porder;
  if (blocksize % n_part != 0) return false;
  int idx = order;
  for (uint32_t p = 0; p < n_part; ++p) {
    int count = blocksize >> porder;
    if (p == 0) count -= order;
    if (count < 0) return false;
    uint32_t param = static_cast<uint32_t>(br.read_bits(param_bits));
    if (param == escape) {
      int raw = static_cast<int>(br.read_bits(5));
      for (int i = 0; i < count; ++i)
        x[idx++] = raw ? br.read_signed(raw) : 0;
    } else {
      for (int i = 0; i < count; ++i) {
        uint32_t q = br.read_unary();
        uint64_t low = br.read_bits(param);
        x[idx++] = zigzag((static_cast<uint64_t>(q) << param) | low);
        if (br.error) return false;
      }
    }
  }
  return !br.error;
}

void restore_fixed(int order, std::vector<int64_t>& x) {
  int n = static_cast<int>(x.size());
  switch (order) {
    case 0:
      break;
    case 1:
      for (int i = 1; i < n; ++i) x[i] += x[i - 1];
      break;
    case 2:
      for (int i = 2; i < n; ++i) x[i] += 2 * x[i - 1] - x[i - 2];
      break;
    case 3:
      for (int i = 3; i < n; ++i)
        x[i] += 3 * x[i - 1] - 3 * x[i - 2] + x[i - 3];
      break;
    case 4:
      for (int i = 4; i < n; ++i)
        x[i] += 4 * x[i - 1] - 6 * x[i - 2] + 4 * x[i - 3] - x[i - 4];
      break;
    default:
      break;
  }
}

bool decode_subframe(BitReader& br, int blocksize, int bps,
                     std::vector<int64_t>& x) {
  x.assign(blocksize, 0);
  if (br.read_bit() != 0) return false;  // padding bit
  uint32_t type = static_cast<uint32_t>(br.read_bits(6));
  int wasted = 0;
  if (br.read_bit()) wasted = 1 + static_cast<int>(br.read_unary());
  int eff_bps = bps - wasted;
  if (eff_bps <= 0 || br.error) return false;

  if (type == 0) {  // CONSTANT
    int64_t v = br.read_signed(eff_bps);
    for (auto& s : x) s = v;
  } else if (type == 1) {  // VERBATIM
    for (auto& s : x) s = br.read_signed(eff_bps);
  } else if ((type & 0x38) == 0x08 && (type & 0x07) <= 4) {  // FIXED
    int order = type & 0x07;
    if (order > blocksize) return false;
    for (int i = 0; i < order; ++i) x[i] = br.read_signed(eff_bps);
    if (!decode_residual(br, blocksize, order, x)) return false;
    restore_fixed(order, x);
  } else if (type & 0x20) {  // LPC
    int order = (type & 0x1F) + 1;
    if (order > blocksize) return false;
    for (int i = 0; i < order; ++i) x[i] = br.read_signed(eff_bps);
    uint32_t prec = static_cast<uint32_t>(br.read_bits(4));
    if (prec == 0xF) return false;
    int precision = static_cast<int>(prec) + 1;
    int shift = static_cast<int>(br.read_signed(5));
    if (shift < 0) return false;
    std::vector<int64_t> coef(order);
    for (int i = 0; i < order; ++i) coef[i] = br.read_signed(precision);
    if (!decode_residual(br, blocksize, order, x)) return false;
    for (int i = order; i < blocksize; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += coef[j] * x[i - 1 - j];
      x[i] += pred >> shift;
    }
  } else {
    return false;
  }
  if (wasted)
    for (auto& s : x) s <<= wasted;
  return !br.error;
}

struct StreamInfo {
  uint32_t sample_rate = 0;
  int channels = 0;
  int bps = 0;
  uint64_t total_samples = 0;
  size_t frames_offset = 0;  // byte offset of the first audio frame
};

bool parse_streaminfo(const uint8_t* data, size_t n, StreamInfo* si) {
  if (n < 42 || std::memcmp(data, "fLaC", 4) != 0) return false;
  size_t pos = 4;
  bool have_info = false;
  while (pos + 4 <= n) {
    uint8_t hdr = data[pos];
    bool last = hdr & 0x80;
    int type = hdr & 0x7F;
    uint32_t len = (static_cast<uint32_t>(data[pos + 1]) << 16) |
                   (static_cast<uint32_t>(data[pos + 2]) << 8) |
                   data[pos + 3];
    pos += 4;
    if (pos + len > n) return false;
    if (type == 0 && len >= 34) {
      BitReader br(data + pos, len);
      br.read_bits(16);  // min block size
      br.read_bits(16);  // max block size
      br.read_bits(24);  // min frame size
      br.read_bits(24);  // max frame size
      si->sample_rate = static_cast<uint32_t>(br.read_bits(20));
      si->channels = static_cast<int>(br.read_bits(3)) + 1;
      si->bps = static_cast<int>(br.read_bits(5)) + 1;
      si->total_samples = br.read_bits(36);
      have_info = true;
    }
    pos += len;
    if (last) break;
  }
  si->frames_offset = pos;
  return have_info && si->sample_rate > 0 && si->channels >= 1 &&
         si->channels <= 8;
}

const int kBlockSizes[16] = {0,    192,  576,  1152, 2304, 4608, -1,  -2,
                             256,  512,  1024, 2048, 4096, 8192, 16384,
                             32768};

}  // namespace

extern "C" {

int dvc_flac_info(const uint8_t* data, long n, int* sample_rate,
                  int* channels, long* total_samples) {
  StreamInfo si;
  if (!parse_streaminfo(data, static_cast<size_t>(n), &si)) return -1;
  *sample_rate = static_cast<int>(si.sample_rate);
  *channels = si.channels;
  *total_samples = static_cast<long>(si.total_samples);
  return 0;
}

// Decode all frames, average channels to mono float32.  Returns the number
// of samples written (<= capacity) or -1 on error.
long dvc_flac_decode(const uint8_t* data, long n, float* out, long capacity) {
  StreamInfo si;
  if (!parse_streaminfo(data, static_cast<size_t>(n), &si)) return -1;
  BitReader br(data, static_cast<size_t>(n));
  br.byte = si.frames_offset;

  long written = 0;
  std::vector<std::vector<int64_t>> ch(si.channels);

  while (true) {
    br.align();
    // tolerate trailing padding: stop at EOF
    if (br.byte >= br.size) break;
    uint32_t sync = static_cast<uint32_t>(br.read_bits(14));
    if (br.error) break;
    if (sync != 0x3FFE) return written > 0 ? written : -1;
    br.read_bit();                      // reserved
    br.read_bit();                      // blocking strategy
    uint32_t bs_code = static_cast<uint32_t>(br.read_bits(4));
    uint32_t sr_code = static_cast<uint32_t>(br.read_bits(4));
    uint32_t ch_code = static_cast<uint32_t>(br.read_bits(4));
    uint32_t ss_code = static_cast<uint32_t>(br.read_bits(3));
    br.read_bit();                      // reserved
    uint64_t frame_no;
    if (!read_utf8(br, &frame_no)) return -1;

    int blocksize;
    if (bs_code == 6)
      blocksize = static_cast<int>(br.read_bits(8)) + 1;
    else if (bs_code == 7)
      blocksize = static_cast<int>(br.read_bits(16)) + 1;
    else if (bs_code == 0)
      return -1;
    else
      blocksize = kBlockSizes[bs_code];

    if (sr_code == 12) br.read_bits(8);
    else if (sr_code == 13 || sr_code == 14) br.read_bits(16);
    br.read_bits(8);  // header CRC-8 (unchecked)

    int bps = si.bps;
    switch (ss_code) {  // per-frame bps override
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      case 7: bps = 32; break;
      default: break;
    }

    int n_ch;
    int assignment = 0;  // 0=independent, 1=L/S, 2=R/S, 3=M/S
    if (ch_code < 8) {
      n_ch = static_cast<int>(ch_code) + 1;
    } else if (ch_code <= 10) {
      n_ch = 2;
      assignment = static_cast<int>(ch_code) - 7;
    } else {
      return -1;
    }
    if (n_ch != si.channels) return -1;

    for (int c = 0; c < n_ch; ++c) {
      int sub_bps = bps;
      // the side channel carries one extra bit
      if ((assignment == 1 && c == 1) || (assignment == 2 && c == 0) ||
          (assignment == 3 && c == 1))
        sub_bps += 1;
      if (!decode_subframe(br, blocksize, sub_bps, ch[c])) return -1;
    }
    br.align();
    br.read_bits(16);  // frame CRC-16 (unchecked)
    if (br.error) return -1;

    // undo stereo decorrelation
    if (assignment == 1) {  // left/side: right = left - side
      for (int i = 0; i < blocksize; ++i) ch[1][i] = ch[0][i] - ch[1][i];
    } else if (assignment == 2) {  // right/side: left = right + side
      for (int i = 0; i < blocksize; ++i) ch[0][i] = ch[1][i] + ch[0][i];
    } else if (assignment == 3) {  // mid/side
      for (int i = 0; i < blocksize; ++i) {
        int64_t mid = ch[0][i], side = ch[1][i];
        int64_t left = ((mid << 1) | (side & 1)) + side;
        ch[0][i] = left >> 1;
        ch[1][i] = (left - (side << 1)) >> 1;
      }
    }

    // scale by the FRAME's bit depth: a spec-legal frame may override
    // STREAMINFO's bps (ss_code), and its samples are integers at that
    // width — scaling by si.bps would mis-gain such frames by 2^(diff)
    const double scale = 1.0 / static_cast<double>(1ll << (bps - 1));
    for (int i = 0; i < blocksize && written < capacity; ++i, ++written) {
      double acc = 0.0;
      for (int c = 0; c < si.channels; ++c)
        acc += static_cast<double>(ch[c][i]);
      out[written] = static_cast<float>(acc / si.channels * scale);
    }
    if (si.total_samples &&
        written >= static_cast<long>(si.total_samples))
      break;
    if (written >= capacity) break;
  }
  return written;
}

}  // extern "C"
