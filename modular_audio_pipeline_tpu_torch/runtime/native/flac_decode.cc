// Native FLAC decoder (no FFmpeg, no third-party code).
//
// Lossless compressed ingest without an ffmpeg binary. Scope: the full FLAC bitstream as commonly produced --
// CONSTANT / VERBATIM / FIXED(0-4) / LPC subframes, RICE and RICE2
// residual coding with escape partitions, independent + left/right/mid
// side stereo decorrelation, 8..32-bit sample sizes, wasted bits, both
// blocking strategies. Frame CRC-16 is verified.
//
// C ABI (ctypes from runtime/native_lib.py):
//   flac_probe(data, len, &sr, &ch, &bps, &total)   -> 0 | negative error
//   flac_decode(data, len, out_i32, capacity, &sr, &ch, &bps)
//       -> samples written (interleaved), or negative error

#include <cstdint>
#include <cstring>

namespace {

constexpr int64_t ERR_NOT_FLAC = -1;
constexpr int64_t ERR_TRUNCATED = -2;
constexpr int64_t ERR_BAD_STREAM = -3;
constexpr int64_t ERR_CAPACITY = -4;
constexpr int64_t ERR_CRC = -5;

struct BitReader {
  const uint8_t* data;
  int64_t len;       // bytes
  int64_t byte = 0;  // next byte index
  int bit = 0;       // bits consumed of data[byte] (0..7), MSB first
  bool overrun = false;

  explicit BitReader(const uint8_t* d, int64_t n) : data(d), len(n) {}

  bool at_byte_boundary() const { return bit == 0; }

  void align() {
    if (bit) {
      bit = 0;
      ++byte;
    }
  }

  uint64_t bits(int n) {  // n <= 57
    uint64_t v = 0;
    while (n > 0) {
      if (byte >= len) {
        overrun = true;
        return 0;
      }
      int avail = 8 - bit;
      int take = n < avail ? n : avail;
      int shift = avail - take;
      v = (v << take) | ((data[byte] >> shift) & ((1u << take) - 1));
      bit += take;
      n -= take;
      if (bit == 8) {
        bit = 0;
        ++byte;
      }
    }
    return v;
  }

  int64_t sbits(int n) {  // two's-complement signed read
    if (n == 0) return 0;
    uint64_t v = bits(n);
    uint64_t sign = 1ull << (n - 1);
    return (v & sign) ? (int64_t)(v | ~((sign << 1) - 1)) : (int64_t)v;
  }

  uint32_t unary() {  // count 0s until the terminating 1
    uint32_t q = 0;
    for (;;) {
      if (byte >= len) {
        overrun = true;
        return q;
      }
      // fast path: whole remaining byte is zeros
      uint8_t cur = (uint8_t)(data[byte] << bit);
      if (cur == 0) {
        q += 8 - bit;
        bit = 0;
        ++byte;
        continue;
      }
      // leading zeros within this byte
      int lz = 0;
      while (!(cur & 0x80)) {
        cur <<= 1;
        ++lz;
      }
      q += lz;
      bit += lz + 1;  // consume zeros + the 1
      if (bit >= 8) {
        bit -= 8;
        ++byte;
      }
      return q;
    }
  }
};

// CRC-8 poly 0x07 over [start, end) bytes.
uint8_t crc8(const uint8_t* d, int64_t n) {
  uint8_t crc = 0;
  for (int64_t i = 0; i < n; ++i) {
    crc ^= d[i];
    for (int k = 0; k < 8; ++k)
      crc = (crc & 0x80) ? (uint8_t)((crc << 1) ^ 0x07) : (uint8_t)(crc << 1);
  }
  return crc;
}

// CRC-16 poly 0x8005 (x^16+x^15+x^2+1), init 0.
uint16_t crc16(const uint8_t* d, int64_t n) {
  uint16_t crc = 0;
  for (int64_t i = 0; i < n; ++i) {
    crc ^= (uint16_t)d[i] << 8;
    for (int k = 0; k < 8; ++k)
      crc = (crc & 0x8000) ? (uint16_t)((crc << 1) ^ 0x8005)
                           : (uint16_t)(crc << 1);
  }
  return crc;
}

// FLAC's extended UTF-8-style coded number (frame/sample index).
int64_t coded_number(BitReader& br) {
  uint64_t b0 = br.bits(8);
  if (b0 < 0x80) return (int64_t)b0;
  int n = 0;
  uint8_t mask = 0x40;
  while (b0 & mask) {
    ++n;
    mask >>= 1;
  }
  if (n == 0 || n > 6) return -1;
  uint64_t v = b0 & (mask - 1);
  for (int i = 0; i < n; ++i) {
    uint64_t c = br.bits(8);
    if ((c & 0xC0) != 0x80) return -1;
    v = (v << 6) | (c & 0x3F);
  }
  return (int64_t)v;
}

struct StreamInfo {
  int32_t sample_rate = 0;
  int32_t channels = 0;
  int32_t bps = 0;
  int64_t total_samples = 0;  // per channel; 0 = unknown
};

// Parses "fLaC" + metadata blocks; returns offset of the first frame or
// a negative error.
int64_t parse_header(const uint8_t* data, int64_t len, StreamInfo* si) {
  int64_t pos = 0;
  // tolerate an ID3v2 tag prefix (some taggers add one)
  if (len >= 10 && !memcmp(data, "ID3", 3)) {
    int64_t sz = ((int64_t)(data[6] & 0x7F) << 21) |
                 ((int64_t)(data[7] & 0x7F) << 14) |
                 ((int64_t)(data[8] & 0x7F) << 7) | (data[9] & 0x7F);
    pos = 10 + sz;
  }
  if (pos + 4 > len || memcmp(data + pos, "fLaC", 4)) return ERR_NOT_FLAC;
  pos += 4;

  bool last = false;
  bool have_si = false;
  while (!last) {
    if (pos + 4 > len) return ERR_TRUNCATED;
    last = data[pos] & 0x80;
    int type = data[pos] & 0x7F;
    int64_t blen =
        ((int64_t)data[pos + 1] << 16) | (data[pos + 2] << 8) | data[pos + 3];
    pos += 4;
    if (pos + blen > len) return ERR_TRUNCATED;
    if (type == 0 && blen >= 34) {  // STREAMINFO
      const uint8_t* p = data + pos;
      si->sample_rate = (p[10] << 12) | (p[11] << 4) | (p[12] >> 4);
      si->channels = ((p[12] >> 1) & 0x07) + 1;
      si->bps = (((p[12] & 1) << 4) | (p[13] >> 4)) + 1;
      si->total_samples = ((int64_t)(p[13] & 0x0F) << 32) |
                          ((int64_t)p[14] << 24) | ((int64_t)p[15] << 16) |
                          ((int64_t)p[16] << 8) | p[17];
      have_si = true;
    }
    pos += blen;
  }
  if (!have_si || si->sample_rate <= 0 || si->channels <= 0) {
    return ERR_BAD_STREAM;
  }
  return pos;
}

// Decodes one subframe into ch_buf[0..blocksize). bps already includes
// the +1 for side channels. Returns false on malformed input.
bool decode_subframe(BitReader& br, int64_t* buf, int blocksize, int bps) {
  if (br.bits(1) != 0) return false;  // mandatory zero pad bit
  int type = (int)br.bits(6);
  int wasted = 0;
  if (br.bits(1)) wasted = (int)br.unary() + 1;
  int eff = bps - wasted;
  if (eff <= 0 || eff > 33) return false;

  int order = 0;
  bool is_lpc = false;
  if (type == 0) {  // CONSTANT
    int64_t v = br.sbits(eff);
    for (int i = 0; i < blocksize; ++i) buf[i] = v;
    order = -1;
  } else if (type == 1) {  // VERBATIM
    for (int i = 0; i < blocksize; ++i) buf[i] = br.sbits(eff);
    order = -1;
  } else if (type >= 8 && type <= 12) {  // FIXED
    order = type - 8;
  } else if (type >= 32) {  // LPC
    order = type - 31;
    is_lpc = true;
  } else {
    return false;
  }

  if (order >= 0) {
    if (order > blocksize) return false;
    for (int i = 0; i < order; ++i) buf[i] = br.sbits(eff);

    int precision = 0, shift = 0;
    int64_t coefs[32];
    if (is_lpc) {
      precision = (int)br.bits(4) + 1;
      if (precision == 16) return false;  // 0b1111 invalid
      shift = (int)br.sbits(5);
      if (shift < 0) return false;
      for (int i = 0; i < order; ++i) coefs[i] = br.sbits(precision);
    }

    // residual
    int method = (int)br.bits(2);
    if (method > 1) return false;
    int plen = method == 0 ? 4 : 5;
    int escape = method == 0 ? 0x0F : 0x1F;
    int porder = (int)br.bits(4);
    int nparts = 1 << porder;
    if ((blocksize >> porder) << porder != blocksize) return false;
    int idx = order;
    for (int part = 0; part < nparts; ++part) {
      int count = (blocksize >> porder) - (part == 0 ? order : 0);
      if (count < 0) return false;
      int param = (int)br.bits(plen);
      if (param == escape) {
        int raw = (int)br.bits(5);
        for (int i = 0; i < count; ++i) buf[idx++] = br.sbits(raw);
      } else {
        for (int i = 0; i < count; ++i) {
          uint64_t q = br.unary();
          uint64_t r = param ? br.bits(param) : 0;
          uint64_t u = (q << param) | r;
          buf[idx++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
        }
      }
      if (br.overrun) return false;
    }

    // prediction
    if (is_lpc) {
      for (int i = order; i < blocksize; ++i) {
        int64_t acc = 0;
        for (int j = 0; j < order; ++j) acc += coefs[j] * buf[i - 1 - j];
        buf[i] += acc >> shift;
      }
    } else {
      switch (order) {
        case 0:
          break;
        case 1:
          for (int i = 1; i < blocksize; ++i) buf[i] += buf[i - 1];
          break;
        case 2:
          for (int i = 2; i < blocksize; ++i)
            buf[i] += 2 * buf[i - 1] - buf[i - 2];
          break;
        case 3:
          for (int i = 3; i < blocksize; ++i)
            buf[i] += 3 * buf[i - 1] - 3 * buf[i - 2] + buf[i - 3];
          break;
        case 4:
          for (int i = 4; i < blocksize; ++i)
            buf[i] +=
                4 * buf[i - 1] - 6 * buf[i - 2] + 4 * buf[i - 3] - buf[i - 4];
          break;
      }
    }
  }

  if (wasted) {
    for (int i = 0; i < blocksize; ++i) buf[i] <<= wasted;
  }
  return !br.overrun;
}

constexpr int kMaxChannels = 8;
constexpr int kMaxBlock = 65535;

}  // namespace

extern "C" {

int64_t flac_probe(const uint8_t* data, int64_t len, int32_t* sample_rate,
                   int32_t* channels, int32_t* bps, int64_t* total_samples) {
  StreamInfo si;
  int64_t r = parse_header(data, len, &si);
  if (r < 0) return r;
  *sample_rate = si.sample_rate;
  *channels = si.channels;
  *bps = si.bps;
  *total_samples = si.total_samples;
  return 0;
}

int64_t flac_decode(const uint8_t* data, int64_t len, int32_t* out,
                    int64_t capacity, int32_t* sample_rate, int32_t* channels,
                    int32_t* bps) {
  StreamInfo si;
  int64_t pos = parse_header(data, len, &si);
  if (pos < 0) return pos;
  if (si.channels > kMaxChannels) return ERR_BAD_STREAM;
  *sample_rate = si.sample_rate;
  *channels = si.channels;
  *bps = si.bps;

  static thread_local int64_t chan[kMaxChannels][kMaxBlock];

  int64_t written = 0;  // interleaved samples
  BitReader br(data, len);
  br.byte = pos;

  while (br.byte < len) {
    int64_t frame_start = br.byte;
    // sync: 14 bits 0b11111111111110
    if ((uint32_t)br.bits(14) != 0x3FFE) {
      if (br.overrun) break;  // clean EOF after last frame
      return ERR_BAD_STREAM;
    }
    br.bits(1);  // reserved
    br.bits(1);  // blocking strategy
    int bs_code = (int)br.bits(4);
    int sr_code = (int)br.bits(4);
    int ch_code = (int)br.bits(4);
    int ss_code = (int)br.bits(3);
    br.bits(1);  // reserved
    if (coded_number(br) < 0) return ERR_BAD_STREAM;

    int blocksize;
    switch (bs_code) {
      case 0: return ERR_BAD_STREAM;
      case 1: blocksize = 192; break;
      case 6: blocksize = (int)br.bits(8) + 1; break;
      case 7: blocksize = (int)br.bits(16) + 1; break;
      default:
        blocksize = bs_code < 8 ? 576 << (bs_code - 2) : 256 << (bs_code - 8);
    }
    if (blocksize > kMaxBlock) return ERR_BAD_STREAM;

    switch (sr_code) {  // value unused beyond consuming trailing fields
      case 12: br.bits(8); break;
      case 13: case 14: br.bits(16); break;
      case 15: return ERR_BAD_STREAM;
      default: break;
    }

    int nch = ch_code < 8 ? ch_code + 1 : 2;
    if (ch_code > 10 || nch != si.channels) return ERR_BAD_STREAM;

    static const int kSampleSize[8] = {0, 8, 12, -1, 16, 20, 24, 32};
    int bits_ps = ss_code == 0 ? si.bps : kSampleSize[ss_code];
    if (bits_ps <= 0) return ERR_BAD_STREAM;

    // header CRC-8 covers sync..just before the crc byte
    int64_t hdr_end = br.byte;  // byte-aligned here
    if (!br.at_byte_boundary()) return ERR_BAD_STREAM;
    uint8_t expect8 = (uint8_t)br.bits(8);
    if (crc8(data + frame_start, hdr_end - frame_start) != expect8) {
      return ERR_CRC;
    }

    for (int c = 0; c < nch; ++c) {
      int sub_bps = bits_ps;
      if ((ch_code == 8 && c == 1) ||   // left/side
          (ch_code == 9 && c == 0) ||   // right/side (side first)
          (ch_code == 10 && c == 1)) {  // mid/side
        sub_bps += 1;
      }
      if (!decode_subframe(br, chan[c], blocksize, sub_bps)) {
        return br.overrun ? ERR_TRUNCATED : ERR_BAD_STREAM;
      }
    }

    br.align();
    int64_t frame_end = br.byte;
    uint16_t expect16 = (uint16_t)br.bits(16);
    if (br.overrun) return ERR_TRUNCATED;
    if (crc16(data + frame_start, frame_end - frame_start) != expect16) {
      return ERR_CRC;
    }

    // stereo decorrelation
    if (ch_code == 8) {  // left/side: right = left - side
      for (int i = 0; i < blocksize; ++i) {
        chan[1][i] = chan[0][i] - chan[1][i];
      }
    } else if (ch_code == 9) {  // right/side: left = right + side
      for (int i = 0; i < blocksize; ++i) {
        chan[0][i] = chan[1][i] + chan[0][i];
      }
    } else if (ch_code == 10) {  // mid/side
      for (int i = 0; i < blocksize; ++i) {
        int64_t side = chan[1][i];
        int64_t mid = (chan[0][i] << 1) | (side & 1);
        chan[0][i] = (mid + side) >> 1;
        chan[1][i] = (mid - side) >> 1;
      }
    }

    if (written + (int64_t)blocksize * nch > capacity) return ERR_CAPACITY;
    for (int i = 0; i < blocksize; ++i) {
      for (int c = 0; c < nch; ++c) {
        out[written++] = (int32_t)chan[c][i];
      }
    }
  }

  return written;
}

}  // extern "C"
