// First-party MPEG-1 Layer III (MP3) decoder for the host runtime.
//
// Decodes the pipeline's primary ingest format without an ffmpeg binary.
// Written from the ISO 11172-3 behaviour: all constant tables (Huffman
// codes, scale-factor bands, slen pairs, pretab, the synthesis window,
// short-block maps) were re-derived empirically from libmpg123 with
// crafted probe frames (tools/derive_mp3_tables.py,
// tools/derive_mp3_aux.py).
//
// Scope: MPEG-1 Layer III (32/44.1/48 kHz) plus the MPEG-2/2.5 LSF
// extensions (16/22.05/24 and 8/11.025/12 kHz, one granule per frame,
// 9-bit scalefac_compress layouts), mono/stereo/joint stereo with both
// MS and intensity stereo (ratio laws measured from libmpg123:
// tools/derive_mp3_lsf.py), long + short + start/stop + mixed blocks,
// bit reservoir, CBR and VBR streams, ID3v2/ID3v1 tag skipping.
//
// Entry points (ctypes, see runtime/native_lib.py):
//   mp3_probe(data, n, *sr, *channels, *approx_samples) -> 0 | error
//   mp3_decode(data, n, out, capacity, *sr, *channels) -> samples | error

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include "mp3_huffman_tables.h"
#include "mp3_tables_aux.h"
#include "mp3_tables_lsf.h"

namespace {

constexpr int64_t kErrNotMp3 = -1;
constexpr int64_t kErrTruncated = -2;
constexpr int64_t kErrMalformed = -3;
constexpr int64_t kErrCapacity = -4;
constexpr int64_t kErrUnsupported = -6;

// ---------------------------------------------------------------------------
// Bit reader over a byte buffer
// ---------------------------------------------------------------------------

struct BitReader {
  const uint8_t* data = nullptr;
  size_t nbits = 0;
  size_t pos = 0;

  BitReader(const uint8_t* d, size_t nbytes) : data(d), nbits(nbytes * 8) {}

  int bit() {
    if (pos >= nbits) {
      ++pos;  // reads past the end yield zeros (reservoir padding)
      return 0;
    }
    int b = (data[pos >> 3] >> (7 - (pos & 7))) & 1;
    ++pos;
    return b;
  }

  uint32_t bits(int k) {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i) v = (v << 1) | bit();
    return v;
  }

  void skip(size_t k) { pos += k; }
};

// ---------------------------------------------------------------------------
// Huffman decoding (tries built once from the derived code tables)
// ---------------------------------------------------------------------------

struct HuffTree {
  // nodes[i][b]: >=0 child index; < 0 => ~value is the entry index
  std::vector<int32_t> nodes;  // 2 per node
  bool built = false;

  void add(uint32_t code, int len, int32_t entry) {
    if (nodes.empty()) nodes.assign(2, 0);
    int32_t node = 0;
    for (int i = len - 1; i >= 0; --i) {
      int b = (code >> i) & 1;
      const size_t at = size_t(node) * 2 + size_t(b);
      if (i == 0) {
        nodes[at] = ~entry;
        return;
      }
      if (nodes[at] == 0) {
        // resize first: a reference into nodes would dangle across it
        nodes[at] = static_cast<int32_t>(nodes.size() / 2);
        nodes.resize(nodes.size() + 2, 0);
      }
      node = nodes[at];
    }
  }

  // returns entry index, or -1 on a dead branch
  int32_t decode(BitReader& br) const {
    int32_t node = 0;
    for (int depth = 0; depth < 24; ++depth) {
      int32_t slot = nodes[node * 2 + br.bit()];
      if (slot < 0) return ~slot;
      if (slot == 0) return -1;
      node = slot;
    }
    return -1;
  }
};

struct PairTable {
  const mp3tab::HuffEntry* entries = nullptr;
  int n = 0;
  int linbits = 0;
  HuffTree tree;
};

PairTable g_pair_tables[32];
HuffTree g_count1_a;
bool g_tables_ready = false;

void register_table(int id, const mp3tab::HuffEntry* e, int n, int lb) {
  g_pair_tables[id].entries = e;
  g_pair_tables[id].n = n;
  g_pair_tables[id].linbits = lb;
  for (int i = 0; i < n; ++i) {
    g_pair_tables[id].tree.add(e[i].code, e[i].len, i);
  }
}

void init_tables() {
  if (g_tables_ready) return;
#define REG(ID) register_table(ID, mp3tab::kTable##ID, \
    int(sizeof(mp3tab::kTable##ID) / sizeof(mp3tab::HuffEntry)), \
    mp3tab::kLinbits##ID)
  REG(1); REG(2); REG(3); REG(5); REG(6); REG(7); REG(8); REG(9);
  REG(10); REG(11); REG(12); REG(13); REG(15); REG(16); REG(17);
  REG(18); REG(19); REG(20); REG(21); REG(22); REG(23); REG(24);
  REG(25); REG(26); REG(27); REG(28); REG(29); REG(30); REG(31);
#undef REG
  for (int i = 0; i < 16; ++i) {
    g_count1_a.add(mp3tab::kCount1A[i].code, mp3tab::kCount1A[i].len, i);
  }
  g_tables_ready = true;
}

// ---------------------------------------------------------------------------
// Header / side info
// ---------------------------------------------------------------------------

constexpr int kBitrates[] = {0, 32, 40, 48, 56, 64, 80, 96, 112,
                             128, 160, 192, 224, 256, 320, 0};
// MPEG-2/2.5 Layer III (LSF) bitrate ladder
constexpr int kBitratesLsf[] = {0, 8, 16, 24, 32, 40, 48, 56, 64,
                                80, 96, 112, 128, 144, 160, 0};
constexpr int kRates[] = {44100, 48000, 32000, 0};

struct Header {
  int bitrate_kbps = 0;
  int samplerate = 0;
  int padding = 0;
  int channels = 0;
  int mode = 0;       // 0 stereo, 1 joint, 2 dual, 3 mono
  int mode_ext = 0;
  bool crc = false;
  bool lsf = false;   // MPEG-2 / MPEG-2.5 low-sample-rate extension
  int frame_bytes = 0;
  int side_bytes = 0;
  int granules = 2;   // 1 for LSF
};

// returns true when the 4 bytes at p are a valid Layer III header
// (MPEG-1, MPEG-2 or MPEG-2.5 — LSF streams carry one granule/frame)
bool parse_header(const uint8_t* p, Header* h) {
  if (p[0] != 0xFF || (p[1] & 0xE0) != 0xE0) return false;
  int version = (p[1] >> 3) & 3;   // 3 = MPEG-1, 2 = MPEG-2, 0 = MPEG-2.5
  int layer = (p[1] >> 1) & 3;     // 1 = Layer III
  if (version == 1 || layer != 1) return false;
  int br_idx = (p[2] >> 4) & 0xF;
  int sr_idx = (p[2] >> 2) & 3;
  if (br_idx == 0 || br_idx == 15 || sr_idx == 3) return false;
  h->lsf = version != 3;
  h->crc = ((p[1] & 1) == 0);
  h->bitrate_kbps = (h->lsf ? kBitratesLsf : kBitrates)[br_idx];
  int sr = kRates[sr_idx];
  if (version == 2) sr /= 2;       // MPEG-2: 22.05/24/16 kHz
  if (version == 0) sr /= 4;       // MPEG-2.5: 11.025/12/8 kHz
  h->samplerate = sr;
  h->padding = (p[2] >> 1) & 1;
  h->mode = (p[3] >> 6) & 3;
  h->mode_ext = (p[3] >> 4) & 3;
  h->channels = (h->mode == 3) ? 1 : 2;
  h->granules = h->lsf ? 1 : 2;
  h->frame_bytes = (h->lsf ? 72000 : 144000) * h->bitrate_kbps
                   / h->samplerate + h->padding;
  if (h->lsf) {
    h->side_bytes = (h->channels == 1) ? 9 : 17;
  } else {
    h->side_bytes = (h->channels == 1) ? 17 : 32;
  }
  return true;
}

struct GranuleInfo {
  int part2_3_length = 0;
  int big_values = 0;
  int global_gain = 0;
  int scalefac_compress = 0;
  bool window_switching = false;
  int block_type = 0;
  bool mixed_block = false;
  int table_select[3] = {0, 0, 0};
  int subblock_gain[3] = {0, 0, 0};
  int region0_count = 0;
  int region1_count = 0;
  bool preflag = false;
  bool scalefac_scale = false;
  int count1table_select = 0;
};

struct SideInfo {
  int main_data_begin = 0;
  int scfsi[2] = {0, 0};  // per channel, 4 bits
  GranuleInfo gr[2][2];   // [granule][channel]
};

bool parse_side_info(BitReader& br, const Header& h, SideInfo* si) {
  const int channels = h.channels;
  // LSF: 8-bit main_data_begin, 1|2 private bits, no scfsi, ONE granule;
  // the granule layout also drops the preflag bit and widens
  // scalefac_compress to 9 bits.
  si->main_data_begin = int(br.bits(h.lsf ? 8 : 9));
  if (h.lsf) {
    br.skip(channels == 1 ? 1 : 2);
  } else {
    br.skip(channels == 1 ? 5 : 3);  // private bits
    for (int ch = 0; ch < channels; ++ch) si->scfsi[ch] = int(br.bits(4));
  }
  for (int g = 0; g < h.granules; ++g) {
    for (int ch = 0; ch < channels; ++ch) {
      GranuleInfo& gi = si->gr[g][ch];
      gi.part2_3_length = int(br.bits(12));
      gi.big_values = int(br.bits(9));
      gi.global_gain = int(br.bits(8));
      gi.scalefac_compress = int(br.bits(h.lsf ? 9 : 4));
      gi.window_switching = br.bit() != 0;
      if (gi.window_switching) {
        gi.block_type = int(br.bits(2));
        gi.mixed_block = br.bit() != 0;
        for (int r = 0; r < 2; ++r) gi.table_select[r] = int(br.bits(5));
        for (int w = 0; w < 3; ++w) gi.subblock_gain[w] = int(br.bits(3));
        if (gi.block_type == 0) return false;  // forbidden
      } else {
        for (int r = 0; r < 3; ++r) gi.table_select[r] = int(br.bits(5));
        gi.region0_count = int(br.bits(4));
        gi.region1_count = int(br.bits(3));
        gi.block_type = 0;
      }
      gi.preflag = h.lsf ? false : (br.bit() != 0);
      gi.scalefac_scale = br.bit() != 0;
      gi.count1table_select = br.bit();
      if (gi.big_values > 288) return false;
    }
  }
  return true;
}

// ---------------------------------------------------------------------------
// Rate-dependent tables
// ---------------------------------------------------------------------------

struct RateTables {
  const int16_t* sfb_long;    // 23 edges
  const int16_t* sfb_short;   // 14 edges (line domain)
  const uint16_t* short_map;  // is index -> sb*18 + win*6 + line
  int ws_region0_short;       // region0 end (is domain) for block_type 2
  int ws_region0_long;        // region0 end (lines) for block_type 1/3
  bool lsf;                   // MPEG-2 / MPEG-2.5 rate
};

bool rate_tables(int sr, RateTables* rt) {
  rt->lsf = false;
  switch (sr) {
    case 44100:
      rt->sfb_long = mp3tab::kSfbLong44;
      rt->sfb_short = mp3tab::kSfbShort44;
      rt->short_map = mp3tab::kShortMap44;
      rt->ws_region0_short = mp3tab::kWsRegion0Short44;
      rt->ws_region0_long = mp3tab::kSfbLong44[mp3tab::kWsRegion0LongBand];
      return true;
    case 48000:
      rt->sfb_long = mp3tab::kSfbLong48;
      rt->sfb_short = mp3tab::kSfbShort48;
      rt->short_map = mp3tab::kShortMap48;
      rt->ws_region0_short = mp3tab::kWsRegion0Short48;
      rt->ws_region0_long = mp3tab::kSfbLong48[mp3tab::kWsRegion0LongBand];
      return true;
    case 32000:
      rt->sfb_long = mp3tab::kSfbLong32;
      rt->sfb_short = mp3tab::kSfbShort32;
      rt->short_map = mp3tab::kShortMap32;
      rt->ws_region0_short = mp3tab::kWsRegion0Short32;
      rt->ws_region0_long = mp3tab::kSfbLong32[mp3tab::kWsRegion0LongBand];
      return true;
  }
  // LSF rates (derived behaviourally, tools/derive_mp3_lsf.py)
  rt->lsf = true;
#define MAP_LSF_RATE(hz, sfx)                                   \
  case hz:                                                      \
    rt->sfb_long = mp3tab::kSfbLongLsf##sfx;                    \
    rt->sfb_short = mp3tab::kSfbShortLsf##sfx;                  \
    rt->short_map = mp3tab::kShortMapLsf##sfx;                  \
    rt->ws_region0_short = mp3tab::kWsRegion0ShortLsf##sfx;     \
    rt->ws_region0_long = mp3tab::kWsRegion0LongLsf##sfx;       \
    return true
  switch (sr) {
    MAP_LSF_RATE(22050, 2205);
    MAP_LSF_RATE(24000, 24000);
    MAP_LSF_RATE(16000, 16000);
    MAP_LSF_RATE(11025, 11025);
    MAP_LSF_RATE(12000, 12000);
    MAP_LSF_RATE(8000, 8000);
  }
#undef MAP_LSF_RATE
  return false;
}

// ---------------------------------------------------------------------------
// Scalefactors
// ---------------------------------------------------------------------------

struct Scalefactors {
  int l[23] = {0};      // long bands
  int s[13][3] = {{0}}; // short bands x windows
  // LSF intensity bookkeeping: bits used per band (illegal is_position
  // is (1 << slen) - 1) and the intensity_scale flag (sc & 1)
  int slen_l[23] = {0};
  int slen_s[13] = {0};
  int intensity_scale = 0;
};

// part2: reads scalefactors, honouring scfsi for granule 1
void read_scalefactors(BitReader& br, const GranuleInfo& gi, int granule,
                       int scfsi, const Scalefactors& prev,
                       Scalefactors* sf) {
  const int slen1 = mp3tab::kSlen[gi.scalefac_compress][0];
  const int slen2 = mp3tab::kSlen[gi.scalefac_compress][1];
  const int split = mp3tab::kSlen[gi.scalefac_compress][2];
  if (gi.window_switching && gi.block_type == 2) {
    if (gi.mixed_block) {
      // first long bands then short bands from band 3 up
      for (int b = 0; b < 8; ++b) sf->l[b] = int(br.bits(slen1));
      for (int b = 3; b < 6; ++b)
        for (int w = 0; w < 3; ++w) sf->s[b][w] = int(br.bits(slen1));
      for (int b = 6; b < 12; ++b)
        for (int w = 0; w < 3; ++w) sf->s[b][w] = int(br.bits(slen2));
    } else {
      for (int b = 0; b < 6; ++b)
        for (int w = 0; w < 3; ++w) sf->s[b][w] = int(br.bits(slen1));
      for (int b = 6; b < 12; ++b)
        for (int w = 0; w < 3; ++w) sf->s[b][w] = int(br.bits(slen2));
    }
    return;
  }
  // long blocks: scfsi groups can inherit granule 0's scalefactors
  for (int grp = 0; grp < 4; ++grp) {
    const int b0 = mp3tab::kScfsiGroup[grp];
    const int b1 = mp3tab::kScfsiGroup[grp + 1];
    const bool inherit = granule == 1 && ((scfsi >> (3 - grp)) & 1);
    for (int b = b0; b < b1; ++b) {
      const int slen = (b < split) ? slen1 : slen2;
      if (inherit) {
        sf->l[b] = prev.l[b];
      } else {
        sf->l[b] = int(br.bits(slen));
      }
    }
  }
}

// LSF scalefactor layout (ISO 13818-3 2.4.3.2 semantics): a slen
// quadruple computed from the 9-bit scalefac_compress plus a partition
// table; channel 1 in joint intensity mode uses the halved-sc variant.
// Verified behaviourally: whole-stream sample equality vs libmpg123 on
// LAME-encoded 16/22.05/24/8/11.025/12 kHz streams and crafted
// intensity probe frames (tools/derive_mp3_lsf.py measured the
// partition alignment and the intensity ratio laws directly).
constexpr int kLsfNsfb[6][3][4] = {
    {{6, 5, 5, 5}, {9, 9, 9, 9}, {6, 9, 9, 9}},
    {{6, 5, 7, 3}, {9, 9, 12, 6}, {6, 9, 12, 6}},
    {{11, 10, 0, 0}, {18, 18, 0, 0}, {15, 18, 0, 0}},
    {{7, 7, 7, 0}, {12, 12, 12, 0}, {6, 15, 12, 0}},
    {{6, 6, 6, 3}, {12, 9, 9, 6}, {6, 12, 9, 6}},
    {{8, 8, 5, 0}, {15, 12, 9, 0}, {6, 18, 9, 0}},
};

void read_scalefactors_lsf(BitReader& br, GranuleInfo& gi,
                           bool intensity_ch, Scalefactors* sf) {
  int sc = gi.scalefac_compress;
  int slen[4] = {0, 0, 0, 0};
  int blocknumber = 0;
  if (intensity_ch) {
    sf->intensity_scale = sc & 1;
    sc >>= 1;
    if (sc < 180) {
      slen[0] = sc / 36;
      slen[1] = (sc % 36) / 6;
      slen[2] = sc % 6;
      blocknumber = 3;
    } else if (sc < 244) {
      // measured per-band (tools/derive_mp3_lsf.py block-4 fit):
      // base-4 digit triple of (sc - 180)
      sc -= 180;
      slen[0] = sc / 16;
      slen[1] = (sc % 16) / 4;
      slen[2] = sc % 4;
      blocknumber = 4;
    } else {
      sc -= 244;
      slen[0] = sc / 3;
      slen[1] = sc % 3;
      blocknumber = 5;
    }
  } else {
    if (sc < 400) {
      slen[0] = (sc >> 4) / 5;
      slen[1] = (sc >> 4) % 5;
      slen[2] = (sc % 16) >> 2;
      slen[3] = sc % 4;
      blocknumber = 0;
    } else if (sc < 500) {
      sc -= 400;
      slen[0] = (sc >> 2) / 5;
      slen[1] = (sc >> 2) % 5;
      slen[2] = sc % 4;
      blocknumber = 1;
    } else {
      sc -= 500;
      slen[0] = sc / 3;
      slen[1] = sc % 3;
      blocknumber = 2;
      gi.preflag = true;  // LSF: preflag implied, no side-info bit
    }
  }
  const int bt = (gi.window_switching && gi.block_type == 2)
                     ? (gi.mixed_block ? 2 : 1)
                     : 0;
  const int* nsfb = kLsfNsfb[blocknumber][bt];
  if (bt == 0) {  // long blocks: values are per band 0..20
    int b = 0;
    for (int part = 0; part < 4; ++part) {
      for (int i = 0; i < nsfb[part] && b < 23; ++i, ++b) {
        sf->l[b] = slen[part] ? int(br.bits(slen[part])) : 0;
        sf->slen_l[b] = slen[part];
      }
    }
  } else if (bt == 1) {  // short: band-major, window-minor
    int j = 0;
    for (int part = 0; part < 4; ++part) {
      for (int i = 0; i < nsfb[part]; ++i, ++j) {
        const int b = j / 3, w = j % 3;
        if (b >= 13) continue;
        sf->s[b][w] = slen[part] ? int(br.bits(slen[part])) : 0;
        sf->slen_s[b] = slen[part];
      }
    }
  } else {  // mixed: 6 long bands, then short bands from band 3
    int j = 0;
    for (int part = 0; part < 4; ++part) {
      for (int i = 0; i < nsfb[part]; ++i, ++j) {
        if (j < 6) {
          sf->l[j] = slen[part] ? int(br.bits(slen[part])) : 0;
          sf->slen_l[j] = slen[part];
        } else {
          const int k = j - 6;
          const int b = 3 + k / 3, w = k % 3;
          if (b >= 13) continue;
          sf->s[b][w] = slen[part] ? int(br.bits(slen[part])) : 0;
          sf->slen_s[b] = slen[part];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Huffman spectrum decode
// ---------------------------------------------------------------------------

double g_pow43[8207];
bool g_pow_ready = false;

void init_pow() {
  if (g_pow_ready) return;
  for (int i = 0; i < 8207; ++i) g_pow43[i] = std::pow(double(i), 4.0 / 3.0);
  g_pow_ready = true;
}

// decodes one big-values pair into is[idx], is[idx+1]
bool decode_pair(BitReader& br, const PairTable& pt, int32_t* is, int idx) {
  if (pt.entries == nullptr) {  // table 0 (or invalid 4/14): zeros
    is[idx] = 0;
    is[idx + 1] = 0;
    return true;
  }
  int32_t e = pt.tree.decode(br);
  if (e < 0) return false;
  int x = pt.entries[e].x;
  int y = pt.entries[e].y;
  if (x == 15 && pt.linbits) x += int(br.bits(pt.linbits));
  if (x && br.bit()) x = -x;
  if (y == 15 && pt.linbits) y += int(br.bits(pt.linbits));
  if (y && br.bit()) y = -y;
  is[idx] = x;
  is[idx + 1] = y;
  return true;
}

// full spectrum for one granule/channel; returns false on malformed data
bool huffman_spectrum(BitReader& br, const GranuleInfo& gi,
                      const RateTables& rt, size_t part2_start,
                      int32_t* is, int* nz_end = nullptr) {
  std::memset(is, 0, 576 * sizeof(int32_t));
  // big-values region boundaries
  int reg_end[3];
  if (gi.window_switching) {
    const int r0 = (gi.block_type == 2 && !gi.mixed_block)
                       ? rt.ws_region0_short
                       : rt.ws_region0_long;
    reg_end[0] = r0;
    reg_end[1] = 576;
    reg_end[2] = 576;
  } else {
    int r0 = gi.region0_count + 1;
    int r1 = r0 + gi.region1_count + 1;
    if (r0 > 22) r0 = 22;
    if (r1 > 22) r1 = 22;
    reg_end[0] = rt.sfb_long[r0];
    reg_end[1] = rt.sfb_long[r1];
    reg_end[2] = 576;
  }
  const size_t part2_3_end = part2_start + size_t(gi.part2_3_length);
  int idx = 0;
  for (int region = 0; region < 3; ++region) {
    const int tid = gi.table_select[region];
    if (tid == 4 || tid == 14) return false;
    while (idx < gi.big_values * 2 && idx < reg_end[region]) {
      if (tid == 0) {
        is[idx] = 0;
        is[idx + 1] = 0;
        idx += 2;
        continue;
      }
      if (br.pos >= part2_3_end) {
        idx = gi.big_values * 2;  // starved: remaining pairs are zero
        break;
      }
      if (!decode_pair(br, g_pair_tables[tid], is, idx)) return false;
      idx += 2;
    }
    if (idx >= gi.big_values * 2) break;
  }
  idx = gi.big_values * 2;
  // count1 region
  while (br.pos < part2_3_end && idx <= 572) {
    int q[4];
    if (gi.count1table_select == 1) {
      // table B: 4-bit one's complement
      uint32_t code = br.bits(4);
      uint32_t pat = (~code) & 0xF;
      q[0] = (pat >> 3) & 1;
      q[1] = (pat >> 2) & 1;
      q[2] = (pat >> 1) & 1;
      q[3] = pat & 1;
    } else {
      int32_t e = g_count1_a.decode(br);
      if (e < 0) return false;
      q[0] = mp3tab::kCount1A[e].v;
      q[1] = mp3tab::kCount1A[e].w;
      q[2] = mp3tab::kCount1A[e].x;
      q[3] = mp3tab::kCount1A[e].y;
    }
    for (int i = 0; i < 4; ++i) {
      int v = q[i];
      if (v && br.bit()) v = -v;
      // values whose sign bit crosses part2_3 are dropped (mpg123
      // behaviour, verified in tools/derive_mp3_tables.py)
      if (br.pos > part2_3_end) v = 0;
      is[idx + i] = v;
    }
    idx += 4;
  }
  // intensity stereo's "zero part" boundary: the position after the
  // last truly NONZERO value (probed: mpg123 keeps a band out of the
  // intensity region while any of its lines is nonzero, including
  // zero-valued count1 tail quads)
  if (nz_end != nullptr) {
    int last = idx < 576 ? idx : 576;
    while (last > 0 && is[last - 1] == 0) --last;
    *nz_end = last;
  }
  // position the reader at the end of this granule's bits
  br.pos = part2_3_end;
  return true;
}

// ---------------------------------------------------------------------------
// Requantization (+ reorder for short blocks)
// ---------------------------------------------------------------------------

inline double requant_mag(int mag, double gain_factor) {
  return g_pow43[mag] * gain_factor;
}

void requantize(const GranuleInfo& gi, const RateTables& rt,
                const Scalefactors& sf, const int32_t* is, double* xr) {
  const double g_gain = std::pow(2.0, 0.25 * (gi.global_gain - 210));
  const double sf_step = gi.scalefac_scale ? 1.0 : 0.5;
  std::memset(xr, 0, 576 * sizeof(double));
  if (gi.window_switching && gi.block_type == 2 && !gi.mixed_block) {
    // short blocks: is order runs band-major, window-minor; the
    // derived map sends each is position to (sb, win, line) in the
    // subband-major reordered domain the IMDCT consumes.
    // band of each is position from the short band edges:
    int band_start[13];
    for (int b = 0; b < 13; ++b) band_start[b] = 3 * rt.sfb_short[b];
    for (int k = 0; k < 576; ++k) {
      if (!is[k]) continue;
      // band: is-position k sits in band b iff 3*edge[b] <= k < 3*edge[b+1]
      int b = 0;
      while (b < 12 && k >= 3 * rt.sfb_short[b + 1]) ++b;
      const uint16_t dst = rt.short_map[k];
      const int win = (dst % 18) / 6;
      const int mag = is[k] < 0 ? -is[k] : is[k];
      double v = requant_mag(mag, g_gain);
      v *= std::pow(2.0, -2.0 * gi.subblock_gain[win]);
      const int sfv = (b < 12) ? sf.s[b][win] : 0;
      v *= std::pow(2.0, -sf_step * sfv);
      xr[dst] = is[k] < 0 ? -v : v;
    }
    return;
  }
  if (gi.window_switching && gi.block_type == 2 && gi.mixed_block) {
    // mixed blocks: first 2 subbands (36 bins) long, rest short.
    for (int k = 0; k < 36; ++k) {
      if (!is[k]) continue;
      int b = 0;
      while (b < 21 && k >= rt.sfb_long[b + 1]) ++b;
      const int mag = is[k] < 0 ? -is[k] : is[k];
      double v = requant_mag(mag, g_gain);
      const int pre = gi.preflag ? mp3tab::kPretab[b] : 0;
      v *= std::pow(2.0, -sf_step * (sf.l[b] + pre));
      xr[k] = is[k] < 0 ? -v : v;
    }
    for (int k = 36; k < 576; ++k) {
      if (!is[k]) continue;
      int b = 3;
      while (b < 12 && k >= 3 * rt.sfb_short[b + 1]) ++b;
      const uint16_t dst = rt.short_map[k];
      const int win = (dst % 18) / 6;
      const int mag = is[k] < 0 ? -is[k] : is[k];
      double v = requant_mag(mag, g_gain);
      v *= std::pow(2.0, -2.0 * gi.subblock_gain[win]);
      v *= std::pow(2.0, -sf_step * sf.s[b][win]);
      xr[dst] = is[k] < 0 ? -v : v;
    }
    return;
  }
  // long blocks
  for (int k = 0; k < 576; ++k) {
    if (!is[k]) continue;
    int b = 0;
    while (b < 21 && k >= rt.sfb_long[b + 1]) ++b;
    const int mag = is[k] < 0 ? -is[k] : is[k];
    const int pre = gi.preflag ? mp3tab::kPretab[b] : 0;
    double v = requant_mag(mag, g_gain);
    v *= std::pow(2.0, -sf_step * (sf.l[b] + pre));
    xr[k] = is[k] < 0 ? -v : v;
  }
}

// ---------------------------------------------------------------------------
// Joint stereo: MS + intensity
// ---------------------------------------------------------------------------

// (kl, kr) for one intensity position; false = illegal position (the
// band passes through, or takes MS when the MS flag is set). Ratio laws
// measured from libmpg123 (tools/derive_mp3_lsf.py): MPEG-1 follows
// kl = tan(p*pi/12) / (1 + tan), kr = 1 - kl with p = 6 fully left and
// p >= 7 illegal; LSF scales one side by powers of 2^-1/4 (or 2^-1/2
// when intensity_scale is set), odd positions scaling the left.
bool intensity_pair(bool lsf, int pos, int slen, int intensity_scale,
                    double* kl, double* kr) {
  if (lsf) {
    // illegal position is 7 EXACTLY, independent of the band's slen
    // (probed: slen-2 position 3 and slen-4 positions 9/15 are legal,
    // position 7 passes through at every slen); slen-0 bands carry
    // position 0, which is legal
    (void)slen;
    if (pos == 7) return false;
    const double io = intensity_scale ? 0.7071067811865476
                                      : 0.8408964152537145;
    if (pos & 1) {
      *kl = std::pow(io, (pos + 1) / 2);
      *kr = 1.0;
    } else if (pos > 0) {
      *kl = 1.0;
      *kr = std::pow(io, pos / 2);
    } else {
      *kl = 1.0;
      *kr = 1.0;
    }
    return true;
  }
  if (pos >= 7) return false;
  *kl = mp3tab::kIsRatioL1[pos];
  *kr = mp3tab::kIsRatioR1[pos];
  return true;
}

// Per-granule joint-stereo post-processing over the requantized
// spectra. ``nz_end`` is the right channel's decoded extent in the
// is-order domain (its "zero part" starts there); intensity applies to
// scalefactor bands whose is-range starts at/after it, positions taken
// from the right channel's scalefactors. MS covers everything else
// when flagged. The spectra are already reordered for short blocks, so
// short-band lines are touched through the reorder map.
void apply_joint_stereo(bool lsf, bool ms_flag, bool is_flag,
                        const GranuleInfo& gi1, const RateTables& rt,
                        const Scalefactors& sf1, int nz_end,
                        double* xl, double* xr) {
  const double inv_sqrt2 = 0.7071067811865476;
  auto ms = [&](int k) {
    const double m = xl[k], s = xr[k];
    xl[k] = (m + s) * inv_sqrt2;
    xr[k] = (m - s) * inv_sqrt2;
  };
  if (!is_flag) {
    if (ms_flag) {
      for (int k = 0; k < 576; ++k) ms(k);
    }
    return;
  }

  const bool short_blk =
      gi1.window_switching && gi1.block_type == 2 && !gi1.mixed_block;
  const bool mixed_blk =
      gi1.window_switching && gi1.block_type == 2 && gi1.mixed_block;

  auto long_bands = [&](int b_begin, int line_end) {
    for (int b = b_begin; b < 22 && rt.sfb_long[b] < line_end; ++b) {
      const int sb = b < 21 ? b : 20;  // last band shares its neighbour
      double kl = 1.0, kr = 1.0;
      const bool is_band = rt.sfb_long[b] >= nz_end;
      const bool legal =
          is_band && intensity_pair(lsf, sf1.l[sb], sf1.slen_l[sb],
                                    sf1.intensity_scale, &kl, &kr);
      const int e1 = rt.sfb_long[b + 1] < line_end ? rt.sfb_long[b + 1]
                                                   : line_end;
      for (int k = rt.sfb_long[b]; k < e1; ++k) {
        if (legal) {
          xr[k] = kr * xl[k];
          xl[k] = kl * xl[k];
        } else if (ms_flag) {
          ms(k);
        }
      }
    }
  };

  auto short_bands = [&](int b_begin) {
    for (int b = b_begin; b < 13 && rt.sfb_short[b] < 192; ++b) {
      const int width = rt.sfb_short[b + 1] - rt.sfb_short[b];
      const int sb = b < 12 ? b : 11;
      for (int w = 0; w < 3; ++w) {
        const int start = 3 * rt.sfb_short[b] + w * width;
        double kl = 1.0, kr = 1.0;
        const bool is_band = start >= nz_end;
        const bool legal =
            is_band && intensity_pair(lsf, sf1.s[sb][w], sf1.slen_s[sb],
                                      sf1.intensity_scale, &kl, &kr);
        for (int i = 0; i < width; ++i) {
          const int dst = rt.short_map[start + i];
          if (legal) {
            xr[dst] = kr * xl[dst];
            xl[dst] = kl * xl[dst];
          } else if (ms_flag) {
            ms(dst);
          }
        }
      }
    }
  };

  if (short_blk) {
    short_bands(0);
  } else if (mixed_blk) {
    long_bands(0, 36);
    short_bands(3);
  } else {
    long_bands(0, 576);
  }
}

// ---------------------------------------------------------------------------
// Alias reduction, IMDCT, frequency inversion
// ---------------------------------------------------------------------------

// alias butterflies (ISO 2.4.3.4.10.1 constants; verified behaviourally
// by kernel prediction in tools/derive_mp3_aux.py)
constexpr double kCi[8] = {-0.6, -0.535, -0.33, -0.185,
                           -0.095, -0.041, -0.0142, -0.0037};
double g_cs[8], g_ca[8];
double g_imdct36[36][18];
double g_imdct12[12][6];
double g_win[4][36];       // windows for block types 0,1,3 (36) — [2] unused
double g_win_short[12];
double g_nmat[64][32];
bool g_dsp_ready = false;

void init_dsp() {
  if (g_dsp_ready) return;
  for (int i = 0; i < 8; ++i) {
    g_cs[i] = 1.0 / std::sqrt(1.0 + kCi[i] * kCi[i]);
    g_ca[i] = kCi[i] * g_cs[i];
  }
  const double pi = 3.14159265358979323846;
  for (int k = 0; k < 36; ++k)
    for (int n = 0; n < 18; ++n)
      g_imdct36[k][n] = std::cos(pi / 72.0 * (2 * k + 1 + 18) * (2 * n + 1));
  for (int k = 0; k < 12; ++k)
    for (int n = 0; n < 6; ++n)
      g_imdct12[k][n] = std::cos(pi / 24.0 * (2 * k + 1 + 6) * (2 * n + 1));
  for (int k = 0; k < 36; ++k) {
    const double w = std::sin(pi / 36.0 * (k + 0.5));
    g_win[0][k] = w;
    g_win[1][k] = w;
    g_win[3][k] = w;
  }
  for (int k = 18; k < 24; ++k) g_win[1][k] = 1.0;
  for (int k = 24; k < 30; ++k)
    g_win[1][k] = std::sin(pi / 12.0 * (k - 18 + 0.5));
  for (int k = 30; k < 36; ++k) g_win[1][k] = 0.0;
  for (int k = 0; k < 6; ++k) g_win[3][k] = 0.0;
  for (int k = 6; k < 12; ++k)
    g_win[3][k] = std::sin(pi / 12.0 * (k - 6 + 0.5));
  for (int k = 12; k < 18; ++k) g_win[3][k] = 1.0;
  for (int k = 0; k < 12; ++k)
    g_win_short[k] = std::sin(pi / 12.0 * (k + 0.5));
  for (int i = 0; i < 64; ++i)
    for (int k = 0; k < 32; ++k)
      g_nmat[i][k] = std::cos(pi / 64.0 * (16 + i) * (2 * k + 1));
  g_dsp_ready = true;
}

void alias_reduce(double* xr, int n_subbands) {
  for (int sb = 1; sb < n_subbands; ++sb) {
    for (int i = 0; i < 8; ++i) {
      const int lo = 18 * sb - 1 - i;
      const int hi = 18 * sb + i;
      const double a = xr[lo], b = xr[hi];
      xr[lo] = a * g_cs[i] - b * g_ca[i];
      xr[hi] = b * g_cs[i] + a * g_ca[i];
    }
  }
}

// per-channel filterbank state
struct ChannelState {
  double overlap[32][18] = {{0}};
  double v[16][64] = {{0}};
  int v_head = 0;  // index of the most recent 64-block
};

// one granule: xr[576] -> 576 PCM samples (interleaved stride written
// by the caller)
void synth_granule(const GranuleInfo& gi, double* xr, ChannelState* st,
                   float* out, int stride) {
  const bool short_blk = gi.window_switching && gi.block_type == 2;
  const bool mixed = short_blk && gi.mixed_block;
  if (!short_blk) {
    alias_reduce(xr, 32);
  } else if (mixed) {
    alias_reduce(xr, 2);  // long part: butterflies between sb 0 and 1
  }
  double s[32][18];
  for (int sb = 0; sb < 32; ++sb) {
    const double* xin = xr + 18 * sb;
    double z[36];
    const bool sb_short = short_blk && (!mixed || sb >= 2);
    if (sb_short) {
      for (int k = 0; k < 36; ++k) z[k] = 0.0;
      for (int w = 0; w < 3; ++w) {
        for (int k = 0; k < 12; ++k) {
          double acc = 0.0;
          for (int n = 0; n < 6; ++n)
            acc += g_imdct12[k][n] * xin[6 * w + n];
          z[6 + 6 * w + k] += acc * g_win_short[k];
        }
      }
    } else {
      const int bt = short_blk ? 0 : gi.block_type;  // mixed long part
      const double* win = g_win[bt == 2 ? 0 : bt];
      for (int k = 0; k < 36; ++k) {
        double acc = 0.0;
        for (int n = 0; n < 18; ++n) acc += g_imdct36[k][n] * xin[n];
        z[k] = acc * win[k];
      }
    }
    for (int k = 0; k < 18; ++k) {
      s[sb][k] = z[k] + st->overlap[sb][k];
      st->overlap[sb][k] = z[k + 18];
    }
  }
  // frequency inversion
  for (int sb = 1; sb < 32; sb += 2)
    for (int t = 1; t < 18; t += 2) s[sb][t] = -s[sb][t];
  // polyphase synthesis: 18 steps x 32 samples
  for (int t = 0; t < 18; ++t) {
    st->v_head = (st->v_head + 15) & 15;
    double* v0 = st->v[st->v_head];
    for (int i = 0; i < 64; ++i) {
      double acc = 0.0;
      for (int k = 0; k < 32; ++k) acc += g_nmat[i][k] * s[k][t];
      v0[i] = acc;
    }
    for (int j = 0; j < 32; ++j) {
      // U[i*64+j] = V[i*128+j], U[i*64+32+j] = V[i*128+96+j] over the
      // 1024-deep V fifo held as 16 blocks of 64
      double acc = 0.0;
      for (int i = 0; i < 8; ++i) {
        const double* even = st->v[(st->v_head + 2 * i) & 15];
        const double* odd = st->v[(st->v_head + 2 * i + 1) & 15];
        acc += even[j] * mp3tab::kWindowD[i * 64 + j];
        acc += odd[32 + j] * mp3tab::kWindowD[i * 64 + 32 + j];
      }
      out[(t * 32 + j) * stride] = float(acc);
    }
  }
}

// ---------------------------------------------------------------------------
// Stream decode
// ---------------------------------------------------------------------------

size_t skip_id3v2(const uint8_t* data, size_t n) {
  if (n >= 10 && data[0] == 'I' && data[1] == 'D' && data[2] == '3') {
    const size_t size = (size_t(data[6] & 0x7F) << 21) |
                        (size_t(data[7] & 0x7F) << 14) |
                        (size_t(data[8] & 0x7F) << 7) |
                        size_t(data[9] & 0x7F);
    const size_t total = 10 + size + ((data[5] & 0x10) ? 10 : 0);
    if (total < n) return total;
  }
  return 0;
}

struct Decoder {
  std::vector<uint8_t> reservoir;
  ChannelState state[2];
  int samplerate = 0;
  int channels = 0;

  // decode one frame's granules from the reservoir; returns samples
  // per channel written (0 when the reservoir is starved)
  int decode_frame(const Header& h, const SideInfo& si,
                   size_t frame_main_start, float* out, int64_t room) {
    RateTables rt;
    if (!rate_tables(h.samplerate, &rt)) return int(kErrUnsupported);
    const bool ms = (h.mode == 1) && (h.mode_ext & 2);
    const bool is = (h.mode == 1) && (h.mode_ext & 1) && h.channels == 2;
    const int frame_samples = 576 * h.granules;
    if (room < frame_samples * h.channels) return int(kErrCapacity);

    BitReader br(reservoir.data(), reservoir.size());
    br.pos = frame_main_start * 8;
    static thread_local int32_t is_buf[576];
    static thread_local double xr[2][576];
    static thread_local Scalefactors sf_store[2][2];
    static thread_local GranuleInfo gi_store[2];

    for (int g = 0; g < h.granules; ++g) {
      int nz_end[2] = {576, 576};
      for (int ch = 0; ch < h.channels; ++ch) {
        // local copy: the LSF scalefactor reader derives preflag from
        // scalefac_compress (there is no side-info bit for it)
        GranuleInfo& gi = gi_store[ch];
        gi = si.gr[g][ch];
        const size_t part2_start = br.pos;
        Scalefactors& sf = sf_store[g][ch];
        sf = Scalefactors();
        if (h.lsf) {
          read_scalefactors_lsf(br, gi, is && ch == 1, &sf);
        } else {
          read_scalefactors(br, gi, g, si.scfsi[ch], sf_store[0][ch], &sf);
        }
        if (!huffman_spectrum(br, gi, rt, part2_start, is_buf,
                              &nz_end[ch]))
          return int(kErrMalformed);
        requantize(gi, rt, sf, is_buf, xr[ch]);
      }
      if (ms || is) {
        apply_joint_stereo(h.lsf, ms, is, gi_store[1], rt,
                           sf_store[g][1], nz_end[1], xr[0], xr[1]);
      }
      for (int ch = 0; ch < h.channels; ++ch) {
        synth_granule(gi_store[ch], xr[ch], &state[ch],
                      out + g * 576 * h.channels + ch, h.channels);
      }
    }
    return frame_samples;
  }
};

}  // namespace

extern "C" {

int64_t mp3_probe(const uint8_t* data, int64_t n, int32_t* sr,
                  int32_t* channels, int64_t* approx_samples) {
  size_t pos = skip_id3v2(data, size_t(n));
  Header h;
  // find the first header confirmed by a consecutive one (or EOF span)
  size_t first = 0;
  bool found = false;
  for (; pos + 4 <= size_t(n); ++pos) {
    if (!parse_header(data + pos, &h)) continue;
    const size_t next = pos + size_t(h.frame_bytes);
    Header h2;
    const bool confirmed =
        (next + 4 <= size_t(n) && parse_header(data + next, &h2) &&
         h2.samplerate == h.samplerate && h2.channels == h.channels) ||
        (next >= size_t(n) - 1 && next <= size_t(n) + 1);
    if (confirmed) {
      first = pos;
      found = true;
      break;
    }
  }
  if (!found) return kErrNotMp3;
  *sr = h.samplerate;
  *channels = h.channels;
  // walk every frame header for an exact count (VBR streams make a
  // first-frame extrapolation unsafe in both directions)
  int64_t frames = 0;
  pos = first;
  const int ref_sr = h.samplerate, ref_ch = h.channels;
  while (pos + 4 <= size_t(n)) {
    Header hf;
    if (!parse_header(data + pos, &hf) || hf.samplerate != ref_sr ||
        hf.channels != ref_ch) {
      ++pos;  // resync past garbage / tags
      continue;
    }
    ++frames;
    pos += size_t(hf.frame_bytes);
  }
  *approx_samples = frames * (h.lsf ? 576 : 1152) + 2304;
  return 0;
}

int64_t mp3_decode(const uint8_t* data, int64_t n, float* out,
                   int64_t capacity, int32_t* sr, int32_t* channels) {
  init_tables();
  init_pow();
  init_dsp();
  Decoder dec;
  size_t pos = skip_id3v2(data, size_t(n));
  int64_t written = 0;  // samples per channel
  bool seen_frame = false;

  while (pos + 4 <= size_t(n)) {
    Header h;
    if (!parse_header(data + pos, &h)) {
      ++pos;  // resync (also skips ID3v1/APE tails harmlessly)
      continue;
    }
    if (pos + size_t(h.frame_bytes) > size_t(n)) break;  // truncated tail
    if (!seen_frame) {
      dec.samplerate = h.samplerate;
      dec.channels = h.channels;
      seen_frame = true;
    } else if (h.samplerate != dec.samplerate ||
               h.channels != dec.channels) {
      pos += 1;  // spurious sync inside data; keep scanning
      continue;
    }

    size_t off = pos + 4 + (h.crc ? 2 : 0);
    BitReader sbr(data + off, size_t(h.side_bytes));
    SideInfo si;
    if (!parse_side_info(sbr, h, &si)) return kErrMalformed;

    const size_t main_off = off + size_t(h.side_bytes);
    const size_t main_len = pos + size_t(h.frame_bytes) - main_off;
    // reservoir bookkeeping: this frame's granule data starts
    // main_data_begin bytes BEFORE the accumulated reservoir end
    const size_t have = dec.reservoir.size();
    dec.reservoir.insert(dec.reservoir.end(), data + main_off,
                         data + main_off + main_len);
    if (size_t(si.main_data_begin) <= have) {
      const size_t start = have - size_t(si.main_data_begin);
      const int got = dec.decode_frame(
          h, si, start, out + written * dec.channels,
          capacity - written * dec.channels);
      if (got < 0) return got;
      written += got;
    }
    // cap the reservoir (spec maximum main_data_begin is 511 bytes)
    if (dec.reservoir.size() > 2048) {
      dec.reservoir.erase(dec.reservoir.begin(),
                          dec.reservoir.end() - 1024);
    }
    pos += size_t(h.frame_bytes);
  }
  if (!seen_frame) return kErrNotMp3;
  *sr = dec.samplerate;
  *channels = dec.channels;
  return written;
}

}  // extern "C"
