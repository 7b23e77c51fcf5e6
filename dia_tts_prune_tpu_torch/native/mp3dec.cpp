// In-repo MPEG-1/2 Audio Layer III decoder (host-side native component),
// the PyTorch port's own copy of dia_tts_prune_tpu/native/mp3dec.cpp.
//
// The torch reference loads arbitrary compressed voice prompts through
// torchaudio's native backends (reference dia/model.py:551-559) and ships an
// mp3 example prompt (example_prompt.mp3).  The port decodes WAV and FLAC
// with in-repo code (utils/flac.py); this file closes the remaining gap: a
// from-scratch ISO/IEC 11172-3 Layer III decoder (MPEG-1 fully; MPEG-2 LSF
// mono/stereo long blocks) exposed via ctypes (native/__init__.py::decode_mp3).
//
// Differences from the JAX package's copy, each a memory or thread fault
// there; decoded samples of a well-formed stream are the same bits:
//   - mp3_decode takes the output's capacity in floats and never writes past
//     it, whatever channel count a later frame has (a mono Xing tag frame
//     before stereo audio made the JAX copy write twice its buffer);
//   - the Xing flags word is read only when all of its 4 bytes are in the
//     buffer;
//   - the huffman and power tables are built once, under std::call_once;
//   - no environment variable turns on debug prints.
//
// Written from the spec's algorithm description; no code copied from any
// decoder.  Validation status (tests/test_native.py + tools/mp3_recover/;
// the port's copy against the JAX copy: tests/test_torch_native.py):
// float-rounding exact vs libavcodec on real LAME streams at all nine
// sample rates (MPEG-1/2/2.5), mono and stereo (L/R + mid/side joint).
// Intensity stereo follows the spec but is UNVALIDATED: no available
// encoder emits it (LAME never does) and the synthetic-stereo probe
// harness does not yet reproduce libav's framing for such streams.  Self-validation: huffman-table construction fails loudly on a
// non-prefix-free or incomplete code (mp3_selftest), and every granule
// asserts the spec invariant that scalefactor+huffman reads consume exactly
// part2_3_length bits — a structural error in any used table cannot stay
// silent (tests/test_native.py drives both).
//
// Decode pipeline per granule (spec 2.4.3.4):
//   side info -> scalefactors -> huffman (big_values pairs + count1 quads)
//   -> requantize (2^(gain/4) * |x|^(4/3), pretab, subblock gain)
//   -> short-block reorder -> stereo (MS / intensity) -> alias reduction
//   -> IMDCT 36/12+overlap-add -> frequency inversion
//   -> 32-band polyphase synthesis (DCT via matrixing + windowed FIFO).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <mutex>

namespace {

// ---------------------------------------------------------------------------
// Bit reader over a byte buffer (MSB first).
struct BitReader {
  const uint8_t* data = nullptr;
  int64_t nbytes = 0;
  int64_t pos = 0;  // bit position

  void init(const uint8_t* d, int64_t n) { data = d; nbytes = n; pos = 0; }
  int64_t bits_left() const { return nbytes * 8 - pos; }
  // Read n bits (n <= 24) MSB-first; returns 0 past end (caller checks).
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++) {
      int64_t byte = pos >> 3;
      int bit = 7 - (pos & 7);
      uint32_t b = (byte < nbytes) ? ((data[byte] >> bit) & 1u) : 0u;
      v = (v << 1) | b;
      pos++;
    }
    return v;
  }
  uint32_t read1() {
    int64_t byte = pos >> 3;
    int bit = 7 - (pos & 7);
    uint32_t b = (byte < nbytes) ? ((data[byte] >> bit) & 1u) : 0u;
    pos++;
    return b;
  }
  void skip(int64_t n) { pos += n; }
};

// ---------------------------------------------------------------------------
// Header / side info structures.

struct FrameHeader {
  int version;        // 3 = MPEG-1, 2 = MPEG-2, 0 = MPEG-2.5
  int layer;          // 1 = Layer III (header field value)
  bool crc_protected;
  int bitrate_kbps;
  int sample_rate;
  bool padding;
  int mode;           // 0 stereo, 1 joint, 2 dual, 3 mono
  int mode_ext;       // joint stereo: bit1 = MS, bit0 = intensity
  int nchan() const { return mode == 3 ? 1 : 2; }
  bool mpeg1() const { return version == 3; }
  int frame_bytes;    // total frame length incl. header
  int samples_per_frame() const { return mpeg1() ? 1152 : 576; }
};

struct GranuleInfo {
  int part2_3_length;
  int big_values;
  int global_gain;
  int scalefac_compress;
  int window_switching;
  int block_type;
  int mixed_block;
  int table_select[3];
  int subblock_gain[3];
  int region0_count;
  int region1_count;
  int preflag;
  int scalefac_scale;
  int count1table_select;
};

struct SideInfo {
  int main_data_begin;
  int scfsi[2][4];
  GranuleInfo gr[2][2];  // [granule][channel]
};

// Bitrate table, Layer III (kbps).  MPEG-1 row then MPEG-2/2.5 (LSF) row.
const int kBitrate[2][15] = {
    {0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320},
    {0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160}};
const int kSampleRate[3][3] = {{44100, 48000, 32000},    // MPEG-1
                               {22050, 24000, 16000},    // MPEG-2
                               {11025, 12000, 8000}};    // MPEG-2.5

// Scalefactor band boundaries (spec table B.8).  Rows: sample-rate index.
// MPEG-1 long (23 entries = 22 bands) and short (14 entries = 13 bands).
const int kSfbLong1[3][23] = {
    {0, 4, 8, 12, 16, 20, 24, 30, 36, 44, 52, 62, 74, 90, 110, 134, 162, 196,
     238, 288, 342, 418, 576},  // 44100
    {0, 4, 8, 12, 16, 20, 24, 30, 36, 42, 50, 60, 72, 88, 106, 128, 156, 190,
     230, 276, 330, 384, 576},  // 48000
    {0, 4, 8, 12, 16, 20, 24, 30, 36, 44, 54, 66, 82, 102, 126, 156, 194, 240,
     296, 364, 448, 550, 576}}; // 32000 (550 oracle-recovered; the row had
                                // only 22 entries -> bl[22] read as 0)
const int kSfbShort1[3][14] = {
    {0, 4, 8, 12, 16, 22, 30, 40, 52, 66, 84, 106, 136, 192},   // 44100
    {0, 4, 8, 12, 16, 22, 28, 38, 50, 64, 80, 100, 126, 192},   // 48000
    {0, 4, 8, 12, 16, 22, 30, 42, 58, 78, 104, 138, 180, 192}}; // 32000
// MPEG-2 LSF long/short boundaries (spec 13818-3 table B.2).
const int kSfbLong2[3][23] = {
    {0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140, 168, 200, 238,
     284, 336, 396, 464, 522, 576},  // 22050
    {0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 114, 136, 162, 194, 232,
     278, 330, 394, 464, 540, 576},  // 24000 (row oracle-recovered:
                                     // tools/mp3_recover/boundary_recover.py)
    {0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140, 168, 200, 238,
     284, 336, 396, 464, 522, 576}}; // 16000
const int kSfbShort2[3][14] = {
    {0, 4, 8, 12, 18, 24, 32, 42, 56, 74, 100, 132, 174, 192},
    {0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 136, 180, 192},
    {0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 134, 174, 192}};
// MPEG-2.5 rows (11025/12000/8000) — oracle-recovered
// (tools/mp3_recover/boundary_recover.py): 11.025/12 kHz share the 22.05 kHz
// long row and the 16 kHz short row; 8 kHz has doubled widths with
// degenerate 2-line top bands.
const int kSfbLong25[3][23] = {
    {0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140, 168, 200, 238,
     284, 336, 396, 464, 522, 576},  // 11025
    {0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140, 168, 200, 238,
     284, 336, 396, 464, 522, 576},  // 12000
    {0, 12, 24, 36, 48, 60, 72, 88, 108, 132, 160, 192, 232, 280, 336, 400,
     476, 566, 568, 570, 572, 574, 576}};  // 8000
const int kSfbShort25[3][14] = {
    {0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 134, 174, 192},   // 11025
    {0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 134, 174, 192},   // 12000
    {0, 8, 16, 24, 36, 52, 72, 96, 124, 160, 162, 164, 166, 192}};  // 8000

// Pretab (spec 2.4.3.4.5): extra scaling for the upper long bands.
const int kPretab[22] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                         1, 1, 1, 1, 2, 2, 3, 3, 3, 2, 0};

// MPEG-1 scalefac_compress -> (slen1, slen2) (spec 2.4.2.7).
const int kSlen1[16] = {0, 0, 0, 0, 3, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4};
const int kSlen2[16] = {0, 1, 2, 3, 0, 1, 2, 3, 1, 2, 3, 1, 2, 3, 2, 3};

}  // namespace

// ===========================================================================
// Huffman tables (ISO 11172-3 Annex B.7), written as length/code pairs in
// row-major (x outer, y inner) order.  Tables 17-23 reuse table 16's codes
// and tables 25-31 reuse table 24's, with per-table linbits.
// mp3_selftest() verifies each table is an exact prefix code (Kraft sum 1).
#include "mp3_tables.h"

namespace {

// Decode tree: flat array of nodes; value = (x<<5)|y for pairs.
struct HuffNode { int16_t next0, next1; int16_t value; };

struct HuffTable {
  HuffNode nodes[1024];
  int n_nodes = 0;
  bool ok = false;

  int alloc() {
    if (n_nodes >= 1024) return -1;
    nodes[n_nodes] = {-1, -1, -1};
    return n_nodes++;
  }
  // Insert code (given as bit-length + value bits) mapping to v.
  bool insert(int len, uint32_t code, int v) {
    if (n_nodes == 0 && alloc() < 0) return false;
    int cur = 0;
    for (int i = len - 1; i >= 0; i--) {
      if (nodes[cur].value >= 0) return false;  // prefix conflict
      int bit = (code >> i) & 1;
      int16_t* slot = bit ? &nodes[cur].next1 : &nodes[cur].next0;
      if (*slot < 0) {
        int nn = alloc();
        if (nn < 0) return false;
        *slot = (int16_t)nn;
      }
      cur = *slot;
    }
    if (nodes[cur].value >= 0 || nodes[cur].next0 >= 0 || nodes[cur].next1 >= 0)
      return false;  // duplicate / prefix conflict
    nodes[cur].value = (int16_t)v;
    return true;
  }
  // A complete code has no internal node with a missing child.
  bool complete() const {
    for (int i = 0; i < n_nodes; i++) {
      if (nodes[i].value >= 0) continue;
      if (nodes[i].next0 < 0 || nodes[i].next1 < 0) return false;
    }
    return n_nodes > 0;
  }
  int decode(BitReader& br) const {
    int cur = 0;
    while (nodes[cur].value < 0) {
      int bit = (int)br.read1();
      cur = bit ? nodes[cur].next1 : nodes[cur].next0;
      if (cur < 0) return -1;
    }
    return nodes[cur].value;
  }
};

struct HuffSet {
  HuffTable big[34];      // index by table_select (0..31); 4 and 14 empty
  HuffTable count1[2];    // quad tables A and B
  int linbits[34] = {0};
  bool built = false;
  bool all_ok = true;

  void build_one(HuffTable& t, const Mp3HuffSpec& spec) {
    t.n_nodes = 0;
    if (t.alloc() < 0) { all_ok = false; return; }
    bool ok = true;
    for (int i = 0; i < spec.n && ok; i++)
      ok = t.insert(spec.len[i], spec.code[i], spec.xy ? spec.xy[i] : i);
    t.ok = ok && t.complete();
    if (!t.ok) all_ok = false;
  }

  void build() {
    if (built) return;
    built = true;
    for (int i = 0; i < 34; i++) { big[i].n_nodes = 0; big[i].ok = false; }
    for (const Mp3HuffSpec* s = kMp3BigTables; s->n >= 0; s++) {
      build_one(big[s->id], *s);
      linbits[s->id] = s->linbits;
    }
    // Tables 17-23 and 25-31 share codes with 16 / 24, different linbits.
    static const int kLin16[8] = {1, 2, 3, 4, 6, 8, 10, 13};
    static const int kLin24[8] = {4, 5, 6, 7, 8, 9, 11, 13};
    for (int i = 17; i <= 23; i++) { big[i] = big[16]; linbits[i] = kLin16[i - 16]; }
    linbits[16] = kLin16[0];
    for (int i = 25; i <= 31; i++) { big[i] = big[24]; linbits[i] = kLin24[i - 24]; }
    linbits[24] = kLin24[0];
    build_one(count1[0], kMp3Count1A);
    build_one(count1[1], kMp3Count1B);
  }
};

HuffSet g_huff;

// ---------------------------------------------------------------------------
// Power tables: |x|^(4/3) for x in [0, 8206], and 2^(-0.25*i) gains.
struct PowTables {
  float pow43[8207];
  bool init_done = false;
  void init() {
    if (init_done) return;
    init_done = true;
    for (int i = 0; i < 8207; i++) pow43[i] = (float)pow((double)i, 4.0 / 3.0);
  }
};
PowTables g_pow;

inline float gain_pow2(double e) { return (float)pow(2.0, 0.25 * e); }

// ---------------------------------------------------------------------------
// Both table sets are built exactly once, whichever thread gets there first.
std::once_flag g_tables_once;
void build_tables() {
  std::call_once(g_tables_once, [] {
    g_huff.build();
    g_pow.init();
  });
}

// ---------------------------------------------------------------------------
// Per-channel decoder state that persists across frames.
struct ChannelState {
  float overlap[32][18];   // IMDCT overlap-add tail per subband
  float v[1024];           // synthesis FIFO
  int v_off;               // rotating offset into v (multiples of 64)
};

struct Decoder {
  FrameHeader hdr;
  SideInfo si;
  ChannelState ch_state[2];
  // bit reservoir: main_data accumulated across frames
  uint8_t reservoir[65536];
  int reservoir_len = 0;
  int scalefac_l[2][23];     // long scalefactors per channel
  int scalefac_s[2][13][3];  // short scalefactors per channel [sfb][window]
  float xr[2][576];          // requantized spectrum per channel
  int nonzero_bound[2];      // highest nonzero spectral line + 1
  // MPEG-2 LSF intensity positions use full scalefac range; remembered flag
  bool strict = true;        // abort frame on bit-count mismatch
  int bad_frames = 0;
  int good_frames = 0;

  void reset() {
    memset(ch_state, 0, sizeof(ch_state));
    ch_state[0].v_off = ch_state[1].v_off = 0;
    reservoir_len = 0;
    bad_frames = good_frames = 0;
  }
};

// ---------------------------------------------------------------------------
// Header parsing.

bool parse_header(const uint8_t* p, FrameHeader* h) {
  if (p[0] != 0xFF || (p[1] & 0xE0) != 0xE0) return false;
  int version = (p[1] >> 3) & 3;
  int layer = (p[1] >> 1) & 3;
  if (version == 1 || layer != 1) return false;  // Layer III only
  int br_idx = (p[2] >> 4) & 15;
  int sr_idx = (p[2] >> 2) & 3;
  if (br_idx == 0 || br_idx == 15 || sr_idx == 3) return false;
  h->version = version;
  h->layer = layer;
  h->crc_protected = ((p[1] & 1) == 0);
  bool mpeg1 = (version == 3);
  h->bitrate_kbps = kBitrate[mpeg1 ? 0 : 1][br_idx];
  int sr_row = mpeg1 ? 0 : (version == 2 ? 1 : 2);
  h->sample_rate = kSampleRate[sr_row][sr_idx];
  h->padding = (p[2] >> 1) & 1;
  h->mode = (p[3] >> 6) & 3;
  h->mode_ext = (p[3] >> 4) & 3;
  int coef = mpeg1 ? 144 : 72;  // samples/8 per frame
  h->frame_bytes = coef * h->bitrate_kbps * 1000 / h->sample_rate + (h->padding ? 1 : 0);
  return h->frame_bytes > 4;
}

int sfb_table_row(const FrameHeader& h) {
  // row into the sfb tables for this sample rate
  for (int r = 0; r < 3; r++) {
    const int(*tab)[3] = kSampleRate;
    if (tab[h.mpeg1() ? 0 : (h.version == 2 ? 1 : 2)][r] == h.sample_rate) return r;
  }
  return 0;
}

const int* sfb_long(const FrameHeader& h) {
  int r = sfb_table_row(h);
  if (h.mpeg1()) return kSfbLong1[r];
  return h.version == 2 ? kSfbLong2[r] : kSfbLong25[r];
}
const int* sfb_short(const FrameHeader& h) {
  int r = sfb_table_row(h);
  if (h.mpeg1()) return kSfbShort1[r];
  return h.version == 2 ? kSfbShort2[r] : kSfbShort25[r];
}

// ---------------------------------------------------------------------------
// Side info (spec 2.4.1.7).

bool parse_side_info(BitReader& br, const FrameHeader& h, SideInfo* si) {
  int nch = h.nchan();
  if (h.mpeg1()) {
    si->main_data_begin = br.read(9);
    br.skip(nch == 1 ? 5 : 3);  // private bits
    for (int c = 0; c < nch; c++)
      for (int b = 0; b < 4; b++) si->scfsi[c][b] = br.read1();
    for (int g = 0; g < 2; g++) {
      for (int c = 0; c < nch; c++) {
        GranuleInfo* gi = &si->gr[g][c];
        gi->part2_3_length = br.read(12);
        gi->big_values = br.read(9);
        gi->global_gain = br.read(8);
        gi->scalefac_compress = br.read(4);
        gi->window_switching = br.read1();
        if (gi->window_switching) {
          gi->block_type = br.read(2);
          gi->mixed_block = br.read1();
          for (int r = 0; r < 2; r++) gi->table_select[r] = br.read(5);
          gi->table_select[2] = 0;
          for (int w = 0; w < 3; w++) gi->subblock_gain[w] = br.read(3);
          if (gi->block_type == 0) return false;  // forbidden
          // spec defaults when window switching:
          gi->region0_count = (gi->block_type == 2 && !gi->mixed_block) ? 8 : 7;
          gi->region1_count = 20 - gi->region0_count;
        } else {
          gi->block_type = 0;
          gi->mixed_block = 0;
          for (int r = 0; r < 3; r++) gi->table_select[r] = br.read(5);
          gi->region0_count = br.read(4);
          gi->region1_count = br.read(3);
          gi->subblock_gain[0] = gi->subblock_gain[1] = gi->subblock_gain[2] = 0;
        }
        gi->preflag = br.read1();
        gi->scalefac_scale = br.read1();
        gi->count1table_select = br.read1();
        if (gi->big_values > 288) return false;
      }
    }
  } else {
    // MPEG-2 LSF: one granule, 8-bit main_data_begin? (spec 13818-3 2.4.1.7:
    // main_data_begin 8 bits, private 1/2, no scfsi, 9-bit scalefac_compress)
    si->main_data_begin = br.read(8);
    br.skip(nch == 1 ? 1 : 2);
    for (int c = 0; c < nch; c++) {
      GranuleInfo* gi = &si->gr[0][c];
      gi->part2_3_length = br.read(12);
      gi->big_values = br.read(9);
      gi->global_gain = br.read(8);
      gi->scalefac_compress = br.read(9);
      gi->window_switching = br.read1();
      if (gi->window_switching) {
        gi->block_type = br.read(2);
        gi->mixed_block = br.read1();
        for (int r = 0; r < 2; r++) gi->table_select[r] = br.read(5);
        gi->table_select[2] = 0;
        for (int w = 0; w < 3; w++) gi->subblock_gain[w] = br.read(3);
        if (gi->block_type == 0) return false;
        gi->region0_count = (gi->block_type == 2 && !gi->mixed_block) ? 8 : 7;
        gi->region1_count = 20 - gi->region0_count;
      } else {
        gi->block_type = 0;
        gi->mixed_block = 0;
        for (int r = 0; r < 3; r++) gi->table_select[r] = br.read(5);
        gi->region0_count = br.read(4);
        gi->region1_count = br.read(3);
        gi->subblock_gain[0] = gi->subblock_gain[1] = gi->subblock_gain[2] = 0;
      }
      gi->preflag = 0;  // LSF: derived from scalefac_compress, not a bit
      gi->scalefac_scale = br.read1();
      gi->count1table_select = br.read1();
      if (gi->big_values > 288) return false;
    }
  }
  return true;
}

// ---------------------------------------------------------------------------
// Scalefactors.

// MPEG-1 (spec 2.4.2.7): returns bits read.
int read_scalefactors_mpeg1(BitReader& br, const GranuleInfo& gi,
                            const int scfsi[4], bool first_granule,
                            int sf_l[23], int sf_s[13][3],
                            const int prev_l[23]) {
  int64_t start = br.pos;
  int s1 = kSlen1[gi.scalefac_compress];
  int s2 = kSlen2[gi.scalefac_compress];
  if (gi.window_switching && gi.block_type == 2) {
    if (gi.mixed_block) {
      for (int b = 0; b < 8; b++) sf_l[b] = s1 ? (int)br.read(s1) : 0;
      for (int b = 3; b < 6; b++)
        for (int w = 0; w < 3; w++) sf_s[b][w] = s1 ? (int)br.read(s1) : 0;
      for (int b = 6; b < 12; b++)
        for (int w = 0; w < 3; w++) sf_s[b][w] = s2 ? (int)br.read(s2) : 0;
    } else {
      for (int b = 0; b < 6; b++)
        for (int w = 0; w < 3; w++) sf_s[b][w] = s1 ? (int)br.read(s1) : 0;
      for (int b = 6; b < 12; b++)
        for (int w = 0; w < 3; w++) sf_s[b][w] = s2 ? (int)br.read(s2) : 0;
    }
    for (int w = 0; w < 3; w++) sf_s[12][w] = 0;
  } else {
    // scfsi groups: 0-5, 6-10, 11-15, 16-20
    static const int kGroupStart[5] = {0, 6, 11, 16, 21};
    for (int grp = 0; grp < 4; grp++) {
      int slen = (grp < 2) ? s1 : s2;
      bool copy = !first_granule && scfsi[grp];
      for (int b = kGroupStart[grp]; b < kGroupStart[grp + 1]; b++) {
        if (copy)
          sf_l[b] = prev_l[b];
        else
          sf_l[b] = slen ? (int)br.read(slen) : 0;
      }
    }
    sf_l[21] = 0;
    sf_l[22] = 0;
  }
  return (int)(br.pos - start);
}

// MPEG-2 LSF scalefactors (spec 13818-3 2.4.3.2): slen/group layout derived
// from the 9-bit scalefac_compress.  Intensity-stereo channel-1 variant
// included; preflag is implied by sfc >= 500.
int read_scalefactors_lsf(BitReader& br, GranuleInfo& gi, bool is_right_intensity,
                          int sf_l[23], int sf_s[13][3]) {
  int64_t start = br.pos;
  int slen[4] = {0, 0, 0, 0};
  int nr[4] = {0, 0, 0, 0};
  int sfc = gi.scalefac_compress;
  int blocktype2 = (gi.window_switching && gi.block_type == 2);
  int mixed = blocktype2 && gi.mixed_block;
  int blocknumber;  // selects the partition-size row
  if (!is_right_intensity) {
    if (sfc < 400) {
      slen[0] = (sfc >> 4) / 5; slen[1] = (sfc >> 4) % 5;
      slen[2] = (sfc & 15) >> 2; slen[3] = sfc & 3;
      gi.preflag = 0; blocknumber = 0;
    } else if (sfc < 500) {
      int c = sfc - 400;
      slen[0] = (c >> 2) / 5; slen[1] = (c >> 2) % 5;
      slen[2] = c & 3; slen[3] = 0;
      gi.preflag = 0; blocknumber = 1;
    } else {
      int c = sfc - 500;
      slen[0] = c / 3; slen[1] = c % 3; slen[2] = 0; slen[3] = 0;
      gi.preflag = 1; blocknumber = 2;
    }
  } else {
    // intensity-stereo right channel (spec: int_scalefac_compress = sfc >> 1)
    int c = sfc >> 1;
    if (c < 180) {
      slen[0] = c / 36; slen[1] = (c % 36) / 6; slen[2] = c % 6; slen[3] = 0;
      blocknumber = 3;
    } else if (c < 244) {
      c -= 180;
      slen[0] = (c & 63) >> 4; slen[1] = (c & 15) >> 2; slen[2] = c & 3; slen[3] = 0;
      blocknumber = 4;
    } else {
      c -= 244;
      slen[0] = c / 3; slen[1] = c % 3; slen[2] = 0; slen[3] = 0;
      blocknumber = 5;
    }
    gi.preflag = 0;
  }
  static const int kNrPart[6][3][4] = {
      // [blocknumber][block kind: long / short / mixed][partition]
      {{6, 5, 5, 5}, {9, 9, 9, 9}, {6, 9, 9, 9}},
      {{6, 5, 7, 3}, {9, 9, 12, 6}, {6, 9, 12, 6}},
      {{11, 10, 0, 0}, {18, 18, 0, 0}, {15, 18, 0, 0}},
      {{7, 7, 7, 0}, {12, 12, 12, 0}, {6, 15, 12, 0}},
      {{6, 6, 6, 3}, {12, 9, 9, 6}, {6, 12, 9, 6}},
      {{8, 8, 5, 0}, {15, 12, 9, 0}, {6, 18, 9, 0}}};
  int kind = blocktype2 ? (mixed ? 2 : 1) : 0;
  for (int p = 0; p < 4; p++) nr[p] = kNrPart[blocknumber][kind][p];

  // Read the linear scalefactor list then scatter to long/short layout.
  int raw[54];
  int total = 0;
  for (int p = 0; p < 4; p++)
    for (int i = 0; i < nr[p]; i++) raw[total++] = slen[p] ? (int)br.read(slen[p]) : 0;
  int idx = 0;
  if (blocktype2) {
    if (mixed) {
      for (int b = 0; b < 6 && idx < total; b++) sf_l[b] = raw[idx++];
      for (int b = 3; b < 13; b++)
        for (int w = 0; w < 3; w++) sf_s[b][w] = (idx < total) ? raw[idx++] : 0;
    } else {
      for (int b = 0; b < 13; b++)
        for (int w = 0; w < 3; w++) sf_s[b][w] = (idx < total) ? raw[idx++] : 0;
    }
  } else {
    for (int b = 0; b < 22; b++) sf_l[b] = (idx < total) ? raw[idx++] : 0;
    sf_l[22] = 0;
  }
  return (int)(br.pos - start);
}

// ---------------------------------------------------------------------------
// Huffman spectral decode (spec 2.4.3.4.6).  Returns false on table error.

bool huffman_decode(BitReader& br, const FrameHeader& h, const GranuleInfo& gi,
                    int64_t part2_3_end, float xr[576], int* nonzero_bound) {
  const int* bl = sfb_long(h);
  int region1_start, region2_start;
  if (gi.window_switching && gi.block_type == 2) {
    // short blocks: region0 covers the first 3 short scalefactor bands (x3
    // windows) — 36 lines everywhere EXCEPT 8 kHz MPEG-2.5 whose doubled
    // band widths make it 3*bs[3] = 72 (oracle-verified divergence probe,
    // tools/mp3_recover).  Mixed blocks keep the long-band rule below.
    if (gi.mixed_block) {
      region1_start = bl[8];
    } else {
      region1_start = 3 * sfb_short(h)[3];
    }
    region2_start = 576;  // no region 2 for short blocks
  } else {
    int r0 = gi.region0_count + 1;
    int r1 = r0 + gi.region1_count + 1;
    if (r0 > 22) r0 = 22;
    if (r1 > 22) r1 = 22;
    region1_start = bl[r0];
    region2_start = bl[r1];
  }
  float gg = gain_pow2(gi.global_gain - 210);  // applied later per band
  (void)gg;
  int pos = 0;
  int maxpos = 0;
  for (int i = 0; i < 576; i++) xr[i] = 0.f;
  int bigv = gi.big_values * 2;
  if (bigv > 576) return false;
  while (pos < bigv) {
    // A pair starting at/after the part2_3 boundary is not decoded, and a
    // pair whose reads CROSS the boundary is discarded (same rule as the
    // count1 rollback below; libav-verified via the oracle line-diff).
    if (br.pos >= part2_3_end) break;
    int pair_start_pos = pos;
    int prev_max = maxpos;
    int region = (pos < region1_start) ? 0 : (pos < region2_start ? 1 : 2);
    int tsel = gi.table_select[region];
    if (tsel == 4 || tsel == 14) return false;
    const HuffTable& t = g_huff.big[tsel];
    int lb = g_huff.linbits[tsel];
    int x, y;
    if (tsel == 0) {
      x = y = 0;
    } else {
      if (!t.ok) return false;
      int v = t.decode(br);
      if (v < 0) return false;
      x = v >> 5;
      y = v & 31;
    }
    // escape + sign handling
    float fx, fy;
    if (x == 15 && lb > 0) x += (int)br.read(lb);
    fx = g_pow.pow43[x < 8207 ? x : 8206];
    if (x) { if (br.read1()) fx = -fx; }
    if (y == 15 && lb > 0) y += (int)br.read(lb);
    fy = g_pow.pow43[y < 8207 ? y : 8206];
    if (y) { if (br.read1()) fy = -fy; }
    xr[pos] = fx;
    xr[pos + 1] = fy;
    if (x) maxpos = pos + 1;
    if (y) maxpos = pos + 2;
    pos += 2;
    if (br.pos > part2_3_end) {
      xr[pair_start_pos] = 0.f;
      xr[pair_start_pos + 1] = 0.f;
      maxpos = prev_max;
      break;
    }
  }
  // count1 region: quads until bits exhausted
  const HuffTable& c1 = g_huff.count1[gi.count1table_select];
  if (!c1.ok) return false;
  int prev_maxpos = maxpos;
  while (br.pos < part2_3_end && pos < 576) {
    int quad_start_pos = pos;
    int64_t quad_start_bit = br.pos;
    int v = c1.decode(br);
    if (v < 0) return false;
    // v bits: (v,w,x,y) as 4 bits, MSB = v
    int q[4] = {(v >> 3) & 1, (v >> 2) & 1, (v >> 1) & 1, v & 1};
    prev_maxpos = maxpos;
    for (int i = 0; i < 4 && pos < 576; i++, pos++) {
      if (q[i]) {
        float f = br.read1() ? -1.f : 1.f;
        xr[pos] = f;
        maxpos = pos + 1;
      }
    }
    if (br.pos > part2_3_end) {
      // A quad that overruns part2_3_length is DISCARDED (spec 2.4.3.4.6 /
      // libav behavior, verified line-exactly by the oracle harness): zero
      // its lines and roll maxpos back before realigning.
      for (int k = quad_start_pos; k < pos; k++) xr[k] = 0.f;
      maxpos = prev_maxpos;
      (void)quad_start_bit;
      break;
    }
  }
  br.pos = part2_3_end;  // realign (stuffing bits or discarded-quad tail)
  *nonzero_bound = maxpos;
  return true;
}

// ---------------------------------------------------------------------------
// Requantization (spec 2.4.3.4.7.1).

void requantize(const FrameHeader& h, const GranuleInfo& gi,
                const int sf_l[23], const int sf_s[13][3], float xr[576],
                int nonzero_bound) {
  const int* bl = sfb_long(h);
  const int* bs = sfb_short(h);
  double sf_mult = gi.scalefac_scale ? 1.0 : 0.5;
  bool short_blocks = gi.window_switching && gi.block_type == 2;
  int long_end = 0;  // spectral lines treated as long block
  if (!short_blocks)
    long_end = 576;
  else if (gi.mixed_block)
    long_end = h.mpeg1() ? 36 : 36;

  // Long-block portion
  int sfb = 0;
  for (int i = 0; i < long_end && i < nonzero_bound;) {
    while (sfb < 21 && bl[sfb + 1] <= i) sfb++;
    double exp = 0.25 * (gi.global_gain - 210) -
                 sf_mult * (sf_l[sfb] + gi.preflag * kPretab[sfb]);
    float g = (float)pow(2.0, exp);
    int end = bl[sfb + 1];
    if (end > long_end) end = long_end;
    for (; i < end && i < nonzero_bound; i++) xr[i] *= g;
    if (i >= end && end == long_end) break;
  }
  if (!short_blocks) return;

  // Short-block portion: spectrum laid out as [sfb][window][line]
  int start_sfb = 0;
  int i = long_end;
  if (gi.mixed_block) {
    // find the short sfb whose start matches long_end in short layout: the
    // mixed layout switches at line 36 == 3 windows * bs line 12? Spec: short
    // bands start at sfb 3 for mixed blocks (MPEG-1).
    start_sfb = 3;
    i = bs[3] * 3;
  }
  for (int b = start_sfb; b < 13 && i < 576; b++) {
    int width = bs[b + 1] - bs[b];
    for (int w = 0; w < 3; w++) {
      double exp = 0.25 * (gi.global_gain - 210 - 8 * gi.subblock_gain[w]) -
                   sf_mult * sf_s[b][w];
      float g = (float)pow(2.0, exp);
      for (int k = 0; k < width && i < 576; k++, i++)
        if (i < nonzero_bound) xr[i] *= g;
    }
  }
}

// ---------------------------------------------------------------------------
// Short-block reorder (spec 2.4.3.4.8): from [sfb][window][line] order to
// [subband sample] order interleaved by window: out[sb*18 + w*6 + k]... the
// target layout groups lines so each 18-line subband holds 3 windows x 6.

void reorder_short(const FrameHeader& h, const GranuleInfo& gi, float xr[576],
                   int* nonzero_bound) {
  if (!(gi.window_switching && gi.block_type == 2)) return;
  const int* bs = sfb_short(h);
  float tmp[576];
  memcpy(tmp, xr, sizeof(tmp));
  int start_sfb = gi.mixed_block ? 3 : 0;
  int src = bs[start_sfb] * 3;
  for (int b = start_sfb; b < 13; b++) {
    int width = bs[b + 1] - bs[b];
    for (int w = 0; w < 3; w++) {
      for (int k = 0; k < width; k++) {
        int dst = 3 * bs[b] + 3 * k + w;  // interleave lines across windows
        if (dst < 576 && src < 576) xr[dst] = tmp[src];
        src++;
      }
    }
  }
  if (*nonzero_bound > 0) *nonzero_bound = 576;  // reorder spreads lines
}

// ---------------------------------------------------------------------------
// Stereo processing (spec 2.4.3.4.9).

void process_stereo(const FrameHeader& h, const GranuleInfo& gi_right,
                    const int sf_l_r[23], const int sf_s_r[13][3],
                    float xl[576], float xr_[576], int nzb[2]) {
  bool ms = (h.mode == 1) && (h.mode_ext & 2);
  bool intensity = (h.mode == 1) && (h.mode_ext & 1);
  int max_nzb = nzb[0] > nzb[1] ? nzb[0] : nzb[1];
  if (ms) {
    const float inv_sqrt2 = 0.70710678118654752f;
    for (int i = 0; i < max_nzb; i++) {
      float m = xl[i], s = xr_[i];
      xl[i] = (m + s) * inv_sqrt2;
      xr_[i] = (m - s) * inv_sqrt2;
    }
    nzb[0] = nzb[1] = max_nzb;
  }
  if (!intensity) return;
  // Intensity: bands above the right channel's nonzero bound.
  const int* bl = sfb_long(h);
  const int* bs = sfb_short(h);
  bool short_blocks = gi_right.window_switching && gi_right.block_type == 2;
  int right_bound = nzb[1];
  if (!short_blocks) {
    for (int b = 0; b < 22; b++) {
      if (bl[b] < right_bound) continue;
      int is_pos = sf_l_r[b];
      if (is_pos == 7) continue;  // illegal -> leave as-is (MS result)
      float ratio_l, ratio_r;
      if (h.mpeg1()) {
        float angle = (float)(is_pos * (3.14159265358979 / 12.0));
        float t = tanf(angle);
        ratio_l = t / (1.f + t);
        ratio_r = 1.f / (1.f + t);
      } else {
        // LSF intensity: 2^(-(is_pos+1)/2 * ...) simplified common form
        float f = (float)pow(2.0, -0.5 * ((is_pos + 1) >> 1));
        if (is_pos == 0) { ratio_l = 1.f; ratio_r = 1.f; }
        else if (is_pos & 1) { ratio_l = f; ratio_r = 1.f; }
        else { ratio_l = 1.f; ratio_r = f; }
      }
      for (int i = bl[b]; i < bl[b + 1] && i < 576; i++) {
        float v = xl[i];
        xl[i] = v * ratio_l;
        xr_[i] = v * ratio_r;
      }
      if (bl[b + 1] > nzb[1]) nzb[1] = bl[b + 1];
    }
  } else {
    for (int b = 0; b < 13; b++) {
      int width = bs[b + 1] - bs[b];
      for (int w = 0; w < 3; w++) {
        int start = 3 * bs[b] + w * width;  // pre-reorder layout... we run
        // intensity AFTER reorder, so lines of window w sit interleaved; use
        // the interleaved positions:
        (void)start;
        int is_pos = sf_s_r[b][w];
        if (is_pos == 7) continue;
        float ratio_l, ratio_r;
        float angle = (float)(is_pos * (3.14159265358979 / 12.0));
        float t = tanf(angle);
        ratio_l = t / (1.f + t);
        ratio_r = 1.f / (1.f + t);
        for (int k = 0; k < width; k++) {
          int i = 3 * bs[b] + 3 * k + w;
          if (i >= right_bound && i < 576) {
            float v = xl[i];
            xl[i] = v * ratio_l;
            xr_[i] = v * ratio_r;
          }
        }
      }
      if (3 * bs[b + 1] > nzb[1]) nzb[1] = 3 * bs[b + 1] < 576 ? 3 * bs[b + 1] : 576;
    }
  }
}

// ---------------------------------------------------------------------------
// Alias reduction (spec 2.4.3.4.10.1).

void alias_reduce(const GranuleInfo& gi, float xr[576], int nonzero_bound) {
  static const double ci[8] = {-0.6, -0.535, -0.33, -0.185,
                               -0.095, -0.041, -0.0142, -0.0037};
  static float cs[8], ca[8];
  static bool init = false;
  if (!init) {
    init = true;
    for (int i = 0; i < 8; i++) {
      double d = sqrt(1.0 + ci[i] * ci[i]);
      cs[i] = (float)(1.0 / d);
      ca[i] = (float)(ci[i] / d);
    }
  }
  bool short_blocks = gi.window_switching && gi.block_type == 2;
  int n_boundaries;
  if (short_blocks && !gi.mixed_block) return;
  if (short_blocks && gi.mixed_block)
    n_boundaries = 1;
  else {
    int sblimit = (nonzero_bound + 17) / 18;
    n_boundaries = sblimit - 1;
    if (n_boundaries > 31) n_boundaries = 31;
    if (n_boundaries < 0) n_boundaries = 0;
  }
  for (int sb = 0; sb < n_boundaries; sb++) {
    int base = 18 * sb + 17;  // last line of subband sb
    for (int i = 0; i < 8; i++) {
      int up = base - i;
      int down = base + 1 + i;
      float u = xr[up], d = xr[down];
      xr[up] = u * cs[i] - d * ca[i];
      xr[down] = d * cs[i] + u * ca[i];
    }
  }
}

// ---------------------------------------------------------------------------
// IMDCT + windowing + overlap add (spec 2.4.3.4.10.2-3).

struct ImdctTables {
  float win[4][36];
  float cos36[18][36];  // cos(pi/72 * (2i+1+18) * (2k+1)) for n=36
  float cos12[6][12];
  bool init_done = false;
  void init() {
    if (init_done) return;
    init_done = true;
    for (int i = 0; i < 36; i++) win[0][i] = (float)sin(M_PI / 36 * (i + 0.5));
    for (int i = 0; i < 36; i++) {
      if (i < 18) win[1][i] = (float)sin(M_PI / 36 * (i + 0.5));
      else if (i < 24) win[1][i] = 1.f;
      else if (i < 30) win[1][i] = (float)sin(M_PI / 12 * (i - 18 + 0.5));
      else win[1][i] = 0.f;
    }
    for (int i = 0; i < 36; i++) {
      if (i < 6) win[3][i] = 0.f;
      else if (i < 12) win[3][i] = (float)sin(M_PI / 12 * (i - 6 + 0.5));
      else if (i < 18) win[3][i] = 1.f;
      else win[3][i] = (float)sin(M_PI / 36 * (i + 0.5));
    }
    for (int i = 0; i < 12; i++) win[2][i] = (float)sin(M_PI / 12 * (i + 0.5));
    for (int k = 0; k < 18; k++)
      for (int i = 0; i < 36; i++)
        cos36[k][i] = (float)cos(M_PI / 72.0 * (2 * i + 1 + 18) * (2 * k + 1));
    for (int k = 0; k < 6; k++)
      for (int i = 0; i < 12; i++)
        cos12[k][i] = (float)cos(M_PI / 24.0 * (2 * i + 1 + 6) * (2 * k + 1));
  }
};
ImdctTables g_imdct;

// One subband's 18 spectral lines -> 18 time samples (with overlap state).
void imdct_subband(const float in[18], int block_type, float out[18],
                   float overlap[18]) {
  g_imdct.init();
  float raw[36];
  if (block_type == 2) {
    // three 12-point IMDCTs, windowed, overlapped at 6-sample offsets
    float tmp[36] = {0};
    for (int w = 0; w < 3; w++) {
      float s[12];
      for (int i = 0; i < 12; i++) {
        double acc = 0;
        for (int k = 0; k < 6; k++) acc += in[w + 3 * k] * g_imdct.cos12[k][i];
        s[i] = (float)acc * g_imdct.win[2][i];
      }
      int off = 6 + w * 6;
      for (int i = 0; i < 12; i++) tmp[off + i] += s[i];
    }
    for (int i = 0; i < 36; i++) raw[i] = tmp[i];
  } else {
    for (int i = 0; i < 36; i++) {
      double acc = 0;
      for (int k = 0; k < 18; k++) acc += in[k] * g_imdct.cos36[k][i];
      raw[i] = (float)acc * g_imdct.win[block_type][i];
    }
  }
  for (int i = 0; i < 18; i++) {
    out[i] = raw[i] + overlap[i];
    overlap[i] = raw[18 + i];
  }
}

// ---------------------------------------------------------------------------
// Polyphase synthesis filterbank (spec 2.4.3.4.10.4 + Annex B table B.3).

#include "mp3_synth_window.h"  // const float kSynthWindow[512]

struct SynthTables {
  float nmat[64][32];  // cos((16+i)(2k+1) pi / 64)
  bool init_done = false;
  void init() {
    if (init_done) return;
    init_done = true;
    for (int i = 0; i < 64; i++)
      for (int k = 0; k < 32; k++)
        nmat[i][k] = (float)cos((16 + i) * (2 * k + 1) * M_PI / 64.0);
  }
};
SynthTables g_synth;

// One time slot: 32 subband samples -> 32 PCM samples.
void synth_slot(ChannelState* st, const float sb[32], float out[32]) {
  g_synth.init();
  st->v_off = (st->v_off - 64) & 1023;
  float* v = st->v;
  for (int i = 0; i < 64; i++) {
    double acc = 0;
    for (int k = 0; k < 32; k++) acc += g_synth.nmat[i][k] * sb[k];
    v[(st->v_off + i) & 1023] = (float)acc;
  }
  for (int j = 0; j < 32; j++) {
    double acc = 0;
    // standard windowing: 16 taps, alternating halves of the FIFO
    for (int i = 0; i < 8; i++) {
      acc += (double)v[(st->v_off + (i << 7) + j) & 1023] * kSynthWindow[(i << 6) + j];
      acc += (double)v[(st->v_off + (i << 7) + 96 + j) & 1023] * kSynthWindow[(i << 6) + 32 + j];
    }
    out[j] = (float)acc;
  }
}

// ---------------------------------------------------------------------------
// Whole-granule back end: xr[576] -> 576 PCM samples appended to out.

void granule_to_pcm(const FrameHeader&, const GranuleInfo& gi,
                    ChannelState* st, float xr[576], int /*nonzero_bound*/,
                    float* out /*576*/) {
  alias_reduce(gi, xr, 576);
  bool short_blocks = gi.window_switching && gi.block_type == 2;
  int long_subbands;
  if (!short_blocks) long_subbands = 32;
  else if (gi.mixed_block) long_subbands = 2;
  else long_subbands = 0;

  float tsb[32][18];  // time samples per subband
  for (int sb = 0; sb < 32; sb++) {
    int bt = (sb < long_subbands) ? gi.block_type : (short_blocks ? 2 : gi.block_type);
    if (short_blocks && sb < long_subbands) bt = 0;  // mixed: lower 2 are long
    imdct_subband(&xr[18 * sb], bt, tsb[sb], st->overlap[sb]);
  }
  // frequency inversion: odd subbands, odd time samples
  for (int sb = 1; sb < 32; sb += 2)
    for (int i = 1; i < 18; i += 2) tsb[sb][i] = -tsb[sb][i];
  // synthesis: 18 slots of 32 samples
  float slot_in[32], slot_out[32];
  for (int s = 0; s < 18; s++) {
    for (int sb = 0; sb < 32; sb++) slot_in[sb] = tsb[sb][s];
    synth_slot(st, slot_in, slot_out);
    memcpy(&out[32 * s], slot_out, sizeof(slot_out));
  }
}

}  // namespace

// ===========================================================================
// Public C API.

extern "C" {

// Validates all huffman tables; returns 0 on success, else a bitmask of
// failures (bit 0: a big-value table is invalid; bit 1: count1 invalid).
int mp3_selftest() {
  build_tables();
  int rc = 0;
  for (const Mp3HuffSpec* s = kMp3BigTables; s->n >= 0; s++)
    if (!g_huff.big[s->id].ok) { rc |= 1; fprintf(stderr, "mp3: table %d invalid\n", s->id); }
  if (!g_huff.count1[0].ok) { rc |= 2; fprintf(stderr, "mp3: count1 A invalid\n"); }
  if (!g_huff.count1[1].ok) { rc |= 2; fprintf(stderr, "mp3: count1 B invalid\n"); }
  return rc;
}

// Probe: scan the stream, return frame count; fills sample_rate/channels.
// Returns -1 if no valid Layer III frame is found.
int64_t mp3_probe(const uint8_t* data, int64_t nbytes, int* sample_rate,
                  int* channels, int* samples_per_frame) {
  int64_t i = 0;
  if (nbytes > 10 && data[0] == 'I' && data[1] == 'D' && data[2] == '3') {
    int64_t sz = ((int64_t)(data[6] & 0x7F) << 21) | ((data[7] & 0x7F) << 14) |
                 ((data[8] & 0x7F) << 7) | (data[9] & 0x7F);
    i = 10 + sz;
  }
  int64_t frames = 0;
  FrameHeader h;
  bool first = true;
  while (i + 4 <= nbytes) {
    if (data[i] == 0xFF && (data[i + 1] & 0xE0) == 0xE0 && parse_header(&data[i], &h)) {
      if (first) {
        *sample_rate = h.sample_rate;
        *channels = h.nchan();
        *samples_per_frame = h.samples_per_frame();
        first = false;
      }
      frames++;
      i += h.frame_bytes;
    } else {
      i++;
    }
  }
  return first ? -1 : frames;
}

// Decode the stream into interleaved float32 PCM.  Returns the number of
// samples (per channel) written, or -1 on hard failure.  `max_floats` is the
// capacity of `out` in floats: no write reaches out[max_floats], whatever the
// channel count of the audio frames (the first frame, which mp3_probe reads,
// may be a mono tag frame before stereo audio).  Writes the number of frames
// whose granule bit-accounting mismatched into *bad_frames (0 for a clean
// file).
int64_t mp3_decode(const uint8_t* data, int64_t nbytes, float* out,
                   int64_t max_floats, int* sample_rate, int* channels,
                   int* bad_frames) {
  build_tables();
  if (!g_huff.all_ok) return -1;
  // The Decoder is large (heap once, not per call) and stateful; serialize
  // concurrent decode_mp3 callers (e.g. serving threads loading prompts).
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  static Decoder dec;
  dec.reset();

  int64_t i = 0;
  if (nbytes > 10 && data[0] == 'I' && data[1] == 'D' && data[2] == '3') {
    int64_t sz = ((int64_t)(data[6] & 0x7F) << 21) | ((data[7] & 0x7F) << 14) |
                 ((data[8] & 0x7F) << 7) | (data[9] & 0x7F);
    i = 10 + sz;
  }
  int64_t written = 0;
  int64_t max_samples = 0;  // per channel, set by the first audio frame
  bool first = true;
  int nch = 1;
  // Gapless playback info (Xing/Info + LAME tag in the first frame):
  // encoder delay + 529-sample decoder delay trimmed from the front,
  // encoder padding from the back — matches libav's handling, which also
  // skips the whole tag frame.  Defaults: no trim for headerless streams.
  int64_t trim_front = 0, trim_back = 0;
  bool tag_checked = false;
  while (i + 4 <= nbytes) {
    FrameHeader h;
    if (!(data[i] == 0xFF && (data[i + 1] & 0xE0) == 0xE0 && parse_header(&data[i], &h))) {
      i++;
      continue;
    }
    if (i + h.frame_bytes > nbytes) break;
    if (!tag_checked) {
      tag_checked = true;
      // Xing/Info magic sits right after the (all-zero) side info of the
      // first frame; the LAME extension carries encoder delay/padding.
      int side = h.mpeg1() ? (h.nchan() == 1 ? 17 : 32)
                           : (h.nchan() == 1 ? 9 : 17);
      int64_t off = i + 4 + (h.crc_protected ? 2 : 0) + side;
      if (off + 8 <= nbytes &&
          (memcmp(&data[off], "Xing", 4) == 0 ||
           memcmp(&data[off], "Info", 4) == 0)) {
        // flags -> optional fields before the LAME block
        uint32_t flags = ((uint32_t)data[off + 4] << 24) |
                         (data[off + 5] << 16) | (data[off + 6] << 8) |
                         data[off + 7];
        int64_t p = off + 8;
        if (flags & 1) p += 4;   // frame count
        if (flags & 2) p += 4;   // byte count
        if (flags & 4) p += 100; // TOC
        if (flags & 8) p += 4;   // quality
        // LAME tag: 20 bytes of version string etc.; delay/padding are the
        // 3 bytes at offset +21 from its start (12+12 bits)
        if (p + 24 <= nbytes) {
          int64_t lame = p;       // "LAME..." version string
          int64_t dp = lame + 21;
          if (dp + 3 <= nbytes) {
            int delay = (data[dp] << 4) | (data[dp + 1] >> 4);
            int padding = ((data[dp + 1] & 0x0F) << 8) | data[dp + 2];
            if (delay >= 0 && delay < 4096 && padding >= 0 && padding < 4096) {
              trim_front = delay + 529;
              trim_back = padding > 529 ? padding - 529 : 0;
            }
          }
        }
        i += h.frame_bytes;  // the tag frame carries no audio
        continue;
      }
    }
    if (first) {
      *sample_rate = h.sample_rate;
      nch = h.nchan();
      *channels = nch;
      max_samples = max_floats / nch;
      first = false;
    } else if (h.nchan() != nch || h.sample_rate != *sample_rate) {
      i += h.frame_bytes;  // skip inconsistent frame
      continue;
    }

    BitReader br;
    br.init(&data[i], h.frame_bytes);
    br.skip(32);                      // header
    if (h.crc_protected) br.skip(16); // CRC
    SideInfo si;
    if (!parse_side_info(br, h, &si)) {
      dec.bad_frames++;
      i += h.frame_bytes;
      continue;
    }
    // main data handling via bit reservoir
    int side_bytes = h.mpeg1() ? (nch == 1 ? 17 : 32) : (nch == 1 ? 9 : 17);
    int header_bytes = 4 + (h.crc_protected ? 2 : 0);
    int main_bytes = h.frame_bytes - header_bytes - side_bytes;
    if (main_bytes < 0) { i += h.frame_bytes; continue; }
    if (si.main_data_begin > dec.reservoir_len) {
      // missing reservoir data (stream start / seek): stash and skip
      if (dec.reservoir_len + main_bytes <= (int)sizeof(dec.reservoir)) {
        memcpy(dec.reservoir + dec.reservoir_len,
               &data[i + header_bytes + side_bytes], main_bytes);
        dec.reservoir_len += main_bytes;
      } else {
        dec.reservoir_len = 0;
      }
      i += h.frame_bytes;
      continue;
    }
    // assemble this frame's main data: last main_data_begin bytes of the
    // reservoir + this frame's main bytes
    uint8_t md[8192];
    int md_len = 0;
    memcpy(md, dec.reservoir + dec.reservoir_len - si.main_data_begin,
           si.main_data_begin);
    md_len = si.main_data_begin;
    int copy = main_bytes;
    if (md_len + copy > (int)sizeof(md)) copy = (int)sizeof(md) - md_len;
    memcpy(md + md_len, &data[i + header_bytes + side_bytes], copy);
    md_len += copy;
    // roll reservoir forward (keep at most 511 bytes, spec reservoir limit)
    {
      int keep = dec.reservoir_len + main_bytes;
      if (keep > 511) keep = 511;
      // reservoir := last `keep` bytes of (old reservoir + new main data)
      uint8_t tmp[65536 + 8192];
      memcpy(tmp, dec.reservoir, dec.reservoir_len);
      memcpy(tmp + dec.reservoir_len, &data[i + header_bytes + side_bytes],
             main_bytes);
      int total = dec.reservoir_len + main_bytes;
      memcpy(dec.reservoir, tmp + total - keep, keep);
      dec.reservoir_len = keep;
    }

    BitReader mbr;
    mbr.init(md, md_len);
    int n_gran = h.mpeg1() ? 2 : 1;
    bool frame_ok = true;
    float pcm[2][1152];
    for (int g = 0; g < n_gran && frame_ok; g++) {
      for (int c = 0; c < nch && frame_ok; c++) {
        GranuleInfo& gi = si.gr[g][c];
        int64_t part_start = mbr.pos;
        int64_t part_end = part_start + gi.part2_3_length;
        int part2;
        bool right_intensity = (!h.mpeg1()) && (h.mode == 1) &&
                               (h.mode_ext & 1) && (c == 1);
        if (h.mpeg1())
          part2 = read_scalefactors_mpeg1(mbr, gi, si.scfsi[c], g == 0,
                                          dec.scalefac_l[c], dec.scalefac_s[c],
                                          dec.scalefac_l[c]);
        else
          part2 = read_scalefactors_lsf(mbr, gi, right_intensity,
                                        dec.scalefac_l[c], dec.scalefac_s[c]);
        (void)part2;
        if (part_end > (int64_t)md_len * 8 ||
            !huffman_decode(mbr, h, gi, part_end, dec.xr[c],
                            &dec.nonzero_bound[c])) {
          frame_ok = false;
          break;
        }
        // The spec invariant: we must sit exactly at part_end now.
        if (mbr.pos != part_end) frame_ok = false;
        requantize(h, gi, dec.scalefac_l[c], dec.scalefac_s[c], dec.xr[c],
                   dec.nonzero_bound[c]);
        reorder_short(h, gi, dec.xr[c], &dec.nonzero_bound[c]);
      }
      if (!frame_ok) break;
      if (nch == 2)
        process_stereo(h, si.gr[g][1], dec.scalefac_l[1], dec.scalefac_s[1],
                       dec.xr[0], dec.xr[1], dec.nonzero_bound);
      for (int c = 0; c < nch; c++)
        granule_to_pcm(h, si.gr[g][c], &dec.ch_state[c], dec.xr[c],
                       dec.nonzero_bound[c], &pcm[c][g * 576]);
    }
    if (frame_ok) {
      int n = n_gran * 576;
      for (int s = 0; s < n && written < max_samples; s++, written++)
        for (int c = 0; c < nch; c++)
          out[written * nch + c] = pcm[c][s];
      dec.good_frames++;
    } else {
      dec.bad_frames++;
    }
    i += h.frame_bytes;
  }
  *bad_frames = dec.bad_frames;
  if (first) return -1;
  // gapless trim (LAME tag): drop encoder+decoder delay from the front and
  // encoder padding from the back
  if (trim_front + trim_back > 0 && written > trim_front + trim_back) {
    written -= trim_front + trim_back;
    memmove(out, out + trim_front * nch,
            (size_t)written * nch * sizeof(float));
  }
  return written;
}

}  // extern "C"
