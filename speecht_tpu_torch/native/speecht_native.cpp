// FLAC decoding and Kaiser windowed-sinc resampling (host side).
//
// The port's own copy of the audio half of the JAX package's
// `speecht_tpu/native/speecht_native.cpp`: the same FLAC decoder (fixed
// and LPC predictors, every rice partition layout, stereo decorrelation,
// mono output) and the same polyphase resampler (the Kaiser-windowed sinc
// table and its rational polyphase bank), so the same file gives the same
// float32 samples bit for bit when both are built with the same arithmetic
// flags (-O3, no -march=native, no -ffast-math). It differs in what it
// exports, not in its arithmetic: its C++ sits in a namespace of its own,
// the library is built with hidden visibility and exports only the `stt_`
// C functions below, and it has no edit distance (the port's metrics keep
// their Python bit-vector version).
//
//   stt_flac_decode_file  -- FLAC file -> mono float32 in [-1, 1) at the
//                            file's own rate
//   stt_resample          -- float32 audio from one rate to another;
//                            output length ceil(n_in * sr_out / sr_in)
//   stt_free              -- frees the buffers the two functions return
//   stt_crc32c            -- CRC32C (Castagnoli) of a buffer, unmasked: the
//                            TF checkpoint reader's check of each tensor

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>
#include <memory>
#include <mutex>

namespace speecht_torch {

// ---------------------------------------------------------------------------
// Bit reader over a memory buffer (MSB-first, as FLAC requires)
// ---------------------------------------------------------------------------

namespace {

// v << s for a signed sample: a negative v shifts as its two's complement
// bits (what `v << s` gives on every target, without C++17's undefined
// behaviour for a negative left operand)
inline int64_t shift_left(int64_t v, int s) { return (int64_t)((uint64_t)v << s); }

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte_pos = 0;
  int bit_pos = 0;  // 0..7, bits consumed in current byte
  bool error = false;

  BitReader(const uint8_t* d, size_t n) : data(d), size(n) {}

  bool eof() const { return byte_pos >= size; }

  uint32_t read_bit() {
    if (byte_pos >= size) { error = true; return 0; }
    uint32_t b = (data[byte_pos] >> (7 - bit_pos)) & 1u;
    if (++bit_pos == 8) { bit_pos = 0; ++byte_pos; }
    return b;
  }

  uint64_t read_bits(int n) {
    uint64_t v = 0;
    // fast path for byte-aligned multi-byte reads
    while (n >= 8 && bit_pos == 0) {
      if (byte_pos >= size) { error = true; return 0; }
      v = (v << 8) | data[byte_pos++];
      n -= 8;
    }
    for (int i = 0; i < n; ++i) v = (v << 1) | read_bit();
    return v;
  }

  int64_t read_signed(int n) {
    uint64_t v = read_bits(n);
    // sign-extend
    if (n > 0 && (v >> (n - 1)) & 1u) v |= ~((1ull << n) - 1);
    return (int64_t)v;
  }

  uint32_t read_unary() {
    uint32_t q = 0;
    // scan for the terminating 1 bit
    while (!error) {
      if (byte_pos >= size) { error = true; return q; }
      uint8_t cur = data[byte_pos] & (0xFFu >> bit_pos);
      if (cur == 0) {
        q += 8 - bit_pos;
        bit_pos = 0;
        ++byte_pos;
        continue;
      }
      // position of highest set bit within remaining bits
      int lead = __builtin_clz((uint32_t)cur) - 24;  // 0..7 from MSB of byte
      q += lead - bit_pos;
      bit_pos = lead + 1;
      if (bit_pos == 8) { bit_pos = 0; ++byte_pos; }
      return q;
    }
    return q;
  }

  void align_byte() {
    if (bit_pos) { bit_pos = 0; ++byte_pos; }
  }

  // FLAC frame headers use a UTF-8-like variable length code (up to 56 bits)
  uint64_t read_utf8() {
    uint32_t first = (uint32_t)read_bits(8);
    if (first < 0x80) return first;
    int n_extra = 0;
    uint32_t mask = 0x40;
    while (first & mask) { ++n_extra; mask >>= 1; }
    if (n_extra == 0 || n_extra > 6) { error = true; return 0; }
    uint64_t v = first & (mask - 1);
    for (int i = 0; i < n_extra; ++i) {
      uint32_t cont = (uint32_t)read_bits(8);
      if ((cont & 0xC0) != 0x80) { error = true; return 0; }
      v = (v << 6) | (cont & 0x3F);
    }
    return v;
  }
};

// Rice-coded residual: fills r[order..block_size)
bool decode_residual(BitReader& br, int order, int block_size, int32_t* r) {
  int method = (int)br.read_bits(2);
  if (method > 1) return false;
  int param_bits = method == 0 ? 4 : 5;
  int escape = method == 0 ? 15 : 31;
  int part_order = (int)br.read_bits(4);
  int n_parts = 1 << part_order;
  int samples_per_part = block_size >> part_order;
  if (samples_per_part <= 0) return false;
  int idx = order;
  for (int p = 0; p < n_parts; ++p) {
    int count = samples_per_part - (p == 0 ? order : 0);
    if (count < 0) return false;
    int param = (int)br.read_bits(param_bits);
    if (param == escape) {
      int rbps = (int)br.read_bits(5);
      for (int i = 0; i < count; ++i)
        r[idx++] = rbps ? (int32_t)br.read_signed(rbps) : 0;
    } else {
      for (int i = 0; i < count; ++i) {
        uint32_t q = br.read_unary();
        uint64_t low = param ? br.read_bits(param) : 0;
        uint64_t u = ((uint64_t)q << param) | low;
        // zigzag decode
        r[idx++] = (int32_t)((u >> 1) ^ (~(u & 1) + 1));
      }
    }
    if (br.error) return false;
  }
  return idx == block_size;
}

// Decode one subframe into out[0..block_size); bps = effective bits/sample
bool decode_subframe(BitReader& br, int block_size, int bps, int64_t* out) {
  if (br.read_bits(1) != 0) return false;  // padding bit must be 0
  int type = (int)br.read_bits(6);
  int wasted = 0;
  if (br.read_bits(1)) {  // wasted bits flag
    wasted = 1 + (int)br.read_unary();
    bps -= wasted;
  }
  if (br.error || bps <= 0 || bps > 33) return false;

  std::vector<int32_t> res(block_size);

  if (type == 0) {  // CONSTANT
    int64_t v = br.read_signed(bps);
    for (int i = 0; i < block_size; ++i) out[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (int i = 0; i < block_size; ++i) out[i] = br.read_signed(bps);
  } else if (type >= 8 && type <= 12) {  // FIXED, order 0..4
    int order = type & 7;
    if (order > block_size) return false;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    std::vector<int32_t> r(block_size);
    if (!decode_residual(br, order, block_size, r.data())) return false;
    // fixed predictors
    for (int i = order; i < block_size; ++i) {
      int64_t pred = 0;
      switch (order) {
        case 0: pred = 0; break;
        case 1: pred = out[i - 1]; break;
        case 2: pred = 2 * out[i - 1] - out[i - 2]; break;
        case 3: pred = 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3]; break;
        case 4: pred = 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3] - out[i - 4]; break;
      }
      out[i] = pred + r[i];
    }
  } else if (type >= 32) {  // LPC, order 1..32
    int order = (type & 31) + 1;
    if (order > block_size) return false;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    int precision = (int)br.read_bits(4) + 1;
    if (precision == 16) return false;  // 1111 invalid
    int shift = (int)br.read_signed(5);
    if (shift < 0) shift = 0;
    std::vector<int64_t> coefs(order);
    for (int i = 0; i < order; ++i) coefs[i] = br.read_signed(precision);
    std::vector<int32_t> r(block_size);
    if (!decode_residual(br, order, block_size, r.data())) return false;
    for (int i = order; i < block_size; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += coefs[j] * out[i - 1 - j];
      out[i] = (pred >> shift) + r[i];
    }
  } else {
    return false;  // reserved type
  }

  if (wasted) {
    for (int i = 0; i < block_size; ++i) out[i] = shift_left(out[i], wasted);
  }
  return !br.error;
}

}  // namespace

// ---------------------------------------------------------------------------
// Windowed-sinc resampler (Kaiser window, resampy kaiser_best-like params)
// ---------------------------------------------------------------------------

namespace {

double bessel_i0(double x) {
  // series expansion, converges quickly for the beta range we use
  double sum = 1.0, term = 1.0;
  double x2 = x * x / 4.0;
  for (int k = 1; k < 64; ++k) {
    term *= x2 / (double(k) * double(k));
    sum += term;
    if (term < 1e-18 * sum) break;
  }
  return sum;
}

struct SincFilter {
  // interpolated lookup table of one-sided filter, `precision` samples per
  // zero crossing
  std::vector<double> table;
  int num_zeros;
  int precision;

  SincFilter(int nz = 64, int prec = 512, double rolloff = 0.9475937167399596,
             double beta = 14.769656459379492)
      : num_zeros(nz), precision(prec) {
    int n = nz * prec + 1;
    table.resize(n + 1);
    double i0b = bessel_i0(beta);
    for (int i = 0; i < n; ++i) {
      double t = (double)i / prec;  // in zero crossings
      double x = t / nz;            // window argument in [0, 1]
      double win = bessel_i0(beta * std::sqrt(std::max(0.0, 1.0 - x * x))) / i0b;
      double sinc = (t == 0.0) ? 1.0
                               : std::sin(M_PI * rolloff * t) / (M_PI * rolloff * t);
      table[i] = rolloff * sinc * win;
    }
    table[n] = 0.0;
  }

  double eval(double t) const {
    double a = std::fabs(t) * precision;
    int i = (int)a;
    if (i >= num_zeros * precision) return 0.0;
    double frac = a - i;
    return table[i] * (1.0 - frac) + table[i + 1] * frac;
  }
};

// Polyphase bank for rational ratios L/M: per-phase contiguous tap vectors
// (one dot product per output sample, auto-vectorizable) instead of per-tap
// interpolated table lookups. ~10x the direct evaluation.
struct Polyphase {
  int64_t L = 0, M = 0;
  int ntaps = 0;
  int start_off = 0;  // m0 = (j*M)/L + start_off
  std::vector<float> weights;  // [L, ntaps]

  static int64_t gcd(int64_t a, int64_t b) {
    while (b) { int64_t t = a % b; a = b; b = t; }
    return a;
  }

  bool build(double sr_in, double sr_out, const SincFilter& filt) {
    int64_t i_in = (int64_t)sr_in, i_out = (int64_t)sr_out;
    if ((double)i_in != sr_in || (double)i_out != sr_out) return false;
    int64_t g = gcd(i_in, i_out);
    L = i_out / g;
    M = i_in / g;
    if (L > 4096) return false;  // irrational-ish; use the direct path
    double ratio = sr_out / sr_in;
    double scale = std::min(1.0, ratio);
    double support = filt.num_zeros / scale;
    start_off = -(int)std::floor(support);
    ntaps = (int)std::floor(support) - start_off + 1;
    weights.resize((size_t)L * ntaps);
    for (int64_t r = 0; r < L; ++r) {
      // output j with j*M = n0*L + r sits at input position n0 + r/L
      double frac = (double)r / L;
      for (int k = 0; k < ntaps; ++k) {
        double t = start_off + k - frac;
        weights[(size_t)r * ntaps + k] =
            (float)(scale * filt.eval(scale * t));
      }
    }
    return true;
  }
};

// CRC32C tables for slicing by 8: table[0] is the byte-at-a-time table of
// the reflected polynomial 0x82F63B78, table[k][i] the CRC of byte i
// followed by k zero bytes, so eight bytes fold in one step.
struct Crc32cTables {
  uint32_t table[8][256];
  Crc32cTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1u)));
      table[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int k = 1; k < 8; ++k)
        table[k][i] = (table[k - 1][i] >> 8) ^ table[0][table[k - 1][i] & 0xFF];
  }
};

}  // namespace

}  // namespace speecht_torch

using namespace speecht_torch;

// the library is built with -fvisibility=hidden: only these are exported
#define STT_EXPORT __attribute__((visibility("default")))

extern "C" {

STT_EXPORT void stt_free(void* p) { free(p); }

// Decode a FLAC file to mono float32 (channel-averaged, samples / 2^(bps-1)).
// Returns 0 on success. Caller frees *out with stt_free.
STT_EXPORT int stt_flac_decode_file(const char* path, float** out, int64_t* n_samples,
                        int32_t* sample_rate) {
  *out = nullptr;
  *n_samples = 0;
  *sample_rate = 0;

  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf((size_t)fsize);
  if (fread(buf.data(), 1, (size_t)fsize, f) != (size_t)fsize) {
    fclose(f);
    return -2;
  }
  fclose(f);

  if (fsize < 42 || memcmp(buf.data(), "fLaC", 4) != 0) return -3;

  size_t pos = 4;
  int stream_sr = 0, stream_channels = 0, stream_bps = 0;
  uint64_t stream_total = 0;
  bool last = false;
  // metadata blocks
  while (!last && pos + 4 <= (size_t)fsize) {
    uint8_t hdr = buf[pos];
    last = (hdr & 0x80) != 0;
    int type = hdr & 0x7F;
    uint32_t len = (buf[pos + 1] << 16) | (buf[pos + 2] << 8) | buf[pos + 3];
    pos += 4;
    if (type == 0 && len >= 34) {  // STREAMINFO
      const uint8_t* si = buf.data() + pos;
      stream_sr = (si[10] << 12) | (si[11] << 4) | (si[12] >> 4);
      stream_channels = ((si[12] >> 1) & 0x7) + 1;
      stream_bps = (((si[12] & 1) << 4) | (si[13] >> 4)) + 1;
      stream_total = ((uint64_t)(si[13] & 0x0F) << 32) | ((uint64_t)si[14] << 24) |
                     ((uint64_t)si[15] << 16) | ((uint64_t)si[16] << 8) | si[17];
    }
    pos += len;
  }
  if (stream_sr == 0 || stream_channels == 0) return -4;

  std::vector<float> pcm;
  if (stream_total) pcm.reserve((size_t)stream_total);

  BitReader br(buf.data(), (size_t)fsize);
  br.byte_pos = pos;

  std::vector<std::vector<int64_t>> ch;

  while (br.byte_pos < br.size - 2) {
    // frame sync: 14 bits 0b11111111111110
    uint32_t sync = (uint32_t)br.read_bits(14);
    if (br.error) break;
    if (sync != 0x3FFE) {
      // STREAMINFO may carry total_samples == 0 (streaming encoders):
      // then the loop cannot stop on sample count, and trailing
      // padding or an appended tag after the last frame must not
      // discard fully-decoded audio — stop at sync loss instead
      if (stream_total == 0 && !pcm.empty()) break;
      return -5;
    }
    br.read_bits(1);                    // reserved
    br.read_bits(1);                    // blocking strategy
    int bs_code = (int)br.read_bits(4);
    int sr_code = (int)br.read_bits(4);
    int ch_code = (int)br.read_bits(4);
    int ss_code = (int)br.read_bits(3);
    br.read_bits(1);  // reserved
    br.read_utf8();   // frame or sample number (unused: we decode linearly)

    int block_size;
    switch (bs_code) {
      case 0: return -6;
      case 1: block_size = 192; break;
      case 6: block_size = (int)br.read_bits(8) + 1; break;
      case 7: block_size = (int)br.read_bits(16) + 1; break;
      default:
        if (bs_code >= 2 && bs_code <= 5) block_size = 576 << (bs_code - 2);
        else block_size = 256 << (bs_code - 8);
    }
    // sample rate code: may need to skip explicit values
    if (sr_code == 12) br.read_bits(8);
    else if (sr_code == 13 || sr_code == 14) br.read_bits(16);

    int bps;
    switch (ss_code) {
      case 0: bps = stream_bps; break;
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      case 7: bps = 32; break;
      default: return -7;
    }
    br.read_bits(8);  // CRC-8

    int n_channels = ch_code < 8 ? ch_code + 1 : 2;
    ch.assign(n_channels, std::vector<int64_t>(block_size));

    for (int c = 0; c < n_channels; ++c) {
      int sub_bps = bps;
      // side channel carries one extra bit
      if ((ch_code == 8 && c == 1) || (ch_code == 9 && c == 0) ||
          (ch_code == 10 && c == 1))
        sub_bps += 1;
      if (!decode_subframe(br, block_size, sub_bps, ch[c].data())) return -8;
    }
    br.align_byte();
    br.read_bits(16);  // CRC-16
    if (br.error) return -9;

    // stereo decorrelation
    if (ch_code == 8) {  // left/side
      for (int i = 0; i < block_size; ++i) ch[1][i] = ch[0][i] - ch[1][i];
    } else if (ch_code == 9) {  // right/side: ch0 = side, ch1 = right
      for (int i = 0; i < block_size; ++i) ch[0][i] = ch[0][i] + ch[1][i];
    } else if (ch_code == 10) {  // mid/side
      for (int i = 0; i < block_size; ++i) {
        int64_t mid = ch[0][i], side = ch[1][i];
        mid = shift_left(mid, 1) | (side & 1);
        ch[0][i] = (mid + side) >> 1;
        ch[1][i] = (mid - side) >> 1;
      }
    }

    float scale = 1.0f / (float)(1u << (bps - 1));
    for (int i = 0; i < block_size; ++i) {
      float acc = 0.f;
      for (int c = 0; c < n_channels; ++c) acc += (float)ch[c][i];
      pcm.push_back(acc * scale / (float)n_channels);
    }
    if (stream_total && pcm.size() >= stream_total) break;
  }

  if (stream_total && pcm.size() > stream_total) pcm.resize((size_t)stream_total);

  float* result = (float*)malloc(pcm.size() * sizeof(float));
  if (!result) return -10;
  memcpy(result, pcm.data(), pcm.size() * sizeof(float));
  *out = result;
  *n_samples = (int64_t)pcm.size();
  *sample_rate = stream_sr;
  return 0;
}

// Resample float32 audio from sr_in to sr_out. Output length is
// ceil(n_in * sr_out / sr_in) (librosa.load convention). Returns 0 on success.
STT_EXPORT int stt_resample(const float* in, int64_t n_in, double sr_in, double sr_out,
                float** out, int64_t* n_out) {
  *out = nullptr;
  *n_out = 0;
  if (n_in <= 0 || sr_in <= 0 || sr_out <= 0) return -1;
  if (sr_in == sr_out) {
    float* r = (float*)malloc((size_t)n_in * sizeof(float));
    memcpy(r, in, (size_t)n_in * sizeof(float));
    *out = r;
    *n_out = n_in;
    return 0;
  }

  static SincFilter filt;  // shared; construction is ~30k bessel evals
  double ratio = sr_out / sr_in;
  double scale = std::min(1.0, ratio);  // shrink bandwidth when downsampling
  int64_t count = (int64_t)std::ceil((double)n_in * ratio);
  float* r = (float*)malloc((size_t)count * sizeof(float));
  if (!r) return -2;

  // fast path: rational ratio -> cached polyphase bank
  {
    static std::vector<std::pair<std::pair<double, double>, Polyphase*>> cache;
    static std::mutex cache_mu;
    Polyphase* pp = nullptr;
    {
      std::lock_guard<std::mutex> lock(cache_mu);
      for (auto& kv : cache)
        if (kv.first.first == sr_in && kv.first.second == sr_out)
          pp = kv.second;
      if (!pp) {
        auto* fresh = new Polyphase();
        if (fresh->build(sr_in, sr_out, filt)) {
          cache.emplace_back(std::make_pair(sr_in, sr_out), fresh);
          pp = fresh;
        } else {
          delete fresh;
        }
      }
    }
    if (pp) {
      const int ntaps = pp->ntaps;
      for (int64_t j = 0; j < count; ++j) {
        int64_t num = j * pp->M;
        int64_t n0 = num / pp->L;
        int64_t phase = num % pp->L;
        const float* w = &pp->weights[(size_t)phase * ntaps];
        int64_t m0 = n0 + pp->start_off;
        int k_lo = m0 < 0 ? (int)(-m0) : 0;
        int k_hi = m0 + ntaps > n_in ? (int)(n_in - m0) : ntaps;
        double acc = 0.0;
        const float* x = in + m0;
        for (int k = k_lo; k < k_hi; ++k) acc += (double)x[k] * w[k];
        r[j] = (float)acc;
      }
      *out = r;
      *n_out = count;
      return 0;
    }
  }

  double support = filt.num_zeros / scale;
  for (int64_t j = 0; j < count; ++j) {
    double pos = (double)j / ratio;
    int64_t m_lo = (int64_t)std::ceil(pos - support);
    int64_t m_hi = (int64_t)std::floor(pos + support);
    m_lo = std::max<int64_t>(m_lo, 0);
    m_hi = std::min<int64_t>(m_hi, n_in - 1);
    double acc = 0.0;
    for (int64_t m = m_lo; m <= m_hi; ++m) {
      acc += (double)in[m] * filt.eval(scale * ((double)m - pos));
    }
    r[j] = (float)(acc * scale);
  }
  *out = r;
  *n_out = count;
  return 0;
}

// CRC32C of n bytes (initial value and final xor 0xFFFFFFFF): "123456789"
// gives 0xE3069283.
STT_EXPORT uint32_t stt_crc32c(const uint8_t* p, size_t n) {
  static const Crc32cTables tables;
  const auto& t = tables.table;
  uint32_t crc = 0xFFFFFFFFu;
  for (; n >= 8; p += 8, n -= 8) {
    uint32_t lo = crc ^ ((uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 |
                         (uint32_t)p[3] << 24);
    uint32_t hi = (uint32_t)p[4] | (uint32_t)p[5] << 8 | (uint32_t)p[6] << 16 |
                  (uint32_t)p[7] << 24;
    crc = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^
          t[4][lo >> 24] ^ t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^
          t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
  }
  for (; n; ++p, --n) crc = t[0][(crc ^ *p) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

}  // extern "C"
