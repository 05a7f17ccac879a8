// Reader of the feature cache's npz files (a zip of two .npy entries).
//
// The port's own copy of the JAX package's `speecht_tpu/native/npz_reader.cpp`:
// a minimal ZIP parser plus an NPY v1/v2 header parser that converts the
// numeric payloads to float32 features and int32 transcripts. It reads the
// cache `np.savez` writes (`preprocess`), whose entries are stored, not
// deflated. It differs from the JAX package's copy in two places. It has
// no inflate branch, so the library needs nothing but the compiler: a
// deflated file, and any other well-formed layout it does not read,
// returns code 1 and the caller reads that file with np.load. And it
// reads column-major features, which the host DSP writes (its features
// are a transpose, and np.savez keeps their order; the JAX package's copy
// refuses them and falls back to np.load), returning them row-major. Its C++ sits in a namespace of its own and only
// the `stt_` function is exported. ctypes calls release the GIL, so the
// loader thread and other threads run beside a read.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace speecht_torch {

namespace {

struct ZipEntry {
  std::string name;
  uint16_t method = 0;  // 0 = stored, 8 = deflate
  uint64_t comp_size = 0;
  uint64_t uncomp_size = 0;
  uint64_t header_offset = 0;
};

bool read_file(const char* path, std::vector<uint8_t>& buf) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  buf.resize((size_t)n);
  bool ok = fread(buf.data(), 1, (size_t)n, f) == (size_t)n;
  fclose(f);
  return ok;
}

uint16_t rd16(const uint8_t* p) { return p[0] | (p[1] << 8); }
uint32_t rd32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24);
}

// Locate entries via the end-of-central-directory record.
bool parse_zip(const std::vector<uint8_t>& buf, std::vector<ZipEntry>& out) {
  if (buf.size() < 22) return false;
  // scan backwards for EOCD signature 0x06054b50
  size_t eocd = std::string::npos;
  size_t lo = buf.size() >= 65558 ? buf.size() - 65558 : 0;
  for (size_t i = buf.size() - 22 + 1; i-- > lo;) {
    if (rd32(&buf[i]) == 0x06054b50) { eocd = i; break; }
  }
  if (eocd == std::string::npos) return false;
  uint16_t n_entries = rd16(&buf[eocd + 10]);
  uint32_t cd_offset = rd32(&buf[eocd + 16]);

  size_t p = cd_offset;
  for (int i = 0; i < n_entries; ++i) {
    if (p + 46 > buf.size() || rd32(&buf[p]) != 0x02014b50) return false;
    ZipEntry e;
    e.method = rd16(&buf[p + 10]);
    e.comp_size = rd32(&buf[p + 20]);
    e.uncomp_size = rd32(&buf[p + 24]);
    uint16_t name_len = rd16(&buf[p + 28]);
    uint16_t extra_len = rd16(&buf[p + 30]);
    uint16_t comment_len = rd16(&buf[p + 32]);
    e.header_offset = rd32(&buf[p + 42]);
    // truncated central directory: the fixed header fit but the
    // variable-length fields run past the buffer
    if (p + 46 + (size_t)name_len + extra_len + comment_len > buf.size())
      return false;
    e.name.assign((const char*)&buf[p + 46], name_len);
    out.push_back(std::move(e));
    p += 46 + name_len + extra_len + comment_len;
  }
  return true;
}

// Extract a stored entry's raw bytes (after the local header). A deflated
// entry is not this reader's layout: *unsupported is set, false returned.
bool extract_entry(const std::vector<uint8_t>& buf, const ZipEntry& e,
                   std::vector<uint8_t>& out, bool* unsupported) {
  size_t p = e.header_offset;
  if (p + 30 > buf.size() || rd32(&buf[p]) != 0x04034b50) return false;
  uint16_t name_len = rd16(&buf[p + 26]);
  uint16_t extra_len = rd16(&buf[p + 28]);
  size_t data_off = p + 30 + name_len + extra_len;
  if (data_off + e.comp_size > buf.size()) return false;

  if (e.method == 0) {  // stored
    out.assign(buf.begin() + data_off, buf.begin() + data_off + e.comp_size);
    return true;
  }
  *unsupported = true;  // deflate (np.savez_compressed) or another method
  return false;
}

// Parse an NPY v1/v2 payload: returns dtype char+size, shape, data pointer
// and whether the data is in Fortran (column-major) order. A well-formed
// payload this reader does not read (big-endian) sets *unsupported.
bool parse_npy(const std::vector<uint8_t>& npy, char* type_char,
               int* item_size, int64_t* shape, int32_t* ndim,
               const uint8_t** data, size_t* count, bool* fortran,
               bool* unsupported) {
  if (npy.size() < 10 || memcmp(npy.data(), "\x93NUMPY", 6) != 0) return false;
  int major = npy[6];
  size_t header_len, header_off;
  if (major == 1) {
    header_len = rd16(&npy[8]);
    header_off = 10;
  } else {
    header_len = rd32(&npy[8]);
    header_off = 12;
  }
  if (header_off + header_len > npy.size()) return false;
  std::string hdr((const char*)&npy[header_off], header_len);

  // descr: '<f4' etc.
  size_t dp = hdr.find("'descr'");
  if (dp == std::string::npos) return false;
  size_t q1 = hdr.find('\'', dp + 7);
  size_t q2 = hdr.find('\'', q1 + 1);
  std::string descr = hdr.substr(q1 + 1, q2 - q1 - 1);
  if (descr.size() < 3) return false;
  if (descr[0] != '<' && descr[0] != '|' && descr[0] != '=') {
    *unsupported = descr[0] == '>';
    return false;
  }
  *type_char = descr[1];
  *item_size = atoi(descr.c_str() + 2);

  *fortran = hdr.find("'fortran_order': True") != std::string::npos;

  size_t sp = hdr.find("'shape'");
  if (sp == std::string::npos) return false;
  size_t p1 = hdr.find('(', sp);
  size_t p2 = hdr.find(')', p1);
  std::string dims = hdr.substr(p1 + 1, p2 - p1 - 1);
  *ndim = 0;
  *count = 1;
  const char* c = dims.c_str();
  while (*c && *ndim < 4) {
    while (*c == ' ' || *c == ',') ++c;
    if (!*c) break;
    int64_t d = strtoll(c, (char**)&c, 10);
    // negative or overflow-inducing dims: a corrupt header must fail the
    // parse, not wrap count*item_size modulo 2^64 past the size check
    if (d < 0) return false;
    if (d != 0 && *count > SIZE_MAX / (size_t)d) return false;
    shape[(*ndim)++] = d;
    *count *= (size_t)d;
  }
  *data = npy.data() + header_off + header_len;
  if (*item_size <= 0) return false;
  size_t avail = npy.size() - header_off - header_len;
  if (*count > avail / (size_t)*item_size) return false;
  return true;
}

template <typename SRC, typename DST>
void convert(const uint8_t* src, DST* dst, size_t n) {
  const SRC* s = (const SRC*)src;
  for (size_t i = 0; i < n; ++i) dst[i] = (DST)s[i];
}

template <typename DST>
bool convert_any(char type_char, int item_size, const uint8_t* src, DST* dst,
                 size_t n) {
  if (type_char == 'f' && item_size == 4) convert<float>(src, dst, n);
  else if (type_char == 'f' && item_size == 8) convert<double>(src, dst, n);
  else if (type_char == 'i' && item_size == 4) convert<int32_t>(src, dst, n);
  else if (type_char == 'i' && item_size == 8) convert<int64_t>(src, dst, n);
  else if (type_char == 'u' && item_size == 1) convert<uint8_t>(src, dst, n);
  else return false;
  return true;
}

}  // namespace

}  // namespace speecht_torch

using namespace speecht_torch;

// the library is built with -fvisibility=hidden: only these are exported
#define STT_EXPORT __attribute__((visibility("default")))

extern "C" {

// Load the two entries of an utterance npz: features -> float32 [T, F],
// transcript -> int32. Caller frees both with stt_free.
//   0  success
//   1  a well-formed file of another layout than this reader reads: a
//      deflated entry, big-endian data, or a dtype it does not convert
//      (the caller reads such a file with np.load)
//  <0  the file cannot be read or is damaged (the JAX package's codes)
STT_EXPORT int stt_npz_load_sample(const char* path, float** features,
                                   int64_t* feat_shape /*[2]*/,
                                   int32_t** transcript,
                                   int64_t* transcript_len) {
  *features = nullptr;
  *transcript = nullptr;
  // every error path releases whatever was already allocated: a caller
  // scanning a damaged cache must not leak one buffer per bad file
  auto fail = [&](int code) {
    if (*features) { free(*features); *features = nullptr; }
    if (*transcript) { free(*transcript); *transcript = nullptr; }
    return code;
  };
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return -1;
  std::vector<ZipEntry> entries;
  if (!parse_zip(buf, entries)) return -2;

  bool unsupported = false;
  bool got_feat = false, got_tr = false;
  for (const ZipEntry& e : entries) {
    if (e.name == "audio_fragments.npy") {
      std::vector<uint8_t> npy;
      if (!extract_entry(buf, e, npy, &unsupported))
        return fail(unsupported ? 1 : -3);
      char tc;
      int isz;
      int64_t shape[4];
      int32_t ndim;
      const uint8_t* data;
      size_t count;
      bool fortran;
      if (!parse_npy(npy, &tc, &isz, shape, &ndim, &data, &count, &fortran,
                     &unsupported))
        return fail(unsupported ? 1 : -4);
      if (ndim != 2) return fail(-5);
      float* out = (float*)malloc(count * sizeof(float));
      if (!convert_any<float>(tc, isz, data, out, count)) {
        free(out);
        return fail(1);
      }
      if (fortran) {
        // the host DSP's features are a transpose (np.savez keeps their
        // column-major order): return them row-major, as np.load's array
        // reads
        std::vector<float> cols(out, out + count);
        for (int64_t i = 0; i < shape[0]; ++i)
          for (int64_t j = 0; j < shape[1]; ++j)
            out[i * shape[1] + j] = cols[j * shape[0] + i];
      }
      if (*features) free(*features);  // duplicate entry: keep the last
      *features = out;
      feat_shape[0] = shape[0];
      feat_shape[1] = shape[1];
      got_feat = true;
    } else if (e.name == "transcript.npy") {
      std::vector<uint8_t> npy;
      if (!extract_entry(buf, e, npy, &unsupported))
        return fail(unsupported ? 1 : -7);
      char tc;
      int isz;
      int64_t shape[4];
      int32_t ndim;
      const uint8_t* data;
      size_t count;
      bool fortran;
      if (!parse_npy(npy, &tc, &isz, shape, &ndim, &data, &count, &fortran,
                     &unsupported))
        return fail(unsupported ? 1 : -8);
      if (fortran && ndim > 1) return fail(1);
      int32_t* out = (int32_t*)malloc(count * sizeof(int32_t));
      if (!convert_any<int32_t>(tc, isz, data, out, count)) {
        free(out);
        return fail(1);
      }
      if (*transcript) free(*transcript);
      *transcript = out;
      *transcript_len = (int64_t)count;
      got_tr = true;
    }
  }
  if (!got_feat || !got_tr) return fail(-10);
  return 0;
}

}  // extern "C"
