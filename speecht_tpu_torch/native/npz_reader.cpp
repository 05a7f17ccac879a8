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

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <type_traits>
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

// A file's bytes, or an entry's: a view into a buffer that outlives it.
struct Bytes {
  const uint8_t* ptr = nullptr;
  size_t n = 0;
  size_t size() const { return n; }
  const uint8_t* data() const { return ptr; }
  const uint8_t& operator[](size_t i) const { return ptr[i]; }
};

// Reads the file into `store`, which only grows: a thread that reads file
// after file neither zero-fills nor page-faults a fresh buffer for each.
bool read_file(const char* path, std::vector<uint8_t>& store, Bytes* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (n < 0) {
    fclose(f);
    return false;
  }
  if (store.size() < (size_t)n) store.resize((size_t)n);
  bool ok = fread(store.data(), 1, (size_t)n, f) == (size_t)n;
  fclose(f);
  out->ptr = store.data();
  out->n = (size_t)n;
  return ok;
}

uint16_t rd16(const uint8_t* p) { return p[0] | (p[1] << 8); }
uint32_t rd32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24);
}

// Locate entries via the end-of-central-directory record.
bool parse_zip(Bytes buf, std::vector<ZipEntry>& out) {
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

// A stored entry's raw bytes (after the local header), in place. A deflated
// entry is not this reader's layout: *unsupported is set, false returned.
bool extract_entry(Bytes buf, const ZipEntry& e, Bytes* out,
                   bool* unsupported) {
  size_t p = e.header_offset;
  if (p + 30 > buf.size() || rd32(&buf[p]) != 0x04034b50) return false;
  uint16_t name_len = rd16(&buf[p + 26]);
  uint16_t extra_len = rd16(&buf[p + 28]);
  size_t data_off = p + 30 + name_len + extra_len;
  if (data_off + e.comp_size > buf.size()) return false;

  if (e.method == 0) {  // stored
    out->ptr = buf.data() + data_off;
    out->n = e.comp_size;
    return true;
  }
  *unsupported = true;  // deflate (np.savez_compressed) or another method
  return false;
}

// Parse an NPY v1/v2 payload: returns dtype char+size, shape, data pointer
// and whether the data is in Fortran (column-major) order. A well-formed
// payload this reader does not read (big-endian) sets *unsupported.
bool parse_npy(Bytes npy, char* type_char,
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
  if (std::is_same<SRC, DST>::value) {
    memcpy(dst, src, n * sizeof(DST));
    return;
  }
  // the payload lies where the zip put it, unaligned: read through memcpy
  for (size_t i = 0; i < n; ++i) {
    SRC v;
    memcpy(&v, src + i * sizeof(SRC), sizeof(SRC));
    dst[i] = (DST)v;
  }
}

bool convertible(char type_char, int item_size) {
  return (type_char == 'f' && (item_size == 4 || item_size == 8)) ||
         (type_char == 'i' && (item_size == 4 || item_size == 8)) ||
         (type_char == 'u' && item_size == 1);
}

template <typename DST>
void convert_any(char type_char, int item_size, const uint8_t* src, DST* dst,
                 size_t n) {
  if (type_char == 'f' && item_size == 4) convert<float>(src, dst, n);
  else if (type_char == 'f' && item_size == 8) convert<double>(src, dst, n);
  else if (type_char == 'i' && item_size == 4) convert<int32_t>(src, dst, n);
  else if (type_char == 'i' && item_size == 8) convert<int64_t>(src, dst, n);
  else convert<uint8_t>(src, dst, n);
}

// One NPY payload as parse_npy found it, inside its file's bytes.
struct Payload {
  char type_char = 0;
  int item_size = 0;
  int64_t shape[4] = {0, 0, 0, 0};
  int32_t ndim = 0;
  const uint8_t* data = nullptr;
  size_t count = 0;
  bool fortran = false;
};

// Reads and parses one utterance file into `store` (which only grows) and
// its two payloads. Returns the codes of stt_npz_load_sample.
int parse_sample(const char* path, std::vector<uint8_t>& store,
                 Payload* feat, Payload* trans) {
  Bytes buf;
  if (!read_file(path, store, &buf)) return -1;
  std::vector<ZipEntry> entries;
  if (!parse_zip(buf, entries)) return -2;

  bool unsupported = false;
  bool got_feat = false, got_tr = false;
  for (const ZipEntry& e : entries) {  // a duplicate entry: the last counts
    bool is_feat = e.name == "audio_fragments.npy";
    if (!is_feat && e.name != "transcript.npy") continue;
    Payload* p = is_feat ? feat : trans;
    Bytes npy;
    if (!extract_entry(buf, e, &npy, &unsupported))
      return unsupported ? 1 : (is_feat ? -3 : -7);
    if (!parse_npy(npy, &p->type_char, &p->item_size, p->shape, &p->ndim,
                   &p->data, &p->count, &p->fortran, &unsupported))
      return unsupported ? 1 : (is_feat ? -4 : -8);
    if (is_feat && p->ndim != 2) return -5;
    if (!convertible(p->type_char, p->item_size)) return 1;
    if (!is_feat && p->fortran && p->ndim > 1) return 1;
    (is_feat ? got_feat : got_tr) = true;
  }
  return got_feat && got_tr ? 0 : -10;
}

// Writes a parsed sample's features (float32 [T, F], row-major) and
// transcript (int32).
void write_sample(const Payload& feat, const Payload& trans, float* features,
                  int32_t* transcript) {
  convert_any<float>(feat.type_char, feat.item_size, feat.data, features,
                     feat.count);
  if (feat.fortran) {
    // the host DSP's features are a transpose (np.savez keeps their
    // column-major order): return them row-major, as np.load's array
    // reads
    std::vector<float> cols(features, features + feat.count);
    for (int64_t i = 0; i < feat.shape[0]; ++i)
      for (int64_t j = 0; j < feat.shape[1]; ++j)
        features[i * feat.shape[1] + j] = cols[j * feat.shape[0] + i];
  }
  convert_any<int32_t>(trans.type_char, trans.item_size, trans.data,
                       transcript, trans.count);
}

// What stt_npz_reader_read leaves for stt_npz_reader_fill.
struct NpzBatch {
  int threads = 1;
  int64_t n = 0;
  std::vector<std::vector<uint8_t>> stores;  // file i's bytes
  std::vector<Payload> feats, transs;        // point into stores
  std::vector<int32_t> codes;
};

// fn(0) ... fn(n - 1) on up to `threads` threads, each taking the next.
template <typename F>
void parallel_for(int64_t n, int threads, F fn) {
  int k = (int)std::min<int64_t>(threads, n);
  if (k <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next{0};
  std::vector<std::thread> pool;
  for (int t = 0; t < k; ++t)
    pool.emplace_back([&] {
      for (int64_t i; (i = next++) < n;) fn(i);
    });
  for (std::thread& t : pool) t.join();
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
  thread_local std::vector<uint8_t> store;
  Payload feat, trans;
  int rc = parse_sample(path, store, &feat, &trans);
  if (rc != 0) return rc;
  *features = (float*)malloc(feat.count * sizeof(float));
  *transcript = (int32_t*)malloc(trans.count * sizeof(int32_t));
  write_sample(feat, trans, *features, *transcript);
  feat_shape[0] = feat.shape[0];
  feat_shape[1] = feat.shape[1];
  *transcript_len = (int64_t)trans.count;
  return 0;
}

// A reader of many cache files at a time. stt_npz_reader_read reads and
// parses n files on up to `threads` threads of its own, into buffers the
// reader keeps (they only grow, so a loader that reads batch after batch
// does not page-fault fresh ones); stt_npz_reader_fill converts them, on
// the same threads, into arrays the caller allocated from the shapes the
// read returned. A caller that holds a lock (Python's GIL) releases it
// once for each phase, for all n files. One caller thread at a time.
STT_EXPORT void* stt_npz_reader_new(int32_t threads) {
  NpzBatch* r = new NpzBatch;
  r->threads = std::max(1, (int)threads);
  return r;
}

STT_EXPORT void stt_npz_reader_free(void* reader) {
  delete (NpzBatch*)reader;
}

// File i's code (those of stt_npz_load_sample) goes to codes[i]; for a file
// read (code 0), its features' [T, F] to shapes[2i] and its transcript's
// length to transcript_lens[i], else zeros.
STT_EXPORT void stt_npz_reader_read(void* reader, const char* const* paths,
                                    int64_t n, int32_t* codes,
                                    int64_t* shapes /*[n][2]*/,
                                    int64_t* transcript_lens) {
  NpzBatch* r = (NpzBatch*)reader;
  r->n = n;
  if (r->stores.size() < (size_t)n) r->stores.resize((size_t)n);
  r->feats.assign((size_t)n, Payload());
  r->transs.assign((size_t)n, Payload());
  r->codes.assign((size_t)n, 0);
  parallel_for(n, r->threads, [&](int64_t i) {
    r->codes[i] = parse_sample(paths[i], r->stores[i], &r->feats[i],
                               &r->transs[i]);
  });
  for (int64_t i = 0; i < n; ++i) {
    codes[i] = r->codes[i];
    bool ok = codes[i] == 0;
    shapes[2 * i] = ok ? r->feats[i].shape[0] : 0;
    shapes[2 * i + 1] = ok ? r->feats[i].shape[1] : 0;
    transcript_lens[i] = ok ? (int64_t)r->transs[i].count : 0;
  }
}

// Converts each file the last read read (code 0) into features[i] (float32
// [T, F], row-major) and transcripts[i] (int32); other entries are not
// touched.
STT_EXPORT void stt_npz_reader_fill(void* reader, float* const* features,
                                    int32_t* const* transcripts) {
  NpzBatch* r = (NpzBatch*)reader;
  parallel_for(r->n, r->threads, [&](int64_t i) {
    if (r->codes[i] == 0)
      write_sample(r->feats[i], r->transs[i], features[i], transcripts[i]);
  });
  r->n = 0;
}

}  // extern "C"
