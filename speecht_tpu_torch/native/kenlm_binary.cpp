// KenLM PROBING binary format: the reader and the writer.
//
// The port's own copy of the JAX package's
// `speecht_tpu/native/kenlm_binary.cpp` (the `KenlmBinaryScorer`,
// `load_kenlm_binary_scorer`, `is_kenlm_binary` and the raw-table dump the
// device beam's LM tables are built from, exported as `stt_kenlm_dump_*`)
// and of its ARPA -> binary writer (`write_kenlm_binary`, exported by
// beam_search.cpp as `stt_lm_write_binary`), in a namespace of its own. It
// reads the reference's released language-model bundle
// (`kenlm-model.binary` + `vocabulary`) directly, with no KenLM dependency:
//
//   [Sanity header]  magic "mmap lm http://kheafield.com/code format
//                    version 5", float/endianness canaries
//   [FixedWidthParameters]  order, probing multiplier, model type,
//                    has_vocabulary, search version
//   [counts]         uint64 n-gram counts per order
//   [vocabulary]     ProbingVocabularyHeader + open-addressing hash table
//                    of (murmur64(word) -> word id)
//   [unigram]        (counts[0]+1) x {float prob, float backoff}
//   [middle tables]  per order 2..order-1: open-addressing hash of
//                    (chained word-id hash -> {prob, backoff}), 16 B entries
//   [longest table]  (hash -> {prob}), 12 B entries
//   [word strings]   nul-terminated surface forms in id order (present when
//                    has_vocabulary)
//
// Model types other than PROBING (0) -- REST_PROBING and the TRIE family --
// are rejected with a clear error suggesting the ARPA source.
//
// Layout robustness: the exact slot counts of the vocabulary table and the
// unigram array vary across KenLM builds; the reader solves for them by
// testing a small hypothesis grid and validating that the trailing string
// section parses as words with "<unk>" first -- a mis-parse fails loudly
// instead of mis-scoring.

#include "lm.h"

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <fstream>
#include <memory>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace speecht_torch {
namespace {

constexpr char kMagicPrefix[] =
    "mmap lm http://kheafield.com/code format version ";
constexpr uint32_t kModelTypeProbing = 0;
constexpr float kDefaultMultiplier = 1.5f;

inline uint64_t align8(uint64_t n) { return (n + 7) & ~uint64_t(7); }

// MurmurHash64A (public domain, Austin Appleby) — KenLM's word hash with
// seed 0 (lm/vocab: detail::HashForVocab).
uint64_t murmur64a(const void* key, size_t len, uint64_t seed) {
  const uint64_t m = 0xc6a4a7935bd1e995ull;
  const int r = 47;
  uint64_t h = seed ^ (len * m);
  const unsigned char* data = (const unsigned char*)key;
  const unsigned char* end = data + (len / 8) * 8;
  while (data != end) {
    uint64_t k;
    std::memcpy(&k, data, 8);
    data += 8;
    k *= m;
    k ^= k >> r;
    k *= m;
    h ^= k;
    h *= m;
  }
  switch (len & 7) {
    case 7: h ^= uint64_t(data[6]) << 48; [[fallthrough]];
    case 6: h ^= uint64_t(data[5]) << 40; [[fallthrough]];
    case 5: h ^= uint64_t(data[4]) << 32; [[fallthrough]];
    case 4: h ^= uint64_t(data[3]) << 24; [[fallthrough]];
    case 3: h ^= uint64_t(data[2]) << 16; [[fallthrough]];
    case 2: h ^= uint64_t(data[1]) << 8; [[fallthrough]];
    case 1: h ^= uint64_t(data[0]); h *= m;
  }
  h ^= h >> r;
  h *= m;
  h ^= h >> r;
  return h;
}

inline uint64_t word_hash(const std::string& w) {
  return murmur64a(w.data(), w.size(), 0);
}

// KenLM's chained n-gram hash (lm/search_hashed detail::CombineWordHash):
// start from the first word id, fold each subsequent id in.
inline uint64_t combine_word_hash(uint64_t current, uint32_t next) {
  return (current * 8978948897894561157ull) ^
         (uint64_t(1 + next) * 17894857484156487943ull);
}

inline uint64_t ngram_hash(const uint32_t* ids, int n) {
  uint64_t h = ids[0];
  for (int i = 1; i < n; ++i) h = combine_word_hash(h, ids[i]);
  return h;
}

inline uint64_t probing_buckets(uint64_t entries, float multiplier) {
  uint64_t by_mult = (uint64_t)(multiplier * (float)entries);
  return entries + 1 > by_mult ? entries + 1 : by_mult;
}

// entry sizes (KenLM packs these structs to 4 bytes)
constexpr uint64_t kVocabEntryBytes = 12;    // uint64 key, uint32 id
constexpr uint64_t kMiddleEntryBytes = 16;   // uint64 key, float prob, bo
constexpr uint64_t kLongestEntryBytes = 12;  // uint64 key, float prob
constexpr uint64_t kProbBackoffBytes = 8;

struct Layout {
  // hypothesis parameters
  uint64_t vocab_entries;
  uint64_t unigram_slots;
  // derived offsets (bytes from file start)
  uint64_t vocab_header;  // ProbingVocabularyHeader (8 bytes)
  uint64_t vocab_table;
  uint64_t unigram;
  std::vector<uint64_t> middle;  // orders 2..order-1
  uint64_t longest;
  uint64_t strings;  // start of the word-string section

  uint64_t vocab_buckets = 0;
  std::vector<uint64_t> middle_buckets;
  uint64_t longest_buckets = 0;
};

Layout compute_layout(uint64_t header_end, int order,
                      const std::vector<uint64_t>& counts, float multiplier,
                      uint64_t vocab_entries, uint64_t unigram_slots) {
  Layout lay;
  lay.vocab_entries = vocab_entries;
  lay.unigram_slots = unigram_slots;
  lay.vocab_header = header_end;
  lay.vocab_table = header_end + align8(8);
  lay.vocab_buckets = probing_buckets(vocab_entries, multiplier);
  lay.unigram = lay.vocab_table + lay.vocab_buckets * kVocabEntryBytes;
  uint64_t pos = lay.unigram + unigram_slots * kProbBackoffBytes;
  for (int n = 2; n < order; ++n) {
    lay.middle.push_back(pos);
    uint64_t buckets = probing_buckets(counts[n - 1], multiplier);
    lay.middle_buckets.push_back(buckets);
    pos += buckets * kMiddleEntryBytes;
  }
  lay.longest = pos;
  if (order >= 2) {
    lay.longest_buckets = probing_buckets(counts[order - 1], multiplier);
    pos += lay.longest_buckets * kLongestEntryBytes;
  }
  lay.strings = pos;
  return lay;
}

inline float read_f32(const char* p) {
  float f;
  std::memcpy(&f, p, 4);
  return f;
}
inline uint32_t read_u32(const char* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline uint64_t read_u64(const char* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

class KenlmBinaryScorer : public NGramScorer {
 public:
  bool load(const char* path, std::string* err);

  int order() const override { return order_; }
  uint32_t bos_id() const override { return bos_id_; }

  uint32_t word_id(const std::string& w) const override {
    auto it = vocab_.find(w);
    return it == vocab_.end() ? 0u /* <unk> */ : it->second;
  }

  void vocab_words(std::vector<std::string>* out) const override {
    *out = words_;
  }

  float score(const uint32_t* history, int hist_len,
              uint32_t word) const override {
    int ctx = hist_len < order_ - 1 ? hist_len : order_ - 1;
    uint32_t ids[16];
    for (int i = 0; i < ctx; ++i) ids[i] = history[hist_len - ctx + i];
    ids[ctx] = word;
    float backoff_sum = 0.0f;
    for (int n = ctx + 1; n >= 1; --n) {
      const uint32_t* start = ids + (ctx + 1 - n);
      float prob, backoff;
      if (find(start, n, &prob, &backoff)) return prob + backoff_sum;
      if (n > 1) {
        float bo_prob, bo;
        if (find(start, n - 1, &bo_prob, &bo)) backoff_sum += bo;
      }
    }
    // unigram of <unk>
    float prob, backoff;
    find_unigram(0, &prob, &backoff);
    return prob + backoff_sum;
  }

 private:
  bool find_unigram(uint32_t id, float* prob, float* backoff) const {
    if (id >= lay_.unigram_slots) return false;
    const char* p = data_.data() + lay_.unigram + id * kProbBackoffBytes;
    *prob = read_f32(p);
    *backoff = read_f32(p + 4);
    return true;
  }

  bool probe(uint64_t base, uint64_t buckets, uint64_t entry_bytes,
             uint64_t key, const char** out) const {
    if (buckets == 0) return false;
    uint64_t b = key % buckets;
    for (uint64_t i = 0; i < buckets; ++i) {
      const char* p = data_.data() + base + b * entry_bytes;
      uint64_t k = read_u64(p);
      if (k == key) {
        *out = p;
        return true;
      }
      if (k == 0) return false;  // empty slot terminates the probe chain
      b = (b + 1) % buckets;
    }
    return false;
  }

  bool find(const uint32_t* ids, int n, float* prob, float* backoff) const {
    if (n == 1) return find_unigram(ids[0], prob, backoff);
    if (n > order_) return false;
    uint64_t key = ngram_hash(ids, n);
    if (key == 0) key = 1;  // writer remaps 0 (the empty-slot marker)
    const char* p;
    if (n == order_) {
      if (!probe(lay_.longest, lay_.longest_buckets, kLongestEntryBytes,
                 key, &p))
        return false;
      *prob = read_f32(p + 8);
      *backoff = 0.0f;
      return true;
    }
    if (!probe(lay_.middle[n - 2], lay_.middle_buckets[n - 2],
               kMiddleEntryBytes, key, &p))
      return false;
    *prob = read_f32(p + 8);
    *backoff = read_f32(p + 12);
    return true;
  }

  std::vector<char> data_;
  Layout lay_;
  int order_ = 0;
  std::vector<uint64_t> counts_;
  std::unordered_map<std::string, uint32_t> vocab_;
  std::vector<std::string> words_;  // id order
  uint32_t bos_id_ = UINT32_MAX;

 public:
  // ---- raw-table dump (builds the DEVICE beam's HBM tables from a binary;
  // the n-gram keys are one-way hashes, so word sequences are
  // unrecoverable — but the device search recomputes the same chained hash
  // from word-id windows, so (key -> prob/backoff) is all it needs) ----
  int dump_order() const { return order_; }
  uint64_t dump_unigram_slots() const { return lay_.unigram_slots; }
  const std::vector<std::string>& dump_words() const { return words_; }

  void dump_unigrams(float* prob, float* backoff) const {
    for (uint64_t id = 0; id < lay_.unigram_slots; ++id) {
      const char* p = data_.data() + lay_.unigram + id * kProbBackoffBytes;
      prob[id] = read_f32(p);
      backoff[id] = read_f32(p + 4);
    }
  }

  // occupied entries of the order-n hash table (n in 2..order)
  uint64_t dump_table_count(int n) const {
    uint64_t base, buckets, entry;
    if (!table_geometry(n, &base, &buckets, &entry)) return 0;
    uint64_t cnt = 0;
    for (uint64_t b = 0; b < buckets; ++b)
      if (read_u64(data_.data() + base + b * entry) != 0) ++cnt;
    return cnt;
  }

  int dump_table(int n, uint32_t* lo, uint32_t* hi, float* prob,
                 float* backoff) const {
    uint64_t base, buckets, entry;
    if (!table_geometry(n, &base, &buckets, &entry)) return 1;
    uint64_t i = 0;
    for (uint64_t b = 0; b < buckets; ++b) {
      const char* p = data_.data() + base + b * entry;
      uint64_t key = read_u64(p);
      if (key == 0) continue;
      lo[i] = (uint32_t)(key & 0xFFFFFFFFull);
      hi[i] = (uint32_t)(key >> 32);
      prob[i] = read_f32(p + 8);
      backoff[i] = (n == order_) ? 0.0f : read_f32(p + 12);
      ++i;
    }
    return 0;
  }

 private:
  bool table_geometry(int n, uint64_t* base, uint64_t* buckets,
                      uint64_t* entry) const {
    if (n < 2 || n > order_) return false;
    if (n == order_) {
      *base = lay_.longest;
      *buckets = lay_.longest_buckets;
      *entry = kLongestEntryBytes;
    } else {
      *base = lay_.middle[n - 2];
      *buckets = lay_.middle_buckets[n - 2];
      *entry = kMiddleEntryBytes;
    }
    return true;
  }
};

// Parse the trailing nul-terminated string section; true when it yields
// >= 1 word, the first is "<unk>", and the bytes end cleanly.
bool parse_strings(const std::vector<char>& data, uint64_t start,
                   std::vector<std::string>* words) {
  words->clear();
  if (start >= data.size()) return false;
  uint64_t pos = start;
  while (pos < data.size()) {
    const char* s = data.data() + pos;
    size_t maxlen = data.size() - pos;
    size_t len = strnlen(s, maxlen);
    if (len == maxlen) return false;  // no terminator
    words->push_back(std::string(s, len));
    pos += len + 1;
    // tolerate trailing padding nuls at EOF
    if (pos < data.size() && data[pos] == '\0') {
      bool all_nul = true;
      for (uint64_t q = pos; q < data.size(); ++q)
        if (data[q] != '\0') {
          all_nul = false;
          break;
        }
      if (all_nul) break;
    }
  }
  return !words->empty() && (*words)[0] == "<unk>";
}

bool KenlmBinaryScorer::load(const char* path, std::string* err) {
  // one sized fread, not an istreambuf_iterator copy: production KenLM
  // binaries are hundreds of MB and the byte-at-a-time stream read plus
  // reallocating vector growth costs seconds-to-minutes of startup
  FILE* f = fopen(path, "rb");
  if (!f) {
    *err = "cannot open file";
    return false;
  }
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (n < 0) {
    fclose(f);
    *err = "cannot stat file";
    return false;
  }
  data_.resize((size_t)n);
  bool read_ok = fread(data_.data(), 1, (size_t)n, f) == (size_t)n;
  fclose(f);
  if (!read_ok) {
    *err = "short read";
    return false;
  }
  if (data_.size() < 128 ||
      std::memcmp(data_.data(), kMagicPrefix, sizeof(kMagicPrefix) - 1)) {
    *err = "not a KenLM binary (magic mismatch)";
    return false;
  }

  // locate the Sanity tail by its unambiguous canary pattern:
  // f32 0.0, f32 1.0, f32 -0.5, u32 1, u32 0xFFFFFFFF, [pad], u64 1
  uint64_t sanity_end = 0;
  for (uint64_t off = sizeof(kMagicPrefix) - 1;
       off + 24 <= 256 && off + 24 <= data_.size(); ++off) {
    const char* p = data_.data() + off;
    if (read_f32(p) == 0.0f && read_f32(p + 4) == 1.0f &&
        read_f32(p + 8) == -0.5f && read_u32(p + 12) == 1u &&
        read_u32(p + 16) == 0xFFFFFFFFu) {
      uint64_t u64_off = off + 20;
      if (u64_off % 8) u64_off += 8 - (u64_off % 8);
      if (u64_off + 8 <= data_.size() &&
          read_u64(data_.data() + u64_off) == 1ull) {
        sanity_end = align8(u64_off + 8);
        break;
      }
    }
  }
  if (!sanity_end) {
    *err = "KenLM sanity header not recognized (endianness or version?)";
    return false;
  }

  // FixedWidthParameters
  const char* fix = data_.data() + sanity_end;
  order_ = (unsigned char)fix[0];
  float multiplier = read_f32(fix + 4);
  uint32_t model_type = read_u32(fix + 8);
  bool has_vocab = fix[12] != 0;
  // (search_version at fix+16 accepted as-is)
  if (order_ < 1 || order_ > 12) {
    *err = "implausible order " + std::to_string(order_);
    return false;
  }
  if (!(multiplier >= 1.0f && multiplier <= 100.0f)) {  // NaN-safe
    *err = "implausible probing multiplier (corrupt header?)";
    return false;
  }
  if (model_type != kModelTypeProbing) {
    *err = "unsupported KenLM model type " + std::to_string(model_type) +
           " (only PROBING=0 is supported; rebuild the binary with "
           "`build_binary probing` or use the ARPA source)";
    return false;
  }
  if (!has_vocab) {
    *err = "binary lacks the embedded vocabulary strings "
           "(build_binary without vocab); word ids cannot be recovered";
    return false;
  }
  uint64_t counts_off = sanity_end + 20;
  if (counts_off + 8ull * order_ > data_.size()) {
    *err = "truncated header";
    return false;
  }
  counts_.resize(order_);
  for (int i = 0; i < order_; ++i) {
    counts_[i] = read_u64(data_.data() + counts_off + 8ull * i);
    // guard the layout arithmetic against overflow from corrupt counts:
    // even the largest published LMs are << 2^40 n-grams
    if (counts_[i] > (1ull << 40)) {
      *err = "implausible n-gram count (corrupt header?)";
      return false;
    }
  }
  uint64_t header_end = align8(counts_off + 8ull * order_);

  // solve the layout: vocabulary-table and unigram slot counts vary by
  // KenLM build; accept the hypothesis whose string section validates
  uint64_t c0 = counts_[0];
  const uint64_t vocab_options[] = {c0, c0 + 1, c0 > 0 ? c0 - 1 : 0};
  const uint64_t uni_options[] = {c0 + 1, c0, c0 + 2};
  bool solved = false;
  for (uint64_t ve : vocab_options) {
    for (uint64_t us : uni_options) {
      Layout lay = compute_layout(header_end, order_, counts_, multiplier,
                                  ve, us);
      // every table must lie inside the file (monotonic offsets also rule
      // out arithmetic wrap-around)
      bool sane = lay.vocab_table >= lay.vocab_header &&
                  lay.unigram >= lay.vocab_table &&
                  lay.longest >= lay.unigram &&
                  lay.strings >= lay.longest &&
                  lay.strings <= data_.size();
      std::vector<std::string> words;
      if (sane && parse_strings(data_, lay.strings, &words)) {
        lay_ = lay;
        words_ = std::move(words);
        solved = true;
        break;
      }
    }
    if (solved) break;
  }
  if (!solved) {
    *err = "could not resolve the binary layout (string section did not "
           "validate); regenerate it with `build_binary probing` or use "
           "the ARPA source";
    return false;
  }

  vocab_.reserve(words_.size() * 2);
  for (uint32_t i = 0; i < words_.size(); ++i) vocab_.emplace(words_[i], i);
  auto bos = vocab_.find("<s>");
  if (bos != vocab_.end()) bos_id_ = bos->second;
  return true;
}

// ---------------------------------------------------------------------------
// writer: ARPA -> PROBING binary
// ---------------------------------------------------------------------------

struct ArpaEntry {
  std::vector<uint32_t> ids;
  float prob;
  float backoff;
};

void put_u64(std::vector<char>& buf, uint64_t off, uint64_t v) {
  std::memcpy(buf.data() + off, &v, 8);
}
void put_u32(std::vector<char>& buf, uint64_t off, uint32_t v) {
  std::memcpy(buf.data() + off, &v, 4);
}
void put_f32(std::vector<char>& buf, uint64_t off, float v) {
  std::memcpy(buf.data() + off, &v, 4);
}

bool probing_insert(std::vector<char>& buf, uint64_t base, uint64_t buckets,
                    uint64_t entry_bytes, uint64_t key,
                    const float* values, int n_values) {
  if (key == 0) key = 1;  // 0 marks empty slots; remap (prob ~0 of hashes)
  uint64_t b = key % buckets;
  for (uint64_t i = 0; i < buckets; ++i) {
    uint64_t off = base + b * entry_bytes;
    uint64_t existing;
    std::memcpy(&existing, buf.data() + off, 8);
    if (existing == 0) {
      put_u64(buf, off, key);
      for (int v = 0; v < n_values; ++v)
        put_f32(buf, off + 8 + 4ull * v, values[v]);
      return true;
    }
    b = (b + 1) % buckets;
  }
  return false;  // table full (cannot happen: buckets > entries)
}

int write_kenlm_binary_impl(const char* arpa_path, const char* out_path,
                            std::string* err) {
  std::vector<uint64_t> counts;
  std::unordered_map<std::string, uint32_t> vocab;
  std::vector<std::string> words;  // id order
  uint32_t next_id = 1;            // 0 reserved for <unk>
  std::vector<std::vector<ArpaEntry>> grams;

  auto intern = [&](const std::string& w) -> uint32_t {
    auto it = vocab.find(w);
    if (it != vocab.end()) return it->second;
    uint32_t id;
    if (w == "<unk>") {
      id = 0;
    } else {
      id = next_id++;
    }
    vocab.emplace(w, id);
    if (words.size() <= id) words.resize(id + 1);
    words[id] = w;
    return id;
  };
  intern("<unk>");  // id 0 always exists

  // shared grammar (lm.h parse_arpa_stream); the order cap matches the
  // reader's `order > 12` rejection so a converted binary always loads
  int order = speecht_torch::parse_arpa_stream(
      arpa_path, 12,
      [&](int n, uint64_t cnt) {
        if ((int)counts.size() < n) counts.resize(n, 0);
        counts[n - 1] = cnt;
      },
      [&](int n, float prob, const std::vector<std::string>& ws,
          float backoff) {
        if ((int)grams.size() < n) grams.resize(n);
        ArpaEntry e;
        e.prob = prob;
        e.backoff = backoff;
        e.ids.resize(n);
        for (int i = 0; i < n; ++i) e.ids[i] = intern(ws[i]);
        grams[n - 1].push_back(std::move(e));
      });
  if (order == -2) {
    *err = "cannot open ARPA file";
    return 1;
  }
  if (order == -1) {
    *err = "ARPA order exceeds the supported maximum (12)";
    return 1;
  }
  if (order == 0) {
    *err = "no n-grams parsed from ARPA";
    return 1;
  }
  grams.resize(order);
  counts.resize(order);
  for (int n = 0; n < order; ++n) counts[n] = grams[n].size();

  // ---- header ----
  // Sanity: magic + version, canaries (layout mirrors lm/binary_format.cc)
  std::string magic = std::string(kMagicPrefix) + "5\n";
  uint64_t magic_field = align8(magic.size() + 2);  // two trailing nuls
  uint64_t f_zero = magic_field;
  uint64_t f_words = f_zero + 12;
  uint64_t f_u64 = align8(f_words + 8);
  uint64_t sanity_size = align8(f_u64 + 8);
  uint64_t fixed_off = sanity_size;
  uint64_t counts_off = fixed_off + 20;
  uint64_t header_end = align8(counts_off + 8ull * order);

  // vocabulary entries: every unigram surface form (incl. <unk>)
  uint64_t vocab_entries = words.size();
  uint64_t unigram_slots = counts[0] + 1;
  float multiplier = kDefaultMultiplier;
  Layout lay = compute_layout(header_end, order, counts, multiplier,
                              vocab_entries, unigram_slots);

  uint64_t strings_bytes = 0;
  for (const auto& w : words) strings_bytes += w.size() + 1;
  std::vector<char> buf(lay.strings + strings_bytes, 0);

  std::memcpy(buf.data(), magic.data(), magic.size());
  put_f32(buf, f_zero, 0.0f);
  put_f32(buf, f_zero + 4, 1.0f);
  put_f32(buf, f_zero + 8, -0.5f);
  put_u32(buf, f_words, 1u);
  put_u32(buf, f_words + 4, 0xFFFFFFFFu);
  put_u64(buf, f_u64, 1ull);
  buf[fixed_off] = (char)order;
  put_f32(buf, fixed_off + 4, multiplier);
  put_u32(buf, fixed_off + 8, kModelTypeProbing);
  buf[fixed_off + 12] = 1;  // has_vocabulary
  put_u32(buf, fixed_off + 16, 0u);  // search version
  for (int n = 0; n < order; ++n)
    put_u64(buf, counts_off + 8ull * n, counts[n]);

  // vocabulary header {version, bound} + hash table
  put_u32(buf, lay.vocab_header, 1u);
  put_u32(buf, lay.vocab_header + 4, (uint32_t)words.size());
  for (uint32_t id = 0; id < words.size(); ++id) {
    float value;
    std::memcpy(&value, &id, 4);
    if (!probing_insert(buf, lay.vocab_table, lay.vocab_buckets,
                        kVocabEntryBytes, word_hash(words[id]), &value, 1)) {
      *err = "vocab table overflow";
      return 1;
    }
  }

  // unigrams: direct-indexed array. Slot 0 (<unk>) gets the same -10
  // floor ArpaScorer uses BEFORE the entries are written: an ARPA built
  // without a <unk> unigram must not leave log10 P(<unk>) = 0.0 (i.e.
  // probability 1 for every OOV word, which would make garbage letter
  // sequences outscore real words in the beam). A real <unk> entry in
  // grams[0] overwrites the floor.
  put_f32(buf, lay.unigram, -10.0f);
  put_f32(buf, lay.unigram + 4, 0.0f);
  for (const auto& e : grams[0]) {
    uint64_t off = lay.unigram + e.ids[0] * kProbBackoffBytes;
    put_f32(buf, off, e.prob);
    put_f32(buf, off + 4, e.backoff);
  }
  // middle + longest
  for (int n = 2; n <= order; ++n) {
    for (const auto& e : grams[n - 1]) {
      uint64_t key = ngram_hash(e.ids.data(), n);
      if (n == order) {
        if (!probing_insert(buf, lay.longest, lay.longest_buckets,
                            kLongestEntryBytes, key, &e.prob, 1)) {
          *err = "longest table overflow";
          return 1;
        }
      } else {
        float pv[2] = {e.prob, e.backoff};
        if (!probing_insert(buf, lay.middle[n - 2],
                            lay.middle_buckets[n - 2], kMiddleEntryBytes,
                            key, pv, 2)) {
          *err = "middle table overflow";
          return 1;
        }
      }
    }
  }

  // word strings in id order
  uint64_t pos = lay.strings;
  for (const auto& w : words) {
    std::memcpy(buf.data() + pos, w.data(), w.size());
    pos += w.size() + 1;  // keep the nul
  }

  std::ofstream out(out_path, std::ios::binary | std::ios::trunc);
  if (!out.good()) {
    *err = "cannot open output file";
    return 1;
  }
  out.write(buf.data(), (std::streamsize)buf.size());
  return out.good() ? 0 : 1;
}

}  // namespace

NGramScorer* load_kenlm_binary_scorer(const char* path, std::string* err) {
  auto scorer = std::make_unique<KenlmBinaryScorer>();
  if (!scorer->load(path, err)) return nullptr;
  return scorer.release();
}

int write_kenlm_binary(const char* arpa_path, const char* out_path,
                       std::string* err) {
  return write_kenlm_binary_impl(arpa_path, out_path, err);
}

bool is_kenlm_binary(const char* path) {
  std::ifstream f(path, std::ios::binary);
  if (!f.good()) return false;
  char head[sizeof(kMagicPrefix)] = {0};
  f.read(head, sizeof(kMagicPrefix) - 1);
  return f.gcount() == (std::streamsize)(sizeof(kMagicPrefix) - 1) &&
         std::memcmp(head, kMagicPrefix, sizeof(kMagicPrefix) - 1) == 0;
}

}  // namespace speecht_torch

// ---------------------------------------------------------------------------
// ctypes surface: the raw-table dump for the device beam's LM tables
// (speecht_tpu_torch/ops/beam_device.py DeviceLM.from_binary)
// ---------------------------------------------------------------------------

using speecht_torch::KenlmBinaryScorer;

// the library is built with -fvisibility=hidden: only these are exported
#define STT_EXPORT __attribute__((visibility("default")))

extern "C" {

STT_EXPORT void* stt_kenlm_dump_open(const char* path, char* err,
                                     int32_t errlen) {
  auto scorer = std::make_unique<KenlmBinaryScorer>();
  std::string e;
  if (!scorer->load(path, &e)) {
    if (err && errlen > 0) {
      std::snprintf(err, (size_t)errlen, "%s", e.c_str());
    }
    return nullptr;
  }
  return scorer.release();
}

STT_EXPORT void stt_kenlm_dump_close(void* h) {
  delete static_cast<KenlmBinaryScorer*>(h);
}

STT_EXPORT int32_t stt_kenlm_dump_order(void* h) {
  return static_cast<KenlmBinaryScorer*>(h)->dump_order();
}

STT_EXPORT int64_t stt_kenlm_dump_unigram_slots(void* h) {
  return (int64_t)static_cast<KenlmBinaryScorer*>(h)->dump_unigram_slots();
}

STT_EXPORT int32_t stt_kenlm_dump_unigrams(void* h, float* prob,
                                           float* backoff) {
  static_cast<KenlmBinaryScorer*>(h)->dump_unigrams(prob, backoff);
  return 0;
}

STT_EXPORT int64_t stt_kenlm_dump_table_count(void* h, int32_t n) {
  return (int64_t)static_cast<KenlmBinaryScorer*>(h)->dump_table_count(n);
}

STT_EXPORT int32_t stt_kenlm_dump_table(void* h, int32_t n, uint32_t* lo,
                                        uint32_t* hi, float* prob,
                                        float* backoff) {
  return static_cast<KenlmBinaryScorer*>(h)->dump_table(n, lo, hi, prob,
                                                        backoff);
}

// vocabulary surface forms, nul-joined in id order
STT_EXPORT int64_t stt_kenlm_dump_vocab_bytes(void* h) {
  const auto& words = static_cast<KenlmBinaryScorer*>(h)->dump_words();
  int64_t total = 0;
  for (const auto& w : words) total += (int64_t)w.size() + 1;
  return total;
}

STT_EXPORT int32_t stt_kenlm_dump_vocab(void* h, char* out, int64_t cap) {
  const auto& words = static_cast<KenlmBinaryScorer*>(h)->dump_words();
  int64_t pos = 0;
  for (const auto& w : words) {
    if (pos + (int64_t)w.size() + 1 > cap) return 1;
    std::memcpy(out + pos, w.data(), w.size());
    pos += (int64_t)w.size();
    out[pos++] = '\0';
  }
  return 0;
}

}  // extern "C"
