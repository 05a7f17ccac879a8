// Shared n-gram language model interface for the host beam search.
//
// The port's own copy of the JAX package's `speecht_tpu/native/lm.h`, in a
// namespace of its own. Two backends implement it:
//  - ArpaScorer (beam_search.cpp): KenLM's source format, parsed directly.
//  - KenlmBinaryScorer (kenlm_binary.cpp): KenLM's PROBING binary format
//    ("mmap lm ... format version 5"), read without the KenLM library.
//
// Scores are log10 (ARPA convention); shallow fusion scales them in the
// beam (beam_search.cpp).

#pragma once

#include <cstdint>
#include <cstdlib>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

namespace speecht_torch {

struct NGramScorer {
  virtual ~NGramScorer() = default;
  virtual int order() const = 0;
  // word -> backend id; OOV maps to the backend's <unk> id
  virtual uint32_t word_id(const std::string& w) const = 0;
  virtual uint32_t bos_id() const = 0;  // UINT32_MAX when absent
  // log10 P(word | history), Katz backoff; history ids most-recent-last
  virtual float score(const uint32_t* history, int hist_len,
                      uint32_t word) const = 0;
  // vocabulary surface forms (for the valid-word character trie)
  virtual void vocab_words(std::vector<std::string>* out) const = 0;
};

// Returns nullptr + *err on failure.
NGramScorer* load_kenlm_binary_scorer(const char* path, std::string* err);

// True when the file starts with the KenLM binary magic.
bool is_kenlm_binary(const char* path);

// ARPA -> KenLM PROBING binary writer (0 on success).
int write_kenlm_binary(const char* arpa_path, const char* out_path,
                       std::string* err);

// Streaming ARPA parser shared by ArpaScorer (beam_search.cpp) and the
// binary writer (kenlm_binary.cpp): the counts of the \data\ section, the
// \N-grams: sections and their entries, in one implementation so the two
// cannot drift.
//
//   on_count(int order, uint64_t count)  — per "ngram N=count" line
//   on_entry(int order, float prob, const std::vector<std::string>&
//            words, float backoff)       — per parsed n-gram entry
//
// Returns the max order seen; 0 when the file held no n-grams,
// -1 when a section order falls outside [1, max_order] (callers size
// fixed history buffers from this bound), -2 when the file cannot be
// opened.
template <typename CountFn, typename EntryFn>
inline int parse_arpa_stream(const char* path, int max_order,
                             CountFn on_count, EntryFn on_entry) {
  std::ifstream f(path);
  if (!f.good()) return -2;
  std::string line;
  int current = 0, order = 0;
  bool in_data = false;
  std::vector<std::string> words;
  while (std::getline(f, line)) {
    while (!line.empty() && (line.back() == '\r' || line.back() == '\n'))
      line.pop_back();
    if (line == "\\data\\") {
      in_data = true;
      continue;
    }
    if (in_data && line.rfind("ngram ", 0) == 0) {
      size_t eq = line.find('=');
      if (eq != std::string::npos) {
        int n = std::atoi(line.c_str() + 6);
        uint64_t cnt = std::strtoull(line.c_str() + eq + 1, nullptr, 10);
        if (n >= 1) on_count(n, cnt);
      }
      continue;
    }
    if (line.size() > 2 && line[0] == '\\' &&
        line.find("-grams:") != std::string::npos) {
      current = std::atoi(line.c_str() + 1);
      if (current < 1 || current > max_order) return -1;
      if (order < current) order = current;
      continue;
    }
    if (line == "\\end\\") break;
    if (current == 0 || line.empty()) continue;
    std::istringstream ss(line);
    float prob;
    if (!(ss >> prob)) continue;
    words.resize(current);
    bool ok = true;
    for (int i = 0; i < current; ++i)
      if (!(ss >> words[i])) {
        ok = false;
        break;
      }
    if (!ok) continue;
    float backoff = 0.0f;
    ss >> backoff;  // optional
    on_entry(current, prob, words, backoff);
  }
  return order;
}

}  // namespace speecht_torch
