// CTC prefix beam search with n-gram LM shallow fusion (host side).
//
// The port's own copy of the JAX package's
// `speecht_tpu/native/beam_search.cpp`: the same ARPA scorer, vocabulary
// trie, prefix-tree arena and search, so the same emissions give the same
// ids. It differs in what it exports, not in its arithmetic: its C++ sits
// in a namespace of its own, the library is built with hidden visibility
// and exports only the `stt_` C functions below (so it and the JAX
// package's library can live in one process). Beside the search it exports
// the continuation search of streaming partials (`stt_ctc_beam_search_cont`)
// and the ARPA -> KenLM binary writer (`stt_lm_write_binary`).
//
// The device produces (blank-collapsed) log-probs and this file scores
// prefixes with:
//
//   score = log P_acoustic(prefix)
//         + lm_weight * log10 P_LM(completed words)   [ARPA backoff n-gram]
//         + word_count_weight * #words
//         + valid_word_count_weight * #in-vocabulary-words
//
// The three weights are runtime arguments (never compiled in), which
// `search` mutates per evaluation.
//
// The LM is a word-level backoff model -- KenLM's ARPA source format OR its
// PROBING binary format (kenlm_binary.cpp) -- plus a vocabulary file (one
// word per line) used for the valid-word bonus and the in-beam character
// trie; without the file the trie falls back to the LM's own vocabulary.

#include "lm.h"

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <string>
#include <vector>
#include <unordered_map>
#include <algorithm>
#include <memory>
#include <fstream>
#include <sstream>

namespace {

constexpr int kSpaceId = 27;   // vocabulary.SPACE_ID
constexpr double kNegInf = -1e30;
constexpr double kLog10 = 2.302585092994046;  // ln(10)

inline double log_add(double a, double b) {
  if (a <= kNegInf) return b;
  if (b <= kNegInf) return a;
  double m, d;
  if (a > b) { m = a; d = b - a; } else { m = b; d = a - b; }
  if (d < -36.0) return m;  // below double epsilon of log1p
  return m + std::log1p(std::exp(d));
}

inline char id_to_char(int id) {
  if (id == 26) return '\'';
  if (id == kSpaceId) return ' ';
  return (char)('a' + id);
}

// ---------------------------------------------------------------------------
// ARPA backoff n-gram word LM + vocabulary trie
// ---------------------------------------------------------------------------

struct NGramEntry {
  float logprob;   // log10
  float backoff;   // log10
};

struct TrieNode {
  int32_t children[28];  // index into trie pool per char id (a-z, ', -)
  bool terminal;
  TrieNode() : terminal(false) { std::fill(children, children + 28, -1); }
};

// ARPA backend: parses KenLM's source format into per-order hash maps.
struct ArpaScorer : public speecht_torch::NGramScorer {
  std::unordered_map<std::string, uint32_t> word_ids;
  std::vector<std::unordered_map<uint64_t, NGramEntry>> ngrams;  // [order-1]
  int order_ = 0;
  uint32_t unk_id = UINT32_MAX;
  uint32_t bos_id_ = UINT32_MAX;
  float unk_floor = -10.0f;

  int order() const override { return order_; }
  uint32_t bos_id() const override { return bos_id_; }

  uint32_t word_id(const std::string& w) const override {
    auto it = word_ids.find(w);
    return it == word_ids.end() ? unk_id : it->second;
  }

  void vocab_words(std::vector<std::string>* out) const override {
    out->clear();
    out->reserve(word_ids.size());
    for (const auto& kv : word_ids) out->push_back(kv.first);
  }

  static uint64_t key(const uint32_t* ids, int n) {
    // polynomial hash over word ids (fits order <= 3 exactly in 64 bits
    // for vocab < 2^21; beyond that it is a hash, collisions negligible)
    uint64_t k = 1469598103934665603ull;
    for (int i = 0; i < n; ++i) {
      k ^= ids[i] + 1;
      k *= 1099511628211ull;
    }
    return k;
  }

  const NGramEntry* find(const uint32_t* ids, int n) const {
    if (n <= 0 || n > order_) return nullptr;
    const auto& m = ngrams[n - 1];
    auto it = m.find(key(ids, n));
    return it == m.end() ? nullptr : &it->second;
  }

  // log10 P(word | history) with Katz backoff. history = up to order-1 ids,
  // most recent last. Stack buffer — this is the beam's hot path and a
  // per-call heap allocation here costs ~30% of the whole search.
  float score(const uint32_t* history, int hist_len,
              uint32_t word) const override {
    if (order_ == 0) return unk_floor;
    int ctx = std::min(hist_len, order_ - 1);
    uint32_t ids[16];
    for (int i = 0; i < ctx; ++i) ids[i] = history[hist_len - ctx + i];
    ids[ctx] = word;
    // try longest n-gram first, accumulate backoffs
    float backoff_sum = 0.0f;
    for (int n = ctx + 1; n >= 1; --n) {
      const uint32_t* start = ids + (ctx + 1 - n);
      const NGramEntry* e = find(start, n);
      if (e) return e->logprob + backoff_sum;
      if (n > 1) {
        // add backoff of the (n-1)-gram context
        const NGramEntry* b = find(start, n - 1);
        if (b) backoff_sum += b->backoff;
      }
    }
    return unk_floor + backoff_sum;
  }
};

// Handle the bindings hold: a scorer backend (ARPA or KenLM binary) plus
// the character trie for the valid-word bonus.
struct LanguageModel {
  std::unique_ptr<speecht_torch::NGramScorer> scorer;
  int order = 0;
  uint32_t bos_id = UINT32_MAX;

  // vocabulary trie over character ids for valid-word lookup
  std::vector<TrieNode> trie;

  LanguageModel() { trie.emplace_back(); }

  uint32_t word_id(const std::string& w) const {
    return scorer->word_id(w);
  }

  float score(const uint32_t* history, int hist_len, uint32_t word) const {
    return scorer->score(history, hist_len, word);
  }

  void trie_insert(const std::string& word) {
    int node = 0;
    for (char c : word) {
      int cid;
      if (c == '\'') cid = 26;
      else if (c >= 'a' && c <= 'z') cid = c - 'a';
      else return;  // skip words with out-of-vocab characters
      if (trie[node].children[cid] < 0) {
        trie[node].children[cid] = (int32_t)trie.size();
        trie.emplace_back();
      }
      node = trie[node].children[cid];
    }
    trie[node].terminal = true;
  }

  bool trie_has_word(const std::string& word) const {
    int node = 0;
    for (char c : word) {
      int cid;
      if (c == '\'') cid = 26;
      else if (c >= 'a' && c <= 'z') cid = c - 'a';
      else return false;
      node = trie[node].children[cid];
      if (node < 0) return false;
    }
    return trie[node].terminal;
  }

};

ArpaScorer* parse_arpa(const char* arpa_path) {
  auto lm = std::make_unique<ArpaScorer>();
  std::vector<uint64_t> counts;

  // shared grammar (lm.h parse_arpa_stream): the order cap (12) matches
  // the binary reader and, more importantly, score()'s fixed
  // uint32_t ids[16] stack buffer — an unchecked \17-grams: section
  // would overflow it
  int order = speecht_torch::parse_arpa_stream(
      arpa_path, 12,
      [&](int n, uint64_t cnt) {
        if ((int)counts.size() < n) counts.resize(n, 0);
        counts[n - 1] = cnt;
      },
      [&](int n, float logprob, const std::vector<std::string>& words,
          float backoff) {
        if ((int)lm->ngrams.size() < n) {
          lm->ngrams.resize(n);
          // reserve from the declared \data\ counts on first entry
          if (counts.size() >= (size_t)n)
            lm->ngrams[n - 1].reserve(counts[n - 1] * 2);
        }
        // intern words (unigram section defines the id space)
        uint32_t ids[16];  // n <= 12 enforced by the parser
        for (int i = 0; i < n; ++i) {
          auto it = lm->word_ids.find(words[i]);
          if (it == lm->word_ids.end()) {
            uint32_t id = (uint32_t)lm->word_ids.size();
            lm->word_ids.emplace(words[i], id);
            ids[i] = id;
          } else {
            ids[i] = it->second;
          }
        }
        lm->ngrams[n - 1][ArpaScorer::key(ids, n)] =
            NGramEntry{logprob, backoff};
      });
  if (order < 0) return nullptr;  // unreadable file or order out of range
  lm->order_ = order;
  // an order whose section held no entries must still have a map to
  // probe (find() indexes ngrams[n-1] for any n <= order_)
  if ((int)lm->ngrams.size() < order) lm->ngrams.resize(order);

  auto unk = lm->word_ids.find("<unk>");
  if (unk != lm->word_ids.end()) {
    lm->unk_id = unk->second;
    uint32_t uid = unk->second;
    const NGramEntry* e = lm->find(&uid, 1);
    if (e) lm->unk_floor = e->logprob;
  }
  auto bos = lm->word_ids.find("<s>");
  if (bos != lm->word_ids.end()) lm->bos_id_ = bos->second;
  return lm.release();
}

// Loads either format (sniffed by magic) and builds the character trie.
LanguageModel* load_lm(const char* model_path, const char* vocab_path) {
  auto lm = std::make_unique<LanguageModel>();
  if (speecht_torch::is_kenlm_binary(model_path)) {
    std::string err;
    speecht_torch::NGramScorer* s =
        speecht_torch::load_kenlm_binary_scorer(model_path, &err);
    if (!s) {
      std::fprintf(stderr, "kenlm binary load failed (%s): %s\n",
                   model_path, err.c_str());
      return nullptr;
    }
    lm->scorer.reset(s);
  } else {
    ArpaScorer* s = parse_arpa(model_path);
    if (!s) return nullptr;
    lm->scorer.reset(s);
  }
  lm->order = lm->scorer->order();
  lm->bos_id = lm->scorer->bos_id();

  // vocabulary trie: explicit vocabulary file, else the LM's own words
  if (vocab_path && vocab_path[0]) {
    std::ifstream vf(vocab_path);
    std::string w;
    while (std::getline(vf, w)) {
      while (!w.empty() && (w.back() == '\r' || w.back() == '\n')) w.pop_back();
      std::transform(w.begin(), w.end(), w.begin(), ::tolower);
      if (!w.empty()) lm->trie_insert(w);
    }
  } else {
    std::vector<std::string> words;
    lm->scorer->vocab_words(&words);
    for (std::string w : words) {
      if (w == "<s>" || w == "</s>" || w == "<unk>") continue;
      std::transform(w.begin(), w.end(), w.begin(), ::tolower);
      lm->trie_insert(w);
    }
  }
  return lm.release();
}

// ---------------------------------------------------------------------------
// CTC prefix beam search
// ---------------------------------------------------------------------------

// Prefix-tree arena: each decoded prefix is a node (parent, char); LM
// shallow-fusion state is computed once at node creation, and per-frame
// beam bookkeeping only touches integer node ids + two log-probs.

struct Node {
  int32_t parent;      // -1 for root
  int8_t ch;           // char id appended by this node
  int32_t depth;       // prefix length
  // shallow-fusion state (function of the prefix string alone)
  float lm_score;      // accumulated weighted bonuses (ln scale)
  uint32_t hist[4];    // last up-to-4 completed word ids (order <= 5)
  int8_t hist_len;
  // intrusive child list (hash-free lookups; fanout is <= 28)
  int32_t first_child = -1;
  int32_t next_sibling = -1;
  // per-frame candidate slot (stamped so no clearing between frames)
  int64_t slot_stamp = -1;
  int32_t slot_idx = -1;
};

// Push a completed word id into a 4-slot history ring (most recent
// last); returns the new length. The in-beam fusion, the sentence
// scorer (stt_lm_score_sentence) and the streaming context seed must all
// apply this exact rule.
inline int push_ring(uint32_t* hist, int len, uint32_t wid) {
  if (len < 4) {
    hist[len] = wid;
    return len + 1;
  }
  for (int i = 0; i < 3; ++i) hist[i] = hist[i + 1];
  hist[3] = wid;
  return 4;
}

struct Arena {
  std::vector<Node> nodes;
  // continuation mode: the trailing partial word of the committed
  // transcript, which prefixes the first word that completes inside this
  // search so the LM scores the whole word (streaming partials)
  std::string root_partial;

  Arena() {
    nodes.reserve(1 << 14);
    nodes.push_back(Node{-1, -1, 0, 0.0f, {0, 0}, 0});
  }

  // read the trailing partial word of prefix `id` (walking up, bounded by
  // word length); returns characters in order
  std::string partial_word(int32_t id) const {
    std::string w;
    while (id > 0) {
      const Node& n = nodes[id];
      if (n.ch == kSpaceId) break;
      w.push_back(id_to_char(n.ch));
      id = n.parent;
    }
    std::reverse(w.begin(), w.end());
    // the walk reached the root without a space: the word began in the
    // committed text
    if (id == 0 && !root_partial.empty()) w = root_partial + w;
    return w;
  }

  int32_t child(int32_t parent, int8_t ch, const LanguageModel* lm,
                float lm_weight, float word_count_weight,
                float valid_word_count_weight) {
    for (int32_t c = nodes[parent].first_child; c >= 0;
         c = nodes[c].next_sibling) {
      if (nodes[c].ch == ch) return c;
    }

    const Node& p = nodes[parent];
    Node n{parent, ch, p.depth + 1, p.lm_score,
           {p.hist[0], p.hist[1], p.hist[2], p.hist[3]}, p.hist_len};
    if (ch == kSpaceId) {
      std::string w = partial_word(parent);
      if (!w.empty()) {
        n.lm_score += word_count_weight;
        if (lm && lm->trie_has_word(w))
          n.lm_score += valid_word_count_weight;
        if (lm && lm->order > 0) {
          uint32_t hist[8];
          int hn = 0;
          if (lm->bos_id != UINT32_MAX) hist[hn++] = lm->bos_id;
          for (int i = 0; i < n.hist_len; ++i) hist[hn++] = n.hist[i];
          uint32_t wid = lm->word_id(w);
          n.lm_score += lm_weight * lm->score(hist, hn, wid) * (float)kLog10;
          n.hist_len = (int8_t)push_ring(n.hist, n.hist_len, wid);
        }
      }
    }
    int32_t id = (int32_t)nodes.size();
    n.next_sibling = nodes[parent].first_child;
    nodes.push_back(n);
    nodes[parent].first_child = id;
    return id;
  }
};

struct Cand {
  int32_t node;
  double p_b;
  double p_nb;
  double total(const Arena& a) const {
    return log_add(p_b, p_nb) + a.nodes[node].lm_score;
  }
};

}  // namespace

// the library is built with -fvisibility=hidden: only these are exported
#define STT_EXPORT __attribute__((visibility("default")))

extern "C" {

STT_EXPORT void* stt_lm_load(const char* model_path, const char* vocab_path) {
  return load_lm(model_path, vocab_path);
}

// ARPA -> KenLM PROBING binary writer. Returns 0 on success; err_buf
// receives a message on failure.
STT_EXPORT int stt_lm_write_binary(const char* arpa_path, const char* out_path,
                                   char* err_buf, int err_capacity) {
  std::string err;
  int rc = speecht_torch::write_kenlm_binary(arpa_path, out_path, &err);
  if (rc != 0 && err_buf && err_capacity > 0) {
    std::snprintf(err_buf, (size_t)err_capacity, "%s", err.c_str());
  }
  return rc;
}

STT_EXPORT int stt_lm_is_binary(const char* path) {
  return speecht_torch::is_kenlm_binary(path) ? 1 : 0;
}

STT_EXPORT void stt_lm_free(void* lm) { delete (LanguageModel*)lm; }

STT_EXPORT int stt_lm_order(void* lm) { return ((LanguageModel*)lm)->order; }

// log10 P(word | space-separated history string)
STT_EXPORT float stt_lm_score_word(void* lm_ptr, const char* history, const char* word) {
  auto* lm = (LanguageModel*)lm_ptr;
  std::vector<uint32_t> hist;
  if (lm->bos_id != UINT32_MAX) hist.push_back(lm->bos_id);
  std::istringstream ss(history);
  std::string w;
  while (ss >> w) hist.push_back(lm->word_id(w));
  return lm->score(hist.data(), (int)hist.size(), lm->word_id(word));
}

STT_EXPORT int stt_lm_has_word(void* lm_ptr, const char* word) {
  return ((LanguageModel*)lm_ptr)->trie_has_word(word) ? 1 : 0;
}

// Scores a whole space-separated sentence with the beam's history
// semantics (<s> pinned + last-4-word ring per completed word — matching
// the in-beam fusion exactly, incl. the trailing word). One call per
// hypothesis replaces a per-word ctypes round trip in n-best rescoring.
// Outputs: summed log10 LM prob, word count, valid-word count.
STT_EXPORT void stt_lm_score_sentence(void* lm_ptr, const char* text, float* lm_sum,
                          int32_t* n_words, int32_t* n_valid) {
  auto* lm = (LanguageModel*)lm_ptr;
  *lm_sum = 0.0f;
  *n_words = 0;
  *n_valid = 0;
  uint32_t ring[4];
  int ring_n = 0;
  std::istringstream ss(text);
  std::string w;
  while (ss >> w) {
    ++*n_words;
    if (lm->trie_has_word(w)) ++*n_valid;
    if (lm->order > 0) {
      uint32_t hist[8];
      int hn = 0;
      if (lm->bos_id != UINT32_MAX) hist[hn++] = lm->bos_id;
      for (int i = 0; i < ring_n; ++i) hist[hn++] = ring[i];
      uint32_t wid = lm->word_id(w);
      *lm_sum += lm->score(hist, hn, wid);
      ring_n = push_ring(ring, ring_n, wid);
    }
  }
}

// CTC prefix beam search over one utterance, or over the continuation of
// committed context (streaming partials).
//   log_probs: [T, C] natural-log softmax emissions (C = 29, blank last)
//   lm: optional LanguageModel* (may be null)
//   weights: lm_weight (applied to log10 LM scores), word_count_weight,
//            valid_word_count_weight -- runtime-tunable shallow fusion
//   context_text: the committed transcript so far (null or empty for a
//     fresh utterance): its complete words seed the LM history ring and
//     its trailing partial word prefixes the first word completed here
//   last_char_id / ended_in_blank: the committed greedy path's collapse
//     carry -- the raw last emission decides whether the first frame here
//     can merge as a repeat (CTC stay) or must start a new character
//   out_ids: caller buffer of capacity out_capacity; returns decoded length
//     (the characters after the context only: the caller owns the
//     committed text)
static int beam_search_impl(
    const float* log_probs, int64_t T, int32_t C, int32_t blank_id,
    int32_t beam_width, void* lm_ptr, float lm_weight,
    float word_count_weight, float valid_word_count_weight,
    int32_t prune_top_k, const char* context_text, int32_t last_char_id,
    int32_t ended_in_blank, int32_t* out_ids, int32_t out_capacity) {
  auto* lm = (LanguageModel*)lm_ptr;
  Arena arena;
  if (context_text && context_text[0]) {
    // split the committed text into complete words (the LM history ring)
    // and the trailing partial word (prefixes the first completion here)
    std::string text(context_text);
    size_t last_space = text.find_last_of(' ');
    std::string complete =
        last_space == std::string::npos ? "" : text.substr(0, last_space);
    arena.root_partial =
        last_space == std::string::npos ? text : text.substr(last_space + 1);
    Node& root = arena.nodes[0];
    std::istringstream ss(complete);
    std::string w;
    while (ss >> w) {
      if (!lm || lm->order == 0) break;
      uint32_t wid = lm->word_id(w);
      root.hist_len = (int8_t)push_ring(root.hist, root.hist_len, wid);
    }
  }
  if (last_char_id >= 0) arena.nodes[0].ch = (int8_t)last_char_id;

  std::vector<Cand> beam;
  // a fresh utterance: all mass on the blank path (log prob 1). A
  // continuation whose committed raw path ended mid-character carries its
  // mass on the non-blank path instead, so an immediate repeat merges.
  if (ended_in_blank || last_char_id < 0) {
    beam.push_back(Cand{0, 0.0, kNegInf});
  } else {
    beam.push_back(Cand{0, kNegInf, 0.0});
  }

  std::vector<int> cand_chars;
  cand_chars.reserve(C);
  std::vector<int> idx(C);

  // per-frame candidate accumulation; node slots are stamped with the
  // frame index, so neither clearing nor hashing is needed
  std::vector<Cand> next;
  next.reserve(4096);
  std::vector<double> totals;
  std::vector<int32_t> order;
  std::vector<Cand> pruned;
  pruned.reserve(beam_width);
  int64_t stamp = 0;

  auto get_slot = [&](int32_t node) -> Cand& {
    Node& n = arena.nodes[node];
    if (n.slot_stamp == stamp) return next[n.slot_idx];
    n.slot_stamp = stamp;
    n.slot_idx = (int32_t)next.size();
    next.push_back(Cand{node, kNegInf, kNegInf});
    return next.back();
  };

  for (int64_t t = 0; t < T; ++t) {
    const float* lp = log_probs + t * C;

    // top-k emission pruning per frame
    cand_chars.clear();
    if (prune_top_k > 0 && prune_top_k < C) {
      for (int c = 0; c < C; ++c) idx[c] = c;
      std::partial_sort(
          idx.begin(), idx.begin() + prune_top_k, idx.end(),
          [&](int a, int b) { return lp[a] > lp[b]; });
      cand_chars.assign(idx.begin(), idx.begin() + prune_top_k);
      // blank must always be considered
      if (std::find(cand_chars.begin(), cand_chars.end(), blank_id) ==
          cand_chars.end())
        cand_chars.push_back(blank_id);
    } else {
      for (int c = 0; c < C; ++c) cand_chars.push_back(c);
    }

    stamp = t + 1;
    next.clear();

    for (const Cand& p : beam) {
      double p_tot = log_add(p.p_b, p.p_nb);
      int last = arena.nodes[p.node].ch;  // -1 at root

      for (int c : cand_chars) {
        double emit = lp[c];
        if (c == blank_id) {
          Cand& q = get_slot(p.node);
          q.p_b = log_add(q.p_b, p_tot + emit);
          continue;
        }
        if (c == last) {
          // repeat extends the non-blank path of the SAME prefix...
          Cand& q = get_slot(p.node);
          q.p_nb = log_add(q.p_nb, p.p_nb + emit);
          // ...and the blank path starts a NEW prefix
          int32_t child = arena.child(
              p.node, (int8_t)c, lm, lm_weight, word_count_weight,
              valid_word_count_weight);
          Cand& r = get_slot(child);
          r.p_nb = log_add(r.p_nb, p.p_b + emit);
          continue;
        }
        // new character extends the prefix
        int32_t child = arena.child(
            p.node, (int8_t)c, lm, lm_weight, word_count_weight,
            valid_word_count_weight);
        Cand& r = get_slot(child);
        r.p_nb = log_add(r.p_nb, p_tot + emit);
      }
    }

    // prune to beam_width by total score, after a cheap score-gap prune:
    // candidates more than kPruneGap nats below the frame's best carry
    // ~e^-20 of its probability and cannot re-enter the beam. Totals are
    // computed once per candidate (log_add is the inner-loop cost).
    if ((int)next.size() > beam_width) {
      constexpr double kPruneGap = 20.0;
      totals.resize(next.size());
      double best_total = -1e300;
      for (size_t i = 0; i < next.size(); ++i) {
        totals[i] = next[i].total(arena);
        if (totals[i] > best_total) best_total = totals[i];
      }
      size_t kept = 0;
      for (size_t i = 0; i < next.size(); ++i) {
        if (totals[i] >= best_total - kPruneGap) {
          // keep the stamped slot index consistent after compaction
          arena.nodes[next[i].node].slot_idx = (int32_t)kept;
          next[kept] = next[i];
          totals[kept] = totals[i];
          ++kept;
        }
      }
      next.resize(kept);
      if ((int)next.size() > beam_width) {
        // order an index array by cached totals, then apply
        order.resize(next.size());
        for (size_t i = 0; i < order.size(); ++i) order[i] = (int32_t)i;
        std::partial_sort(
            order.begin(), order.begin() + beam_width, order.end(),
            [&](int32_t a, int32_t b) { return totals[a] > totals[b]; });
        pruned.clear();
        for (int i = 0; i < beam_width; ++i)
          pruned.push_back(next[order[i]]);
        next.swap(pruned);
      }
    }
    beam.assign(next.begin(), next.end());
  }

  // final: also score the trailing partial word (sentence end)
  const Cand* best = nullptr;
  double best_score = -1e300;
  for (const Cand& p : beam) {
    double s = p.total(arena);
    std::string w = arena.partial_word(p.node);
    if (!w.empty()) {
      s += word_count_weight;
      if (lm && lm->trie_has_word(w)) s += valid_word_count_weight;
      if (lm && lm->order > 0) {
        const Node& n = arena.nodes[p.node];
        std::vector<uint32_t> hist;
        if (lm->bos_id != UINT32_MAX) hist.push_back(lm->bos_id);
        for (int i = 0; i < n.hist_len; ++i) hist.push_back(n.hist[i]);
        s += lm_weight *
             lm->score(hist.data(), (int)hist.size(), lm->word_id(w)) *
             kLog10;
      }
    }
    if (s > best_score) { best_score = s; best = &p; }
  }

  if (!best) return 0;
  // walk up the prefix tree to emit the character sequence
  const Node* n = &arena.nodes[best->node];
  int len = n->depth;
  int out_len = std::min(len, out_capacity);
  int32_t id = best->node;
  for (int i = len - 1; i >= 0; --i) {
    if (i < out_capacity) out_ids[i] = arena.nodes[id].ch;
    id = arena.nodes[id].parent;
  }
  return out_len;
}

STT_EXPORT int stt_ctc_beam_search(
    const float* log_probs, int64_t T, int32_t C, int32_t blank_id,
    int32_t beam_width, void* lm_ptr, float lm_weight,
    float word_count_weight, float valid_word_count_weight,
    int32_t prune_top_k, int32_t* out_ids, int32_t out_capacity) {
  return beam_search_impl(
      log_probs, T, C, blank_id, beam_width, lm_ptr, lm_weight,
      word_count_weight, valid_word_count_weight, prune_top_k, nullptr,
      -1, 1, out_ids, out_capacity);
}

// Continuation-mode beam search: decodes a tail of emissions conditioned
// on already-committed context (streaming partials: the committed text
// never changes; only the tail's characters are returned).
STT_EXPORT int stt_ctc_beam_search_cont(
    const float* log_probs, int64_t T, int32_t C, int32_t blank_id,
    int32_t beam_width, void* lm_ptr, float lm_weight,
    float word_count_weight, float valid_word_count_weight,
    int32_t prune_top_k, const char* context_text, int32_t last_char_id,
    int32_t ended_in_blank, int32_t* out_ids, int32_t out_capacity) {
  return beam_search_impl(
      log_probs, T, C, blank_id, beam_width, lm_ptr, lm_weight,
      word_count_weight, valid_word_count_weight, prune_top_k,
      context_text, last_char_id, ended_in_blank, out_ids, out_capacity);
}

}  // extern "C"
