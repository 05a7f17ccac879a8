// CTC prefix beam search with n-gram LM shallow fusion, for Hopper (sm_90a).
//
// Replaces an XLA program, not a Pallas kernel: the lax.scan over the
// blank-collapsed frames of speecht_tpu/ops/beam_device.py:1228
// (make_device_beam_search, vmapped over the rows at :1273-1284). It
// computes what the plain PyTorch version computes,
// speecht_tpu_torch/ops/beam_device.py::plain_beam_search: per frame and
// row, the frame's top-K chars (lax.top_k's order), the stay and extend
// candidates of every beam, the merge of extend(p, c) into stay(j), the LM
// bonus of completing a word (word table, then the Katz backoff walk over
// the n-gram arena), the top W of the (K+1)·W candidates (value
// descending, the lower candidate index first on a tie) and the state
// update; then the final ranking, the n-best and the backtrack of the
// backpointer lattice into ids padded with PAD_ID (-1).
//
// What bounds it on this card: the serial chain of frames, not the work.
// Per row and frame the work is small (at W=100, K=8: ~900 candidate
// scores, one selection of 100 among them, W merge probes, the LM walks
// of the new words), but every frame depends on the last, so a frame
// costs its block barriers, the shared-memory round trips between them
// and the dependent L2 round trips of the LM walk. The bytes the batch must
// move take microseconds at 3.35 TB/s; the chain's latency sets the time,
// so the design keeps the chain short: no sort of the pool, no scan over
// the slots for the merge, the LM walked beside the chain:
//
// - One CTA per row, the whole frame loop inside the kernel: a batch is one
//   launch, and a row stops at its own length. Thread tid < W owns a slot
//   (which slot changes every frame) and keeps its state in registers.
// - The frames' top-K is off the chain: every 32 frames the warps rank the
//   chunk of 32 after the current one (a warp a frame, a lane a char, by
//   shuffles) into a shared ring of two chunks.
// - The merge by a table, not a scan: the owners insert their alive
//   prefixes' hashes (h1, h2) into an open-addressed table of 2W..4W cells
//   (atomicCAS); a beam probes (ph1, ph2) once and takes the lowest
//   matching slot of the probe chain, the plain version's first match.
// - The scoring by beam slices: thread s scores candidates [c0, c1) of beam
//   s mod W (slice s / W of its K + 1), loading the beam's values once.
// - A selection, not a sort: the totals become order-preserving 32-bit keys
//   (float bits flipped; -0 folded into +0, so equal values give equal
//   keys). A radix select finds the W-th key, each pass one barrier: the
//   histogram is built with shared atomics and every selecting warp scans
//   it itself. The first pass bins a window placed at the last frame's
//   threshold, as wide as its kept keys were, so that it often decides
//   alone; a W-th key outside the window restarts from the top 8 bits. Ties at the threshold are broken by candidate index: a
//   block prefix count keeps the first `need` equal keys in index order and
//   writes the W kept candidates to a list in index order. Only those W are
//   put in order: thread c takes kept candidate c to slot rank = the kept
//   keys above it plus the equal ones before it in the list.
// - The LM bonus travels with the slot: a stay keeps its parent's word
//   state and so its bonus and word id; a space sets wlen to 0 (bonus 0);
//   only a letter extension needs a new bonus. Its owner posts the new word
//   in shared memory, and where the block has spare warps an LM thread
//   walks it (the key rows of every level and the two unigram rows in one
//   round trip, then the values the walk reads in one) while the owners
//   publish and merge, behind a barrier of the other threads only.
// - Backpointers stay in shared memory when [T, W] int16 fits beside the
//   rest (the main shape), else in the caller's [B, T, W] scratch; one thread
//   per winner walks them back, and a warp per winner moves the kept chars
//   to the front of the row.
//
// A frame has 5 block barriers and one per radix pass (1.3-1.7 passes a
// frame at the main shape): the publish (the threads but the LM threads),
// the merge, the scoring with the first histogram, each pass, the kept
// list and the frame's end. The split build (see the end of this comment)
// shows that the rest of a frame is thread 0's own work between the
// barriers, not waiting at them.
//
// Shared memory (offsets 16-byte aligned, `Layout`): the frame ring
// (64 x round16(5K + 36) bytes), the published beam state (6 float, 6 u32
// and 5 int words a slot, the word history W·H, the has-a-merge flags),
// the [W, K] int16 merge map, the hash table (int, next_pow2(2W) cells),
// the P keys (u32), 5 x 256 histogram bins, 32 warp sums, two keys and
// the kept list (W u32 keys, W u16 candidate indices); then the LM
// requests and the backpointers where they fit, the backpointers first
// (beam_device_smem_bytes is the least a launch needs).
//
// Arithmetic: float32 as the plain version; log-add-exp as torch's CUDA
// logaddexp (m + log1pf(expf(-|a - b|)), an infinite pair returned as is;
// past |a - b| = 110 expf gives 0 and the sum is m + 0, computed so without
// the calls), products that feed a sum by __fmul_rn/__fadd_rn so that
// nothing is contracted into an FMA the plain version does not make; u32
// hashes wrap natively and the KenLM key hash is a native u64 multiply. A
// carried bonus is the value the same operations gave on the same word
// state.
//
// Built with -DBEAM_DEVICE_SPLIT, thread 0 of each CTA adds up clock64()
// intervals of the frame's phases and its waits at barriers
// (beam_device_split_read); only chip_smoke.py's phase 2d loads that build.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr float kNeg = -1.0e30f;
constexpr uint32_t kM1 = 16777619u, kM2 = 2246822519u;
constexpr uint32_t kSeed1 = 2166136261u, kSeed2 = 3266489917u;
constexpr uint32_t kWSeed1 = 374761393u, kWSeed2 = 668265263u;
constexpr uint32_t kKP1 = 16777619u, kKP2 = 2654435761u;
constexpr uint32_t kKSeed1 = 2166136261u, kKSeed2 = 40503u;
constexpr uint64_t kC1 = 8978948897894561157ull, kC2 = 17894857484156487943ull;
constexpr int kSpace = 27, kBlank = 28, kPad = -1;
constexpr int kMaxC = 32, kMaxH = 5, kMaxW = 1024, kMaxThreads = 1024;
constexpr int kMaxSmem = 232448;  // the card's 227 KB a block
constexpr int kChunk = 32;  // frames ranked at a time; the ring holds two chunks
// the radix select's histograms: a window pass, a restart and 3 refinements
constexpr int kBins = 256, kPasses = 5;
constexpr int kWindowAt = 160;  // the bin of the last frame's threshold
constexpr unsigned kFull = 0xFFFFFFFFu;

#ifdef BEAM_DEVICE_SPLIT
// columns of a row: the phases' cycles, thread 0's cycles waiting at
// barriers (within the phases), the radix passes, the row's cycles in all,
// its frames
constexpr int kSplitPhases = 8, kSplitCols = kSplitPhases + 4, kSplitRows = 4096;
__device__ unsigned long long g_split[kSplitRows][kSplitCols];
#define SPLIT_PASS()                                     \
  do {                                                   \
    if (threadIdx.x == 0) ++split_acc[kSplitPhases + 1]; \
  } while (0)
#define SPLIT_START                                                   \
  long long split_t0 = clock64(), split_last = split_t0, split_pre = 0; \
  unsigned long long split_acc[kSplitPhases + 2] = {};
#define SPLIT_MARK(ph)                   \
  do {                                   \
    if (threadIdx.x == 0) {              \
      const long long now = clock64();   \
      split_acc[ph] += now - split_last; \
      split_last = now;                  \
    }                                    \
  } while (0)
#define SYNC()                                                          \
  do {                                                                  \
    if (threadIdx.x == 0) split_pre = clock64();                        \
    __syncthreads();                                                    \
    if (threadIdx.x == 0) split_acc[kSplitPhases] += clock64() - split_pre; \
  } while (0)
#define SYNC_OR(pred) split_sync_or(pred, &split_pre, split_acc + kSplitPhases)
#define SYNC_PART(n)                                                          \
  do {                                                                        \
    if (threadIdx.x == 0) split_pre = clock64();                              \
    bar_sync_part(n);                                                         \
    if (threadIdx.x == 0) split_acc[kSplitPhases] += clock64() - split_pre;   \
  } while (0)
#define SPLIT_END(b, frames)                                                    \
  do {                                                                          \
    if (threadIdx.x == 0 && (b) < kSplitRows) {                                 \
      for (int c = 0; c < kSplitPhases + 2; ++c) g_split[b][c] = split_acc[c];  \
      g_split[b][kSplitPhases + 2] = clock64() - split_t0;                      \
      g_split[b][kSplitPhases + 3] = (frames);                                  \
    }                                                                           \
  } while (0)
#else
#define SPLIT_START
#define SPLIT_MARK(ph)
#define SPLIT_PASS()
#define SYNC() __syncthreads()
#define SYNC_OR(pred) __syncthreads_or(pred)
#define SYNC_PART(n) bar_sync_part(n)
#define SPLIT_END(b, frames)
#endif
// A barrier of the block's first n threads (n a multiple of 32), apart
// from __syncthreads' barrier 0.
__device__ __forceinline__ void bar_sync_part(int n) {
  asm volatile("bar.sync 1, %0;" ::"r"(n) : "memory");
}

#ifdef BEAM_DEVICE_SPLIT
__device__ __forceinline__ int split_sync_or(int pred, long long* pre,
                                             unsigned long long* wait) {
  if (threadIdx.x == 0) *pre = clock64();
  const int any = __syncthreads_or(pred);
  if (threadIdx.x == 0) *wait += clock64() - *pre;
  return any;
}
#endif
// the split's phases (beam_device_cuda.SPLIT_PHASES)
enum { kPhFrames, kPhPublish, kPhMerge, kPhScore, kPhSelect, kPhReindex, kPhLm, kPhTail };

struct Params {
  const float* logp;  // [B, T, C]
  const int32_t* lengths;  // [B]
  int T, C, W, K, n_best, P;
  int R;  // candidates a thread in the selection: [tid·R, tid·R + R)
  int L;  // scoring threads a beam, each for `per` of its K + 1 candidates
  int lm_from;  // the first LM thread (the last warps), or 0: the owners walk
  int tbits;  // log2 of the hash table's cells
  int bp_shared;  // the backpointers live in shared memory
  // the LM (has_lm == 0: the word-count bonus only)
  int has_lm, kenlm, bos_id, unk_id, pin_bos, hcnt_cap;
  float unk_floor, lm_ln10, wc_w, vwc_w;
  const int32_t* uni;  // [nuni, 3]: prob bits, backoff bits, present
  int nuni;
  const int32_t* arena_k;  // [arena_nb, 4, 2]
  const int32_t* arena_v;  // [arena_nb, 4, 2]: prob bits, backoff bits
  int arena_nb, arena_2c;
  const int32_t* words_k;  // [words_nb, 4, 2]
  const int32_t* words_v;  // [words_nb, 4, 2]: word id, valid
  int words_nb, words_2c;
  int16_t* bp;  // [B, T, W] scratch, unless bp_shared
  int32_t* out_ids;  // [B, n_best, T]
  int32_t* out_len;  // [B, n_best]
  float* out_scores;  // [B, n_best]
};

__host__ __device__ inline int next_pow2(int n) {
  int m = 1;
  while (m < n) m <<= 1;
  return m;
}

// A frame record of the ring: topv[K] (f32), lp[blank] (f32), kof[32]
// (int8: the k of each char in the top-K, else -1), topi[K] (u8).
__host__ __device__ inline int frame_bytes(int K) { return (5 * K + 36 + 15) & ~15; }

__host__ __device__ inline int table_cells(int W) { return next_pow2(2 * W); }

// The LM requests beside the layout, when LM threads walk: the word hashes,
// hcnt and the history of each slot's new word.
__host__ __device__ inline size_t request_bytes(int W, int H) {
  return (size_t(W) * (12 + 4 * H) + 15) & ~size_t(15);
}

// Shared memory: the frame ring, the published beam state, the merge map,
// the hash table, the selection's keys, bins, warp sums and kept list
// (offsets in bytes, each 16-byte aligned).
struct Layout {
  size_t ring, f, u, i, hist, has, mslot, tab, key, bins, wsum, misc, selk, seli, bytes;
  __host__ __device__ static size_t take(size_t* o, size_t n) {
    const size_t at = *o;
    *o = (*o + n + 15) & ~size_t(15);
    return at;
  }
  __host__ __device__ Layout(int W, int K, int H) {
    size_t o = 0;
    ring = take(&o, size_t(2 * kChunk) * frame_bytes(K));
    f = take(&o, size_t(6) * W * 4);  // pb, ptot, lm, bonus, stay pb, stay pnb
    u = take(&o, size_t(6) * W * 4);  // h1, h2, ph1, ph2, wh1, wh2
    i = take(&o, size_t(5) * W * 4);  // last, wlen, hcnt, alive, wid
    hist = take(&o, size_t(W) * (H > 0 ? H : 1) * 4);
    has = take(&o, size_t(W));
    mslot = take(&o, size_t(W) * K * 2);
    tab = take(&o, size_t(table_cells(W)) * 4);
    key = take(&o, size_t(K + 1) * W * 4);
    bins = take(&o, size_t(kPasses) * kBins * 4);
    wsum = take(&o, size_t(kMaxThreads / 32) * 4);
    misc = take(&o, 16);  // the last frame's best key and threshold
    selk = take(&o, size_t(W) * 4);
    seli = take(&o, size_t(W) * 2);
    bytes = o;
  }
};

__device__ __forceinline__ float logaddexp(float a, float b) {
  if (isinf(a) && a == b) return a;
  const float m = fmaxf(a, b), d = fabsf(a - b);
  // expf(-d) is 0 past d = 104, and log1pf(0) is 0: the same bits without
  // the two calls (most candidates pair a score with kNeg)
  if (d > 110.0f) return m + 0.0f;
  return m + log1pf(expf(-d));
}

__device__ __forceinline__ float as_f32(int32_t v) { return __int_as_float(v); }

// An order-preserving key: larger floats give larger keys, and -0 the key
// of +0 (they compare equal, as in the plain version's sort).
__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t x = __float_as_uint(f + 0.0f);
  return (x & 0x80000000u) ? ~x : (x | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// The key rows of a split bucket table for the key (k1, k2): the primary
// bucket's 4 slots of 2 key words, and (two-choice tables) the second
// bucket's, loaded together (one round trip); the values sit beside them
// in a parallel table and are loaded only for a key that is there.
struct KeyRows {
  int4 a0, a1, b0, b1;
  uint32_t bkt0, bkt1;
};

__device__ __forceinline__ KeyRows load_keys(const int32_t* keys, int nb, int two_choice,
                                             uint32_t k1, uint32_t k2) {
  KeyRows r;
  r.bkt0 = k1 % static_cast<uint32_t>(nb);
  r.bkt1 = k2 % static_cast<uint32_t>(nb);
  const int4* p0 = reinterpret_cast<const int4*>(keys + size_t(r.bkt0) * 8);
  r.a0 = __ldg(p0);
  r.a1 = __ldg(p0 + 1);
  r.b0 = r.a0;
  r.b1 = r.a1;
  if (two_choice) {
    const int4* p1 = reinterpret_cast<const int4*>(keys + size_t(r.bkt1) * 8);
    r.b0 = __ldg(p1);
    r.b1 = __ldg(p1 + 1);
  }
  return r;
}

__device__ __forceinline__ int slot_of(const int4& x, const int4& y, uint32_t k1, uint32_t k2) {
  const int32_t a = static_cast<int32_t>(k1), b = static_cast<int32_t>(k2);
  if (x.x == a && x.y == b) return 0;
  if (x.z == a && x.w == b) return 1;
  if (y.x == a && y.y == b) return 2;
  if (y.z == a && y.w == b) return 3;
  return -1;
}

// Where the key is: its value's index (bucket·4 + slot), the primary
// bucket first; -1 if it is absent. The index is an int: sound while
// nb·4 < 2^31, i.e. up to 2^28 buckets (the host build refuses more,
// ops/beam_device.py::_build_bucket_table); a 10^7-n-gram arena has 2^23.
// At 2^29 buckets the index would wrap negative.
__device__ __forceinline__ int find_key(const KeyRows& r, int two_choice, uint32_t k1,
                                        uint32_t k2) {
  int s = slot_of(r.a0, r.a1, k1, k2);
  if (s >= 0) return static_cast<int>(r.bkt0) * 4 + s;
  if (!two_choice) return -1;
  s = slot_of(r.b0, r.b1, k1, k2);
  return s >= 0 ? static_cast<int>(r.bkt1) * 4 + s : -1;
}

__device__ __forceinline__ int2 load_value(const int32_t* vals, int idx) {
  return __ldg(reinterpret_cast<const int2*>(vals + size_t(idx) * 2));
}

// The n-gram key of tok[0..n): the FNV-style dual hash or KenLM's chained
// u64 hash, as (k1, k2) / (lo, hi).
__device__ __forceinline__ void window_key(const Params& p, const int* tok, int n,
                                           uint32_t* k1, uint32_t* k2) {
  if (p.kenlm) {
    uint64_t h = static_cast<uint32_t>(tok[0]);
    for (int i = 1; i < n; ++i) {
      const uint32_t w = static_cast<uint32_t>(tok[i]) + 1u;
      h = (h * kC1) ^ (static_cast<uint64_t>(w) * kC2);
    }
    if (h == 0) h = 1;
    *k1 = static_cast<uint32_t>(h);
    *k2 = static_cast<uint32_t>(h >> 32);
    return;
  }
  uint32_t a = kKSeed1, b = kKSeed2;
  for (int i = 0; i < n; ++i) {
    const uint32_t u = static_cast<uint32_t>(tok[i] + 1);
    a = (a ^ u) * kKP1;
    b = (b ^ u) * kKP2;
  }
  if (a == 0 && b == 0) b = 1;
  *k1 = a;
  *k2 = b;
}

// A unigram row: prob bits, backoff bits, present (zeros out of range).
__device__ __forceinline__ int4 uni_row(const Params& p, int wid) {
  if (wid < 0 || wid >= p.nuni) return make_int4(0, 0, 0, 0);
  const int32_t* row = p.uni + size_t(wid) * 3;
  return make_int4(__ldg(row), __ldg(row + 1), __ldg(row + 2), 0);
}

// log10 P(wid | hist) with Katz backoff: the plain version's walk, which
// skips the levels that do not apply (they change nothing), stops at the
// first n-gram found (nothing changes after it) and adds up the backoffs of
// the contexts above it in walk order. The key rows of every applicable
// level (the n-gram, and the n-1 words before the word, as a context) and
// the two unigram rows are loaded together; then the values the walk reads
// (the n-gram found, the contexts' backoffs), together.
template <int kH>
__device__ __forceinline__ float ngram_score(const Params& p, const int (&hist)[kMaxH], int hcnt, int wid) {
  int tok[kH + 1];
#pragma unroll
  for (int i = 0; i < kH; ++i) tok[i] = hist[i];
  tok[kH] = wid;
  const int ctx = min(hcnt, kH);
  const int two = p.arena_2c;
  // level n = kH + 1 - l for l = 0 .. kH - 1 (n >= 2)
  KeyRows gram[kH > 0 ? kH : 1], cont[kH > 0 ? kH : 1];
  uint32_t gk1[kH > 0 ? kH : 1], gk2[kH > 0 ? kH : 1];
  uint32_t ck1[kH > 0 ? kH : 1], ck2[kH > 0 ? kH : 1];
#pragma unroll
  for (int l = 0; l < kH; ++l) {
    const int n = kH + 1 - l;
    if (n <= ctx + 1) {
      window_key(p, tok + l, n, &gk1[l], &gk2[l]);
      gram[l] = load_keys(p.arena_k, p.arena_nb, two, gk1[l], gk2[l]);
      if (n >= 3) {
        window_key(p, tok + l, n - 1, &ck1[l], &ck2[l]);
        cont[l] = load_keys(p.arena_k, p.arena_nb, two, ck1[l], ck2[l]);
      }
    }
  }
  const int4 uw = uni_row(p, wid);
  const int4 uh = kH > 0 && ctx >= 1 ? uni_row(p, tok[kH > 0 ? kH - 1 : 0]) : make_int4(0, 0, 0, 0);

  // the walk: the level found, and the contexts whose backoff it adds
  int found_l = kH;  // kH: the unigram level (or nothing)
  int gram_idx = -1;
  int back_idx[kH > 0 ? kH : 1];
#pragma unroll
  for (int l = 0; l < kH; ++l) back_idx[l] = -1;
  bool stop = false;
#pragma unroll
  for (int l = 0; l < kH; ++l) {
    const int n = kH + 1 - l;
    if (!stop && n <= ctx + 1) {
      gram_idx = find_key(gram[l], two, gk1[l], gk2[l]);
      if (gram_idx >= 0) {
        found_l = l;
        stop = true;
      } else if (n >= 3) {
        back_idx[l] = find_key(cont[l], two, ck1[l], ck2[l]);
      }
    }
  }
  // the values, together
  const int2 gv = gram_idx >= 0 ? load_value(p.arena_v, gram_idx) : make_int2(0, 0);
  int2 bv[kH > 0 ? kH : 1];
#pragma unroll
  for (int l = 0; l < kH; ++l)
    bv[l] = (l < found_l && back_idx[l] >= 0) ? load_value(p.arena_v, back_idx[l])
                                              : make_int2(0, 0);
  float bsum = 0.0f;
#pragma unroll
  for (int l = 0; l < kH; ++l) {
    const int n = kH + 1 - l;
    if (l < found_l && n <= ctx + 1) {
      if (n >= 3) {
        if (back_idx[l] >= 0) bsum = bsum + as_f32(bv[l].y);
      } else if (uh.z > 0) {  // n == 2: the unigram before the word
        bsum = bsum + as_f32(uh.y);
      }
    }
  }
  if (found_l < kH) return as_f32(gv.x) + bsum;
  if (uw.z > 0) return as_f32(uw.x) + bsum;
  return p.unk_floor + bsum;
}

// The fusion bonus of completing the partial word (wh1, wh2) (wlen > 0)
// after the history, and the word's id: the word table's key rows, its
// value, then the n-gram walk.
template <int kH>
__device__ __forceinline__ float word_bonus(const Params& p, uint32_t wh1, uint32_t wh2,
                                            const int (&hist)[kMaxH], int hcnt, int* wid) {
  const int idx = find_key(load_keys(p.words_k, p.words_nb, p.words_2c, wh1, wh2),
                           p.words_2c, wh1, wh2);
  const int2 v = idx >= 0 ? load_value(p.words_v, idx) : make_int2(p.unk_id, 0);
  *wid = v.x;
  const float valid = idx >= 0 ? static_cast<float>(v.y) : 0.0f;
  const float sc = ngram_score<kH>(p, hist, hcnt, *wid);
  return __fadd_rn(__fadd_rn(p.wc_w, __fmul_rn(p.vwc_w, valid)),
                   __fmul_rn(p.lm_ln10, sc));
}

// Rank the frames [t0, t1) of the row into the ring, a frame a warp of
// warps [0, nw) (only those call it), lane c holding lp[c]: lax.top_k's
// order (value descending, the lower char first on a tie), or every char
// in its own order when K == C.
__device__ void stage_frames(const Params& p, const float* logp, unsigned char* ring,
                             int t0, int t1, int nw) {
  const int lane = threadIdx.x & 31, C = p.C, K = p.K, rec = frame_bytes(K);
  for (int t = t0 + static_cast<int>(threadIdx.x >> 5); t < t1; t += nw) {
    const float v = lane < C ? __ldg(logp + size_t(t) * C + lane) : 0.0f;
    int rank = lane;
    if (K < C) {
      rank = 0;
      for (int j = 0; j < C; ++j) {
        const float u = __shfl_sync(kFull, v, j);
        rank += (u > v) || (u == v && j < lane);
      }
    }
    unsigned char* fr = ring + size_t(t % (2 * kChunk)) * rec;
    const bool kept = lane < C && rank < K;
    if (kept) {
      reinterpret_cast<float*>(fr)[rank] = v;
      fr[4 * K + 36 + rank] = static_cast<unsigned char>(lane);
    }
    reinterpret_cast<signed char*>(fr + 4 * K + 4)[lane] =
        static_cast<signed char>(kept ? rank : -1);
    if (lane == kBlank) reinterpret_cast<float*>(fr)[K] = v;
  }
}

// The hash table's first cell for a prefix hash (h1, h2).
__device__ __forceinline__ int table_cell(uint32_t h1, uint32_t h2, int tbits) {
  return static_cast<int>(((h1 ^ (h2 * 0x9E3779B9u)) * 0x85EBCA6Bu) >> (32 - tbits));
}

// Histogram `digit` where `valid`: one shared atomic a key (aggregating a
// warp's equal digits with __match_any_sync cost more than it saved).
__device__ __forceinline__ void count_digit(int* bins, bool valid, uint32_t digit) {
  if (valid) atomicAdd(bins + digit, 1);
}

// The bin that holds the `need`-th largest key of a 256-bin histogram: its
// digit, the keys in the bins above it and its own count. Every lane of the
// warp calls it and gets the same answer (lane l reads bins 8l..8l+7).
__device__ __forceinline__ void find_bin(const int* bins, int need, int* digit, int* above,
                                         int* count) {
  const int lane = threadIdx.x & 31;
  const int4 a = reinterpret_cast<const int4*>(bins)[2 * lane];
  const int4 b = reinterpret_cast<const int4*>(bins)[2 * lane + 1];
  const int own = a.x + a.y + a.z + a.w + b.x + b.y + b.z + b.w;
  int s = own;  // the keys in lanes >= lane
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_down_sync(kFull, s, off);
    if (lane + off < 32) s += o;
  }
  const int L = 31 - __clz(__ballot_sync(kFull, s >= need));
  // in lane L: the keys in its bins j..7 and above it, S[j]; the bin is the
  // highest j with S[j] >= need (S grows as j falls)
  const int run = s - own;
  const int v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  int S[9];
  S[8] = run;
#pragma unroll
  for (int j = 7; j >= 0; --j) S[j] = S[j + 1] + v[j];
  int j_at = -1;
#pragma unroll
  for (int j = 0; j < 8; ++j) j_at += S[j] >= need;
  int over = 0, here = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j == j_at) {
      over = S[j + 1];
      here = v[j];
    }
  }
  *digit = 8 * L + __shfl_sync(kFull, j_at, L);
  *above = __shfl_sync(kFull, over, L);
  *count = __shfl_sync(kFull, here, L);
}

template <int kThreads, int kH>
__global__ void __launch_bounds__(kThreads) beam_device_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int H = kH;
  const int W = p.W, K = p.K, P = p.P, R = p.R;
  const Layout lay(W, K, H);
  unsigned char* s_ring = smem + lay.ring;
  float* s_pb = reinterpret_cast<float*>(smem + lay.f);
  float* s_ptot = s_pb + W;
  float* s_lm = s_ptot + W;
  float* s_bonus = s_lm + W;
  float* s_spb = s_bonus + W;  // stay pb and pnb before the merge
  float* s_spnb = s_spb + W;
  uint32_t* s_h1 = reinterpret_cast<uint32_t*>(smem + lay.u);
  uint32_t* s_h2 = s_h1 + W;
  uint32_t* s_ph1 = s_h2 + W;
  uint32_t* s_ph2 = s_ph1 + W;
  uint32_t* s_wh1 = s_ph2 + W;
  uint32_t* s_wh2 = s_wh1 + W;
  int* s_last = reinterpret_cast<int*>(smem + lay.i);
  int* s_wlen = s_last + W;
  int* s_hcnt = s_wlen + W;
  int* s_alive = s_hcnt + W;
  int* s_wid = s_alive + W;
  int* s_hist = reinterpret_cast<int*>(smem + lay.hist);
  unsigned char* s_has = smem + lay.has;
  int16_t* s_mslot = reinterpret_cast<int16_t*>(smem + lay.mslot);
  int* s_tab = reinterpret_cast<int*>(smem + lay.tab);
  uint32_t* s_key = reinterpret_cast<uint32_t*>(smem + lay.key);
  int* s_bins = reinterpret_cast<int*>(smem + lay.bins);
  uint32_t* s_wsum = reinterpret_cast<uint32_t*>(smem + lay.wsum);
  uint32_t* s_misc = reinterpret_cast<uint32_t*>(smem + lay.misc);
  uint32_t* s_selk = reinterpret_cast<uint32_t*>(smem + lay.selk);
  uint16_t* s_seli = reinterpret_cast<uint16_t*>(smem + lay.seli);

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int len = min(max(p.lengths[b], 0), p.T);
  const float* logp = p.logp + size_t(b) * p.T * p.C;
  int16_t* bp = p.bp_shared
                    ? reinterpret_cast<int16_t*>(smem + lay.bytes +
                                                 (p.lm_from > 0 ? request_bytes(W, H) : 0))
                    : p.bp + size_t(b) * p.T * W;
  const int cells = 1 << p.tbits, rec = frame_bytes(K);
  const int W4 = (W + 3) & ~3;  // the kept list, padded with 0 keys
  // the scoring: thread tid < W·L takes candidates [c0, c1) of beam sq's
  // K + 1 (0: its stay, c: its extension by the (c-1)-th char), slice-major
  // so that the stays (whose log-add-exp is never the short path) share
  // the first warps
  const int per = (K + 1 + p.L - 1) / p.L;
  const int slice = tid / W, sq = tid - slice * W, c0 = slice * per;
  const int c1 = slice < p.L ? min(c0 + per, K + 1) : c0;
  // the selecting threads: tid·R < P
  const bool selector = warp * 32 * R < P;
  // the LM threads: thread lm0 + q walks the LM for slot q's new word,
  // requested by its owner in shared memory, while the other threads
  // publish and merge; without them (lm0 == nthreads) each owner walks for
  // its own slot after its merge probe
  const int lm0 = p.lm_from > 0 ? p.lm_from : nthreads;
  const bool lm_thread = tid >= lm0;
  uint32_t* r_wh = reinterpret_cast<uint32_t*>(smem + lay.bytes);  // [W, 2]
  int* r_hcnt = reinterpret_cast<int*>(r_wh + 2 * W);  // -1: no request
  int* r_hist = r_hcnt + W;  // [W, H]

  // thread tid < W owns a slot, `me`, and keeps its state in registers
  int me = tid < W ? tid : -1;
  float pb = me == 0 ? 0.0f : kNeg, pnb = kNeg, lm = 0.0f, bonus = 0.0f;
  uint32_t h1 = kSeed1, h2 = kSeed2, ph1 = 0, ph2 = 0, wh1 = kWSeed1, wh2 = kWSeed2;
  int last = -1, wlen = 0, hcnt = 0, alive = me == 0, wid = 0;
  int hist[kMaxH];
#pragma unroll
  for (int j = 0; j < kMaxH; ++j) hist[j] = 0;
  if (p.bos_id >= 0 && H > 0) {
#pragma unroll
    for (int j = 0; j < kMaxH; ++j)
      if (j == H - 1) hist[j] = p.bos_id;
    hcnt = 1;
  }
  // a letter extension's bonus is pending until the LM walk (the owner's
  // own, or requested of an LM thread)
  bool pending = false, requested = false;

  for (int j = tid; j < cells; j += nthreads) s_tab[j] = -1;
  for (int j = tid; j < kPasses * kBins; j += nthreads) s_bins[j] = 0;
  if (tid < W4 - W) s_selk[W + tid] = 0;
  if (p.lm_from > 0 && tid < W) r_hcnt[tid] = -1;
  stage_frames(p, logp, s_ring, 0, min(kChunk, len), nwarps);
  __syncthreads();

  SPLIT_START
  for (int t = 0; t < len; ++t) {
    const unsigned char* fr = s_ring + size_t(t % (2 * kChunk)) * rec;
    const float* topv = reinterpret_cast<const float*>(fr);
    const signed char* kof = reinterpret_cast<const signed char*>(fr + 4 * K + 4);
    const unsigned char* topi = fr + 4 * K + 36;

    // candidate i of the pool: (pb, pnb, lm) and whether its beam is
    // alive, as the plain version builds cand_pb / cand_pnb / cand_lm /
    // cand_alive
    auto candidate = [&](int i, float* cpb, float* cpnb, float* clm) -> bool {
      if (i < W) {
        const bool merged = s_has[i];
        *cpb = merged ? kNeg : s_spb[i];
        *cpnb = merged ? kNeg : s_spnb[i];
        *clm = s_lm[i];
        return s_alive[i];
      }
      const int e = i - W, q = e / K, k = e - q * K;
      const int c = topi[k];
      float epnb = (c == s_last[q] ? s_pb[q] : s_ptot[q]) + topv[k];
      if (c == kBlank) epnb = kNeg;
      float epb = kNeg;
      const int m = s_mslot[q * K + k];
      if (m >= 0) {
        epnb = logaddexp(epnb, s_spnb[m]);
        epb = s_spb[m];
      }
      *cpb = epb;
      *cpnb = epnb;
      *clm = s_lm[q] + ((c == kSpace && s_wlen[q] > 0) ? s_bonus[q] : 0.0f);
      return s_alive[q];
    };

    // the LM threads walk for the requested slots meanwhile
    if (lm_thread) {
      const int q = tid - lm0;
      if (q < W && r_hcnt[q] >= 0) {
        int rhist[kMaxH];
#pragma unroll
        for (int j = 0; j < kMaxH; ++j) rhist[j] = j < H ? r_hist[q * H + j] : 0;
        int rwid;
        s_bonus[q] = word_bonus<kH>(p, r_wh[2 * q], r_wh[2 * q + 1], rhist, r_hcnt[q], &rwid);
        s_wid[q] = rwid;
      }
    }
    // publish: the owner's state, its stay candidate, a cleared merge row,
    // and (alive) its prefix in the hash table
    int k_idx = -1;
    if (me >= 0) {
      const float ptot = logaddexp(pb, pnb);
      s_pb[me] = pb;
      s_ptot[me] = ptot;
      s_lm[me] = lm;
      s_h1[me] = h1;
      s_h2[me] = h2;
      s_ph1[me] = ph1;
      s_ph2[me] = ph2;
      s_wh1[me] = wh1;
      s_wh2[me] = wh2;
      s_last[me] = last;
      s_wlen[me] = wlen;
      s_hcnt[me] = hcnt;
      s_alive[me] = alive;
#pragma unroll
      for (int j = 0; j < kMaxH; ++j)
        if (j < H) s_hist[me * H + j] = hist[j];
      for (int k = 0; k < K; ++k) s_mslot[me * K + k] = -1;
      k_idx = last >= 0 ? kof[last] : -1;
      s_spb[me] = ptot + topv[K];
      s_spnb[me] = k_idx >= 0 ? pnb + topv[k_idx] : kNeg;
      if (alive) {
        int cell = table_cell(h1, h2, p.tbits);
        while (atomicCAS(s_tab + cell, -1, me) != -1) cell = (cell + 1) & (cells - 1);
      }
    }
    if (!lm_thread) SYNC_PART(lm0);
    SPLIT_MARK(kPhPublish);

    // the merge of stay(me) into extend(q, last): the lowest alive slot q
    // whose prefix is this beam's parent prefix
    if (me >= 0) {
      bool has = false;
      if (alive && k_idx >= 0) {
        int q = INT_MAX;
        for (int cell = table_cell(ph1, ph2, p.tbits), s; (s = s_tab[cell]) >= 0;
             cell = (cell + 1) & (cells - 1)) {
          if (s < q && s_h1[s] == ph1 && s_h2[s] == ph2) q = s;
        }
        if (q != INT_MAX) {
          s_mslot[q * K + k_idx] = static_cast<int16_t>(me);
          has = true;
        }
      }
      s_has[me] = has;
    }
    SPLIT_MARK(kPhMerge);
    // the bonus of a letter extension's new word, unless an LM thread has it
    if (me >= 0 && !requested) {
      if (pending) bonus = word_bonus<kH>(p, wh1, wh2, hist, hcnt, &wid);
      pending = false;
      s_bonus[me] = bonus;
      s_wid[me] = wid;
      SPLIT_MARK(kPhLm);
    }
    // the next chunk of frames, a chunk ahead of its first use (its ring
    // half was last read before this frame's first barrier)
    if (t % kChunk == 0 && t + kChunk < len && !lm_thread)
      stage_frames(p, logp, s_ring, t + kChunk, min(t + 2 * kChunk, len), lm0 >> 5);
    SPLIT_MARK(kPhFrames);
    SYNC();
    SPLIT_MARK(kPhMerge);

    // the first pass's window: bins of 2^wshift keys, with the last frame's
    // threshold at bin kWindowAt, wide enough that its W kept keys spanned
    // 64-128 bins; keys outside fall into bins 0 and 255 (a restart if the
    // W-th key does). The first frame takes the top 8 bits.
    int wshift = 24;
    long long wbase = 0;
    bool window = false;
    if (t > 0) {
      const uint32_t best = s_misc[0], span = best - s_misc[1];
      if (best > s_misc[1]) {
        wshift = max(0, 32 - __clz(span) - 7);
        wbase = static_cast<long long>(s_misc[1] >> wshift) - kWindowAt;
        window = true;
      }
    }
    // the pool's keys and the histogram of their first digit: each thread
    // loads its beam's published values once for its candidates
    {
      const int q = min(sq, W - 1);
      const float qpb = s_pb[q], qptot = s_ptot[q], qlm = s_lm[q], qbonus = s_bonus[q];
      const float qspb = s_spb[q], qspnb = s_spnb[q];
      const int qlast = s_last[q], qwlen = s_wlen[q], qalive = s_alive[q], qhas = s_has[q];
#pragma unroll 2
      for (int j = 0; j < per; ++j) {
        const int c = c0 + j;
        const bool v = c < c1;
        uint32_t key = 0;
        if (v) {
          float cpb, cpnb, clm;
          int i;
          if (c == 0) {  // the stay candidate
            i = q;
            cpb = qhas ? kNeg : qspb;
            cpnb = qhas ? kNeg : qspnb;
            clm = qlm;
          } else {
            const int k = c - 1, ch = topi[k];
            i = W + q * K + k;
            cpnb = (ch == qlast ? qpb : qptot) + topv[k];
            if (ch == kBlank) cpnb = kNeg;
            cpb = kNeg;
            const int m = s_mslot[q * K + k];
            if (m >= 0) {
              cpnb = logaddexp(cpnb, s_spnb[m]);
              cpb = s_spb[m];
            }
            clm = qlm + ((ch == kSpace && qwlen > 0) ? qbonus : 0.0f);
          }
          key = order_key(qalive ? logaddexp(cpb, cpnb) + clm : kNeg);
          s_key[i] = key;
        }
        const long long d = static_cast<long long>(key >> wshift) - wbase;
        count_digit(s_bins, v, static_cast<uint32_t>(d < 0 ? 0 : (d > kBins - 1 ? kBins - 1 : d)));
      }
    }
    SYNC();
    SPLIT_MARK(kPhScore);

    // the radix select, by the warps that hold keys: after each pass the
    // bits of the W-th key from `shift` up are in `prefix`, and `need` keys
    // are still to take among the keys with those bits; a bin that holds
    // exactly `need` (or all 32 bits known) ends it. A first pass whose
    // W-th key falls in an edge bin of the window starts again from the
    // top 8 bits of every key. Then the kept keys, those above the
    // threshold bits and the first `need` equal ones in index order, are
    // counted by a block prefix count (16 bits each) before the last barrier
    uint32_t prefix = 0, top = 0, incl = 0, mine = 0;
    int need = W, shift = wshift;
    for (int pass = 0;; ++pass) {
      bool done = false;
      if (selector) {
        int digit, above, count;
        find_bin(s_bins + pass * kBins, need, &digit, &above, &count);
        const bool restart = window && (digit == 0 || digit == kBins - 1);
        int dshift = 24;
        uint32_t dmask = kBins - 1;
        if (restart) {
          need = W;
          prefix = 0;
          shift = 24;
        } else {
          need -= above;
          prefix = window ? static_cast<uint32_t>(wbase + digit) << shift
                          : prefix | (static_cast<uint32_t>(digit) << shift);
          done = count == need || shift == 0;
          dshift = max(shift - 8, 0);
          dmask = (1u << (shift - dshift)) - 1u;
        }
        if (!done) {
          for (int r = 0; r < R; ++r) {
            const int i = tid * R + r;
            const uint32_t key = i < P ? s_key[i] : 0;
            count_digit(s_bins + (pass + 1) * kBins,
                        i < P && (restart || (key >> shift) == (prefix >> shift)),
                        (key >> dshift) & dmask);
          }
          shift = dshift;
        } else {
          top = prefix >> shift;
          for (int r = 0; r < R; ++r) {
            const int i = tid * R + r;
            if (i < P) {
              const uint32_t hi = s_key[i] >> shift;
              mine += hi > top ? (1u << 16) : (hi == top ? 1u : 0u);
            }
          }
          incl = mine;
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const uint32_t o = __shfl_up_sync(kFull, incl, off);
            if (lane >= off) incl += o;
          }
          if (lane == 31) s_wsum[warp] = incl;
          // the next frame's window is placed at this threshold
          if (tid == 0) s_misc[1] = prefix | ((1u << shift) >> 1);
        }
        window = false;
      }
      SPLIT_PASS();
      if (SYNC_OR(done)) break;
    }
    // every warp has read the histograms: clear them for the next frame
    for (int j = tid; j < kPasses * kBins; j += nthreads) s_bins[j] = 0;
    uint32_t before = incl - mine;
    if (selector) {
      uint32_t w = lane < warp ? s_wsum[lane] : 0u;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) w += __shfl_xor_sync(kFull, w, off);
      before += w;
    }
    int gt_before = static_cast<int>(before >> 16), eq_before = static_cast<int>(before & 0xFFFFu);
    for (int r = 0; r < R && selector; ++r) {
      const int i = tid * R + r;
      if (i >= P) break;
      const uint32_t key = s_key[i], hi = key >> shift;
      int at = -1;
      if (hi > top) {
        at = gt_before + min(eq_before, need);
        ++gt_before;
      } else if (hi == top) {
        if (eq_before < need) at = gt_before + eq_before;
        ++eq_before;
      }
      if (at >= 0) {
        s_selk[at] = key;
        s_seli[at] = static_cast<uint16_t>(i);
      }
    }
    SYNC();
    SPLIT_MARK(kPhSelect);

    // the kept candidates in order: thread c takes kept candidate c to slot
    // rank = the kept keys above it and the equal ones before it in the
    // list (4 keys a load; the padding's 0 keys are below every key)
    if (tid < W) {
      const uint32_t mk = s_selk[tid];
      int r0 = 0, r1 = 0, r2 = 0, r3 = 0;
#pragma unroll 4
      for (int j = 0; j < W4; j += 4) {
        const uint4 o = *reinterpret_cast<const uint4*>(s_selk + j);
        r0 += (o.x > mk) + (o.x == mk && j < tid);
        r1 += (o.y > mk) + (o.y == mk && j + 1 < tid);
        r2 += (o.z > mk) + (o.z == mk && j + 2 < tid);
        r3 += (o.w > mk) + (o.w == mk && j + 3 < tid);
      }
      const int rank = (r0 + r1) + (r2 + r3);
      if (rank == 0) s_misc[0] = mk;  // the best key, for the next window
      // slot `rank` takes the candidate: its scores, its parent's state
      // updated by the candidate's char
      me = rank;
      const int i = s_seli[tid];
      candidate(i, &pb, &pnb, &lm);
      const bool is_stay = i < W;
      const int par = is_stay ? i : (i - W) / K;
      const int ch = is_stay ? -1 : topi[(i - W) - par * K];
      const uint32_t u = static_cast<uint32_t>(max(ch, 0) + 2);
      const uint32_t h1p = s_h1[par], h2p = s_h2[par];
      const uint32_t wh1p = s_wh1[par], wh2p = s_wh2[par];
      const int wlenp = s_wlen[par], hcntp = s_hcnt[par];
      const bool is_space = !is_stay && ch == kSpace;
      const bool completes = is_space && wlenp > 0;
      ph1 = is_stay ? s_ph1[par] : h1p;
      ph2 = is_stay ? s_ph2[par] : h2p;
      h1 = is_stay ? h1p : h1p * kM1 + u;
      h2 = is_stay ? h2p : h2p * kM2 + u;
      wh1 = is_stay ? wh1p : (is_space ? kWSeed1 : wh1p * kM1 + u);
      wh2 = is_stay ? wh2p : (is_space ? kWSeed2 : wh2p * kM2 + u);
      last = is_stay ? s_last[par] : ch;
      wlen = is_stay ? wlenp : (is_space ? 0 : wlenp + 1);
      hcnt = completes ? min(hcntp + 1, p.hcnt_cap) : hcntp;
      alive = key_value(mk) > kNeg / 2;
      const int* hp = s_hist + par * H;
      const int widp = completes ? s_wid[par] : 0;
      const bool pinned = p.pin_bos && hcntp == p.hcnt_cap;
#pragma unroll
      for (int j = 0; j < kMaxH; ++j) {
        if (j < H) {
          hist[j] = !completes                 ? hp[j]
                    : j == H - 1               ? widp
                    : (pinned && j == 0)       ? hp[0]
                                               : hp[j + 1];
        }
      }
      bp[size_t(t) * W + me] = static_cast<int16_t>((par << 5) | (ch + 1));
      // the bonus of the new word state: a stay's is its parent's, a
      // space's 0 (wlen 0); a letter's needs the LM walk (or is the
      // word-count weight alone); a dead slot's is never read
      if (is_stay) {
        bonus = s_bonus[par];
        wid = s_wid[par];
      } else {
        wid = 0;
        bonus = (is_space || !alive) ? 0.0f : p.wc_w;
      }
      pending = !is_stay && !is_space && alive && p.has_lm;
      requested = pending && p.lm_from > 0;
      if (p.lm_from > 0) {
        r_hcnt[me] = requested ? hcnt : -1;
        if (requested) {
          r_wh[2 * me] = wh1;
          r_wh[2 * me + 1] = wh2;
#pragma unroll
          for (int j = 0; j < kMaxH; ++j)
            if (j < H) r_hist[me * H + j] = hist[j];
        }
      }
    }
    for (int j = tid; j < cells; j += nthreads) s_tab[j] = -1;
    SYNC();
    SPLIT_MARK(kPhReindex);
  }

  // the final ranking: the trailing partial word scores as a word too (the
  // carried bonus, or the pending one of the last frame's letters)
  if (me >= 0) {
    if (pending) bonus = word_bonus<kH>(p, wh1, wh2, hist, hcnt, &wid);
    s_pb[me] = alive ? logaddexp(pb, pnb) + lm + bonus : kNeg;
  }
  __syncthreads();
  if (tid < W) {
    const uint32_t mk = order_key(s_pb[tid]);
    int rank = 0;
    for (int j = 0; j < W; ++j) {
      const uint32_t o = order_key(s_pb[j]);
      rank += (o > mk) || (o == mk && j < tid);
    }
    if (rank < p.n_best) s_seli[rank] = static_cast<uint16_t>(tid);
  }
  __syncthreads();

  // one thread per winner: walk the backpointers back from the last frame
  if (tid < p.n_best) {
    const size_t o = size_t(b) * p.n_best + tid;
    int32_t* row = p.out_ids + o * p.T;
    int cur = s_seli[tid];
    p.out_scores[o] = s_pb[cur];
    for (int t = len - 1; t >= 0; --t) {
      const int v = bp[size_t(t) * W + cur];
      row[t] = (v & 31) - 1;
      cur = v >> 5;
    }
  }
  __syncthreads();
  // a warp per winner: move the kept chars to the front of the row, 32 at a
  // time (a chunk is read before any lane writes, and writes land at or
  // before the read positions), then pad
  for (int r = warp; r < p.n_best; r += nwarps) {
    const size_t o = size_t(b) * p.n_best + r;
    int32_t* row = p.out_ids + o * p.T;
    int n = 0;
    for (int base = 0; base < len; base += 32) {
      const int c = base + lane < len ? row[base + lane] : -1;
      const unsigned keep = __ballot_sync(kFull, c >= 0);
      if (c >= 0) row[n + __popc(keep & ((1u << lane) - 1))] = c;
      n += __popc(keep);
      __syncwarp();
    }
    for (int t = n + lane; t < p.T; t += 32) row[t] = kPad;
    if (lane == 0) p.out_len[o] = n;
  }
  SPLIT_MARK(kPhTail);
  SPLIT_END(b, len);
}

using KernelFn = void (*)(Params);

template <int kH>
KernelFn kernel_for(int threads) {
  return threads > 512 ? beam_device_kernel<kMaxThreads, kH> : beam_device_kernel<512, kH>;
}

int block_threads(int W, int P2) {
  const int warps = (W + 31) / 32;
  return std::min(kMaxThreads, std::max(32 * warps, P2 / 2));
}

}  // namespace

extern "C" {

// The widest beam the kernel takes.
int beam_device_max_width() { return kMaxW; }

// The card's shared memory limit a block, which beam_device_smem_bytes must
// not pass.
int beam_device_max_smem() { return kMaxSmem; }

// Dynamic shared memory the kernel needs at width W, top-K K and history H
// (a launch adds the backpointers where they fit).
size_t beam_device_smem_bytes(int W, int K, int H) { return Layout(W, K, H).bytes; }

// Threads a block at width W and top-K K.
int beam_device_threads(int W, int K) {
  return block_threads(W, next_pow2((K + 1) * W));
}

// Launches the kernel on `stream` and returns cudaGetLastError(): a launch
// that is refused (threads, shared memory) never runs, and only this shows
// it. Tables of an absent LM (has_lm == 0) may be null, and so may `bp`
// where the [T, W] int16 backpointers fit in shared memory beside the
// layout (beam_device_smem_bytes + 2·T·W <= beam_device_max_smem).
int beam_device_search(
    const void* logp, const void* lengths, int B, int T, int C, int W, int K,
    int n_best, int has_lm, int H, int kenlm, int bos_id, int unk_id,
    int pin_bos, int hcnt_cap, float unk_floor, float lm_ln10, float wc_w,
    float vwc_w, const void* uni, int nuni, const void* arena_k,
    const void* arena_v, int arena_nb, int arena_2c, const void* words_k,
    const void* words_v, int words_nb, int words_2c, void* bp, void* out_ids,
    void* out_len, void* out_scores, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0) return 0;
  if (W < 1 || W > kMaxW || C < 1 || C > kMaxC || kBlank >= C || K < 1 ||
      K > C || n_best < 1 || n_best > W || H < 0 || H > kMaxH || T < 1 ||
      (K + 1) * W > 0xFFFF || (has_lm && (nuni < 1 || arena_nb < 1 || words_nb < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.logp = static_cast<const float*>(logp);
  p.lengths = static_cast<const int32_t*>(lengths);
  p.T = T;
  p.C = C;
  p.W = W;
  p.K = K;
  p.n_best = n_best;
  p.P = (K + 1) * W;
  const int threads = block_threads(W, next_pow2(p.P));
  // at least 4 keys a selecting thread: fewer warps scan the histograms
  p.R = std::max(4, (p.P + threads - 1) / threads);
  p.L = std::max(1, std::min(K + 1, threads / W));
  const int owner_threads = 32 * ((W + 31) / 32);
  p.lm_from = has_lm && threads >= 2 * owner_threads ? threads - owner_threads : 0;
  p.tbits = 0;
  while ((1 << p.tbits) < table_cells(W)) ++p.tbits;
  p.has_lm = has_lm;
  p.kenlm = kenlm;
  p.bos_id = bos_id;
  p.unk_id = unk_id;
  p.pin_bos = pin_bos;
  p.hcnt_cap = hcnt_cap;
  p.unk_floor = unk_floor;
  p.lm_ln10 = lm_ln10;
  p.wc_w = wc_w;
  p.vwc_w = vwc_w;
  p.uni = static_cast<const int32_t*>(uni);
  p.nuni = nuni;
  p.arena_k = static_cast<const int32_t*>(arena_k);
  p.arena_v = static_cast<const int32_t*>(arena_v);
  p.arena_nb = arena_nb;
  p.arena_2c = arena_2c;
  p.words_k = static_cast<const int32_t*>(words_k);
  p.words_v = static_cast<const int32_t*>(words_v);
  p.words_nb = words_nb;
  p.words_2c = words_2c;
  p.bp = static_cast<int16_t*>(bp);
  p.out_ids = static_cast<int32_t*>(out_ids);
  p.out_len = static_cast<int32_t*>(out_len);
  p.out_scores = static_cast<float*>(out_scores);
  size_t smem = Layout(W, K, H).bytes;
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  // the backpointers first (the caller passes no scratch when they fit),
  // then the LM requests where they fit beside them
  p.bp_shared = smem + size_t(T) * W * 2 <= static_cast<size_t>(kMaxSmem);
  if (!p.bp_shared && bp == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bp_bytes = p.bp_shared ? size_t(T) * W * 2 : 0;
  if (p.lm_from > 0) {
    if (smem + request_bytes(W, H) + bp_bytes <= static_cast<size_t>(kMaxSmem))
      smem += request_bytes(W, H);
    else
      p.lm_from = 0;
  }
  smem += bp_bytes;
  const KernelFn kernels[kMaxH + 1] = {kernel_for<0>(threads), kernel_for<1>(threads),
                                       kernel_for<2>(threads), kernel_for<3>(threads),
                                       kernel_for<4>(threads), kernel_for<5>(threads)};
  const KernelFn kernel = kernels[H];
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* beam_device_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef BEAM_DEVICE_SPLIT
// Copies the clock64() split of the last launch's first `rows` rows to
// `out` ([rows, kSplitCols]: each phase's cycles summed over the row's
// frames, thread 0's cycles waiting at barriers, the radix passes, the
// row's cycles in all, its frames). Returns a CUDA code.
int beam_device_split_read(void* out, int rows) {
  if (rows < 0 || rows > kSplitRows) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_split, size_t(rows) * kSplitCols * sizeof(unsigned long long)));
}
#endif

}  // extern "C"
