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
// What bounds it on this card: the serial chain of frames. Per row and
// frame the work is small (at W=100, K=8: 10^4 merge compares, the 55
// compare-exchange stages of a 1024-key bitonic sort, ~900 candidate
// scores and up to W LM walks), but every frame depends on the last, and
// a frame is a few block barriers plus two or three dependent L2/HBM round
// trips for the LM probes (the word table, then the arena rows of the
// backoff walk). The bytes the batch must move (the emissions once, the
// backpointers once, the LM rows probed) take microseconds at 3.35 TB/s,
// so the chain's latency sets the time.
//
// Design: one CTA per row, the whole frame loop inside the kernel, so a
// batch is one launch; a row stops at its own length (the frames past it
// change nothing, and the backtrack starts at the row's last frame).
// Thread j < W owns beam slot j and keeps its state in registers; each
// frame it publishes the state to shared memory, where the merge scan, the
// candidate scoring and the re-index after the selection read it (one
// buffer: every thread reads its parent's state before any writes the
// next). The candidate scores are never stored as [W, K] arrays: a
// candidate's (pb, pnb, lm) is recomputed from its beam's published values
// and a [W, K] merge map, the same operations in the same order, so the
// scoring pass and the re-index agree bit for bit. The LM probes of a
// frame are issued before the first barrier, beside the top-K selection
// (one warp, by rank). The selection sorts (score, index) keys with a
// block-wide bitonic sort in shared memory. Backpointers go to a [B, T, W]
// int16 scratch (parent << 5 | char + 1); after the last frame one thread
// per winner walks them back.
//
// Arithmetic: float32 as the plain version; log-add-exp as torch's CUDA
// logaddexp (m + log1pf(expf(-|a - b|)), an infinite pair returned as is),
// products that feed a sum by __fmul_rn/__fadd_rn so that nothing is
// contracted into an FMA the plain version does not make; u32 hashes wrap
// natively and the KenLM key hash is a native u64 multiply.

#include <cuda_runtime.h>

#include <algorithm>
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

struct Params {
  const float* logp;  // [B, T, C]
  const int32_t* lengths;  // [B]
  int T, C, W, K, n_best, P, P2, F2;
  // the LM (has_lm == 0: the word-count bonus only)
  int has_lm, H, kenlm, bos_id, unk_id, pin_bos, hcnt_cap;
  float unk_floor, lm_ln10, wc_w, vwc_w;
  const int32_t* uni;  // [nuni, 3]: prob bits, backoff bits, present
  int nuni;
  const int32_t* arena_k;  // [arena_nb, 4, 2]
  const int32_t* arena_v;  // [arena_nb, 4, 2]: prob bits, backoff bits
  int arena_nb, arena_2c;
  const int32_t* words_k;  // [words_nb, 4, 2]
  const int32_t* words_v;  // [words_nb, 4, 2]: word id, valid
  int words_nb, words_2c;
  int16_t* bp;  // [B, T, W] scratch
  int32_t* out_ids;  // [B, n_best, T]
  int32_t* out_len;  // [B, n_best]
  float* out_scores;  // [B, n_best]
};

// Shared memory: the frame, its top-K, the published beam state, the merge
// map and the sort keys (offsets in bytes, each 16-byte aligned).
struct Layout {
  size_t lp, topv, topi, f, u, i, hist, has, mslot, key, idx, bytes;
  __host__ __device__ static size_t take(size_t* o, size_t n) {
    const size_t at = *o;
    *o = (*o + n + 15) & ~size_t(15);
    return at;
  }
  __host__ __device__ Layout(int W, int K, int H, int P2) {
    size_t o = 0;
    lp = take(&o, kMaxC * 4);
    topv = take(&o, kMaxC * 4);
    topi = take(&o, kMaxC * 4);
    f = take(&o, size_t(6) * W * 4);  // pb, ptot, lm, bonus, stay pb, stay pnb
    u = take(&o, size_t(6) * W * 4);  // h1, h2, ph1, ph2, wh1, wh2
    i = take(&o, size_t(5) * W * 4);  // last, wlen, hcnt, alive, wid
    hist = take(&o, size_t(W) * (H > 0 ? H : 1) * 4);
    has = take(&o, size_t(W));
    mslot = take(&o, size_t(W) * K * 2);
    key = take(&o, size_t(P2) * 4);
    idx = take(&o, size_t(P2) * 2);
    bytes = o;
  }
};

__device__ __forceinline__ float logaddexp(float a, float b) {
  if (isinf(a) && a == b) return a;
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__device__ __forceinline__ float as_f32(int32_t v) { return __int_as_float(v); }

// Probe a split bucket table for the key (k1, k2): the primary bucket's 4
// slots, then (two-choice tables) the second bucket's. Returns whether the
// key is there and its 2 values.
__device__ bool probe(const int32_t* keys, const int32_t* vals, int nb,
                      int two_choice, uint32_t k1, uint32_t k2, int32_t* v0,
                      int32_t* v1) {
  const uint32_t buckets[2] = {k1 % static_cast<uint32_t>(nb),
                               k2 % static_cast<uint32_t>(nb)};
  for (int c = 0; c < 1 + two_choice; ++c) {
    const uint32_t bkt = buckets[c];
    const int4* row = reinterpret_cast<const int4*>(keys + size_t(bkt) * 8);
    const int4 a = __ldg(row), b = __ldg(row + 1);
    const int32_t ks[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    for (int s = 0; s < 4; ++s) {
      if (ks[2 * s] == static_cast<int32_t>(k1) &&
          ks[2 * s + 1] == static_cast<int32_t>(k2)) {
        const int2 v = __ldg(reinterpret_cast<const int2*>(vals + (size_t(bkt) * 4 + s) * 2));
        *v0 = v.x;
        *v1 = v.y;
        return true;
      }
    }
  }
  return false;
}

// The n-gram key of tok[0..n): the FNV-style dual hash or KenLM's chained
// u64 hash, as (k1, k2) / (lo, hi).
__device__ void window_key(const Params& p, const int* tok, int n,
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

// (found, prob, backoff) of a unigram
__device__ bool uni_lookup(const Params& p, int wid, float* prob, float* back) {
  if (wid < 0 || wid >= p.nuni) return false;
  const int32_t* row = p.uni + size_t(wid) * 3;
  if (__ldg(row + 2) <= 0) return false;
  *prob = as_f32(__ldg(row));
  *back = as_f32(__ldg(row + 1));
  return true;
}

// log10 P(wid | hist) with Katz backoff: the plain version's walk, which
// skips the levels that do not apply (they change nothing) and stops at
// the first n-gram found (nothing changes after it).
__device__ float ngram_score(const Params& p, const int* hist, int hcnt, int wid) {
  const int H = p.H;
  int tok[kMaxH + 1];
  for (int i = 0; i < H; ++i) tok[i] = hist[i];
  tok[H] = wid;
  const int ctx = min(hcnt, H);
  float res = 0.0f, bsum = 0.0f;
  bool done = false;
  for (int n = H + 1; n >= 1; --n) {
    if (n > ctx + 1) continue;  // not applicable
    bool found;
    float prob = 0.0f, back = 0.0f;
    if (n == 1) {
      found = uni_lookup(p, tok[H], &prob, &back);
    } else {
      uint32_t k1, k2;
      int32_t v0 = 0, v1 = 0;
      window_key(p, tok + (H + 1 - n), n, &k1, &k2);
      found = probe(p.arena_k, p.arena_v, p.arena_nb, p.arena_2c, k1, k2, &v0, &v1);
      prob = as_f32(v0);
    }
    if (found) {
      res = prob + bsum;
      done = true;
      break;
    }
    if (n > 1) {  // the backoff of the length n-1 context before the word
      bool bfound;
      float bprob = 0.0f, bback = 0.0f;
      if (n - 1 == 1) {
        bfound = uni_lookup(p, tok[H - 1], &bprob, &bback);
      } else {
        uint32_t k1, k2;
        int32_t v0 = 0, v1 = 0;
        window_key(p, tok + (H + 1 - n), n - 1, &k1, &k2);
        bfound = probe(p.arena_k, p.arena_v, p.arena_nb, p.arena_2c, k1, k2, &v0, &v1);
        bback = as_f32(v1);
      }
      if (bfound) bsum = bsum + bback;
    }
  }
  return done ? res : p.unk_floor + bsum;
}

// The fusion bonus of completing the partial word (wh1, wh2) of length
// wlen after the history, and the word's id; 0 where wlen == 0.
__device__ float space_bonus(const Params& p, uint32_t wh1, uint32_t wh2,
                             int wlen, const int* hist, int hcnt, int* wid) {
  *wid = 0;
  if (wlen <= 0) return 0.0f;
  if (!p.has_lm) return p.wc_w;
  int32_t v0 = 0, v1 = 0;
  const bool found = probe(p.words_k, p.words_v, p.words_nb, p.words_2c, wh1, wh2, &v0, &v1);
  *wid = found ? v0 : p.unk_id;
  const float valid = found ? static_cast<float>(v1) : 0.0f;
  const float sc = ngram_score(p, hist, hcnt, *wid);
  return __fadd_rn(__fadd_rn(p.wc_w, __fmul_rn(p.vwc_w, valid)),
                   __fmul_rn(p.lm_ln10, sc));
}

// Block-wide bitonic sort of n (a power of two) keys, descending by value,
// the lower index first on equal values. Every thread of the block calls it.
__device__ void bitonic_sort_desc(float* key, uint16_t* idx, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n / 2; i += blockDim.x) {
        const int lo = 2 * i - (i & (j - 1));
        const int hi = lo + j;
        const float ka = key[lo], kb = key[hi];
        const uint16_t ia = idx[lo], ib = idx[hi];
        const bool b_first = kb > ka || (kb == ka && ib < ia);
        if (b_first == ((lo & k) == 0)) {
          key[lo] = kb;
          key[hi] = ka;
          idx[lo] = ib;
          idx[hi] = ia;
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
beam_device_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = p.W, K = p.K, H = p.H, C = p.C, T = p.T;
  const Layout lay(W, K, H, p.P2);
  float* s_lp = reinterpret_cast<float*>(smem + lay.lp);
  float* s_topv = reinterpret_cast<float*>(smem + lay.topv);
  int* s_topi = reinterpret_cast<int*>(smem + lay.topi);
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
  float* s_key = reinterpret_cast<float*>(smem + lay.key);
  uint16_t* s_idx = reinterpret_cast<uint16_t*>(smem + lay.idx);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const bool owner = tid < W;
  const int len = min(max(p.lengths[b], 0), T);
  const float* logp = p.logp + size_t(b) * T * C;
  int16_t* bp = p.bp + size_t(b) * T * W;

  // the beam state of slot tid
  float pb = tid == 0 ? 0.0f : kNeg, pnb = kNeg, lm = 0.0f;
  uint32_t h1 = kSeed1, h2 = kSeed2, ph1 = 0, ph2 = 0, wh1 = kWSeed1, wh2 = kWSeed2;
  int last = -1, wlen = 0, hcnt = 0, alive = tid == 0;
  int hist[kMaxH];
  for (int i = 0; i < kMaxH; ++i) hist[i] = 0;
  if (p.bos_id >= 0 && H > 0) {
    hist[H - 1] = p.bos_id;
    hcnt = 1;
  }

  // candidate i of the pool: (pb, pnb, lm, alive), as the plain version
  // builds cand_pb / cand_pnb / cand_lm / cand_alive
  auto candidate = [&](int i, float* cpb, float* cpnb, float* clm) -> bool {
    if (i < W) {
      const bool merged = s_has[i];
      *cpb = merged ? kNeg : s_spb[i];
      *cpnb = merged ? kNeg : s_spnb[i];
      *clm = s_lm[i];
      return s_alive[i];
    }
    const int e = i - W, q = e / K, k = e - q * K;
    const int c = s_topi[k];
    float epnb = (c == s_last[q] ? s_pb[q] : s_ptot[q]) + s_topv[k];
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

  for (int t = 0; t < len; ++t) {
    // the frame, its top-K chars (one warp, by rank: value descending,
    // the lower index first on a tie); the LM probes of the beams run
    // beside it
    if (tid < C) s_lp[tid] = __ldg(logp + size_t(t) * C + tid);
    __syncwarp();
    if (tid < 32) {  // warp 0 loaded the frame (C <= 32)
      if (tid < C) {
        const float v = s_lp[tid];
        if (K < C) {
          int rank = 0;
          for (int j = 0; j < C; ++j) {
            const float u = s_lp[j];
            rank += (u > v) || (u == v && j < tid);
          }
          if (rank < K) {
            s_topv[rank] = v;
            s_topi[rank] = tid;
          }
        } else {
          s_topv[tid] = v;
          s_topi[tid] = tid;
        }
      }
    }
    float ptot = 0.0f;
    if (owner) {
      int wid;
      ptot = logaddexp(pb, pnb);
      const float bonus = space_bonus(p, wh1, wh2, wlen, hist, hcnt, &wid);
      s_pb[tid] = pb;
      s_ptot[tid] = ptot;
      s_lm[tid] = lm;
      s_bonus[tid] = bonus;
      s_h1[tid] = h1;
      s_h2[tid] = h2;
      s_ph1[tid] = ph1;
      s_ph2[tid] = ph2;
      s_wh1[tid] = wh1;
      s_wh2[tid] = wh2;
      s_last[tid] = last;
      s_wlen[tid] = wlen;
      s_hcnt[tid] = hcnt;
      s_alive[tid] = alive;
      s_wid[tid] = wid;
      for (int i = 0; i < H; ++i) s_hist[tid * H + i] = hist[i];
      for (int k = 0; k < K; ++k) s_mslot[tid * K + k] = -1;
    }
    __syncthreads();

    // stay candidates, and the merge of stay(j) into extend(p, last[j])
    if (owner) {
      int k_idx = -1;
      for (int k = 0; k < K; ++k) {
        if (s_topi[k] == last) {
          k_idx = k;
          break;
        }
      }
      const bool last_ok = k_idx >= 0 && last >= 0;
      s_spb[tid] = ptot + s_lp[kBlank];
      s_spnb[tid] = last_ok ? pnb + s_lp[last] : kNeg;
      bool has = false;
      if (alive && last_ok) {
        for (int q = 0; q < W; ++q) {
          if (s_alive[q] && s_h1[q] == ph1 && s_h2[q] == ph2) {
            s_mslot[q * K + k_idx] = static_cast<int16_t>(tid);
            has = true;
            break;
          }
        }
      }
      s_has[tid] = has;
    }
    __syncthreads();

    // the pool's scores, then its order
    for (int i = tid; i < p.P2; i += blockDim.x) {
      float total = -INFINITY;
      if (i < p.P) {
        float cpb, cpnb, clm;
        total = candidate(i, &cpb, &cpnb, &clm) ? logaddexp(cpb, cpnb) + clm : kNeg;
      }
      s_key[i] = total;
      s_idx[i] = i < p.P ? static_cast<uint16_t>(i) : uint16_t(0xFFFF);
    }
    __syncthreads();
    bitonic_sort_desc(s_key, s_idx, p.P2);

    // slot tid takes the tid-th candidate: its scores, its parent's state
    // updated by the candidate's char
    if (owner) {
      const int i = s_idx[tid];
      const float tv = s_key[tid];
      candidate(i, &pb, &pnb, &lm);
      const bool is_stay = i < W;
      const int par = is_stay ? i : (i - W) / K;
      const int ch = is_stay ? -1 : s_topi[(i - W) % K];
      const uint32_t u = static_cast<uint32_t>(max(ch, 0) + 2);
      const uint32_t ph1p = s_ph1[par], ph2p = s_ph2[par];
      const uint32_t h1p = s_h1[par], h2p = s_h2[par];
      const uint32_t wh1p = s_wh1[par], wh2p = s_wh2[par];
      const int lastp = s_last[par], wlenp = s_wlen[par], hcntp = s_hcnt[par];
      const bool is_space = !is_stay && ch == kSpace;
      const bool completes = is_space && wlenp > 0;
      h1 = is_stay ? h1p : h1p * kM1 + u;
      h2 = is_stay ? h2p : h2p * kM2 + u;
      ph1 = is_stay ? ph1p : h1p;
      ph2 = is_stay ? ph2p : h2p;
      wh1 = is_stay ? wh1p : (is_space ? kWSeed1 : wh1p * kM1 + u);
      wh2 = is_stay ? wh2p : (is_space ? kWSeed2 : wh2p * kM2 + u);
      last = is_stay ? lastp : ch;
      wlen = is_stay ? wlenp : (is_space ? 0 : wlenp + 1);
      hcnt = completes ? min(hcntp + 1, p.hcnt_cap) : hcntp;
      alive = tv > kNeg / 2;
      const int* hp = s_hist + par * H;
      if (H > 0 && completes) {
        const int widp = s_wid[par];
        if (p.pin_bos && hcntp == p.hcnt_cap) {
          hist[0] = hp[0];
          for (int j = 1; j < H - 1; ++j) hist[j] = hp[j + 1];
        } else {
          for (int j = 0; j < H - 1; ++j) hist[j] = hp[j + 1];
        }
        hist[H - 1] = widp;
      } else {
        for (int j = 0; j < H; ++j) hist[j] = hp[j];
      }
      bp[size_t(t) * W + tid] = static_cast<int16_t>((par << 5) | (ch + 1));
    }
    __syncthreads();
  }

  // the final ranking: the trailing partial word scores as a word too
  if (owner) {
    int wid;
    const float fbonus = space_bonus(p, wh1, wh2, wlen, hist, hcnt, &wid);
    const float final_score = logaddexp(pb, pnb) + lm + fbonus;
    s_key[tid] = alive ? final_score : kNeg;
    s_idx[tid] = static_cast<uint16_t>(tid);
  } else if (tid < p.F2) {
    s_key[tid] = -INFINITY;
    s_idx[tid] = uint16_t(0xFFFF);
  }
  for (int i = tid + blockDim.x; i < p.F2; i += blockDim.x) {
    s_key[i] = -INFINITY;
    s_idx[i] = uint16_t(0xFFFF);
  }
  __syncthreads();
  bitonic_sort_desc(s_key, s_idx, p.F2);

  // one thread per winner: walk the backpointers back from the last frame,
  // then move the kept chars to the front of the row
  if (tid < p.n_best) {
    const size_t o = size_t(b) * p.n_best + tid;
    int32_t* row = p.out_ids + o * T;
    int cur = s_idx[tid];
    p.out_scores[o] = s_key[tid];
    for (int t = len - 1; t >= 0; --t) {
      const int v = bp[size_t(t) * W + cur];
      row[t] = (v & 31) - 1;
      cur = v >> 5;
    }
    int n = 0;
    for (int t = 0; t < len; ++t) {
      const int c = row[t];
      if (c >= 0) row[n++] = c;
    }
    for (int t = n; t < T; ++t) row[t] = kPad;
    p.out_len[o] = n;
  }
}

int next_pow2(int n) {
  int m = 1;
  while (m < n) m <<= 1;
  return m;
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

// Dynamic shared memory the kernel needs at width W, top-K K and history H.
size_t beam_device_smem_bytes(int W, int K, int H) {
  return Layout(W, K, H, next_pow2((K + 1) * W)).bytes;
}

// Threads a block at width W and top-K K.
int beam_device_threads(int W, int K) {
  return block_threads(W, next_pow2((K + 1) * W));
}

// Launches the kernel on `stream` and returns cudaGetLastError(): a launch
// that is refused (threads, shared memory) never runs, and only this shows
// it. Tables of an absent LM (has_lm == 0) may be null.
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
  p.P2 = next_pow2(p.P);
  p.F2 = next_pow2(W);
  p.has_lm = has_lm;
  p.H = H;
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
  const size_t smem = Layout(W, K, H, p.P2).bytes;
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(beam_device_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = block_threads(W, p.P2);
  beam_device_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* beam_device_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
