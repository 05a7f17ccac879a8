// CTC forward (alpha) recursion and per-example loss, for Hopper (sm_90a).
//
// Replaces the TPU kernel speecht_tpu/ops/ctc_pallas.py::_forward_kernel
// (:145; its pallas_call at :357 in _forward, launched through
// ctc_loss_pallas / ctc_loss). It computes the same function as the plain
// PyTorch version, speecht_tpu_torch/ops/ctc.py::ctc_loss_log_probs and
// ctc_alpha:
//
//   ext   = blank-interleaved labels, S = 2L+1 states
//   a[0]  = logp[0, ext[s]] for s < 2, NEG_INF elsewhere
//   a[t]  = lse(a[t-1,s], a[t-1,s-1], skip(s) ? a[t-1,s-2] : NEG_INF)
//           + logp[t, ext[s]]                         for 1 <= t < len
//   loss  = -lse(a[len-1, 2*ll], a[len-1, 2*ll-1])    (the latter if ll > 0)
//
// with the JAX package's NEG_INF = -1e30 arithmetic (not -inf), the max of
// the three-term log-sum-exp clamped at NEG_INF, alpha frozen for t >=
// len, frame 0 read even when len == 0, and ids outside [0, C) read as
// blank. A caller that passes a [T, B, S] buffer gets the alpha history,
// frozen rows included (the backward kernel, ctc_beta.cu, reads it).
//
// What bounds it on this card: the serial chain. At the evaluate shape
// (B=64, T=512 logit frames, L=256) the bytes a row needs take about 1 us
// at 3.35 TB/s and its arithmetic (14 operations a needed state and frame)
// 1.35 us at 67 TFLOP/s float32: 0.00135 ms, bound by operations. With
// the history (the train step) 67 MB of it and the log-prob rows move
// once: about 70 MB, 0.021 ms. Both are small beside up to 512 dependent
// frames of a log-sum-exp a state, so dependent latency and issue set the
// time.
//
// Design (one CTA per example; the first version ran a block barrier over
// up to 32 warps every frame, alpha double-buffered in shared memory, the
// emission gather and the history stores inside the frame):
// - Recursion warps hold alpha in registers: lane g owns the K contiguous
//   states g*K .. g*K + K - 1, K even, so even slots are blanks and odd
//   slots labels. A row of n states runs on W = ceil(n / 32K) of up to 14
//   warps (every S <= 14336 fits at K=32), with K from 2, 4, 6, 8, 12, 16,
//   24, 32 chosen for the least issue on the busiest SM sub-partition,
//   ceil(W / 4) warps of K/2 state pairs: a frame's time is that issue
//   plus the chain's latency (on an H100, K=2 on 7 warps took 0.148 ms at
//   the evaluate shape, K=4 on 5 warps 0.218 ms on rows of 513 states,
//   K=2 on 9 warps 0.172 ms on those). Without a
//   history a row runs only its own n = 2 ll + 1 states: the loss reads
//   states 2ll and 2ll-1, and alpha[t, s] depends on states <= s only, so
//   the loss is the one all S states give, bit for bit. With a history n =
//   S, so the padded states (finite: state 2ll+1 is a blank fed by 2ll)
//   are the plain version's too. States of a lane at or past n compute
//   values no state below n reads, and are never stored.
// - The one neighbour a lane needs across its boundary, alpha[base - 1]
//   (the blank's s-1 and the next label's s-2), comes by __shfl_up_sync;
//   across a warp boundary through shared memory under a named barrier
//   among the W recursion warps only (none when W = 1). The exchange comes
//   first, then every state's log-sum-exp in one block of independent
//   chains.
// - The log-sum-exp rounds as the plain version rounds it (an ulp here
//   moves every later alpha, and the history feeds ctc_beta's posteriors):
//   (e_a + e_b) + e_c in the plain order, the clamped max's term exactly 1,
//   so a blank takes 1 exp (its third term NEG_INF gives exactly 0 or 1)
//   and a label 2; the log is log_normal (bit-equal to logf on a sum in
//   [1, 3]). Where the clamp is active (all three terms below NEG_INF, as
//   -inf log-probs give) every exp of the three-term form is exactly 0
//   (the floats below -1e30 are at least 7.6e22 below it), so its result
//   is -inf, which is what the kernel returns there. No fast-math
//   intrinsics.
// - Emissions come from log-prob rows staged kLpChunk frames at a time by
//   cp.async, one chunk ahead, and are loaded into registers at the end of
//   the frame before, so the exchange hides their latency.
// - The history is off the chain: each frame's row goes into a
//   shared-memory ring of kNB blocks of KB frames, at the offset (0..3
//   floats past a 16-byte boundary) frame 0's history row has, handed over
//   by an mbarrier pair a block (one arrival a warp). kWriters writer
//   warps take frames round robin and move each row with 16-byte loads
//   and streaming stores (rows start only 4-byte aligned: a scalar head,
//   the aligned body, a scalar tail; a frame at another offset, where B *
//   S % 4 != 0, goes by 4-byte copies), then write the frozen rows t >=
//   len from the last one. The recursion stores frame t - 1's row in
//   frame t after the exchange's load: shared-memory operations issue in
//   order, so stores put between the barrier and that load delayed every
//   frame. KB comes from S at launch so that every S <= 14336 fits in 227
//   KB.
// - No __syncthreads() after set-up.
// What is left: each frame is about 400 clocks of latency (the exchange
// and one exactly rounded log-sum-exp) plus the busiest sub-partition's
// issue; the barrier keeps the warps in step where a point-to-point
// handoff would let them run as a pipeline; one CTA an example, so the
// largest bucket (B=8) runs on 8 of 132 SMs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ctc_common.cuh"

namespace {

using namespace ctc;

constexpr int kMaxK = 32;
// ceil(14295 / (32 kMaxK)): the widest row the first, shared-memory
// version of this kernel took (16 S + 3712 bytes of 227 KB)
constexpr int kRecWarps = 14;
constexpr int kMaxStates = 32 * kRecWarps * kMaxK;
constexpr int kWriters = 2;
constexpr int kLpChunk = 32;
constexpr int kRecBarrier = 1;
constexpr int kNB = 2;  // history ring blocks
constexpr int kSmemLimit = 232448;
constexpr int kMaxThreads = 32 * (kRecWarps + kWriters);

// K and W of a row of n states: the least issue on the busiest SM
// sub-partition (warp w issues from sub-partition w % 4), ceil(W / 4)
// warps of K / 2 state pairs each; ties go to the smaller K.
__host__ __device__ inline void choose_kw(int n, int& K, int& W) {
  const int ks[] = {2, 4, 6, 8, 12, 16, 24, kMaxK};
  int best = 1 << 30;
  K = kMaxK;
  W = kRecWarps;
  for (int k : ks) {
    const int w = (n + 32 * k - 1) / (32 * k);
    const int cost = (w + 3) / 4 * k;
    if (w <= kRecWarps && cost < best) {
      best = cost;
      K = k;
      W = w;
    }
  }
}

// Offsets (in 4-byte words) of the dynamic shared memory sections; every
// section starts 16-byte aligned. The mbarriers come first.
struct Layout {
  int KB;  // frames a ring block (0: no history)
  size_t RS, LPB;
  size_t lpbuf, bnd, fin, ring, words;

  __host__ __device__ Layout(int S, int C, int KB_) : KB(KB_) {
    int K, W;
    choose_kw(S, K, W);
    RS = round4(32 * W * K + 3);  // every lane's states, at an offset 0..3
    LPB = round4(kLpChunk * C + 4);
    lpbuf = 4 * kNB;     // 2*kNB mbarriers of 8 bytes
    bnd = lpbuf + 2 * LPB;
    fin = bnd + round4(2 * kRecWarps);
    ring = fin + 4;
    words = ring + static_cast<size_t>(kNB) * KB * RS;
  }
  size_t bytes() const { return words * 4; }
};

// The history variant's layout: the deepest ring block that fits.
Layout history_layout(int S, int C) {
  for (int kb = 8; kb > 1; kb /= 2) {
    Layout lay(S, C, kb);
    if (lay.bytes() <= kSmemLimit) return lay;
  }
  return Layout(S, C, 1);
}

// lse(a, b, NEG_INF) with the max clamped at NEG_INF, rounded as the plain
// version: the term of hi = max(a, b) is 1 where hi is the max, else 0
// (hi < NEG_INF); the NEG_INF term is 1 where the max is NEG_INF, else 0.
__device__ __forceinline__ float lse_blank(float a, float b) {
  const float hi = fmaxf(a, b), lo = fminf(a, b);
  const float m = fmaxf(hi, kNegInf);
  const float sum = ((hi == m ? 1.f : 0.f) + expf(lo - m)) + (m == kNegInf ? 1.f : 0.f);
  return m + log_normal(sum);
}

// lse(a, b, c) with the max clamped at NEG_INF, rounded as the plain
// version, m + log((e_a + e_b) + e_c): the max's term is exp(0) = 1, so
// only the other two are computed. All three below NEG_INF: every term is
// exactly 0 and the plain version's result -inf.
__device__ __forceinline__ float lse_label(float a, float b, float c) {
  const float mx = fmaxf(fmaxf(a, b), c);
  const float m = fmaxf(mx, kNegInf);
  const bool a_max = a == m, c_max = c == m;
  const float ep = expf((a_max ? b : a) - m);
  const float eq = expf((c_max ? b : c) - m);
  const float ea = a_max ? 1.f : ep;
  const float eb = b == m ? 1.f : (a_max ? ep : eq);
  const float ec = c_max ? 1.f : eq;
  return mx < kNegInf ? -INFINITY : m + log_normal((ea + eb) + ec);
}

struct Shared {
  uint64_t* full;   // [kNB]
  uint64_t* empty;  // [kNB]
  float* lpbuf;     // [2][LPB] log-prob chunks
  float* bnd;       // [2][kRecWarps] the last alpha of each recursion warp
  float* fin;       // [2] alpha at states 2ll, 2ll - 1 after the last frame
  float* ring;      // [kNB * KB][RS] history rows, state s at s + the
                    // offset of frame 0's history row past 16 bytes
};

struct Row {
  const float* lp;        // [T, C] log-probs of the row
  const int32_t* labels;  // [L]
  float* hist;            // the row's history at frame 0 (frame t at + t * stride)
  size_t stride;          // B * S
  int ll, steps, n, C, blank, K, W;  // steps: frames run, max(len, 1)
};

// The alpha recursion of one row on recursion warp w (< W), K states a
// lane; the loss, and each frame's row into the ring when `history`.
template <int K>
__device__ void recursion(const Shared& sh, const Layout& lay, const Row& row, int w,
                          int lane, bool history, float* loss) {
  const int gl = w * 32 + lane;
  const int base = gl * K;  // even
  const int n = row.n, steps = row.steps, C = row.C, blank = row.blank;
  const int nthr = 32 * row.W;
  auto sync_rec = [&] {
    if (row.W > 1) named_barrier(kRecBarrier, nthr); else __syncwarp();
  };

  // classes of the odd (label) slots and their skip bits (s - 2 -> s)
  int lab[K / 2];
  unsigned skip = 0;
  int before = base >= 2 && base - 1 < n ? class_of(row.labels[(base >> 1) - 1], C, blank)
                                         : blank;
#pragma unroll
  for (int j = 0; j < K / 2; ++j) {
    const int s = base + 2 * j + 1;
    lab[j] = s < n ? class_of(row.labels[s >> 1], C, blank) : blank;
    if (s < n && s >= 3 && lab[j] != blank && lab[j] != before) skip |= 1u << j;
    before = lab[j];
  }

  // log-prob rows 0 .. steps-1 in chunks of kLpChunk frames
  const int nchunks = (steps + kLpChunk - 1) / kLpChunk;
  auto issue_chunk = [&](int q) {
    const int first = q * kLpChunk;
    copy_span(sh.lpbuf + (q & 1) * lay.LPB, row.lp + static_cast<size_t>(first) * C,
              min(kLpChunk, steps - first) * C, gl, nthr);
    cp_async_commit();
  };
  const float* rows = nullptr;  // staged row `first`, at its span offset
  int first = 0;
  // chunk q has landed for every thread, and every read of chunk q - 1 is
  // done, so its buffer takes chunk q + 1
  auto use_chunk = [&](int q) {
    if (q + 1 < nchunks) issue_chunk(q + 1);
    first = q * kLpChunk;
    rows = sh.lpbuf + (q & 1) * lay.LPB + span_offset(row.lp + static_cast<size_t>(first) * C);
  };
  float eb = 0.f, el[K / 2];  // the emissions of a frame, loaded at the end of the one before
  auto prefetch = [&](int t) {
    const float* e = rows + (t - first) * C;
    eb = e[blank];
#pragma unroll
    for (int j = 0; j < K / 2; ++j) el[j] = e[lab[j]];
  };

  // frame t goes to ring row t % (kNB KB) of block t / KB (KB a power of
  // two), at the offset frame 0's history row has past 16 bytes; every
  // lane stores all K states (the row has room), the writers read s < S
  float* const my_ring = sh.ring + (history ? span_offset(row.hist) : 0) + base;
  const int kb_shift = __ffs(lay.KB) - 1, ring_mask = kNB * lay.KB - 1;
  const int RS = static_cast<int>(lay.RS);
  float v[K];
  auto publish = [&](int t) {
    const int blk = t >> kb_shift, in_blk = t & (lay.KB - 1);
    if (in_blk == 0 && blk >= kNB) mbar_wait(sh.empty + blk % kNB, ((blk / kNB) - 1) & 1);
    float* out = my_ring + (t & ring_mask) * RS;
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = v[k];
    if (in_blk == lay.KB - 1 || t == steps - 1) {
      __syncwarp();
      if (lane == 0) mbar_arrive(sh.full + blk % kNB);
    }
  };

  issue_chunk(0);
  cp_async_wait<0>();
  sync_rec();
  use_chunk(0);
  prefetch(0);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = base + k;
    v[k] = s == 0 ? eb : (s == 1 ? el[0] : kNegInf);
  }
  if (steps > 1) prefetch(1);

  for (int t = 1; t < steps; ++t) {
    // alpha[base - 1]: from the lane below, or the warp below
    float left = __shfl_up_sync(0xffffffffu, v[K - 1], 1);
    float* bd = sh.bnd + (t & 1) * kRecWarps;
    if (row.W > 1 && lane == 31) bd[w] = v[K - 1];
    const bool next_chunk = (t + 1) % kLpChunk == 0 && t + 1 < steps;
    if (next_chunk) cp_async_wait<0>();
    if (row.W > 1) {
      named_barrier(kRecBarrier, nthr);
    } else if (next_chunk) {
      __syncwarp();
    }
    if (lane == 0) left = w == 0 ? kNegInf : bd[w - 1];
    if (next_chunk) use_chunk((t + 1) / kLpChunk);
    // frame t - 1 into the ring: after the exchange's load, so that the
    // stores drain while the log-sum-exps run, not between the barrier
    // and the load that the next frame waits on
    if (history) publish(t - 1);
    // one block of independent chains, so that they interleave; the
    // blank's s-1 and the label's s-2 are the same state
    float nv[K];
#pragma unroll
    for (int j = 0; j < K / 2; ++j) {
      const float prev = j == 0 ? left : v[2 * j - 1];
      nv[2 * j] = lse_blank(v[2 * j], prev) + eb;
      nv[2 * j + 1] = lse_label(v[2 * j + 1], v[2 * j], (skip >> j) & 1u ? prev : kNegInf) +
                      el[j];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = nv[k];
    // the next frame's emissions: their latency hides behind its exchange
    if (t + 1 < steps) prefetch(t + 1);
  }
  if (history) publish(steps - 1);

  const int ll = row.ll;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (base + k == 2 * ll) sh.fin[0] = v[k];
    if (ll > 0 && base + k == 2 * ll - 1) sh.fin[1] = v[k];
  }
  sync_rec();
  if (gl == 0) {
    const float a1 = sh.fin[0];
    const float a2 = ll > 0 ? sh.fin[1] : kNegInf;
    const float m = fmaxf(a1, a2);
    *loss = -(m + logf(expf(a1 - m) + expf(a2 - m)));
  }
}

// Writer warp cw of kWriters: the history rows of frames cw, cw +
// kWriters, ... from the ring, then the frozen rows t >= steps.
__device__ void write_history(const Shared& sh, const Layout& lay, const Row& row, int cw,
                              int lane, int T, int S) {
  // a ring row holds the states at r[s + roff], roff frame 0's offset; the
  // aligned body goes by 16 bytes where frame t's row has the same offset
  // (every frame when B * S % 4 == 0)
  const int roff = span_offset(row.hist);
  auto write_row = [&](const float* r, int t) {
    float* dst = row.hist + static_cast<size_t>(t) * row.stride;
    const int off = span_offset(dst);
    if (off != roff) {
      for (int s = lane; s < S; s += 32) __stcs(dst + s, r[s + roff]);
      return;
    }
    const int head = min(S, (4 - off) & 3);
    if (lane < head) __stcs(dst + lane, r[lane + off]);
    const int nvec = (S - head) >> 2;
    const float4* src = reinterpret_cast<const float4*>(r + head + off);
    float4* out = reinterpret_cast<float4*>(dst + head);
    for (int i = lane; i < nvec; i += 32) __stcs(out + i, src[i]);
    const int done = head + 4 * nvec;
    if (lane < S - done) __stcs(dst + done + lane, r[done + lane + off]);
  };

  const int steps = row.steps, KB = lay.KB;
  const int nblk = (steps + KB - 1) / KB;
  const int ring_mask = kNB * KB - 1;
  for (int blk = 0; blk < nblk; ++blk) {
    mbar_wait(sh.full + blk % kNB, (blk / kNB) & 1);
    const int end = min((blk + 1) * KB, steps);
    for (int i = blk * KB + ((cw - blk * KB) % kWriters + kWriters) % kWriters; i < end;
         i += kWriters)
      write_row(sh.ring + static_cast<size_t>(i & ring_mask) * lay.RS, i);
    __syncwarp();
    if (lane == 0) mbar_arrive(sh.empty + blk % kNB);
  }
  const float* last = sh.ring + static_cast<size_t>((steps - 1) & ring_mask) * lay.RS;
  for (int t = steps + cw; t < T; t += kWriters) write_row(last, t);
}

__global__ void __launch_bounds__(kMaxThreads, 1)
ctc_alpha_kernel(const float* __restrict__ logp,             // [B, T, C]
                 const int32_t* __restrict__ labels,         // [B, L]
                 const int32_t* __restrict__ logit_lengths,  // [B]
                 const int32_t* __restrict__ label_lengths,  // [B]
                 float* __restrict__ loss,                   // [B]
                 float* __restrict__ alpha_hist,             // [T, B, S] or null
                 int B, int T, int C, int L, int blank, int KB) {
  extern __shared__ __align__(16) float smem[];
  const int S = 2 * L + 1;
  const Layout lay(S, C, KB);
  Shared sh;
  sh.full = reinterpret_cast<uint64_t*>(smem);
  sh.empty = sh.full + kNB;
  sh.lpbuf = smem + lay.lpbuf;
  sh.bnd = smem + lay.bnd;
  sh.fin = smem + lay.fin;
  sh.ring = smem + lay.ring;

  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool history = alpha_hist != nullptr;
  Row row;
  row.lp = logp + static_cast<size_t>(b) * T * C;
  row.labels = labels + static_cast<size_t>(b) * L;
  row.hist = history ? alpha_hist + static_cast<size_t>(b) * S : nullptr;
  row.stride = static_cast<size_t>(B) * S;
  row.ll = min(max(label_lengths[b], 0), L);
  // frame 0 is read even for a row of length 0
  row.steps = max(min(max(logit_lengths[b], 0), T), 1);
  row.n = history ? S : 2 * row.ll + 1;
  row.C = C;
  row.blank = blank;
  choose_kw(row.n, row.K, row.W);

  if (history && threadIdx.x == 0) {
    for (int k = 0; k < kNB; ++k) {
      mbar_init(sh.full + k, row.W);
      mbar_init(sh.empty + k, kWriters);
    }
  }
  __syncthreads();

  if (warp < kRecWarps) {
    if (warp >= row.W) return;
    float* out = loss + b;
    switch (row.K) {
      case 2: recursion<2>(sh, lay, row, warp, lane, history, out); break;
      case 4: recursion<4>(sh, lay, row, warp, lane, history, out); break;
      case 6: recursion<6>(sh, lay, row, warp, lane, history, out); break;
      case 8: recursion<8>(sh, lay, row, warp, lane, history, out); break;
      case 12: recursion<12>(sh, lay, row, warp, lane, history, out); break;
      case 16: recursion<16>(sh, lay, row, warp, lane, history, out); break;
      case 24: recursion<24>(sh, lay, row, warp, lane, history, out); break;
      default: recursion<kMaxK>(sh, lay, row, warp, lane, history, out); break;
    }
    return;
  }
  write_history(sh, lay, row, warp - kRecWarps, lane, T, S);
}

}  // namespace

extern "C" {

// The most CTC states (2L+1) one block takes.
int ctc_alpha_max_states() { return kMaxStates; }

// Dynamic shared memory the kernel needs for L labels and C classes when it
// writes the history (the larger of its two variants).
size_t ctc_alpha_smem_bytes(int L, int C) {
  return history_layout(2 * L + 1, C).bytes();
}

// Launches the kernel on `stream` and returns cudaGetLastError(): a launch
// that is refused (threads, shared memory) never runs, and only this shows it.
int ctc_alpha_forward(const void* logp, const void* labels,
                      const void* logit_lengths, const void* label_lengths,
                      void* loss, void* alpha_hist, int B, int T, int C, int L,
                      int blank, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0) return 0;
  const int S = 2 * L + 1;
  if (S > kMaxStates || blank < 0 || blank >= C) return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay = alpha_hist != nullptr ? history_layout(S, C) : Layout(S, C, 0);
  const size_t smem = lay.bytes();
  const int threads = 32 * (kRecWarps + (alpha_hist != nullptr ? kWriters : 0));
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(ctc_alpha_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ctc_alpha_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logp), static_cast<const int32_t*>(labels),
      static_cast<const int32_t*>(logit_lengths),
      static_cast<const int32_t*>(label_lengths), static_cast<float*>(loss),
      static_cast<float*>(alpha_hist), B, T, C, L, blank, lay.KB);
  return static_cast<int>(cudaGetLastError());
}

const char* ctc_alpha_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
