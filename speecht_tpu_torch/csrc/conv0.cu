// Wav2Letter's first layer on Hopper (sm_90a): conv1d width 48, stride 2,
// SAME padding, + bias + ReLU, as 25 accumulated phase-stacked matmuls.
//
// Replaces the TPU kernel speecht_tpu/ops/conv0_pallas.py::_kernel
// (launched by _pallas_forward through conv0_fused). It computes the same
// function as the plain PyTorch version,
// speecht_tpu_torch/ops/conv0.py::conv0_plain:
//
//   xp[u]  = concat(x[2u], x[2u+1])              [U = T/2 rows of 2I values]
//   V[a]   = phase_weights(w)[a]                 [2I, O], a in [0, 25)
//   y[u]   = relu(sum_a xp[u + a - 12] @ V[a] + bias)   (xp is 0 outside)
//
// with every product summed in float32 and one rounding to the input type
// at the end, after the bias, as the Pallas kernel does.
//
// Layouts. x is read as [B, T, I], the layout the model holds before its
// transpose to channels-first, so the phase stacking is free: row u of xp
// is the 2I contiguous values at x + (b*T + 2u)*I. y is written as
// [B, O, T/2], channels-first, so the next layer's F.conv1d reads it
// without a copy. The weight [O, I, 48] (the port's layout) is rearranged
// at every call by a small first kernel, conv0_phase_weights_kernel, whose
// time is part of the call's: for bf16 into V^T [25, Opad, 2I] (K-major,
// the B operand wgmma reads most simply), for float32 into V [25, 2I,
// Opad]; Opad is O rounded up to the tile width, zero beyond O.
//
// What bounds it on this card. At the main shape (B=64, T=1024, I=128,
// O=250, bf16) the layer does 2*B*U*O*48*I = 0.101 T operations, 0.1018 ms
// at the dense bf16 tensor-core rate (989 TFLOP/s), and moves 36.2 MB
// (x, w, bias, y once each), 0.011 ms at 3.35 TB/s. So it is bound by
// operations: the products must run on wgmma, the only way to the
// tensor cores' full rate, and the tensor cores must never wait for data.
//
// bf16 design (conv0_bf16_kernel):
// - One CTA per (batch row, BM=128 output rows u, BN=256 output channels
//   o): two warpgroups, each a 64x256 float32 accumulator in registers
//   (wgmma.m64n256k16, 128 registers a thread). One CTA an SM.
// - K (the 2I phase-stacked channels) runs in chunks of KC=64, and within
//   a chunk the 25 taps: steps (chunk, tap). A chunk's slab of BM+24 input
//   rows is copied into shared memory once (double-buffered: the next
//   chunk's slab is in flight during this chunk's taps), and all 25 taps
//   read their shifted window of it, the reuse the Pallas kernel gets from
//   holding one padded row in VMEM.
// - The tap shift lives in the A operand, which comes from registers:
//   ldmatrix.x4 takes one row pointer per lane, so a window shifted by one
//   row costs nothing. (A shared-memory descriptor addresses 8-row core
//   matrices and cannot start at an odd row.) The slab's row pitch is
//   padded to 144 bytes, so ldmatrix reads it without bank conflicts.
// - The B operand, one tap's [256 x 64] K-major weight tile (32 KB), comes
//   from shared memory through a descriptor with the 128-byte swizzle. A
//   ring of kStages=4 such tiles is filled by cp.async 16-byte copies, the
//   tiles of the next three steps in flight while wgmma runs on this one.
//   Each step ends with wgmma.wait_group 0, and after the one barrier a
//   step its tile goes back to the ring.
// - Epilogue: the accumulators go through shared memory (reusing the
//   ring), then bias in float32, ReLU, one cast, stored along u (coalesced
//   in [B, O, U]); the ragged edges of U and O are masked here.
// What it leaves on the table: every CTA streams the whole V^T (3.3 MB at
// the main shape) from L2, 0.84 GB over the 256 CTAs, which BM=256 or a
// 2-CTA cluster with TMA multicast would halve; TMA and clusters (and the
// warp-specialised producer they allow, so that no step waits at a
// barrier); and wave quantisation (the largest bucket, B=8, T=4352, is
// 136 CTAs on 132 SMs, two waves, the second nearly empty).
//
// float32 (conv0_f32_kernel; only the card-vs-CPU parity runs use it):
// full-float32 FMA on the SIMT cores, no TF32, a 64x128 tile per CTA, the
// slab loaded once per K chunk of 16, the weight tile double-buffered
// through registers, one barrier a tap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWidth = 48;
constexpr int kHalo = 12;
constexpr int kTaps = 2 * kHalo + 1;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Tap a of the phase-stacked weights holds w[.., 2a-1] in rows k < I and
// w[.., 2a] in rows k >= I; zero where that tap is outside [0, 48) and in
// the channels o >= O. kKMajor: V^T [25, Opad, 2I]; else V [25, 2I, Opad].
template <typename T, bool kKMajor>
__global__ void conv0_phase_weights_kernel(const T* __restrict__ w, T* __restrict__ v,
                                           int I, int O, int Opad) {
  const int I2 = 2 * I;
  const size_t total = static_cast<size_t>(kTaps) * I2 * Opad;
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       idx < total; idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    int o, k;
    if constexpr (kKMajor) {
      k = static_cast<int>(idx % I2);
      o = static_cast<int>((idx / I2) % Opad);
    } else {
      o = static_cast<int>(idx % Opad);
      k = static_cast<int>((idx / Opad) % I2);
    }
    const int a = static_cast<int>(idx / (static_cast<size_t>(Opad) * I2));
    float val = 0.f;
    if (o < O) {
      const int tap = k < I ? 2 * a - 1 : 2 * a;
      const int i = k < I ? k : k - I;
      if (tap >= 0 && tap < kWidth) {
        val = to_float(w[(static_cast<size_t>(o) * I + i) * kWidth + tap]);
      }
    }
    v[idx] = from_float<T>(val);
  }
}

// -- bf16: wgmma, A from registers at the tap's row shift, B from a ring --

namespace bf16 {

constexpr int kBM = 128;                  // output rows u per CTA
constexpr int kBN = 256;                  // output channels o per CTA
constexpr int kKC = 64;                   // K chunk: one 128-byte swizzled row
constexpr int kThreads = 256;             // two warpgroups
constexpr int kStages = 4;                // weight tiles in the ring
constexpr int kSlab = kBM + 2 * kHalo;    // 152 phase-stacked rows
constexpr int kLdx = kKC + 8;             // slab row pitch: 144 bytes
constexpr int kStageBytes = kBN * kKC * 2;                  // 32 KB
constexpr int kSlabBytes = kSlab * kLdx * 2;                // 21,888 B
constexpr int kMainBytes = kStages * kStageBytes + 2 * kSlabBytes;
constexpr int kLdc = kBM + 4;             // epilogue tile, [BN][LDC] float
constexpr int kEpiBytes = kBN * kLdc * 4;
// + 1 KB to align the ring to the swizzle's 1024-byte pattern
constexpr int kSmemBytes = (kMainBytes > kEpiBytes ? kMainBytes : kEpiBytes) + 1024;
static_assert(kSlabBytes % 16 == 0, "slab buffers stay 16-byte aligned");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zeros where src_bytes is 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// makes this thread's cp.async writes visible to wgmma's (async proxy) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving accesses of an accumulator across a fence
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

// Descriptor of a K-major [rows x 64] bf16 tile with the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), leading offset
// unused for this layout (1), the tile at a 1024-byte aligned address.
__device__ __forceinline__ uint64_t b128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d[64 x 256] += a[64 x 16] (registers, the per-warp mma.m16n8k16 A
// layout) @ b[16 x 256] (shared memory, K-major, through the descriptor)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " {%128, %129, %130, %131},"
      " %132,"
      " p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__global__ void __launch_bounds__(kThreads, 1)
conv0_bf16_kernel(const __nv_bfloat16* __restrict__ x,     // [B, T, I] = [B, U, 2I]
                  const __nv_bfloat16* __restrict__ vt,    // [25, Opad, 2I]
                  const __nv_bfloat16* __restrict__ bias,  // [O]
                  __nv_bfloat16* __restrict__ y,           // [B, O, U]
                  int U, int I2, int O, int Opad) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the ring at a 1024-byte boundary (the swizzle pattern's period)
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_addr(smem);                       // kStages x [256][64]
  const uint32_t slabs = ring + kStages * kStageBytes;          // 2 x [kSlab][kLdx]
  float* cs = reinterpret_cast<float*>(smem);                   // [kBN][kLdc], epilogue

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;  // warpgroup warp / 4, row block warp % 4
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int b = blockIdx.z;
  const __nv_bfloat16* xb = x + static_cast<size_t>(b) * U * I2;
  const int chunks = I2 / kKC;
  const int steps = chunks * kTaps;

  // the slab of chunk c: rows m0-12 .. m0+BM+11 of xp, zero outside [0, U)
  auto load_slab = [&](int c) {
    const uint32_t dst = slabs + (c & 1) * kSlabBytes;
    for (int idx = tid; idx < kSlab * (kKC / 8); idx += kThreads) {
      const int s = idx / (kKC / 8), q = idx % (kKC / 8);
      const int r = m0 - kHalo + s;
      const bool inside = r >= 0 && r < U;
      const __nv_bfloat16* src = xb + static_cast<size_t>(inside ? r : 0) * I2 + c * kKC + q * 8;
      cp_async16(dst + s * (kLdx * 2) + q * 16, src, inside ? 16 : 0);
    }
  };
  // the weight tile of step j (chunk j / 25, tap j % 25) into its ring
  // stage, 16-byte chunk q of row n at chunk q ^ (n % 8) (128-byte swizzle)
  auto load_stage = [&](int j) {
    const int a = j % kTaps, c = j / kTaps;
    const uint32_t dst = ring + (j % kStages) * kStageBytes;
    const __nv_bfloat16* src = vt + (static_cast<size_t>(a) * Opad + n0) * I2 + c * kKC;
#pragma unroll
    for (int it = 0; it < kBN * (kKC / 8) / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int n = idx / (kKC / 8), q = idx % (kKC / 8);
      cp_async16(dst + n * (kKC * 2) + ((q ^ (n % 8)) * 16),
                 src + static_cast<size_t>(n) * I2 + q * 8, 16);
    }
  };

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  // A fragments of this lane: matrix lane/8 of ldmatrix.x4 is (rows +8 if
  // odd, k +8 if >= 2), so the lane points at row lane%16, k (lane/16)*8
  const uint32_t a_base =
      slabs + ((warp / 4) * 64 + (warp % 4) * 16 + lane % 16) * (kLdx * 2) + (lane / 16) * 16;

  // prologue: the first kStages-1 steps' tiles (and chunk 0's slab), one
  // commit group a step
  load_slab(0);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < steps) load_stage(j);
    cp_async_commit();
  }

  for (int t = 0; t < steps; ++t) {
    const int a = t % kTaps, c = t / kTaps;
    // step t's group has landed (groups of steps t+1 .. t+kStages-2 may
    // not); every warpgroup has retired step t-1's products (wait_group 0
    // at its end), so its stage, and at a = 0 the slab buffer of chunk
    // c-1, are free again
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();
    if (t + kStages - 1 < steps) load_stage(t + kStages - 1);
    if (a == 0 && c + 1 < chunks) load_slab(c + 1);
    cp_async_commit();

    uint32_t af[kKC / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk) {
      ldmatrix_x4(a_base + (c & 1) * kSlabBytes + a * (kLdx * 2) + kk * 32, af[kk]);
    }
    const uint64_t desc = b128_desc(ring + (t % kStages) * kStageBytes);
#pragma unroll
    for (int i = 0; i < 128; ++i) fence_operand(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk) {
      // k16 step kk: 32 bytes further along each swizzled 128-byte row
      wgmma_m64n256k16(acc, af[kk], desc + 2 * kk);
    }
    wgmma_commit();
    // All of the step's products retire here, before the next step's
    // ldmatrix redefines af. (With one group left in flight, ptxas
    // serializes the wgmmas anyway, C7513, and the step took no less.)
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 128; ++i) fence_operand(acc[i]);
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: accumulators -> cs (element (m, n) at n*kLdc + m). Register
  // i of this thread is row 16*(warp%4) + lane/4 + 8*((i/2)%2) of its
  // warpgroup's 64 rows and column 8*(i/4) + 2*(lane%4) + i%2.
  {
    const int row = (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
    for (int i = 0; i < 128; ++i) {
      const int m = row + 8 * ((i / 2) % 2);
      const int n = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
      cs[n * kLdc + m] = acc[i];
    }
  }
  __syncthreads();
  __nv_bfloat16* yb = y + static_cast<size_t>(b) * O * U;
  for (int idx = tid; idx < kBN * kBM; idx += kThreads) {
    const int n = idx / kBM, m = idx % kBM;
    const int o = n0 + n, u = m0 + m;
    if (o < O && u < U) {
      const float val = cs[n * kLdc + m] + __bfloat162float(bias[o]);
      yb[static_cast<size_t>(o) * U + u] = __float2bfloat16(fmaxf(val, 0.f));
    }
  }
}

}  // namespace bf16

// -- float32: full-float32 FMA on the SIMT cores ---------------------------

namespace f32 {

constexpr int kBM = 64;                 // output rows u per CTA
constexpr int kBN = 128;                // output channels o per CTA
constexpr int kThreads = 256;
constexpr int kSlab = kBM + 2 * kHalo;
constexpr int kLdc = kBM + 4;           // epilogue tile, column-major [BN][LDC] float
constexpr int kKC = 16;                 // K chunk
constexpr int kLdx = kKC + 4;           // slab row pitch (elements)
constexpr int kLdw = kBN + 4;           // weight tile row pitch (elements)
constexpr size_t kXsBytes = sizeof(float) * kSlab * kLdx;
constexpr size_t kWsBytes = sizeof(float) * kKC * kLdw;  // one buffer
constexpr size_t kMainBytes = kXsBytes + 2 * kWsBytes;
constexpr size_t kEpiBytes = sizeof(float) * kBN * kLdc;
constexpr size_t kSmemBytes = kMainBytes > kEpiBytes ? kMainBytes : kEpiBytes;

__global__ void __launch_bounds__(kThreads)
conv0_f32_kernel(const float* __restrict__ x,     // [B, T, I] = [B, U, 2I]
                 const float* __restrict__ v,     // [25, 2I, Opad]
                 const float* __restrict__ bias,  // [O]
                 float* __restrict__ y,           // [B, O, U]
                 int U, int I2, int O, int Opad) {
  constexpr int EPV = 4;                        // elements per 16-byte vector
  constexpr int XVEC = kKC / EPV;               // vectors per slab row chunk
  constexpr int WVEC = kBN / EPV;               // vectors per weight tile row
  constexpr int WLOADS = kKC * WVEC / kThreads;  // weight vectors per thread
  static_assert(kKC * WVEC % kThreads == 0, "weight tile split");

  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);                       // [kSlab][kLdx]
  float* ws = reinterpret_cast<float*>(smem + kXsBytes);            // 2 x [kKC][kLdw]
  float* cs = reinterpret_cast<float*>(smem);                       // [kBN][kLdc]

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int b = blockIdx.z;
  const float* xb = x + static_cast<size_t>(b) * U * I2;

  // thread (tm, tn) owns rows tm*4 + i and columns tn + 16 j
  const int tm = tid / 16, tn = tid % 16;
  float facc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) facc[i][j] = 0.f;

  uint4 wreg[WLOADS];
  auto fetch_weights = [&](int a, int k0) {
#pragma unroll
    for (int it = 0; it < WLOADS; ++it) {
      const int idx = tid + it * kThreads;
      const int kk = idx / WVEC, c = idx % WVEC;
      const float* src = v + (static_cast<size_t>(a) * I2 + k0 + kk) * Opad + n0 + c * EPV;
      wreg[it] = *reinterpret_cast<const uint4*>(src);
    }
  };
  auto store_weights = [&](float* dst_buf) {
#pragma unroll
    for (int it = 0; it < WLOADS; ++it) {
      const int idx = tid + it * kThreads;
      const int kk = idx / WVEC, c = idx % WVEC;
      *reinterpret_cast<uint4*>(dst_buf + kk * kLdw + c * EPV) = wreg[it];
    }
  };

  for (int k0 = 0; k0 < I2; k0 += kKC) {
    // the previous chunk's last barrier retired every read of xs and ws
    for (int idx = tid; idx < kSlab * XVEC; idx += kThreads) {
      const int s = idx / XVEC, c = idx % XVEC;
      const int r = m0 - kHalo + s;  // phase-stacked row
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r >= 0 && r < U) {
        val = *reinterpret_cast<const uint4*>(xb + static_cast<size_t>(r) * I2 + k0 + c * EPV);
      }
      *reinterpret_cast<uint4*>(xs + s * kLdx + c * EPV) = val;
    }
    fetch_weights(0, k0);
    store_weights(ws);
    __syncthreads();

    for (int a = 0; a < kTaps; ++a) {
      if (a + 1 < kTaps) fetch_weights(a + 1, k0);
      const float* wcur = ws + (a & 1) * (kKC * kLdw);
#pragma unroll
      for (int kk = 0; kk < kKC; ++kk) {
        float xa[4], wb[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) xa[i] = xs[(tm * 4 + i + a) * kLdx + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) wb[j] = wcur[kk * kLdw + tn + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) facc[i][j] = fmaf(xa[i], wb[j], facc[i][j]);
      }
      if (a + 1 < kTaps) store_weights(ws + ((a + 1) & 1) * (kKC * kLdw));
      __syncthreads();
    }
  }

  // epilogue: accumulators -> cs (column-major: element (m, n) at n*kLdc + m)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) cs[(tn + 16 * j) * kLdc + tm * 4 + i] = facc[i][j];
  __syncthreads();
  float* yb = y + static_cast<size_t>(b) * O * U;
  for (int idx = tid; idx < kBN * kBM; idx += kThreads) {
    const int n = idx / kBM, m = idx % kBM;
    const int o = n0 + n, u = m0 + m;
    if (o < O && u < U) {
      const float val = cs[n * kLdc + m] + bias[o];
      yb[static_cast<size_t>(o) * U + u] = fmaxf(val, 0.f);
    }
  }
}

}  // namespace f32

int round_up(int n, int m) { return (n + m - 1) / m * m; }

template <typename T, bool kKMajor>
cudaError_t launch_phase_weights(const void* w, void* v, int I, int O, int Opad,
                                 cudaStream_t stream) {
  const size_t total = static_cast<size_t>(kTaps) * 2 * I * Opad;
  const int blocks = static_cast<int>((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  conv0_phase_weights_kernel<T, kKMajor><<<blocks, 256, 0, stream>>>(
      static_cast<const T*>(w), static_cast<T*>(v), I, O, Opad);
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

cudaError_t launch_bf16(const void* x, const void* w, const void* bias, void* v, void* y,
                        int B, int Tn, int I, int O, cudaStream_t stream) {
  const int U = Tn / 2, I2 = 2 * I, Opad = round_up(O, bf16::kBN);
  if (Tn % 2 != 0 || I2 % bf16::kKC != 0) return cudaErrorInvalidValue;
  cudaError_t err = launch_phase_weights<__nv_bfloat16, true>(w, v, I, O, Opad, stream);
  if (err != cudaSuccess) return err;
  err = allow_smem(bf16::conv0_bf16_kernel, bf16::kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((U + bf16::kBM - 1) / bf16::kBM, Opad / bf16::kBN, B);
  bf16::conv0_bf16_kernel<<<grid, bf16::kThreads, bf16::kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(y), U, I2, O, Opad);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* x, const void* w, const void* bias, void* v, void* y,
                       int B, int Tn, int I, int O, cudaStream_t stream) {
  const int U = Tn / 2, I2 = 2 * I, Opad = round_up(O, f32::kBN);
  if (Tn % 2 != 0 || I2 % f32::kKC != 0) return cudaErrorInvalidValue;
  cudaError_t err = launch_phase_weights<float, false>(w, v, I, O, Opad, stream);
  if (err != cudaSuccess) return err;
  err = allow_smem(f32::conv0_f32_kernel, f32::kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((U + f32::kBM - 1) / f32::kBM, Opad / f32::kBN, B);
  f32::conv0_f32_kernel<<<grid, f32::kThreads, f32::kSmemBytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(v),
      static_cast<const float*>(bias), static_cast<float*>(y), U, I2, O, Opad);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements of the phase-stacked weight scratch the wrapper allocates:
// 25 * 2I * O rounded up to the wider (bf16) tile, enough for either type.
size_t conv0_scratch_elements(int I, int O) {
  return static_cast<size_t>(kTaps) * 2 * I * round_up(O, bf16::kBN);
}

// Dynamic shared memory of one CTA of the conv kernel for `dtype` (as in
// conv0_forward); ptxas's report counts only static shared memory.
size_t conv0_smem_bytes(int dtype) {
  return dtype == 1 ? bf16::kSmemBytes : f32::kSmemBytes;
}

// x [B, T, I], w [O, I, 48], bias [O], v scratch, y [B, O, T/2], all of one
// type: dtype 0 = float32, 1 = bfloat16. Launches on `stream` and returns
// cudaGetLastError(): a refused launch never runs, and only this shows it.
int conv0_forward(const void* x, const void* w, const void* bias, void* v, void* y,
                  int dtype, int B, int T, int I, int O, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || O == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      err = launch_f32(x, w, bias, v, y, B, T, I, O, s);
      break;
    case 1:
      err = launch_bf16(x, w, bias, v, y, B, T, I, O, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* conv0_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
