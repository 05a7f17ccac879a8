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
// without a copy. The weight [O, I, 48] (the port's layout) is
// rearranged at every call into V [25, 2I, Opad] (Opad = O rounded up to
// the tile width, zero columns beyond O) by a small first kernel; its time
// is part of the call's.
//
// What bounds it on this card. At the main shape (B=64, T=1024, I=128,
// O=250, bf16) the layer does 2*B*U*O*48*I = 0.101 T operations, 0.1018 ms
// at the dense bf16 tensor-core rate (989 TFLOP/s), and moves 36.2 MB
// (x, w, bias, y once each), 0.011 ms at 3.35 TB/s. So it is bound by
// operations: the work must run on the tensor cores, and each value loaded
// into shared memory must feed many products.
//
// Design (simple and right first; wgmma, TMA and a persistent schedule
// are later work):
// - One CTA per (batch row, tile of BM=64 output rows u, tile of BN=128
//   output channels o); 8 warps, each a 32x32 piece of the tile.
// - K (the 2I phase-stacked channels) runs in chunks of KC. For each chunk
//   the CTA loads the slab of BM+24 phase-stacked rows into shared memory
//   once, and all 25 taps read their shifted window of it: the reuse the
//   Pallas kernel gets from holding one padded row in VMEM.
// - Per tap, the [KC, BN] weight tile is double-buffered in shared memory:
//   the next tap's tile is fetched into registers while the current one
//   feeds the products, so there is one barrier per tap.
// - bf16: nvcuda::wmma 16x16x16 bf16 fragments with float32 accumulators
//   on the tensor cores. float32: full-float32 FMA on the SIMT cores, no
//   TF32 (the card-vs-CPU parity runs in float32).
// - Epilogue: the accumulators go through shared memory, then bias in
//   float32, ReLU, one cast, stored along u (coalesced in [B, O, U]); the
//   ragged edges of U and O are masked here.
// Shared-memory pointers of the fragments are 32-byte aligned and every
// leading dimension is a multiple of 16 elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kWidth = 48;
constexpr int kHalo = 12;
constexpr int kTaps = 2 * kHalo + 1;
constexpr int kBM = 64;                 // output rows u per CTA
constexpr int kBN = 128;                // output channels o per CTA
constexpr int kThreads = 256;           // 8 warps
constexpr int kSlab = kBM + 2 * kHalo;  // phase-stacked rows a CTA reads
constexpr int kLdc = kBM + 4;           // epilogue tile, column-major [BN][LDC] float

template <typename T>
struct Tile;

template <>
struct Tile<__nv_bfloat16> {
  static constexpr int kKC = 32;        // K chunk
  static constexpr int kLdx = kKC + 16; // slab row pitch (elements)
  static constexpr int kLdw = kBN + 16; // weight tile row pitch (elements)
};

template <>
struct Tile<float> {
  static constexpr int kKC = 16;
  static constexpr int kLdx = kKC + 4;
  static constexpr int kLdw = kBN + 4;
};

template <typename T>
struct Smem {
  static constexpr int kKC = Tile<T>::kKC;
  static constexpr size_t kXsBytes = sizeof(T) * kSlab * Tile<T>::kLdx;
  static constexpr size_t kWsBytes = sizeof(T) * kKC * Tile<T>::kLdw;  // one buffer
  static constexpr size_t kMainBytes = kXsBytes + 2 * kWsBytes;
  static constexpr size_t kEpiBytes = sizeof(float) * kBN * kLdc;
  static constexpr size_t kBytes = kMainBytes > kEpiBytes ? kMainBytes : kEpiBytes;
};

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

// V [25, 2I, Opad] from w [O, I, 48]: tap a holds w[.., 2a-1] in rows k < I
// and w[.., 2a] in rows k >= I; zero where that tap is outside [0, 48) and
// in the columns o >= O.
template <typename T>
__global__ void conv0_phase_weights_kernel(const T* __restrict__ w, T* __restrict__ v,
                                           int I, int O, int Opad) {
  const int I2 = 2 * I;
  const size_t total = static_cast<size_t>(kTaps) * I2 * Opad;
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       idx < total; idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int o = static_cast<int>(idx % Opad);
    const int k = static_cast<int>((idx / Opad) % I2);
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv0_kernel(const T* __restrict__ x,     // [B, T, I] = [B, U, 2I]
             const T* __restrict__ v,     // [25, 2I, Opad]
             const T* __restrict__ bias,  // [O]
             T* __restrict__ y,           // [B, O, U]
             int U, int I2, int O, int Opad) {
  constexpr int KC = Tile<T>::kKC;
  constexpr int LDX = Tile<T>::kLdx;
  constexpr int LDW = Tile<T>::kLdw;
  constexpr int EPV = 16 / sizeof(T);           // elements per 16-byte vector
  constexpr int XVEC = KC / EPV;                // vectors per slab row chunk
  constexpr int WVEC = kBN / EPV;               // vectors per weight tile row
  constexpr int WLOADS = KC * WVEC / kThreads;  // weight vectors per thread
  static_assert(KC * WVEC % kThreads == 0, "weight tile split");

  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);                               // [kSlab][LDX]
  T* ws = reinterpret_cast<T*>(smem + Smem<T>::kXsBytes);           // 2 x [KC][LDW]
  float* cs = reinterpret_cast<float*>(smem);                       // [kBN][kLdc]

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int b = blockIdx.z;
  const T* xb = x + static_cast<size_t>(b) * U * I2;

  // bf16: warp (wm, wn) owns rows wm*32.. and columns wn*32.. of the tile.
  // float32: thread (tm, tn) owns rows tm*4 + i and columns tn + 16 j.
  const int warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int tm = tid / 16, tn = tid % 16;

  constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  float facc[4][8];
  if constexpr (kTensorCores) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) facc[i][j] = 0.f;
  }

  uint4 wreg[WLOADS];
  auto fetch_weights = [&](int a, int k0) {
#pragma unroll
    for (int it = 0; it < WLOADS; ++it) {
      const int idx = tid + it * kThreads;
      const int kk = idx / WVEC, c = idx % WVEC;
      const T* src = v + (static_cast<size_t>(a) * I2 + k0 + kk) * Opad + n0 + c * EPV;
      wreg[it] = *reinterpret_cast<const uint4*>(src);
    }
  };
  auto store_weights = [&](T* dst_buf) {
#pragma unroll
    for (int it = 0; it < WLOADS; ++it) {
      const int idx = tid + it * kThreads;
      const int kk = idx / WVEC, c = idx % WVEC;
      *reinterpret_cast<uint4*>(dst_buf + kk * LDW + c * EPV) = wreg[it];
    }
  };

  for (int k0 = 0; k0 < I2; k0 += KC) {
    // the previous chunk's last barrier retired every read of xs and ws
    for (int idx = tid; idx < kSlab * XVEC; idx += kThreads) {
      const int s = idx / XVEC, c = idx % XVEC;
      const int r = m0 - kHalo + s;  // phase-stacked row
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r >= 0 && r < U) {
        val = *reinterpret_cast<const uint4*>(xb + static_cast<size_t>(r) * I2 + k0 + c * EPV);
      }
      *reinterpret_cast<uint4*>(xs + s * LDX + c * EPV) = val;
    }
    fetch_weights(0, k0);
    store_weights(ws);
    __syncthreads();

    for (int a = 0; a < kTaps; ++a) {
      if (a + 1 < kTaps) fetch_weights(a + 1, k0);
      const T* wcur = ws + (a & 1) * (KC * LDW);
      if constexpr (kTensorCores) {
#pragma unroll
        for (int kk = 0; kk < KC; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            wmma::load_matrix_sync(af[i], xs + (wm * 32 + i * 16 + a) * LDX + kk, LDX);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            wmma::load_matrix_sync(bf[j], wcur + kk * LDW + wn * 32 + j * 16, LDW);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) {
          float xa[4], wb[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) xa[i] = to_float(xs[(tm * 4 + i + a) * LDX + kk]);
#pragma unroll
          for (int j = 0; j < 8; ++j) wb[j] = to_float(wcur[kk * LDW + tn + 16 * j]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) facc[i][j] = fmaf(xa[i], wb[j], facc[i][j]);
        }
      }
      if (a + 1 < kTaps) store_weights(ws + ((a + 1) & 1) * (KC * LDW));
      __syncthreads();
    }
  }

  // epilogue: accumulators -> cs (column-major: element (m, n) at n*kLdc + m)
  if constexpr (kTensorCores) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(cs + (wn * 32 + j * 16) * kLdc + wm * 32 + i * 16,
                                acc[i][j], kLdc, wmma::mem_col_major);
      }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) cs[(tn + 16 * j) * kLdc + tm * 4 + i] = facc[i][j];
  }
  __syncthreads();
  T* yb = y + static_cast<size_t>(b) * O * U;
  for (int idx = tid; idx < kBN * kBM; idx += kThreads) {
    const int n = idx / kBM, m = idx % kBM;
    const int o = n0 + n, u = m0 + m;
    if (o < O && u < U) {
      const float val = cs[n * kLdc + m] + to_float(bias[o]);
      yb[static_cast<size_t>(o) * U + u] = from_float<T>(fmaxf(val, 0.f));
    }
  }
}

int round_up(int n, int m) { return (n + m - 1) / m * m; }

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* bias, void* v, void* y,
                   int B, int Tn, int I, int O, cudaStream_t stream) {
  const int U = Tn / 2, I2 = 2 * I, Opad = round_up(O, kBN);
  if (Tn % 2 != 0 || I2 % Tile<T>::kKC != 0 || (I2 * sizeof(T)) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const size_t total = static_cast<size_t>(kTaps) * I2 * Opad;
  const int prep_blocks = static_cast<int>((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  conv0_phase_weights_kernel<T><<<prep_blocks, 256, 0, stream>>>(
      static_cast<const T*>(w), static_cast<T*>(v), I, O, Opad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t smem = Smem<T>::kBytes;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(conv0_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid((U + kBM - 1) / kBM, Opad / kBN, B);
  conv0_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(v), static_cast<const T*>(bias),
      static_cast<T*>(y), U, I2, O, Opad);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements of the V [25, 2I, Opad] scratch the wrapper allocates.
size_t conv0_scratch_elements(int I, int O) {
  return static_cast<size_t>(kTaps) * 2 * I * round_up(O, kBN);
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
      err = launch<float>(x, w, bias, v, y, B, T, I, O, s);
      break;
    case 1:
      err = launch<__nv_bfloat16>(x, w, bias, v, y, B, T, I, O, s);
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
