// Flash attention (forward) for Hopper (sm_90a), hand-written.  Built by
// nvcc into a shared library with a plain C interface and loaded with
// ctypes (repro_torch/kernels/_build.py).
//
// Replaces the JAX reference's Pallas TPU kernel in
// src/repro/kernels/flash_attention.py: _flash_kernel, run by
// flash_attention_single (one (S, hd) problem) and flash_attention
// (GQA over (B, S, Hq, hd), vmapped over batch and head groups).
//
// What it computes is the reference's function: every product, the
// online softmax and the output in float32, whatever the input type
// (float32, bfloat16 or float16 are loaded and widened); masked scores
// and the initial running max are -1e30; the causal mask is top-left
// aligned (key j is seen by query i iff j <= i, also when T != S); the
// output is cast back to the input type.  Query head h reads kv head
// h / (Hq / Hkv).  Tiles above the diagonal are skipped, which changes
// only the rounding, as in the reference.
//
// What bounds it: operations.  At B=1, S=T=4096, Hq=32, hd=128, causal,
// it does 4*Hq*hd*S(S+1)/2 = 1.375e11 FLOP on 160 MiB (float32) of
// input and output: 2.05 ms at the H100's 67 TFLOP/s of IEEE float32
// on the CUDA cores, against 0.05 ms to move the bytes.  The tensor
// cores' TF32 keeps about three digits, too few for the 2e-5 the
// reference's tests hold float32 to, so this kernel stays on the CUDA
// cores for every input type (bfloat16 on the tensor cores, at 0.139 ms
// for the same shape, is later work with wgmma and TMA).
//
// What the design does about it:
//   * the TPU kernel carries the running max, denominator and
//     accumulator across a sequential kv grid axis; a CUDA grid has no
//     order, so one block owns a 64-row query tile of one (batch, head)
//     and a loop inside it walks the 64-row kv tiles, stopping at the
//     diagonal when causal.  The grid is (query tile, batch x q head);
//     the heaviest causal tiles are launched first;
//   * register tiling: each of the 128 threads owns 8 query rows x 4
//     key columns of the score tile and 8 rows x hd/16 columns of the
//     output accumulator, so each float4 read from shared memory feeds
//     8 to 32 FMAs; the 16 threads that share a row reduce its max and
//     sum with warp shuffles;
//   * Q, K and V tiles are widened to float32 once, into shared memory
//     whose rows are padded by 4 floats (conflict-free float4 reads);
//     the probability tile reuses the K tile's space, so that at
//     hd=128 two blocks fit on an SM (98 KB each, above the 48 KB
//     default: cudaFuncSetAttribute raises the limit);
//   * inputs are read through their (batch, seq, head) strides, with
//     64-bit offsets (B*S*H*hd passes 2^31 at long contexts), so the
//     (B, S, H, hd) layout needs no transpose; rows past S or T are
//     zero-filled on load and masked, so S and T need not be multiples
//     of the tile;
//   * expf and IEEE division, no fast-math: the float32 path agrees
//     with the plain version to ~1e-6.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // key / value rows per tile
constexpr int kThreads = 128;    // 8 row groups x 16 column groups
constexpr int kRows = 8;         // query rows per thread
constexpr int kGroups = 16;      // threads sharing a row
constexpr int kCols = kBK / kGroups;   // score columns per thread
constexpr int kMaxGridY = 65535;
constexpr float kMasked = -1e30f;

struct Strides {
  long long b, s, h;             // in elements; the head dim is dense
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int n_heads, group;            // Hq, Hq / Hkv
  long long S, T;
  Strides qs, ks, vs, os;
  int causal;
  float scale;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

template <class E>
__device__ __forceinline__ E narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half narrow<__half>(float x) {
  return __float2half_rn(x);
}

// rows [r0, r0 + kRowsTile) of one head into shared memory as float32
// (row stride ld), zeros past n
template <class E, int HD, int kRowsTile>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const E* __restrict__ src,
                                          long long stride, long long r0,
                                          long long n) {
  for (int idx = threadIdx.x; idx < kRowsTile * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const long long row = r0 + r;
    dst[r * ld + d] = row < n ? widen(src[row * stride + d]) : 0.f;
  }
}

template <class E, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd(const Args a) {
  constexpr int kLd = HD + 4;          // Q and K rows, padded
  constexpr int kLdP = kBK + 4;        // probability rows, padded
  constexpr int kVec = HD / 64;        // float4 output chunks per thread
  static_assert(kBK * kLd >= kBQ * kLdP, "P must fit in the K tile");
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);   // kBQ x kLd
  float* sK = sQ + kBQ * kLd;                    // kBK x kLd
  float* sV = sK + kBK * kLd;                    // kBK x HD
  float* sP = sK;                                // kBQ x kLdP, after S

  const int rg = threadIdx.x / kGroups, cg = threadIdx.x % kGroups;
  const long long q0 =
      static_cast<long long>(gridDim.x - 1 - blockIdx.x) * kBQ;
  const int b = blockIdx.y / a.n_heads, h = blockIdx.y % a.n_heads;
  const int hk = h / a.group;
  const E* qp = static_cast<const E*>(a.q) + b * a.qs.b + h * a.qs.h;
  const E* kp = static_cast<const E*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const E* vp = static_cast<const E*>(a.v) + b * a.vs.b + hk * a.vs.h;
  E* op = static_cast<E*>(a.o) + b * a.os.b + h * a.os.h;

  load_tile<E, HD, kBQ>(sQ, kLd, qp, a.qs.s, q0, a.S);

  float m[kRows], l[kRows], acc[kRows][kVec][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kVec; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  // top-left causal mask: query rows q0 .. q0+kBQ-1 see keys <= their row
  const long long kv_end =
      a.causal ? (a.T < q0 + kBQ ? a.T : q0 + kBQ) : a.T;
  const long long n_tiles = (kv_end + kBK - 1) / kBK;

  for (long long t = 0; t < n_tiles; ++t) {
    const long long k0 = t * kBK;
    __syncthreads();                   // the last tile's P and V are read
    load_tile<E, HD, kBK>(sK, kLd, kp, a.ks.s, k0, a.T);
    load_tile<E, HD, kBK>(sV, HD, vp, a.vs.s, k0, a.T);
    __syncthreads();

    // scores: s = q . k * scale, then the mask
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 kv[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        kv[j] = *reinterpret_cast<const float4*>(
            &sK[(cg + kGroups * j) * kLd + d]);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&sQ[(rg * kRows + i) * kLd + d]);
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
        }
      }
    }
    const bool edge = (a.causal && k0 + kBK - 1 > q0) || k0 + kBK > a.T;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const long long row = q0 + rg * kRows + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        float x = s[i][j] * a.scale;
        if (edge) {
          const long long col = k0 + cg + kGroups * j;
          if (col >= a.T || (a.causal && col > row)) x = kMasked;
        }
        s[i][j] = x;
      }
    }

    // online softmax over the 16 threads of each row
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < kCols; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int w = 1; w < kGroups; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int w = 1; w < kGroups; w <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kVec; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= corr;
    }

    __syncthreads();                   // every thread is done with sK
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        sP[(rg * kRows + i) * kLdP + cg + kGroups * j] = s[i][j];
    __syncthreads();

    // acc += P V
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 vv[4][kVec];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < kVec; ++c)
          vv[r][c] = *reinterpret_cast<const float4*>(
              &sV[(kk + r) * HD + c * 64 + cg * 4]);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 p =
            *reinterpret_cast<const float4*>(&sP[(rg * kRows + i) * kLdP + kk]);
        const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < kVec; ++c) {
            acc[i][c][0] = fmaf(pr[r], vv[r][c].x, acc[i][c][0]);
            acc[i][c][1] = fmaf(pr[r], vv[r][c].y, acc[i][c][1]);
            acc[i][c][2] = fmaf(pr[r], vv[r][c].z, acc[i][c][2]);
            acc[i][c][3] = fmaf(pr[r], vv[r][c].w, acc[i][c][3]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long long row = q0 + rg * kRows + i;
    if (row >= a.S) continue;
    E* dst = op + row * a.os.s + cg * 4;
#pragma unroll
    for (int c = 0; c < kVec; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[c * 64 + e] = narrow<E>(acc[i][c][e] / l[i]);
  }
}

template <class E, int HD>
int launch(const Args& a, int batch, cudaStream_t stream) {
  constexpr size_t smem = static_cast<size_t>(
      (kBQ + kBK) * (HD + 4) + kBK * HD) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fwd<E, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((a.S + kBQ - 1) / kBQ),
                  static_cast<unsigned>(batch * a.n_heads), 1);
  flash_attention_fwd<E, HD><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <class E>
int launch_hd(int hd, const Args& a, int batch, cudaStream_t stream) {
  switch (hd) {
    case 64: return launch<E, 64>(a, batch, stream);
    case 128: return launch<E, 128>(a, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// o = attention(q, k, v) over (B, S, Hq, hd) queries and (B, T, Hkv, hd)
// keys and values, each read through its (batch, seq, head) strides in
// elements (the head dim dense).  dtype: 0 float32, 1 bfloat16,
// 2 float16.  hd: 64 or 128.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments it does not take.
int dart_flash_attention(const void* q, const void* k, const void* v,
                         void* o, int batch, long long S, long long T,
                         int n_heads, int n_kv_heads, int hd,
                         long long qsb, long long qss, long long qsh,
                         long long ksb, long long kss, long long ksh,
                         long long vsb, long long vss, long long vsh,
                         long long osb, long long oss, long long osh,
                         int dtype, int causal, float scale, void* stream) {
  if (batch <= 0 || S <= 0 || T <= 0 || n_heads <= 0 || n_kv_heads <= 0 ||
      n_heads % n_kv_heads != 0 ||
      static_cast<long long>(batch) * n_heads > kMaxGridY ||
      (S + kBQ - 1) / kBQ > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, n_heads, n_heads / n_kv_heads, S, T,
               {qsb, qss, qsh}, {ksb, kss, ksh}, {vsb, vss, vsh},
               {osb, oss, osh}, causal != 0, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_hd<float>(hd, a, batch, st);
    case 1: return launch_hd<__nv_bfloat16>(hd, a, batch, st);
    case 2: return launch_hd<__half>(hd, a, batch, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* dart_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
