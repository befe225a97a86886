// Segmented copy and read-modify-write for DART's one-sided put/get
// path and its reduction plane, hand-written for Hopper (sm_90a).  Built
// by nvcc into a shared library with a plain C interface and loaded with
// ctypes (repro_torch/kernels/_build.py).
//
// Replaces the JAX reference's Pallas TPU kernels in
// src/repro/kernels/segmented_copy.py:
//   * _pallas_scatter_kernel / _pallas_scatter  -> segmented_scatter
//     (disjoint runs) and segmented_scatter_ordered (overlapping runs);
//   * _pallas_gather_kernel  / _pallas_gather   -> segmented_gather;
//   * _pallas_acc_kernel     / _pallas_accumulate -> segmented_accumulate
//     (disjoint runs, and with an output the fused get_accumulate) and
//     segmented_accumulate_ordered (overlapping runs), further below.
//
// Descriptor i of the (kb, 6) int32 table is (row, off, len, start,
// stride, count): count segments of len bytes, stride bytes apart, from
// byte off of arena row row; its payload lies densely at start of the
// flat buffer.  Dense lane l < len*count is arena byte
//     row*P + off + (l / len)*stride + l % len,
// the reference's flat-index formula.  Index arithmetic is 64-bit.
//
// What bounds it: bytes.  A put reads each payload byte once and writes
// each arena byte once; a get reads each addressed arena byte once and
// writes kb*seg output bytes.  There is no arithmetic to speak of, so
// the floor is (bytes read + bytes written) / 3.35 TB/s.
//
// What the design does about it:
//   * every thread moves 16 lanes; where the 16 lanes are one aligned
//     run of one segment on both sides it moves them as one 16-byte
//     vector (128-byte-aligned allocations, payloads of multiples of
//     16 bytes), otherwise byte by byte.  A run whose offsets or payload
//     sizes are not multiples of 16 takes the byte loop for nearly every
//     lane and runs far from the bound; realigning each segment (load
//     aligned words and funnel-shift them, or stage the source through
//     shared memory, so that full destination chunks are vector stores)
//     is the next step;
//   * the disjoint scatter and the gather are one parallel grid over
//     (lane chunk, descriptor), so a coalesced run of many puts fills
//     the card in one launch;
//   * the TPU kernel is ordered for free (its grid runs in sequence);
//     a CUDA grid is not.  Overlapping runs (last writer wins) go to
//     segmented_scatter_ordered: ONE block walks the descriptors in
//     table order with a __syncthreads() between them, which makes each
//     descriptor's stores visible before the next one's are issued.
//     It is correct and slow for large runs; runs that the engine
//     proves disjoint never take it.
//   * a descriptor that would reach outside the arena or the flat
//     buffer moves nothing (a put) or reads as zeros (a get), like the
//     reference's mode='drop' / mode='fill'; the engine never makes one.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRow = 0, kOff = 1, kLen = 2, kStart = 3, kStride = 4,
              kCount = 5, kCols = 6;
constexpr int kVec = 16;               // lanes per thread step (one uint4)
constexpr int kThreads = 256;          // parallel kernels
constexpr int kOrderedThreads = 1024;  // the ordered scatter's one block
constexpr long long kMaxGridX = 1 << 20;
constexpr int kMaxGridY = 65535;

struct Seg {
  long long base;    // row * P + off
  long long len;     // bytes per segment
  long long stride;  // bytes between segment starts
  long long total;   // len * count lanes; 0 for padding or out of range
  long long start;   // first payload byte in the flat buffer
};

__device__ __forceinline__ Seg load_desc(const int* __restrict__ desc,
                                         long long i, long long pool_bytes,
                                         long long n_cells,
                                         long long flat_len,
                                         int cols = kCols) {
  const int* d = desc + i * cols;
  Seg s;
  s.len = d[kLen];
  const long long count = d[kCount];
  s.stride = d[kStride];
  s.start = d[kStart];
  s.base = static_cast<long long>(d[kRow]) * pool_bytes + d[kOff];
  s.total = (s.len > 0 && count > 0) ? s.len * count : 0;
  if (s.total > 0) {
    const long long last = s.base + (count - 1) * s.stride + s.len;
    const bool inside = d[kRow] >= 0 && d[kOff] >= 0 && s.stride >= 0 &&
                        s.base >= 0 && last <= n_cells &&
                        (count == 1 || s.stride >= s.len) &&
                        s.start >= 0 &&
                        (flat_len < 0 || s.start + s.total <= flat_len);
    if (!inside) s.total = 0;
  }
  return s;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & (kVec - 1)) == 0;
}

// Lanes [l0, l0 + 16) of one descriptor: flat -> arena.
__device__ __forceinline__ void scatter16(uint8_t* __restrict__ arena,
                                          const uint8_t* __restrict__ flat,
                                          const Seg& s, long long l0) {
  const long long n = (s.total - l0 < kVec) ? s.total - l0 : kVec;
  long long j = l0 / s.len;
  long long r = l0 - j * s.len;
  uint8_t* dst = arena + s.base + j * s.stride + r;
  const uint8_t* src = flat + s.start + l0;
  if (n == kVec && r + kVec <= s.len && aligned16(dst) && aligned16(src)) {
    *reinterpret_cast<uint4*>(dst) =
        __ldg(reinterpret_cast<const uint4*>(src));
    return;
  }
  for (int t = 0; t < n; ++t) {
    arena[s.base + j * s.stride + r] = src[t];
    if (++r == s.len) {
      r = 0;
      ++j;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
segmented_scatter(uint8_t* __restrict__ arena, long long pool_bytes,
                  long long n_cells, const int* __restrict__ desc, int kb,
                  const uint8_t* __restrict__ flat, long long flat_len) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x * kVec;
  const long long first =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * kVec;
  for (long long i = blockIdx.y; i < kb; i += gridDim.y) {
    const Seg s = load_desc(desc, i, pool_bytes, n_cells, flat_len);
    for (long long l0 = first; l0 < s.total; l0 += step)
      scatter16(arena, flat, s, l0);
  }
}

__global__ void __launch_bounds__(kOrderedThreads)
segmented_scatter_ordered(uint8_t* __restrict__ arena, long long pool_bytes,
                          long long n_cells, const int* __restrict__ desc,
                          int kb, const uint8_t* __restrict__ flat,
                          long long flat_len) {
  const long long step = static_cast<long long>(blockDim.x) * kVec;
  for (int i = 0; i < kb; ++i) {
    const Seg s = load_desc(desc, i, pool_bytes, n_cells, flat_len);
    for (long long l0 = static_cast<long long>(threadIdx.x) * kVec;
         l0 < s.total; l0 += step)
      scatter16(arena, flat, s, l0);
    // descriptor i's stores are complete and visible to the whole block
    // before any store of descriptor i + 1 is issued: last writer wins
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
segmented_gather(const uint8_t* __restrict__ arena, long long pool_bytes,
                 long long n_cells, const int* __restrict__ desc, int kb,
                 uint8_t* __restrict__ out, int seg) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x * kVec;
  const long long first =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * kVec;
  for (long long i = blockIdx.y; i < kb; i += gridDim.y) {
    const Seg s = load_desc(desc, i, pool_bytes, n_cells, -1);
    uint8_t* row = out + i * seg;
    for (long long l0 = first; l0 < seg; l0 += step) {
      union {
        uint4 v;
        uint8_t b[kVec];
      } w;
      w.v = make_uint4(0u, 0u, 0u, 0u);
      if (l0 < s.total) {
        const long long n = (s.total - l0 < kVec) ? s.total - l0 : kVec;
        long long j = l0 / s.len;
        long long r = l0 - j * s.len;
        const uint8_t* src = arena + s.base + j * s.stride + r;
        if (n == kVec && r + kVec <= s.len && aligned16(src)) {
          w.v = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          for (int t = 0; t < n; ++t) {
            w.b[t] = arena[s.base + j * s.stride + r];
            if (++r == s.len) {
              r = 0;
              ++j;
            }
          }
        }
      }
      // seg is a power of two >= 16 and out is 16-byte aligned, so every
      // output step is one aligned vector store; lanes past total are 0
      *reinterpret_cast<uint4*>(row + l0) = w.v;
    }
  }
}

// ---------------------------------------------------------------------------
// Segmented read-modify-write (the reduction plane: dart_accumulate and
// dart_get_accumulate).  Replaces _pallas_acc_kernel / _pallas_accumulate
// of src/repro/kernels/segmented_copy.py.
//
// Descriptor i of the (kb, 7) table is the put descriptor plus an op
// column; every lane l < len*count of it is one byte of an element:
//     arena element at row*P + off + (l / len)*stride + l % len
//       = old op payload element at flat[start + l].
// The engine checks at initiation that off, len and stride are
// multiples of the element size, and payload starts are dense sums of
// whole payloads, so each thread loads and stores whole elements.
//
// What bounds it: bytes (read the payload and the arena, write the
// arena, and with a fetch write the (kb, seg) old windows); one
// combine per element is far below the card's arithmetic rate.
//
// What the design does about it:
//   * segmented_accumulate: one parallel grid over (lane chunk,
//     descriptor), 16 bytes per thread step as one vector load of the
//     arena and the payload and one vector store when the chunk is one
//     aligned piece of one segment, element by element otherwise.  The
//     engine proves such runs disjoint (_RunMeta.disjoint), so every
//     element belongs to exactly one thread;
//   * the fused fetch (get_accumulate) is the same grid with an output
//     pointer: the thread that reads an element's old bytes writes them
//     to row i of the output before it stores the new value, and zeros
//     past len*count, so the output equals the plain version's windows.
//     Fetch runs are disjoint by the run rule, so this is the order of
//     the blocking sequence;
//   * segmented_accumulate_ordered: overlapping same-op runs must come
//     out bitwise equal to the blocking order, so float atomics are out
//     (their rounding depends on order).  ONE block walks the
//     descriptors in table order with __syncthreads() between them, as
//     segmented_scatter_ordered does: right, and slow for long runs;
//   * semantics are the reference's (XLA's): integer sum/prod in the
//     unsigned type, so they wrap; float16/bfloat16 via float32 and
//     round to nearest even; min/max propagate NaN and order -0 < +0
//     (never fminf/fmaxf, which drop NaN); no flush of denormals;
//   * a descriptor that would leave the arena or the payload, or is
//     not element-aligned, moves nothing.
// ---------------------------------------------------------------------------

constexpr int kAccCols = 7;
enum { kSum = 0, kProd = 1, kMin = 2, kMax = 3 };

template <int OP>
__device__ __forceinline__ float combine_float(float a, float b) {
  if (OP == kSum) return __fadd_rn(a, b);
  if (OP == kProd) return __fmul_rn(a, b);
  if (a != a || b != b) return __fadd_rn(a, b);  // NaN: the hardware's NaN
  if (OP == kMin) {
    if (a < b) return a;
    if (b < a) return b;
    // equal: identical bits, or +0 and -0, where min is -0
    return __int_as_float(__float_as_int(a) | __float_as_int(b));
  }
  if (a > b) return a;
  if (b > a) return b;
  return __int_as_float(__float_as_int(a) & __float_as_int(b));
}

// Element types by their storage: integers combine natively (sum and
// product through uint32_t, so they wrap), halves through float32.
template <typename S>
struct IntElem {
  using Store = S;
  template <int OP>
  __device__ static __forceinline__ S apply(S a, S b) {
    if (OP == kSum)
      return static_cast<S>(static_cast<uint32_t>(a) +
                            static_cast<uint32_t>(b));
    if (OP == kProd)
      return static_cast<S>(static_cast<uint32_t>(a) *
                            static_cast<uint32_t>(b));
    if (OP == kMin) return b < a ? b : a;
    return a < b ? b : a;
  }
};

struct F32Elem {
  using Store = float;
  template <int OP>
  __device__ static __forceinline__ float apply(float a, float b) {
    return combine_float<OP>(a, b);
  }
};

struct F16Elem {
  using Store = unsigned short;
  template <int OP>
  __device__ static __forceinline__ unsigned short apply(unsigned short a,
                                                         unsigned short b) {
    const float r = combine_float<OP>(__half2float(__ushort_as_half(a)),
                                      __half2float(__ushort_as_half(b)));
    return __half_as_ushort(__float2half_rn(r));
  }
};

struct BF16Elem {
  using Store = unsigned short;
  template <int OP>
  __device__ static __forceinline__ unsigned short apply(unsigned short a,
                                                         unsigned short b) {
    const float r =
        combine_float<OP>(__bfloat162float(__ushort_as_bfloat16(a)),
                          __bfloat162float(__ushort_as_bfloat16(b)));
    return __bfloat16_as_ushort(__float2bfloat16_rn(r));
  }
};

template <typename S>
__device__ __forceinline__ Seg load_acc_desc(const int* __restrict__ desc,
                                             long long i,
                                             long long pool_bytes,
                                             long long n_cells,
                                             long long flat_len) {
  Seg s = load_desc(desc, i, pool_bytes, n_cells, flat_len, kAccCols);
  constexpr long long e = sizeof(S);
  if ((s.base | s.len | s.stride | s.start) % e) s.total = 0;
  return s;
}

// Lanes [l0, l0 + 16) of one accumulate descriptor.  With `old` (the
// fetch output at row i, column l0) the pre-update bytes go there,
// zeros past the descriptor's last lane.
template <class E, int OP>
__device__ __forceinline__ void acc16(uint8_t* __restrict__ arena,
                                      const uint8_t* __restrict__ flat,
                                      const Seg& s, long long l0,
                                      uint8_t* __restrict__ old) {
  using S = typename E::Store;
  constexpr int kE = kVec / static_cast<int>(sizeof(S));
  union Chunk {
    uint4 v;
    S e[kE];
  };
  const long long n = (s.total - l0 < kVec) ? s.total - l0 : kVec;
  long long j = l0 / s.len;
  long long r = l0 - j * s.len;
  uint8_t* dst = arena + s.base + j * s.stride + r;
  const uint8_t* src = flat + s.start + l0;
  if (n == kVec && r + kVec <= s.len && aligned16(dst) && aligned16(src)) {
    Chunk a, p;
    a.v = *reinterpret_cast<const uint4*>(dst);
    p.v = __ldg(reinterpret_cast<const uint4*>(src));
    if (old != nullptr) *reinterpret_cast<uint4*>(old) = a.v;
#pragma unroll
    for (int t = 0; t < kE; ++t)
      a.e[t] = E::template apply<OP>(a.e[t], p.e[t]);
    *reinterpret_cast<uint4*>(dst) = a.v;
    return;
  }
  Chunk w;
  w.v = make_uint4(0u, 0u, 0u, 0u);
  const int ne = static_cast<int>(n / static_cast<long long>(sizeof(S)));
  for (int t = 0; t < ne; ++t) {
    S* d = reinterpret_cast<S*>(arena + s.base + j * s.stride + r);
    const S cur = *d;
    w.e[t] = cur;
    *d = E::template apply<OP>(cur,
                               reinterpret_cast<const S*>(src)[t]);
    r += sizeof(S);
    if (r == s.len) {
      r = 0;
      ++j;
    }
  }
  if (old != nullptr) *reinterpret_cast<uint4*>(old) = w.v;
}

template <class E, int OP>
__global__ void __launch_bounds__(kThreads)
segmented_accumulate(uint8_t* __restrict__ arena, long long pool_bytes,
                     long long n_cells, const int* __restrict__ desc, int kb,
                     const uint8_t* __restrict__ flat, long long flat_len,
                     uint8_t* __restrict__ out, int seg) {
  using S = typename E::Store;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x * kVec;
  const long long first =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * kVec;
  for (long long i = blockIdx.y; i < kb; i += gridDim.y) {
    const Seg s = load_acc_desc<S>(desc, i, pool_bytes, n_cells, flat_len);
    if (out == nullptr) {
      for (long long l0 = first; l0 < s.total; l0 += step)
        acc16<E, OP>(arena, flat, s, l0, nullptr);
      continue;
    }
    // fetch: every column of output row i is written, zeros past total
    uint8_t* row = out + i * seg;
    for (long long l0 = first; l0 < seg; l0 += step) {
      if (l0 < s.total)
        acc16<E, OP>(arena, flat, s, l0, row + l0);
      else
        *reinterpret_cast<uint4*>(row + l0) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

template <class E, int OP>
__global__ void __launch_bounds__(kOrderedThreads)
segmented_accumulate_ordered(uint8_t* __restrict__ arena,
                             long long pool_bytes, long long n_cells,
                             const int* __restrict__ desc, int kb,
                             const uint8_t* __restrict__ flat,
                             long long flat_len) {
  using S = typename E::Store;
  const long long step = static_cast<long long>(blockDim.x) * kVec;
  for (int i = 0; i < kb; ++i) {
    const Seg s = load_acc_desc<S>(desc, i, pool_bytes, n_cells, flat_len);
    for (long long l0 = static_cast<long long>(threadIdx.x) * kVec;
         l0 < s.total; l0 += step)
      acc16<E, OP>(arena, flat, s, l0, nullptr);
    // descriptor i's read-modify-writes are complete and visible to the
    // block before descriptor i + 1 reads: the blocking order
    __syncthreads();
  }
}

dim3 parallel_grid(int kb, long long lanes);

struct AccArgs {
  uint8_t* arena;
  long long pool_bytes, n_cells;
  const int* desc;
  int kb;
  const uint8_t* flat;
  long long flat_len;
  int seg;
  bool ordered;
  uint8_t* out;
  cudaStream_t stream;
};

template <class E, int OP>
int launch_acc(const AccArgs& a) {
  if (a.ordered) {
    segmented_accumulate_ordered<E, OP><<<1, kOrderedThreads, 0, a.stream>>>(
        a.arena, a.pool_bytes, a.n_cells, a.desc, a.kb, a.flat, a.flat_len);
  } else {
    segmented_accumulate<E, OP>
        <<<parallel_grid(a.kb, a.seg), kThreads, 0, a.stream>>>(
            a.arena, a.pool_bytes, a.n_cells, a.desc, a.kb, a.flat,
            a.flat_len, a.out, a.seg);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class E>
int launch_acc_op(int op, const AccArgs& a) {
  switch (op) {
    case kSum: return launch_acc<E, kSum>(a);
    case kProd: return launch_acc<E, kProd>(a);
    case kMin: return launch_acc<E, kMin>(a);
    case kMax: return launch_acc<E, kMax>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

dim3 parallel_grid(int kb, long long lanes) {
  const long long per_block = static_cast<long long>(kThreads) * kVec;
  long long gx = (lanes + per_block - 1) / per_block;
  if (gx < 1) gx = 1;
  if (gx > kMaxGridX) gx = kMaxGridX;
  const int gy = kb < kMaxGridY ? kb : kMaxGridY;
  return dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy), 1);
}

}  // namespace

extern "C" {

// Segmented put into `arena` (n_rows x pool_bytes uint8, in place).
// Returns cudaGetLastError() after the launch.
int dart_segmented_scatter(void* arena, long long n_rows,
                           long long pool_bytes, const void* desc, int kb,
                           const void* flat, long long flat_len, int seg,
                           int ordered, void* stream) {
  if (kb <= 0 || seg <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_cells = n_rows * pool_bytes;
  auto* a = static_cast<uint8_t*>(arena);
  auto* d = static_cast<const int*>(desc);
  auto* f = static_cast<const uint8_t*>(flat);
  if (ordered) {
    segmented_scatter_ordered<<<1, kOrderedThreads, 0, st>>>(
        a, pool_bytes, n_cells, d, kb, f, flat_len);
  } else {
    segmented_scatter<<<parallel_grid(kb, seg), kThreads, 0, st>>>(
        a, pool_bytes, n_cells, d, kb, f, flat_len);
  }
  return static_cast<int>(cudaGetLastError());
}

// Segmented get: out is (kb, seg) uint8; row i gets descriptor i's
// bytes densely from column 0 and zeros after them.
int dart_segmented_gather(const void* arena, long long n_rows,
                          long long pool_bytes, const void* desc, int kb,
                          void* out, int seg, void* stream) {
  if (kb <= 0 || seg <= 0 || (seg % kVec) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  segmented_gather<<<parallel_grid(kb, seg), kThreads, 0, st>>>(
      static_cast<const uint8_t*>(arena), pool_bytes, n_rows * pool_bytes,
      static_cast<const int*>(desc), kb, static_cast<uint8_t*>(out), seg);
  return static_cast<int>(cudaGetLastError());
}

// Segmented read-modify-write of `arena` in place.  op: 0 sum, 1 prod,
// 2 min, 3 max.  dtype: 0 int8, 1 uint8, 2 int16, 3 uint16, 4 int32,
// 5 uint32, 6 float16, 7 bfloat16, 8 float32.  out (kb x seg uint8, or
// NULL) receives the pre-update windows; it needs ordered == 0.
// Returns cudaGetLastError() after the launch.
int dart_segmented_accumulate(void* arena, long long n_rows,
                              long long pool_bytes, const void* desc, int kb,
                              const void* flat, long long flat_len, int seg,
                              int op, int dtype, int ordered, void* out,
                              void* stream) {
  if (kb <= 0 || seg <= 0 || (seg % kVec) != 0 || (ordered && out))
    return static_cast<int>(cudaErrorInvalidValue);
  const AccArgs a{static_cast<uint8_t*>(arena), pool_bytes,
                  n_rows * pool_bytes, static_cast<const int*>(desc), kb,
                  static_cast<const uint8_t*>(flat), flat_len, seg,
                  ordered != 0, static_cast<uint8_t*>(out),
                  static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return launch_acc_op<IntElem<int8_t>>(op, a);
    case 1: return launch_acc_op<IntElem<uint8_t>>(op, a);
    case 2: return launch_acc_op<IntElem<int16_t>>(op, a);
    case 3: return launch_acc_op<IntElem<uint16_t>>(op, a);
    case 4: return launch_acc_op<IntElem<int32_t>>(op, a);
    case 5: return launch_acc_op<IntElem<uint32_t>>(op, a);
    case 6: return launch_acc_op<F16Elem>(op, a);
    case 7: return launch_acc_op<BF16Elem>(op, a);
    case 8: return launch_acc_op<F32Elem>(op, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* dart_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
