// RMSNorm for Hopper (sm_90a), forward and backward: the port of the TPU
// kernel `rmsnorm` (src/repro/kernels/rmsnorm.py:27, body `_rmsnorm_kernel`
// :20) and its gradient, which the Pallas package never differentiated.
// Plain versions: `ref.rmsnorm_ref`, `ref.rmsnorm_model` and
// `ref.rmsnorm_bwd_ref` (src/repro_torch/kernels/ref.py).
//
// Forward contract: x (rows, d) of one float dtype (f32, bf16 or f16), scale
// (d,) of any of those dtypes.  With inv = rsqrt(mean(x^2) + eps):
//     MODEL=0: out = x * inv * scale, f32 throughout, rounded once to x's
//              dtype (the TPU kernel's math);
//     MODEL=1: `apply_norm`'s numerics: inv rounded to x's dtype, x * inv
//              rounded to it, then times scale rounded to it, rounded again.
//
// Forward bound: x read once and the output written once (2 * rows * d
// elements), scale once: bound by bytes (~4 flops an element).
//
// Forward design (`rmsnorm_fwd_rows`, 256 threads): CTA c takes the
// contiguous rows [c * rows_per_cta, ...), whose bytes are contiguous too, in
// stages of `stage_rows` rows (`fwd_partition` in rmsnorm.py; passed in,
// never recomputed here).  The plan puts about four CTAs on each SM, all
// resident: with one CTA an SM each CTA's chain of stage waits, row sums and
// barriers was exposed (8,192 x 768 bf16: 14.8 us against 11.8; PERF.md).
//   * Reads: one thread issues a 1-D bulk copy (TMA, `cp.async.bulk`) of a
//     whole stage into a ring of `slots` stage buffers in shared memory,
//     each with its own mbarrier (expect_tx of the stage's bytes).  At the
//     main paths' shapes the ring holds every stage of the CTA, so all its
//     reads are in flight at once (24 KB in two stages at 8,192 x 768 bf16,
//     16 KB in one at 2048 x 2048); a slot is refilled once every warp has
//     read it.
//   * Rows: one warp a row, sum of squares in f32 over 16-byte vectors (the
//     same lanes, the same order, whatever the plan or the batch: a row's
//     output depends on that row and the scale alone).  The scale is loaded
//     once a CTA into shared memory (f32; in MODEL=1 already rounded to x's
//     dtype).
//   * Writes: 16-byte stores from registers as each row is done.  A bulk
//     store of the stage (normalised in place, `fence.proxy.async`, a CTA
//     barrier, `cp.async.bulk` out) measured slower: the barrier holds each
//     stage's write for its slowest row (PERF.md).
//   * Rows a bulk copy cannot take (row bytes not a multiple of 16, or a
//     pointer not 16-byte aligned: BULK=0, the wrapper's flag) go element by
//     element from device memory, in the same lanes and order.  Small row
//     counts (decode: 8 rows; the packed step: 257) take a CTA a row.  No
//     atomics: two runs are bit-identical.
//
// Backward contract: x, dy (rows, d) of one float dtype, scale (d,) of any
// of those dtypes.  With inv_c the factor the forward multiplies by,
// t = x * inv_c and dt = dy * s:
//     dx     = dt * inv_c - x * inv^3 * sum(dt * x) / d      (dx in x's dtype)
//     dscale = sum over rows of dy * t                        (in scale's dtype)
// MODEL=1: inv_c = inv rounded to x's dtype, t rounded to it, s = scale
// rounded to it; MODEL=0 is f32 throughout.  All arithmetic is f32, each
// output rounded once.
//
// Backward bound: x and dy read once, dx written once (3 * rows * d
// elements), scale and dscale once: bound by bytes (~8 flops an element
// against the card's ~295 flops a byte).
//
// Backward design: a persistent grid of one CTA an SM (512 threads).  CTA c
// takes the contiguous rows [c * rows_per_cta, ...) and walks them in
// batches of up to `batch_rows` rows that fit in shared memory: the batch's
// rows of x and dy are all put in flight at once by 16-byte `cp.async` (one
// commit group a row, issued by the warp that reduces the row, so a warp
// starts on its row as soon as that row has landed), ~128 KB a CTA at
// 2048 x 2048 bf16.
//   * Per row, one warp: sum(x^2) and sum(dt * x) by shuffles, then dx,
//     written with 16-byte stores; inv_c goes to shared memory.
//   * dscale in the CTA: after a barrier each thread owns fixed columns and
//     adds dy * t over the batch's rows in row order, into an f32 shared
//     array it alone touches; at the end the CTA writes that array as its
//     partial (ctas x d f32).
//   * dscale across CTAs: a second kernel of ceil(d / 32) CTAs (64 at
//     d = 2048), each summing every partial of its 32 columns in a fixed
//     order (8 row groups, then the groups in order).  A plain second launch:
//     with programmatic dependent launch the pair measured 0.4 us slower on
//     the card (PERF.md, section 6).  No float atomics: dx and dscale are
//     bit-identical from run to run.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kColCta = 32;     // columns a CTA of the dscale sum owns
constexpr int kColGroups = 8;   // row groups of the dscale sum (256 threads)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }

// x rounded to T and back (the model mode's roundings)
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// V contiguous elements of T (16-byte accesses when V * sizeof(T) is a
// multiple of 16)
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[V]) {
  if constexpr (V * sizeof(T) % 16 == 0) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int c = 0; c < V / kPer; ++c) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p + c * kPer);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kPer; ++i) out[c * kPer + i] = to_f32(e[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = to_f32(p[i]);
  }
}
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_f32<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = from_f32<T>(v[i]);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// Copy `n` elements (one row) from global to shared memory: 16-byte
// cp.async when VEC (row bytes a multiple of 16, 16-byte aligned), else
// plain loads.  Lanes of one warp share the row.
template <typename T, bool VEC>
__device__ __forceinline__ void stage_row(T* dst, const T* src, int n, int lane) {
  if constexpr (VEC) {
    constexpr int kPer = 16 / sizeof(T);
    for (int c = lane; c < n / kPer; c += 32) cp_async16(dst + c * kPer, src + c * kPer);
  } else {
    for (int i = lane; i < n; i += 32) dst[i] = src[i];
  }
}

// One CTA: its rows in batches; dx per row, its dscale partial per column.
// Shared memory: s_eff[d] f32 | ds[d] f32 | inv_c[batch] f32 |
//                x[batch][d] T | dy[batch][d] T
template <typename T, typename ST, bool MODEL, bool VEC>
__global__ void __launch_bounds__(kThreads, 1) rmsnorm_bwd_rows(
    const T* __restrict__ x, const ST* __restrict__ scale, const T* __restrict__ dy,
    T* __restrict__ dx, float* __restrict__ part, int rows, int d, int rows_per_cta,
    int batch_rows, float eps) {
  constexpr int V = VEC ? 16 / sizeof(T) : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_eff = reinterpret_cast<float*>(smem);
  float* ds = s_eff + d;
  float* s_inv = ds + d;
  T* sx = reinterpret_cast<T*>(smem + (size_t)(2 * d + batch_rows) * sizeof(float) +
                               ((16 - ((2 * d + batch_rows) * sizeof(float)) % 16) % 16));
  T* sdy = sx + (size_t)batch_rows * d;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * rows_per_cta;
  const int r_end = min(rows, r0 + rows_per_cta);
  const float inv_d = 1.f / static_cast<float>(d);

  for (int b0 = r0; b0 < r_end; b0 += batch_rows) {
    const int nb = min(batch_rows, r_end - b0);
    // every row of the batch in flight: warp w stages rows w, w + 16, ...
    for (int r = warp; r < nb; r += kWarps) {
      stage_row<T, VEC>(sx + (size_t)r * d, x + (size_t)(b0 + r) * d, d, lane);
      stage_row<T, VEC>(sdy + (size_t)r * d, dy + (size_t)(b0 + r) * d, d, lane);
      if constexpr (VEC) cp_async_commit();
    }
    if (b0 == r0) {  // scale while the first batch is in flight
      for (int i = threadIdx.x; i < d; i += kThreads) {
        const float s = to_f32(scale[i]);
        s_eff[i] = MODEL ? round_to<T>(s) : s;
        ds[i] = 0.f;
      }
    }
    __syncthreads();  // s_eff (first batch) visible to every warp
    // per row: its warp's two reductions and dx
    const int mine = (nb - warp + kWarps - 1) / kWarps;  // rows this warp staged
    for (int i = 0; i < mine; ++i) {
      const int r = warp + i * kWarps;
      if constexpr (VEC) {
        // the groups complete in order: row i is in once at most
        // (mine - 1 - i) groups are pending
        const int pending = mine - 1 - i;
        if (pending >= 3) cp_async_wait<3>();
        else if (pending == 2) cp_async_wait<2>();
        else if (pending == 1) cp_async_wait<1>();
        else cp_async_wait<0>();
        __syncwarp();
      }
      const T* xr = sx + (size_t)r * d;
      const T* dyr = sdy + (size_t)r * d;
      float ss = 0.f, dot = 0.f;
      for (int c = lane * V; c < d; c += 32 * V) {
        float xv[V], dv[V], sv[V];
        load_vec<T, V>(xr + c, xv);
        load_vec<T, V>(dyr + c, dv);
        load_vec<float, V>(s_eff + c, sv);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          ss = fmaf(xv[j], xv[j], ss);
          dot = fmaf(dv[j] * sv[j], xv[j], dot);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      }
      const float inv = rsqrtf(ss * inv_d + eps);
      const float inv_c = MODEL ? round_to<T>(inv) : inv;
      const float coef = inv * inv * inv * dot * inv_d;
      T* dxr = dx + (size_t)(b0 + r) * d;
      for (int c = lane * V; c < d; c += 32 * V) {
        float xv[V], dv[V], sv[V], o[V];
        load_vec<T, V>(xr + c, xv);
        load_vec<T, V>(dyr + c, dv);
        load_vec<float, V>(s_eff + c, sv);
#pragma unroll
        for (int j = 0; j < V; ++j) o[j] = dv[j] * sv[j] * inv_c - xv[j] * coef;
        store_vec<T, V>(dxr + c, o);
      }
      if (lane == 0) s_inv[r] = inv_c;
    }
    __syncthreads();  // every row of the batch and its inv_c in
    // dscale: thread-owned columns, rows in order
    for (int c = threadIdx.x * V; c < d; c += kThreads * V) {
      float acc[V];
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = ds[c + j];
      for (int r = 0; r < nb; ++r) {
        float xv[V], dv[V];
        load_vec<T, V>(sx + (size_t)r * d + c, xv);
        load_vec<T, V>(sdy + (size_t)r * d + c, dv);
        const float ic = s_inv[r];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float t = MODEL ? round_to<T>(xv[j] * ic) : xv[j] * ic;
          acc[j] = fmaf(dv[j], t, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < V; ++j) ds[c + j] = acc[j];
    }
    __syncthreads();  // the batch's buffers are free again
  }
  // ds[c] was written by the thread that owns c: it writes its own partial
  for (int c = threadIdx.x * V; c < d; c += kThreads * V) {
#pragma unroll
    for (int j = 0; j < V; ++j) part[(size_t)blockIdx.x * d + c + j] = ds[c + j];
  }
}

// dscale[c] = sum over the `ctas` partials of column c, in a fixed order:
// 8 row groups (partials g, g + 8, ...), then the groups 0..7.
template <typename ST>
__global__ void __launch_bounds__(kColCta* kColGroups) rmsnorm_bwd_colsum(
    const float* __restrict__ part, ST* __restrict__ dscale, int ctas, int d) {
  __shared__ float acc[kColGroups][kColCta];
  const int col = threadIdx.x % kColCta;
  const int grp = threadIdx.x / kColCta;
  const int c = blockIdx.x * kColCta + col;
  float a = 0.f;
  if (c < d) {
    for (int p = grp; p < ctas; p += kColGroups) a += part[(size_t)p * d + c];
  }
  acc[grp][col] = a;
  __syncthreads();
  if (grp == 0 && c < d) {
    float s = acc[0][col];
#pragma unroll
    for (int g = 1; g < kColGroups; ++g) s += acc[g][col];
    dscale[c] = from_f32<ST>(s);
  }
}

struct Args {
  const void *x, *scale, *dy;
  void *dx, *part, *dscale;
  int rows, d, ctas, rows_per_cta, batch_rows;
  float eps;
  cudaStream_t stream;
};

template <typename T, typename ST, bool MODEL, bool VEC>
cudaError_t launch(const Args& a) {
  auto rows_kernel = rmsnorm_bwd_rows<T, ST, MODEL, VEC>;
  const size_t head = (size_t)(2 * a.d + a.batch_rows) * sizeof(float);
  const size_t smem = head + (16 - head % 16) % 16 + 2 * (size_t)a.batch_rows * a.d * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(rows_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  rows_kernel<<<a.ctas, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const ST*>(a.scale), static_cast<const T*>(a.dy),
      static_cast<T*>(a.dx), static_cast<float*>(a.part), a.rows, a.d, a.rows_per_cta,
      a.batch_rows, a.eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rmsnorm_bwd_colsum<ST><<<(a.d + kColCta - 1) / kColCta, kColCta * kColGroups, 0, a.stream>>>(
      static_cast<const float*>(a.part), static_cast<ST*>(a.dscale), a.ctas, a.d);
  return cudaGetLastError();
}

template <typename T, typename ST>
cudaError_t launch_mode(const Args& a, int model, int vec) {
  if (model) {
    return vec ? launch<T, ST, true, true>(a) : launch<T, ST, true, false>(a);
  }
  return vec ? launch<T, ST, false, true>(a) : launch<T, ST, false, false>(a);
}

template <typename T>
cudaError_t launch_scale(const Args& a, int scale_dtype, int model, int vec) {
  switch (scale_dtype) {
    case 0: return launch_mode<T, float>(a, model, vec);
    case 1: return launch_mode<T, __nv_bfloat16>(a, model, vec);
    default: return launch_mode<T, __half>(a, model, vec);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  dtypes: 0 f32, 1 bf16, 2 f16.
// `part` is (ctas, d) f32 scratch.  `vec`: rows are 16-byte aligned and a
// multiple of 16 bytes (the wrapper checks).  Returns 0, a CUDA error code, or -1
// for arguments the kernels do not take.  Asynchronous on `stream`.
extern "C" int repro_rmsnorm_bwd(const void* x, const void* scale, const void* dy, void* dx,
                                 void* dscale, void* part, int rows, int d, int ctas,
                                 int rows_per_cta, int batch_rows, float eps, int x_dtype,
                                 int scale_dtype, int model, int vec, void* stream) {
  if (rows <= 0 || d <= 0 || ctas <= 0 || rows_per_cta <= 0 || batch_rows <= 0 ||
      (long long)ctas * rows_per_cta < rows || x_dtype < 0 || x_dtype > 2 || scale_dtype < 0 ||
      scale_dtype > 2) {
    return -1;
  }
  const Args a{x, scale, dy, dx, part, dscale, rows, d, ctas, rows_per_cta, batch_rows, eps,
               static_cast<cudaStream_t>(stream)};
  cudaError_t e;
  switch (x_dtype) {
    case 0: e = launch_scale<float>(a, scale_dtype, model, vec); break;
    case 1: e = launch_scale<__nv_bfloat16>(a, scale_dtype, model, vec); break;
    default: e = launch_scale<__half>(a, scale_dtype, model, vec); break;
  }
  return static_cast<int>(e);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

namespace {

constexpr int kFwdThreads = 256;
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kMaxSlots = 32;          // stage buffers a CTA may ring through
constexpr int kHead = kMaxSlots * 8;   // their mbarriers, at the head of shared memory

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of parity `parity` to complete.  A wait that outlasts
// any real one (2^26 polls, seconds) traps: a broken ring fails the launch
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from device memory
// into shared memory; completion counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// V consecutive elements from column c of a row of d: 16-byte vectors when
// VEC, else one element at a time, the columns past d read as 0
template <typename T, int V, bool VEC>
__device__ __forceinline__ void load_cols(const T* row, int c, int d, float (&out)[V]) {
  if constexpr (VEC) {
    load_vec<T, V>(row + c, out);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = c + j < d ? to_f32(row[c + j]) : 0.f;
  }
}
template <typename T, int V, bool VEC>
__device__ __forceinline__ void store_cols(T* row, int c, int d, const float (&v)[V]) {
  if constexpr (VEC) {
    store_vec<T, V>(row + c, v);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (c + j < d) row[c + j] = from_f32<T>(v[j]);
    }
  }
}

// One row by one warp: lane l owns the 16-byte vectors l, l + 32, ... and
// sums their squares in order, then the shuffles add the lanes; the row is
// read again for the outputs, which go to dst from registers.  With VEC=0
// the same columns in the same order (a missing column adds fma(0, 0, ss) =
// ss), so both paths give a row the same bits.
template <typename T, bool MODEL, bool VEC>
__device__ __forceinline__ void norm_row(const T* src, T* dst, const float* s_eff, int d,
                                         float inv_d, float eps, int lane) {
  constexpr int V = 16 / sizeof(T);
  float ss = 0.f;
  for (int c = lane * V; c < d; c += 32 * V) {
    float v[V];
    load_cols<T, V, VEC>(src, c, d, v);
#pragma unroll
    for (int j = 0; j < V; ++j) ss = fmaf(v[j], v[j], ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float inv = rsqrtf(ss * inv_d + eps);
  const float inv_c = MODEL ? round_to<T>(inv) : inv;
  for (int c = lane * V; c < d; c += 32 * V) {
    float v[V], s[V], o[V];
    load_cols<T, V, VEC>(src, c, d, v);
    load_cols<float, V, VEC>(s_eff, c, d, s);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      o[j] = MODEL ? round_to<T>(v[j] * inv_c) * s[j] : v[j] * inv_c * s[j];
    }
    store_cols<T, V, VEC>(dst, c, d, o);
  }
}

// Shared memory: kMaxSlots mbarriers | s_eff[d] f32 (16-byte aligned) |
//                slots x stage_rows x d of T (BULK only)
template <typename T, typename ST, bool MODEL, bool BULK>
__global__ void __launch_bounds__(kFwdThreads) rmsnorm_fwd_rows(
    const T* __restrict__ x, const ST* __restrict__ scale, T* __restrict__ out, int rows, int d,
    int rows_per_cta, int stage_rows, int slots, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* s_eff = reinterpret_cast<float*>(smem + kHead);
  T* ring = reinterpret_cast<T*>(smem + kHead + align16((size_t)d * sizeof(float)));

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * rows_per_cta;
  const int nrows = min(rows, r0 + rows_per_cta) - r0;
  const int stages = (nrows + stage_rows - 1) / stage_rows;
  const float inv_d = 1.f / static_cast<float>(d);
  const uint32_t row_bytes = static_cast<uint32_t>(d * sizeof(T));

  // stage k of this CTA's rows into its slot (one thread)
  auto load = [&](int k) {
    const int n = min(stage_rows, nrows - k * stage_rows);
    uint64_t* bar = full + k % slots;
    mbar_expect_tx(bar, n * row_bytes);
    bulk_load(ring + (size_t)(k % slots) * stage_rows * d, x + (size_t)(r0 + k * stage_rows) * d,
              n * row_bytes, bar);
  };
  if constexpr (BULK) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < slots; ++s) mbar_init(full + s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int k = 0; k < min(slots, stages); ++k) load(k);
    }
  }
  for (int i = threadIdx.x; i < d; i += kFwdThreads) {  // the scale, while the reads fly
    const float s = to_f32(scale[i]);
    s_eff[i] = MODEL ? round_to<T>(s) : s;
  }
  __syncthreads();  // s_eff and the mbarriers' init visible to every warp

  if constexpr (!BULK) {
    for (int r = warp; r < nrows; r += kFwdWarps) {
      const size_t off = (size_t)(r0 + r) * d;
      norm_row<T, MODEL, false>(x + off, out + off, s_eff, d, inv_d, eps, lane);
    }
  } else {
    for (int k = 0; k < stages; ++k) {
      const int slot = k % slots;
      const int n = min(stage_rows, nrows - k * stage_rows);
      const T* buf = ring + (size_t)slot * stage_rows * d;
      mbar_wait(full + slot, (k / slots) & 1);
      for (int r = warp; r < n; r += kFwdWarps) {
        norm_row<T, MODEL, true>(buf + (size_t)r * d, out + (size_t)(r0 + k * stage_rows + r) * d,
                                 s_eff, d, inv_d, eps, lane);
      }
      if (k + slots < stages) {  // refill the slot once every warp has read it
        __syncthreads();
        if (threadIdx.x == 0) load(k + slots);
      }
    }
  }
}

struct FwdArgs {
  const void* x;
  const void* scale;
  void* out;
  int rows, d, ctas, rows_per_cta, stage_rows, slots, smem;
  float eps;
  cudaStream_t stream;
};

template <typename T, typename ST, bool MODEL, bool BULK>
cudaError_t launch_fwd(const FwdArgs& a) {
  auto kernel = rmsnorm_fwd_rows<T, ST, MODEL, BULK>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (e != cudaSuccess) return e;
  kernel<<<a.ctas, kFwdThreads, a.smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const ST*>(a.scale), static_cast<T*>(a.out), a.rows,
      a.d, a.rows_per_cta, a.stage_rows, a.slots, a.eps);
  return cudaGetLastError();
}

template <typename T, typename ST>
cudaError_t launch_fwd_mode(const FwdArgs& a, int model, int bulk) {
  if (model) {
    return bulk ? launch_fwd<T, ST, true, true>(a) : launch_fwd<T, ST, true, false>(a);
  }
  return bulk ? launch_fwd<T, ST, false, true>(a) : launch_fwd<T, ST, false, false>(a);
}

template <typename T>
cudaError_t launch_fwd_scale(const FwdArgs& a, int scale_dtype, int model, int bulk) {
  switch (scale_dtype) {
    case 0: return launch_fwd_mode<T, float>(a, model, bulk);
    case 1: return launch_fwd_mode<T, __nv_bfloat16>(a, model, bulk);
    default: return launch_fwd_mode<T, __half>(a, model, bulk);
  }
}

}  // namespace

// Plain C entry point of the forward (loaded with ctypes).  dtypes: 0 f32,
// 1 bf16, 2 f16.  The plan (ctas, rows_per_cta, stage_rows, slots, smem) is
// `fwd_partition`'s; `bulk`: rows go by bulk copies (row bytes a multiple of
// 16, x and out 16-byte aligned; checked again here).  Returns 0, a CUDA
// error code, or -1 for arguments the kernel does not take.  Asynchronous on
// `stream`.
extern "C" int repro_rmsnorm_fwd(const void* x, const void* scale, void* out, int rows, int d,
                                 int ctas, int rows_per_cta, int stage_rows, int slots, int smem,
                                 float eps, int x_dtype, int scale_dtype, int model, int bulk,
                                 void* stream) {
  if (rows <= 0 || d <= 0 || ctas <= 0 || rows_per_cta <= 0 || stage_rows <= 0 || slots <= 0 ||
      slots > kMaxSlots || (long long)ctas * rows_per_cta < rows ||
      (long long)(ctas - 1) * rows_per_cta >= rows || x_dtype < 0 || x_dtype > 2 ||
      scale_dtype < 0 || scale_dtype > 2) {
    return -1;
  }
  const size_t row_bytes = (size_t)d * (x_dtype == 0 ? 4 : 2);
  const size_t need = kHead + align16((size_t)d * sizeof(float)) +
                      (bulk ? (size_t)slots * stage_rows * row_bytes : 0);
  if ((size_t)smem < need ||
      (bulk && (row_bytes % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
                reinterpret_cast<uintptr_t>(out) % 16 != 0))) {
    return -1;
  }
  const FwdArgs a{x, scale, out, rows, d, ctas, rows_per_cta, stage_rows, slots, smem, eps,
                  static_cast<cudaStream_t>(stream)};
  cudaError_t e;
  switch (x_dtype) {
    case 0: e = launch_fwd_scale<float>(a, scale_dtype, model, bulk); break;
    case 1: e = launch_fwd_scale<__nv_bfloat16>(a, scale_dtype, model, bulk); break;
    default: e = launch_fwd_scale<__half>(a, scale_dtype, model, bulk); break;
  }
  return static_cast<int>(e);
}
