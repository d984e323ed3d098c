// RMSNorm backward for Hopper (sm_90a): the gradient of the port of the TPU
// kernel `rmsnorm` (src/repro/kernels/rmsnorm.py:27, body `_rmsnorm_kernel`
// :20), which the Pallas package never differentiated.  Plain version:
// `ref.rmsnorm_bwd_ref` (src/repro_torch/kernels/ref.py).
//
// Contract: x, dy (rows, d) of one float dtype (f32, bf16 or f16), scale (d,)
// of any of those dtypes.  With inv = rsqrt(mean(x^2) + eps), inv_c the
// factor the forward multiplies by, t = x * inv_c and dt = dy * s:
//     dx     = dt * inv_c - x * inv^3 * sum(dt * x) / d      (dx in x's dtype)
//     dscale = sum over rows of dy * t                        (in scale's dtype)
// MODEL=1 is `apply_norm`'s numerics: inv_c = inv rounded to x's dtype, t
// rounded to it, s = scale rounded to it; MODEL=0 is f32 throughout.  All
// arithmetic is f32, each output rounded once.
//
// Bound: x and dy read once, dx written once (3 * rows * d elements), scale
// and dscale once: bound by bytes (~8 flops an element against the card's
// ~295 flops a byte).
//
// Design: a persistent grid of one CTA an SM (512 threads).  CTA c takes the
// contiguous rows [c * rows_per_cta, ...) and walks them in batches of up to
// `batch_rows` rows that fit in shared memory: the batch's rows of x and dy
// are all put in flight at once by 16-byte `cp.async` (one commit group a
// row, issued by the warp that reduces the row, so a warp starts on its row
// as soon as that row has landed), ~128 KB a CTA at 2048 x 2048 bf16.
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
