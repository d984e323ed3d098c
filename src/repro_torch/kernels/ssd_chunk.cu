// Mamba-2's SSD dual-form term for Hopper (sm_90a): the hand-written ports of
// the TPU kernels `_ssd_chunk_kernel` / `ssd_chunk` (K6,
// src/repro/kernels/ssd_chunk.py:27, :104) and `_ssd_segment_kernel` /
// `ssd_segment` (K5, :45, :65).
//
// Contract (pinned by tests/test_torch_kernels.py on the plain versions and by
// tests/test_torch_kernels_gpu.py and chip_smoke.py on the card), all f32 and
// contiguous:
//   x (G, L, H, P); dt, cum (G, L, H); b, c (G, L, N), shared by every head;
//   seg (L,) int32 for the segment kernel (G = 1, L the packed axis).
//   y[g, i, h, :] = sum_j [mask_ij] (C_i . B_j) exp(-(cum_i - cum_j)) dt_j x_j
//   K6 (ssd_chunk_kernel): mask = j <= i inside each of the G chunks.
//   K5 (ssd_segment_kernel): mask = j <= i and seg_j == seg_i and seg_i >= 0.
//   The decay is always formed from the difference cum_j - cum_i, never as
//   exp(-cum_i) * exp(cum_j): over a packed axis cum reaches the thousands and
//   either factor alone over- or underflows.  A masked pair contributes an
//   exact 0 (its exp is never taken), so a padding row writes exact zeros.
//
// Bound: per admissible (i, j) pair, 2N flops for C_i . B_j (once for all
// heads) and 2P flops per head for the att . x product, against one read of
// x, dt, cum, B, C and one write of y: at mamba2-130m's widths (H 24, P 64,
// N 128) ~ 3,300 flops a pair over ~30 bytes a row, far above the card's f32
// ratio (67 TFLOP/s over 3.35 TB/s = 20 flop/B), so the kernel is bound by
// f32 operations.  They run on the FMA pipes in f32, as the reference
// computes them (TF32 or bf16 tensor cores would change the precision).
//
// Design.  A CTA takes one 64-row query tile of one chunk and a group of HG
// heads (HG chosen by the wrapper so the grid fills the card), 256 threads.
//   * The query tile's C is staged once, transposed (C^T, N x 64), in shared
//     memory.  For each key tile at or left of the diagonal (tiles right of it
//     are never visited), the CTA stages B^T and forms S = C . B^T (64 x 64)
//     in registers, a 4 x 4 block a thread: once per key tile for all HG
//     heads, where the TPU kernel formed it again for every head.
//   * The segment kernel first asks whether any pair of the (query, key) tile
//     is admissible (one __syncthreads_or over the pairs' masks) and skips the
//     key tile when none is: segments are contiguous, so a row tile walks only
//     the key tiles its own segments cover.
//   * Per head, each thread turns its 16 scores into att = S * exp(cum_j -
//     cum_i) * dt_j (or 0), stores att^T in shared memory, the head's 64 x P
//     x tile is staged, and each thread adds a 4 x 4 block of att . x (float4
//     shared loads: two 16-byte loads per 16 FMAs) to its HG accumulators,
//     which live in registers across the key tiles.  Rows past L are never
//     written; keys past L load as zeros.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;       // query rows and keys per tile
constexpr int kThreads = 256;   // 16 x 16 threads, a 4 x 4 block of a 64 x 64 tile each

struct Args {
  const float* x;
  const float* dt;
  const float* cum;
  const float* b;
  const float* c;
  const int* seg;
  float* y;
  int L, H;
};

template <int N, int P, int HG>
constexpr int smem_floats() {
  // C^T and B^T (N x 64 each), att^T (64 x 64), the x tile (64 x P), and per
  // head the query cum, key cum and key dt (64 each); two int arrays of 64.
  return 2 * N * kTile + kTile * kTile + kTile * P + 3 * HG * kTile + 2 * kTile;
}

// Stage rows [r0, r0 + 64) of a (rows, N) f32 matrix transposed into dst
// (N x 64): dst[k * 64 + r] = src[(r0 + r) * N + k]; rows >= L load as 0.
template <int N>
__device__ __forceinline__ void stage_transposed(const float* __restrict__ src, int r0, int L,
                                                 float* __restrict__ dst) {
  constexpr int kVec = N / 4;  // float4s a row
  for (int e = threadIdx.x; e < kTile * kVec; e += kThreads) {
    const int r = e % kTile;  // consecutive threads: consecutive rows (conflict-free stores)
    const int k4 = e / kTile;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < L) v = __ldg(reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * N) + k4);
    dst[(4 * k4 + 0) * kTile + r] = v.x;
    dst[(4 * k4 + 1) * kTile + r] = v.y;
    dst[(4 * k4 + 2) * kTile + r] = v.z;
    dst[(4 * k4 + 3) * kTile + r] = v.w;
  }
}

template <int N, int P, int HG, bool SEGMENT>
__device__ __forceinline__ void ssd_tile(const Args& a) {
  static_assert(P == 64, "a thread's 4 x 4 output block spans P = 64 columns");
  static_assert(N % 4 == 0, "B and C rows load as float4");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sCT = smem;                    // N x 64: C^T of the query tile
  float* sBT = sCT + N * kTile;         // N x 64: B^T of the key tile
  float* sAT = sBT + N * kTile;         // 64 x 64: att^T (key-major)
  float* sX = sAT + kTile * kTile;      // 64 x P: x tile of one head
  float* sCumQ = sX + kTile * P;        // HG x 64
  float* sCumK = sCumQ + HG * kTile;    // HG x 64
  float* sDtK = sCumK + HG * kTile;     // HG x 64
  int* sSegQ = reinterpret_cast<int*>(sDtK + HG * kTile);  // 64
  int* sSegK = sSegQ + kTile;                              // 64

  const int L = a.L, H = a.H;
  const int qt = blockIdx.x;
  const int i0 = qt * kTile;
  const int h0 = blockIdx.y * HG;
  const size_t g = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  const float* x = a.x + g * L * H * P;
  const float* dt = a.dt + g * L * H;
  const float* cum = a.cum + g * L * H;
  const float* bm = a.b + g * L * N;
  const float* cm = a.c + g * L * N;
  float* y = a.y + g * L * H * P;

  stage_transposed<N>(cm, i0, L, sCT);
  for (int e = tid; e < HG * kTile; e += kThreads) {
    const int hh = e / kTile, r = e % kTile;
    const int h = h0 + hh, i = i0 + r;
    sCumQ[e] = (h < H && i < L) ? cum[(size_t)i * H + h] : 0.f;
  }
  if (SEGMENT) {
    for (int r = tid; r < kTile; r += kThreads) sSegQ[r] = (i0 + r < L) ? a.seg[i0 + r] : -1;
  }

  float acc[HG][4][4];
#pragma unroll
  for (int hh = 0; hh < HG; ++hh)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[hh][r][q] = 0.f;

  // the S / att stage: thread (ty, tx) holds keys j = 4 ty + r, queries i = 4 tx + q
  for (int kt = 0; kt <= qt; ++kt) {
    const int j0 = kt * kTile;
    __syncthreads();  // the previous key tile's shared buffers are free
    if (SEGMENT) {
      for (int r = tid; r < kTile; r += kThreads) sSegK[r] = (j0 + r < L) ? a.seg[j0 + r] : -2;
      __syncthreads();
      int any = 0;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int jl = 4 * ty + r, il = 4 * tx + q;
          const int sq = sSegQ[il];
          any |= (j0 + jl <= i0 + il) && sq >= 0 && sq == sSegK[jl];
        }
      if (!__syncthreads_or(any)) continue;  // no admissible pair in this key tile
    }
    stage_transposed<N>(bm, j0, L, sBT);
    for (int e = tid; e < HG * kTile; e += kThreads) {
      const int hh = e / kTile, r = e % kTile;
      const int h = h0 + hh, j = j0 + r;
      const bool ok = h < H && j < L;
      sCumK[e] = ok ? cum[(size_t)j * H + h] : 0.f;
      sDtK[e] = ok ? dt[(size_t)j * H + h] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) s[r][q] = 0.f;
#pragma unroll 4
    for (int k = 0; k < N; ++k) {
      const float4 cv = *reinterpret_cast<const float4*>(sCT + k * kTile + 4 * tx);
      const float4 bv = *reinterpret_cast<const float4*>(sBT + k * kTile + 4 * ty);
      const float cq[4] = {cv.x, cv.y, cv.z, cv.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[r][q] = fmaf(br[r], cq[q], s[r][q]);
    }
    bool adm[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int jl = 4 * ty + r, il = 4 * tx + q;
        bool ok = (j0 + jl <= i0 + il) && (i0 + il < L);
        if (SEGMENT) ok = ok && sSegQ[il] >= 0 && sSegQ[il] == sSegK[jl];
        adm[r][q] = ok;
      }

#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
      const int h = h0 + hh;
      if (h >= H) break;  // uniform across the CTA
      if (hh > 0) __syncthreads();  // the previous head's att^T and x tile are read
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int jl = 4 * ty + r;
        const float ck = sCumK[hh * kTile + jl], dk = sDtK[hh * kTile + jl];
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float cq = sCumQ[hh * kTile + 4 * tx + q];
          v[q] = adm[r][q] ? s[r][q] * expf(ck - cq) * dk : 0.f;
        }
        *reinterpret_cast<float4*>(sAT + jl * kTile + 4 * tx) = make_float4(v[0], v[1], v[2], v[3]);
      }
      for (int e = tid; e < kTile * (P / 4); e += kThreads) {
        const int r = e / (P / 4), p4 = e % (P / 4);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j0 + r < L)
          v = __ldg(reinterpret_cast<const float4*>(x + ((size_t)(j0 + r) * H + h) * P) + p4);
        reinterpret_cast<float4*>(sX)[e] = v;
      }
      __syncthreads();
      // the att . x stage: thread (ty, tx) holds rows i = 4 ty + r, columns p = 4 tx + q
#pragma unroll 4
      for (int jl = 0; jl < kTile; ++jl) {
        const float4 av = *reinterpret_cast<const float4*>(sAT + jl * kTile + 4 * ty);
        const float4 xv = *reinterpret_cast<const float4*>(sX + jl * P + 4 * tx);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float xq[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[hh][r][q] = fmaf(ar[r], xq[q], acc[hh][r][q]);
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < HG; ++hh) {
    const int h = h0 + hh;
    if (h >= H) break;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + 4 * ty + r;
      if (i < L) {
        *reinterpret_cast<float4*>(y + ((size_t)i * H + h) * P + 4 * tx) =
            make_float4(acc[hh][r][0], acc[hh][r][1], acc[hh][r][2], acc[hh][r][3]);
      }
    }
  }
}

template <int N, int P, int HG>
__global__ void __launch_bounds__(kThreads) ssd_chunk_kernel(Args a) {
  ssd_tile<N, P, HG, false>(a);
}

template <int N, int P, int HG>
__global__ void __launch_bounds__(kThreads) ssd_segment_kernel(Args a) {
  ssd_tile<N, P, HG, true>(a);
}

template <int N, int P, int HG>
cudaError_t launch(const Args& a, int G, bool segment, cudaStream_t stream) {
  const size_t bytes = smem_floats<N, P, HG>() * sizeof(float);
  auto kernel = segment ? ssd_segment_kernel<N, P, HG> : ssd_chunk_kernel<N, P, HG>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  const dim3 grid((a.L + kTile - 1) / kTile, (a.H + HG - 1) / HG, G);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  segment = 0: K6 over G chunks of
// L rows; segment = 1: K5 over one packed axis of L tokens (G must be 1, seg
// given).  heads_per_cta is the HG instantiated below (1, 2 or 4).  Returns 0
// on success, a CUDA error code when a launch is refused, or -1 for a shape
// the kernel is not built for (the wrapper checks shapes first).  The launch
// is asynchronous on `stream`; nothing is allocated here.
extern "C" int repro_ssd(const void* x, const void* dt, const void* cum, const void* b,
                         const void* c, const void* seg, void* y, int G, int L, int H, int P,
                         int N, int segment, int heads_per_cta, void* stream) {
  if (G == 0 || L == 0 || H == 0) return 0;
  if (G < 0 || L < 0 || H < 0 || G > 65535 || (segment && (G != 1 || !seg))) return -1;
  // Only mamba2-130m's widths are instantiated: head dim P 64, state N 128.
  // Another config adds its launch<N, P, HG> here and its (N, P) to BUILT in
  // ssd_chunk.py (P = 64 is what a thread's 4 x 4 output block spans).
  if (P != 64 || N != 128) return -1;
  const Args a{static_cast<const float*>(x), static_cast<const float*>(dt),
               static_cast<const float*>(cum), static_cast<const float*>(b),
               static_cast<const float*>(c), static_cast<const int*>(seg),
               static_cast<float*>(y), L, H};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (heads_per_cta) {
    case 1: return static_cast<int>(launch<128, 64, 1>(a, G, segment != 0, s));
    case 2: return static_cast<int>(launch<128, 64, 2>(a, G, segment != 0, s));
    case 4: return static_cast<int>(launch<128, 64, 4>(a, G, segment != 0, s));
    default: return -1;
  }
}
