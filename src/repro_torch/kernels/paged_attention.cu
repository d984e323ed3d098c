// Paged flash attention for Hopper (sm_90a): the hand-written port of the
// TPU kernel `_paged_attn_kernel` / `paged_flash_attention`
// (src/repro/kernels/flash_attention.py:166, :238).
//
// Contract (pinned by tests/test_torch_kernels.py on the plain version and
// by tests/test_torch_kernels_gpu.py and chip_smoke.py on the card):
//   q (T, H, D) bf16; k/v pools (P, page_size, KV, D) bf16, or int8 with
//   per-(row, kv head) f32 scales (P, page_size, KV); block tables
//   (num_slots, num_blocks) int32; q_pos / q_slots (T,) int32.
//   Query t of slot s attends keys at absolute positions kp <= q_pos[t]
//   (and kp > q_pos[t] - window when window > 0) found through
//   tables[s, kp / page_size].  A table entry < 0 or >= P masks its whole
//   block and is never dereferenced.  Softcap s -> c*tanh(s/c) applies before
//   the mask.  Masked scores contribute exactly 0, so a padding query
//   (slot < 0) or a fully masked one writes an exact zero row.
//
// Bound: ~4*D flops per (head, key) against 2*D*sizeof(kv) bytes per
// (kv head, key) shared by the g = H/KV grouped heads: ~2 flop/B for bf16
// at g = 8, far under the card's ~295 flop/B, so the kernel is bound by the
// bytes of the pages it reads (and, at decode sizes, by latency).
//
// Design.  A CTA takes one (query token, KV head) and, when the grid would
// be too small to fill the card (decode), one of `splits` slices of the
// query's block range.  The pool is read in its native layout: a key row is
// D contiguous elements at ((page * page_size + r) * KV + kvh) * D, so the
// CTA's g query heads share every row it loads (no transpose of the pool).
//   * Inside a warp, head h owns lanes [h*LPH, (h+1)*LPH) with LPH = 32/GP,
//     GP the power of two at or above g (the lanes of heads g..GP-1 idle);
//     a lane holds D/LPH contiguous dims of its head's pre-scaled query and
//     output, loads the same dims of each K/V row (16-byte loads), and a
//     log2(LPH)-step shuffle finishes each score.
//   * Each warp walks its own blocks (b = warp, warp + NW, ...) with its own
//     online softmax, one row at a time, skipping masked rows and bad
//     pages: no barrier inside the loop.
//   * The warps' (max, sum, acc) merge once through shared memory.  With one
//     split the CTA writes the output; with several it writes its partial
//     and `paged_attention_combine` merges the splits (flash-decoding).
// All softmax math is f32; the output is rounded once to q's dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// N contiguous elements at p (16-byte aligned when N*sizeof(T) is a
// multiple of 16) as floats.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, float (&out)[N]) {
  constexpr int kPer16 = 16 / sizeof(T);
  if constexpr (N % kPer16 == 0) {
#pragma unroll
    for (int c = 0; c < N / kPer16; ++c) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p) + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kPer16; ++i) out[c * kPer16 + i] = to_f32(e[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(p[i]);
  }
}

template <int D, int GP, typename QT, typename KVT, bool QUANT>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const QT* __restrict__ q, const KVT* __restrict__ k_pool,
    const KVT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ q_pos, const int* __restrict__ q_slots,
    QT* __restrict__ out, float* __restrict__ part_acc, float* __restrict__ part_ml,
    int G, int KV, int num_pages, int page_size, int num_slots, int num_blocks,
    int blocks_per_split, int window, float softcap, float sm_scale) {
  constexpr int LPH = 32 / GP;  // lanes per query head
  constexpr int DPL = D / LPH;  // dims per lane
  const int t = blockIdx.x;
  const int kvh = blockIdx.y;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int H = KV * G;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = lane / LPH;
  const int d0 = (lane % LPH) * DPL;

  const int slot = q_slots[t];
  const int pos = q_pos[t];
  const bool valid_q = slot >= 0;
  const int slot_s = min(max(slot, 0), num_slots - 1);
  // admissible logical blocks [lo, hi) (flash_attention.py:184-188); C's
  // truncating division only differs from floor below 0, clamped away
  const int hi = valid_q ? min(pos / page_size + 1, num_blocks) : 0;
  const int lo = window > 0 ? max((pos - window + 1) / page_size, 0) : 0;
  const int b_begin = lo + split * blocks_per_split;
  const int b_end = min(hi, b_begin + blocks_per_split);

  float qv[DPL];
  if (h < G) {
    load_f32<QT, DPL>(q + ((size_t)t * H + kvh * G + h) * D + d0, qv);
  } else {
#pragma unroll
    for (int i = 0; i < DPL; ++i) qv[i] = 0.f;  // padding head: computed, never written
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) qv[i] *= sm_scale;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  const int* table = tables + (size_t)slot_s * num_blocks;
  for (int b = b_begin + warp; b < b_end; b += kWarps) {
    const int page = table[b];
    if (page < 0 || page >= num_pages) continue;  // bad entry: masked, never read
    const int kbase = b * page_size;
    // admissible rows of the block: kp <= pos and kp > pos - window
    const int r_end = min(page_size, pos - kbase + 1);
    const int r_begin = window > 0 ? max(0, pos - window + 1 - kbase) : 0;
    for (int r = r_begin; r < r_end; ++r) {
      const size_t row = ((size_t)page * page_size + r) * KV + kvh;
      float kv[DPL];
      load_f32<KVT, DPL>(k_pool + row * D + d0, kv);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) s = fmaf(qv[i], kv[i], s);
#pragma unroll
      for (int o = LPH / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (QUANT) s *= k_scale[row];
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      const float m_new = fmaxf(m, s);
      const float alpha = __expf(m - m_new);
      float p = __expf(s - m_new);
      l = l * alpha + p;
      m = m_new;
      load_f32<KVT, DPL>(v_pool + row * D + d0, kv);
      if (QUANT) p *= v_scale[row];
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] = fmaf(p, kv[i], acc[i] * alpha);
    }
  }

  // merge the warps: shared [kWarps][GP][D] accumulators plus (max, sum)
  extern __shared__ float smem[];
  float* s_acc = smem;
  float* s_m = s_acc + kWarps * GP * D;
  float* s_l = s_m + kWarps * GP;
#pragma unroll
  for (int i = 0; i < DPL; ++i) s_acc[(warp * GP + h) * D + d0 + i] = acc[i];
  if (lane % LPH == 0) {
    s_m[warp * GP + h] = m;
    s_l[warp * GP + h] = l;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int hh = i / D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w * GP + hh]);
    float sum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = __expf(s_m[w * GP + hh] - mx);
      sum += s_l[w * GP + hh] * c;
      a += s_acc[w * GP * D + i] * c;
    }
    if (splits == 1) {
      out[((size_t)t * H + kvh * G) * D + i] = from_f32<QT>(a / fmaxf(sum, 1e-30f));
    } else {
      const size_t cta = ((size_t)t * KV + kvh) * splits + split;
      part_acc[cta * G * D + i] = a;
      if (i % D == 0) {
        part_ml[(cta * G + hh) * 2] = mx;
        part_ml[(cta * G + hh) * 2 + 1] = sum;
      }
    }
  }
}

// Merge the splits' partials of one (token, KV head, query head) into the
// output: one thread per output dim.
template <int D, typename QT>
__global__ void __launch_bounds__(D) paged_attention_combine(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    QT* __restrict__ out, int G, int KV, int splits) {
  const int t = blockIdx.x;
  const int kvh = blockIdx.y;
  const int hh = blockIdx.z;
  const int d = threadIdx.x;
  const size_t cta0 = ((size_t)t * KV + kvh) * splits;
  float mx = kNegInf;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part_ml[((cta0 + s) * G + hh) * 2]);
  float sum = 0.f, a = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float c = __expf(part_ml[((cta0 + s) * G + hh) * 2] - mx);
    sum += part_ml[((cta0 + s) * G + hh) * 2 + 1] * c;
    a += part_acc[((cta0 + s) * G + hh) * D + d] * c;
  }
  out[(((size_t)t * KV + kvh) * G + hh) * D + d] = from_f32<QT>(a / fmaxf(sum, 1e-30f));
}

struct Args {
  const void *q, *k_pool, *v_pool, *k_scale, *v_scale, *tables, *q_pos, *q_slots;
  void *out, *part_acc, *part_ml;
  int T, G, KV, num_pages, page_size, num_slots, num_blocks, splits, blocks_per_split, window;
  float softcap, sm_scale;
  cudaStream_t stream;
};

template <int D, int GP, typename QT, typename KVT, bool QUANT>
cudaError_t launch(const Args& a) {
  const size_t smem = (size_t)(kWarps * GP * D + 2 * kWarps * GP) * sizeof(float);
  dim3 grid(a.T, a.KV, a.splits);
  paged_attention_kernel<D, GP, QT, KVT, QUANT><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KVT*>(a.k_pool),
      static_cast<const KVT*>(a.v_pool), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.q_pos), static_cast<const int*>(a.q_slots),
      static_cast<QT*>(a.out), static_cast<float*>(a.part_acc),
      static_cast<float*>(a.part_ml), a.G, a.KV, a.num_pages, a.page_size, a.num_slots,
      a.num_blocks, a.blocks_per_split, a.window, a.softcap, a.sm_scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return e;
  paged_attention_combine<D, QT><<<dim3(a.T, a.KV, a.G), D, 0, a.stream>>>(
      static_cast<const float*>(a.part_acc), static_cast<const float*>(a.part_ml),
      static_cast<QT*>(a.out), a.G, a.KV, a.splits);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Returns 0 on success, a CUDA
// error code when a launch is refused, or -1 for a shape the kernel does not
// take (the wrapper checks shapes first).  `part_acc` (T, KV, splits, g, D)
// and `part_ml` (T, KV, splits, g, 2) f32 scratch are used only when
// splits > 1.  The launches are asynchronous on `stream`; nothing is
// allocated here.
extern "C" int repro_paged_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* tables, const void* q_pos,
    const void* q_slots, void* out, void* part_acc, void* part_ml, int T, int H,
    int KV, int D, int num_pages, int page_size, int num_slots, int num_blocks,
    int splits, int blocks_per_split, int window, float softcap, float sm_scale,
    int q_is_bf16, int kv_is_int8, void* stream) {
  if (T == 0) return 0;
  if (KV <= 0 || H % KV != 0 || page_size <= 0 || num_slots <= 0 || num_blocks <= 0 ||
      splits <= 0 || blocks_per_split <= 0 || (splits > 1 && (!part_acc || !part_ml))) {
    return -1;
  }
  const int G = H / KV;
  // Only the shapes the port serves are instantiated: qwen2.5-3b (D 128,
  // g 8) with bf16 queries over bf16 or int8 pools.  A config with another
  // head dim or group adds its launch<D, GP, ...> here (GP: g rounded up to
  // a power of two, D * GP <= 2048 so a lane's query, accumulator and row
  // slices stay in registers) and its (D, g) to SERVED in flash_attention.py.
  if (D != 128 || G != 8 || !q_is_bf16) return -1;
  const Args a{q, k_pool, v_pool, k_scale, v_scale, tables, q_pos, q_slots, out,
               part_acc, part_ml, T, G, KV, num_pages, page_size, num_slots, num_blocks,
               splits, blocks_per_split, window, softcap, sm_scale,
               static_cast<cudaStream_t>(stream)};
  const cudaError_t e = kv_is_int8 ? launch<128, 8, __nv_bfloat16, int8_t, true>(a)
                                   : launch<128, 8, __nv_bfloat16, __nv_bfloat16, false>(a);
  return static_cast<int>(e);
}
