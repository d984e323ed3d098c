// Flash attention for training on Hopper (sm_90a), forward and backward: the
// hand-written port of the TPU kernel `_attn_kernel` / `flash_attention`
// (src/repro/kernels/flash_attention.py:29, :91).  The Pallas package has no
// backward; this file adds one.
//
// Contract (pinned by tests/test_torch_kernels.py on the plain versions in
// kernels/ref.py and by tests/test_torch_kernels_gpu.py and chip_smoke.py on
// the card):
//   q (B, H, Sq, D), k/v (B, KV, Sk, D) bf16, each read through its own
//   (batch, head, position) strides with D contiguous, so the model's
//   (B, S, H, D) activations are passed as transposed views, never copied.
//   Query i sits at position i + (Sk - Sq) (right-aligned, :41); it attends
//   key j when j <= its position (causal), j > its position - window
//   (window > 0) and, with segment ids, q_seg[b, i] == kv_seg[b, j].  KV head
//   h / g serves query head h (g = H / KV): k and v are never repeated.
//   Forward writes o (B, H, Sq, D) through o's strides and the per-row
//   log-sum-exp lse (B, H, Sq) f32 of the scaled logits.
//   A forward CTA takes 128 query rows and walks 64-key steps over the TPU
//   kernel's key range at its default 128/128 blocks (lo/hi of :45-53), so
//   a query with no admissible key returns, as
//   the TPU kernel does, the mean of the values in that range (every score
//   -1e30, every weight exp(0)), and a query whose range is empty returns 0.
//
// Backward (grads of o through the saved lse): dq, dk, dv in q's / k's /
// v's layouts.  P is recomputed per tile from q, k and lse; the (S, S)
// matrix is never stored.  Inadmissible (q, k) pairs get P = 0, so a query
// with no admissible key receives and sends no gradient.  Four launches, no
// atomics (deterministic from run to run):
//   1. `attn_bwd_delta`: delta = rowsum(dO * O) per (b, h, i), f32;
//   2. `attn_bwd_dkdv`: one CTA per (64-key tile, query head, batch) walks
//      its 64-row query steps and writes f32 partials of dK and dV (one
//      consumer warpgroup accumulates dV, the other dK);
//   3. `attn_bwd_group_sum`: sums the g partials of each KV head in head
//      order and writes bf16 dK, dV;
//   4. `attn_bwd_dq`: dQ by a second pass, one CTA per (128-query tile,
//      head, batch) over 64-key steps.
//
// Bound: at Sq = Sk = 2048, D = 128, causal, the forward does ~4*D flops per
// admissible (head, key, query) against ~(q + k + v + o) bytes read once:
// ~1,000 flop/B, above the card's ~295, so it is bound by operations; so is
// the backward (~2.5x the forward's flops).  So the design keeps the tensor
// cores fed: wgmma, loads overlapped with the products, and accumulators
// that fit in registers (ptxas -v reports no spills; a dK/dV CTA that held
// both dK and dV in one warpgroup spilled and serialized its wgmmas).
//
// Design, for Hopper: every CTA is two consumer warpgroups (64 rows each)
// and a producer warpgroup.  The producer's one thread issues TMA loads
// (`cp.async.bulk.tensor`, 128-byte swizzle, a (rows, 128) bf16 tile as two
// slabs of 64 columns) into a ring of `STAGES` buffers; `mbarrier`s signal
// arrival (transaction bytes) and release (one arrival per consumer warp).
// Every product is `wgmma.mma_async` (bf16 in, f32 accumulators in
// registers): both operands from shared memory for S = Q K^T and dP = dO V^T,
// and the probabilities (P, dS) converted to bf16 in registers as the A
// operand of O += P V, dV += P^T dO, dK += dS^T Q and dQ += dS K, whose B
// operand is read MN-major (transposed by the descriptor, never copied).  The
// online softmax runs in registers (row max and sum across the four lanes of
// a row by shuffles).  Masks are applied only on the tiles the schedule
// (`tile_plan` in kernels/flash_attention.py, passed as a device table)
// does not mark free, and on every tile with segment ids, whose key (or
// query) ids are staged in shared memory by the same TMA transaction.  The
// schedule lists CTAs longest walk first.  Only D = 128 in bf16 is
// instantiated (qwen2.5-3b); Sq and Sk must be multiples of 64, and of 128
// above 128; the wrapper raises on any other shape.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 128;
constexpr int SLAB = 64;     // bf16 columns of one 128-byte swizzled slab
constexpr int TILE = 128;    // query rows of a forward / dQ CTA
constexpr int STEP = 64;     // keys of a forward / dQ step and of a dK/dV CTA;
                             // query rows of a dK/dV step
constexpr int STAGES = 2;    // ring depth of the streamed tiles
constexpr int CONSUMER_WARPS = 8;  // two warpgroups
// plus a producer warpgroup: with 9 warps one SM sub-partition holds 3 of
// them and ptxas caps every thread at 168 registers; with 12, `setmaxnreg`
// moves the producer's registers to the consumers (40 / 232 a thread)
constexpr int THREADS = (CONSUMER_WARPS + 4) * 32;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int PLAN_COLS = 6;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Layout {  // element strides of a (B, heads, S, D) tensor, D contiguous
  long long b, h, s;
};

struct Problem {
  int h, kvh, sq, sk, causal, window;
  float scale;
  const int* q_seg;   // (B, Sq) or null
  const int* kv_seg;  // (B, Sk) or null
  const int* plan;    // (CTAs, PLAN_COLS) int32, launch order (tile_plan)
};

__device__ __forceinline__ bool admissible(const Problem& p, int qpos, int kpos) {
  return (!p.causal || kpos <= qpos) && (p.window <= 0 || kpos > qpos - p.window);
}

// ---------------------------------------------------------------------------
// shared memory, barriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the dynamic shared-memory window rounded up to 1024 bytes (the 128-byte
// swizzle repeats every 8 rows of 128 bytes; each slab starts on a repeat)
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + ((1024 - (a & 1023)) & 1023);
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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait for the phase of parity `parity` to complete.  A wait that outlasts
// any real one (2^26 polls, seconds) traps: a broken pipeline fails the
// launch instead of hanging the card.
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

// one (box rows, 64) slab of a 4-D (D, S, heads, B) tensor map into shared memory
__device__ __forceinline__ void tma_slab(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int s, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(s), "r"(h), "r"(b), "r"(smem_u32(bar))
      : "memory");
}

// a (rows, D) tile at position s: two slabs, columns [0, 64) then [64, 128)
__device__ __forceinline__ void tma_tile(bf16* dst, int rows, const CUtensorMap* map,
                                         uint64_t* bar, int s, int h, int b) {
  tma_slab(dst, map, bar, 0, s, h, b);
  tma_slab(dst + rows * SLAB, map, bar, SLAB, s, h, b);
}

// `bytes` (a multiple of 16, 16-byte aligned) from global to shared memory
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading byte offset `lbo`, stride byte offset 1024 (8 rows of
// 128 bytes), layout "128B swizzle".
__device__ __forceinline__ uint64_t desc(const bf16* p, uint32_t lbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

// K-major operand (the reduction axis is D, contiguous): rows [r0, r0 + n)
// of a tile of `rows` rows, D columns [16 kk, 16 kk + 16)
__device__ __forceinline__ uint64_t kmajor(const bf16* tile, int rows, int r0, int kk) {
  return desc(tile + (kk / 4) * rows * SLAB + r0 * SLAB + (kk % 4) * 16, 16);
}

// MN-major operand (the reduction axis is the tile's rows): rows [16 kk,
// 16 kk + 16) of a tile of `rows` rows, all D columns (slab 1 `lbo` bytes on)
__device__ __forceinline__ uint64_t mnmajor(const bf16* tile, int rows, int kk) {
  return desc(tile + kk * 16 * SLAB, rows * SLAB * 2);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads of an accumulator across the wait
template <int N>
__device__ __forceinline__ void keep(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A operand (16 columns per k-step) from an m64nN accumulator: thread
// (warp w, lane 4 r + c) holds rows 16 w + r and + 8, columns 8 j + 2 c, + 1
template <int N>
__device__ __forceinline__ void to_a(const float (&d)[N], uint32_t (&a)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) a[i] = pack_bf16(d[2 * i], d[2 * i + 1]);
}

// D (64 x 64 f32, registers) = A (64 x 16) . B (64 x 16)^T, the first
// k-step: D's old value is dead (write-only operands, so the compiler keeps
// no copy of it); A and B bf16 K-major in shared memory
__device__ __forceinline__ void wgmma_ss64_first(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(a), "l"(b), "r"(0));
}

// D (64 x 64 f32, registers) += A (64 x 16) . B (64 x 16)^T; A and B bf16 K-major in shared memory
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// D (64 x 128 f32) += A (64 x 16 bf16 in registers, the accumulator's layout)
// . B (16 x 128 bf16 in shared memory, MN-major: N contiguous)
__device__ __forceinline__ void wgmma_rs128(float (&d)[64], uint32_t a0, uint32_t a1,
                                            uint32_t a2, uint32_t a3,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// D (64 x 64) = A . B^T reduced over D = 128: A is rows [a_r0, a_r0 + 64)
// of an `a_rows`-row tile, B the 64 rows of a 64-row tile (both K-major)
__device__ __forceinline__ void product64(float (&d)[32], const bf16* a, int a_rows, int a_r0,
                                          const bf16* b) {
  wgmma_ss64_first(d, kmajor(a, a_rows, a_r0, 0), kmajor(b, STEP, 0, 0));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    wgmma_ss64(d, kmajor(a, a_rows, a_r0, kk), kmajor(b, STEP, 0, kk));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}


// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

constexpr int TILE_BYTES = TILE * D * 2;  // a (128, D) bf16 tile
constexpr int STEP_BYTES = STEP * D * 2;  // a (64, D) bf16 tile
constexpr int F_K = TILE_BYTES;
constexpr int F_V = F_K + STAGES * STEP_BYTES;
constexpr int F_SEG = F_V + STAGES * STEP_BYTES;
constexpr int F_BAR = F_SEG + STAGES * STEP * 4;
constexpr size_t FWD_SMEM = F_BAR + 8 * (1 + 3 * STAGES) + 1024;

// grid (H, B, query tiles in plan order); plan row: (q0, key step lo, hi,
// free lo, free hi, key end), in 64-key steps
__global__ void __launch_bounds__(THREADS, 1) attn_fwd(
    const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
    const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o, float* __restrict__ lse,
    Layout lo, Problem p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + F_K);
  bf16* sV = reinterpret_cast<bf16*>(smem + F_V);
  int* sSeg = reinterpret_cast<int*>(smem + F_SEG);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + F_BAR);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty = full_v + STAGES;

  const int* row = p.plan + blockIdx.z * PLAN_COLS;
  const int q0 = row[0], t_lo = row[1], t_hi = row[2], f_lo = row[3], f_hi = row[4];
  const int k_end = row[5];
  const int hh = blockIdx.x, b = blockIdx.y, kh = hh / (p.h / p.kvh);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {  // producer warpgroup: one thread issues every load
    regs_dec<PRODUCER_REGS>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      mbar_expect_tx(bar_q, TILE_BYTES);
      tma_tile(sQ, TILE, &mq, bar_q, q0, hh, b);
      for (int t = t_lo, i = 0; t < t_hi; ++t, ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], (i / STAGES - 1) & 1);
        mbar_expect_tx(&full_k[s], STEP_BYTES + (p.q_seg ? STEP * 4 : 0));
        tma_tile(sK + s * STEP * D, STEP, &mk, &full_k[s], t * STEP, kh, b);
        if (p.q_seg)
          bulk_copy(sSeg + s * STEP, p.kv_seg + (long long)b * p.sk + t * STEP, STEP * 4,
                    &full_k[s]);
        mbar_expect_tx(&full_v[s], STEP_BYTES);
        tma_tile(sV + s * STEP * D, STEP, &mv, &full_v[s], t * STEP, kh, b);
      }
    }
    return;
  }
  regs_inc<CONSUMER_REGS>();

  // consumers: warpgroup wg owns query rows [q0 + 64 wg, +64); this thread
  // rows r0 and r0 + 8, key columns 8 j + 2 c (+1) of each 8-key chunk j
  const int wg = warp / 4, g = lane / 4, c = lane % 4;
  const int r0 = q0 + wg * 64 + (warp % 4) * 16 + g;
  const int off = p.sk - p.sq;
  const float sl2 = p.scale * LOG2E;
  int qseg[2] = {0, 0};
  if (p.q_seg) {
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (r0 + 8 * e < p.sq) qseg[e] = p.q_seg[(long long)b * p.sq + r0 + 8 * e];
  }
  float acc[64], sc[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  mbar_wait(bar_q, 0);

  for (int t = t_lo, i = 0; t < t_hi; ++t, ++i) {
    const int s = i % STAGES, parity = (i / STAGES) & 1;
    const bf16* tk = sK + s * STEP * D;
    const bf16* tv = sV + s * STEP * D;
    mbar_wait(&full_k[s], parity);
    wg_fence();
    product64(sc, sQ, TILE, wg * 64, tk);
    wg_commit();
    wg_wait<0>();
    keep(sc);

    // logits in log2 units; masked (one uniform branch around the whole
    // step, so unmasked steps run none of it): -1e30 inside the visited
    // range, -inf past it
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] *= sl2;
    if (p.q_seg != nullptr || t < f_lo || t >= f_hi) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kcol = 8 * j + 2 * c + (e & 1), kpos = t * STEP + kcol;
          const int qpos = r0 + 8 * (e >> 1) + off;
          if (kpos >= k_end)
            sc[4 * j + e] = -CUDART_INF_F;
          else if (!admissible(p, qpos, kpos) ||
                   (p.q_seg && sSeg[s * STEP + kcol] != qseg[e >> 1]))
            sc[4 * j + e] = NEG;
        }
      }
    }
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    float alpha[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
      const float mn = fmaxf(m[e], mx[e]);
      alpha[e] = ex2(m[e] - mn);
      m[e] = mn;
      l[e] *= alpha[e];
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float pr = ex2(sc[j] - m[(j >> 1) & 1]);
      sc[j] = pr;
      l[(j >> 1) & 1] += pr;
    }
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] *= alpha[(j >> 1) & 1];
    uint32_t pa[16];
    to_a(sc, pa);

    mbar_wait(&full_v[s], parity);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < STEP / 16; ++kk)
      wgmma_rs128(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                  mnmajor(tv, STEP, kk));
    wg_commit();
    wg_wait<0>();
    keep(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
    const int r = r0 + 8 * e;
    if (r >= p.sq) continue;
    const float inv = 1.f / fmaxf(l[e], 1e-30f);
    bf16* og = o + b * lo.b + hh * lo.h + (long long)r * lo.s + 2 * c;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<__nv_bfloat162*>(og + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * e] * inv, acc[4 * j + 2 * e + 1] * inv);
    if (c == 0)
      lse[((long long)b * p.h + hh) * p.sq + r] =
          m[e] == NEG ? NEG : (m[e] + __log2f(fmaxf(l[e], 1e-30f))) * LN2;
  }
}

// ---------------------------------------------------------------------------
// backward 1: delta = rowsum(dO * O), a half warp per (b, h, i) row
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(128) attn_bwd_delta(
    const bf16* __restrict__ o, const bf16* __restrict__ dout, float* __restrict__ delta,
    Layout lo, Layout ldo, int b_count, int h, int sq) {
  const long long rowid = ((long long)blockIdx.x * 128 + threadIdx.x) / 16;
  const int col = (threadIdx.x % 16) * 8;
  if (rowid >= (long long)b_count * h * sq) return;  // whole warps leave together
  const int i = rowid % sq;
  const int hh = (rowid / sq) % h;
  const int b = rowid / ((long long)sq * h);
  const uint4 a = *reinterpret_cast<const uint4*>(o + b * lo.b + hh * lo.h + i * lo.s + col);
  const uint4 d = *reinterpret_cast<const uint4*>(dout + b * ldo.b + hh * ldo.h + i * ldo.s + col);
  const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d);
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 x = __bfloat1622float2(a2[k]), y = __bfloat1622float2(d2[k]);
    acc += x.x * y.x + x.y * y.y;
  }
#pragma unroll
  for (int sh = 8; sh > 0; sh >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, sh);
  if (threadIdx.x % 16 == 0) delta[rowid] = acc;  // (B, H, Sq): rowid = (b * h + hh) * sq + i
}

// ---------------------------------------------------------------------------
// backward 2: f32 partials of dK, dV for one (64-key tile, query head, batch)
// ---------------------------------------------------------------------------

constexpr int B_V = STEP_BYTES;
constexpr int B_Q = 2 * STEP_BYTES;
constexpr int B_DO = B_Q + STAGES * STEP_BYTES;
constexpr int B_LSE = B_DO + STAGES * STEP_BYTES;
constexpr int B_DELTA = B_LSE + STAGES * STEP * 4;
constexpr int B_SEG = B_DELTA + STAGES * STEP * 4;
constexpr int B_BAR = B_SEG + STAGES * STEP * 4;
constexpr size_t DKDV_SMEM = B_BAR + 8 * (1 + 2 * STAGES) + 1024;

// The shared-memory tiles and the walk of one dK/dV CTA, as its consumers see them
struct DkdvTiles {
  const bf16 *k, *v, *q, *dout;        // K, V (64 keys); Q, dO stages (64 rows each)
  const float *lse, *delta;            // stages of 64 rows
  const int* seg;                      // stages of 64 query segment ids
  uint64_t *full, *empty;
  int k0, s_lo, s_hi, f_lo, f_hi;
};

// One consumer warpgroup's walk over the query steps: warpgroup 0
// accumulates dV += P^T dO, warpgroup 1 dK += dS^T Q, each for all 64 keys
// of the tile (S^T = K Q^T is formed by both), so each holds one 64 x D
// accumulator; this thread keys kr0 and kr0 + 8, query columns 8 n + 2 c
// (+1) of each 8-row chunk n.  Writes the warpgroup's partial (dK scaled).
template <bool DK>
__device__ __forceinline__ void dkdv_consumer(const DkdvTiles& t, const Problem& p, int b, int hh,
                                              float* __restrict__ part) {
  const int lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
  const int kr0 = t.k0 + (threadIdx.x / 32 % 4) * 16 + g;
  const int off = p.sk - p.sq;
  const float sl2 = p.scale * LOG2E;
  int kseg[2] = {0, 0};
  if (p.q_seg) {
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (kr0 + 8 * e < p.sk) kseg[e] = p.kv_seg[(long long)b * p.sk + kr0 + 8 * e];
  }
  float acc[64], st[32], dpt[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int j = t.s_lo, i = 0; j < t.s_hi; ++j, ++i) {
    const int s = i % STAGES, q0 = j * STEP;
    const bf16* tq = t.q + s * STEP * D;
    const bf16* tdo = t.dout + s * STEP * D;
    const float* tl = t.lse + s * STEP;
    mbar_wait(&t.full[s], (i / STAGES) & 1);
    // S^T = K Q^T (and for dK, dP^T = V dO^T): (64 keys, 64 queries)
    wg_fence();
    product64(st, t.k, STEP, 0, tq);
    wg_commit();
    if (DK) {
      product64(dpt, t.v, STEP, 0, tdo);
      wg_commit();
    }
    wg_wait<0>();
    keep(st);
    if (DK) keep(dpt);

    // P^T = exp(S^T scale - lse) on admissible pairs, 0 elsewhere (the mask
    // under one uniform branch)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[4 * n + e] = ex2(st[4 * n + e] * sl2 - tl[8 * n + 2 * c + (e & 1)] * LOG2E);
    if (p.q_seg != nullptr || j < t.f_lo || j >= t.f_hi) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qcol = 8 * n + 2 * c + (e & 1), kpos = kr0 + 8 * (e >> 1);
          if (kpos >= p.sk || !admissible(p, q0 + qcol + off, kpos) ||
              (p.q_seg && t.seg[s * STEP + qcol] != kseg[e >> 1]))
            st[4 * n + e] = 0.f;
        }
      }
    }
    uint32_t fa[16];
    if (DK) {  // dS^T = P^T (dP^T - delta)
      const float* td = t.delta + s * STEP;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[4 * n + e] = st[4 * n + e] * (dpt[4 * n + e] - td[8 * n + 2 * c + (e & 1)]);
      to_a(dpt, fa);
    } else {
      to_a(st, fa);
    }

    // dV += P^T dO or dK += dS^T Q: (64 keys, D), reduced over the 64 queries
    const bf16* rhs = DK ? tq : tdo;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < STEP / 16; ++kk)
      wgmma_rs128(acc, fa[4 * kk], fa[4 * kk + 1], fa[4 * kk + 2], fa[4 * kk + 3],
                  mnmajor(rhs, STEP, kk));
    wg_commit();
    wg_wait<0>();
    keep(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&t.empty[s]);
  }

  const float mul = DK ? p.scale : 1.f;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int key = kr0 + 8 * e;
    if (key >= p.sk) continue;
    float* row = part + (((long long)b * p.h + hh) * p.sk + key) * D + 2 * c;
#pragma unroll
    for (int n = 0; n < 16; ++n)
      *reinterpret_cast<float2*>(row + 8 * n) =
          make_float2(acc[4 * n + 2 * e] * mul, acc[4 * n + 2 * e + 1] * mul);
  }
}

// grid (H, B, key tiles in plan order); plan row: (k0, query step lo, hi,
// free lo, free hi, Sq).  Writes dk_part / dv_part (B, H, Sk, D) f32, dK
// already scaled.
__global__ void __launch_bounds__(THREADS, 1) attn_bwd_dkdv(
    const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mdo,
    const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk_part,
    float* __restrict__ dv_part, Problem p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = reinterpret_cast<bf16*>(smem + B_V);
  bf16* sQ = reinterpret_cast<bf16*>(smem + B_Q);
  bf16* sdO = reinterpret_cast<bf16*>(smem + B_DO);
  float* sLse = reinterpret_cast<float*>(smem + B_LSE);
  float* sDelta = reinterpret_cast<float*>(smem + B_DELTA);
  int* sSeg = reinterpret_cast<int*>(smem + B_SEG);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + B_BAR);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + STAGES;

  const int* row = p.plan + blockIdx.z * PLAN_COLS;
  const int k0 = row[0], s_lo = row[1], s_hi = row[2];
  const int hh = blockIdx.x, b = blockIdx.y, kh = hh / (p.h / p.kvh);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long lrow = ((long long)b * p.h + hh) * p.sq;  // (b, hh) row of lse / delta

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {  // producer warpgroup: one thread issues every load
    regs_dec<PRODUCER_REGS>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      mbar_expect_tx(bar_kv, 2 * STEP_BYTES);
      tma_tile(sK, STEP, &mk, bar_kv, k0, kh, b);
      tma_tile(sV, STEP, &mv, bar_kv, k0, kh, b);
      for (int j = s_lo, i = 0; j < s_hi; ++j, ++i) {
        const int s = i % STAGES, q0 = j * STEP;
        if (i >= STAGES) mbar_wait(&empty[s], (i / STAGES - 1) & 1);
        mbar_expect_tx(&full[s], 2 * STEP_BYTES + 2 * STEP * 4 + (p.q_seg ? STEP * 4 : 0));
        tma_tile(sQ + s * STEP * D, STEP, &mq, &full[s], q0, hh, b);
        tma_tile(sdO + s * STEP * D, STEP, &mdo, &full[s], q0, hh, b);
        bulk_copy(sLse + s * STEP, lse + lrow + q0, STEP * 4, &full[s]);
        bulk_copy(sDelta + s * STEP, delta + lrow + q0, STEP * 4, &full[s]);
        if (p.q_seg)
          bulk_copy(sSeg + s * STEP, p.q_seg + (long long)b * p.sq + q0, STEP * 4, &full[s]);
      }
    }
    return;
  }
  regs_inc<CONSUMER_REGS>();

  const DkdvTiles t{sK, sV, sQ, sdO, sLse, sDelta, sSeg, full, empty,
                    k0, s_lo, s_hi, row[3], row[4]};
  mbar_wait(bar_kv, 0);
  if (warp < 4)
    dkdv_consumer<false>(t, p, b, hh, dv_part);
  else
    dkdv_consumer<true>(t, p, b, hh, dk_part);
}

// ---------------------------------------------------------------------------
// backward 3: dK, dV = the g query heads' partials summed in head order
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256) attn_bwd_group_sum(
    const float* __restrict__ dk_part, const float* __restrict__ dv_part, bf16* __restrict__ dk,
    bf16* __restrict__ dv, Layout lk, Layout lv, int b_count, int h, int kvh, int sk) {
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;  // one 4-column group
  if (idx >= (long long)b_count * kvh * sk * (D / 4)) return;
  const int col = (idx % (D / 4)) * 4;
  const int key = (idx / (D / 4)) % sk;
  const int kh = (idx / (D / 4) / sk) % kvh;
  const int b = idx / ((long long)(D / 4) * sk * kvh);
  const int g = h / kvh;
  float4 sk4 = make_float4(0.f, 0.f, 0.f, 0.f), sv4 = sk4;
#pragma unroll 8
  for (int i = 0; i < g; ++i) {
    const long long at = (((long long)b * h + kh * g + i) * sk + key) * D + col;
    const float4 x = *reinterpret_cast<const float4*>(dk_part + at);
    const float4 y = *reinterpret_cast<const float4*>(dv_part + at);
    sk4.x += x.x; sk4.y += x.y; sk4.z += x.z; sk4.w += x.w;
    sv4.x += y.x; sv4.y += y.y; sv4.z += y.z; sv4.w += y.w;
  }
  __nv_bfloat162* ok =
      reinterpret_cast<__nv_bfloat162*>(dk + b * lk.b + kh * lk.h + key * lk.s + col);
  __nv_bfloat162* ov =
      reinterpret_cast<__nv_bfloat162*>(dv + b * lv.b + kh * lv.h + key * lv.s + col);
  ok[0] = __floats2bfloat162_rn(sk4.x, sk4.y);
  ok[1] = __floats2bfloat162_rn(sk4.z, sk4.w);
  ov[0] = __floats2bfloat162_rn(sv4.x, sv4.y);
  ov[1] = __floats2bfloat162_rn(sv4.z, sv4.w);
}

// ---------------------------------------------------------------------------
// backward 4: dQ for one (128-query tile, head, batch), second pass
// ---------------------------------------------------------------------------

constexpr int Q_DO = TILE_BYTES;
constexpr int Q_K = 2 * TILE_BYTES;
constexpr int Q_V = Q_K + STAGES * STEP_BYTES;
constexpr int Q_SEG = Q_V + STAGES * STEP_BYTES;
constexpr int Q_BAR = Q_SEG + STAGES * STEP * 4;
constexpr size_t DQ_SMEM = Q_BAR + 8 * (1 + 2 * STAGES) + 1024;

// grid (H, B, query tiles in plan order); plan row: (q0, key step lo, hi,
// free lo, free hi, Sk)
__global__ void __launch_bounds__(THREADS, 1) attn_bwd_dq(
    const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mdo,
    const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq,
    Layout lq, Problem p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = reinterpret_cast<bf16*>(smem + Q_DO);
  bf16* sK = reinterpret_cast<bf16*>(smem + Q_K);
  bf16* sV = reinterpret_cast<bf16*>(smem + Q_V);
  int* sSeg = reinterpret_cast<int*>(smem + Q_SEG);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + Q_BAR);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + STAGES;

  const int* row = p.plan + blockIdx.z * PLAN_COLS;
  const int q0 = row[0], s_lo = row[1], s_hi = row[2], f_lo = row[3], f_hi = row[4];
  const int hh = blockIdx.x, b = blockIdx.y, kh = hh / (p.h / p.kvh);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {  // producer warpgroup: one thread issues every load
    regs_dec<PRODUCER_REGS>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      mbar_expect_tx(bar_q, 2 * TILE_BYTES);
      tma_tile(sQ, TILE, &mq, bar_q, q0, hh, b);
      tma_tile(sdO, TILE, &mdo, bar_q, q0, hh, b);
      for (int j = s_lo, i = 0; j < s_hi; ++j, ++i) {
        const int s = i % STAGES, k0 = j * STEP;
        if (i >= STAGES) mbar_wait(&empty[s], (i / STAGES - 1) & 1);
        mbar_expect_tx(&full[s], 2 * STEP_BYTES + (p.q_seg ? STEP * 4 : 0));
        tma_tile(sK + s * STEP * D, STEP, &mk, &full[s], k0, kh, b);
        tma_tile(sV + s * STEP * D, STEP, &mv, &full[s], k0, kh, b);
        if (p.q_seg)
          bulk_copy(sSeg + s * STEP, p.kv_seg + (long long)b * p.sk + k0, STEP * 4, &full[s]);
      }
    }
    return;
  }
  regs_inc<CONSUMER_REGS>();

  // consumers: warpgroup wg owns query rows [q0 + 64 wg, +64); this thread
  // rows r0 and r0 + 8, key columns 8 n + 2 c (+1) of each 8-key chunk n
  const int wg = warp / 4, g = lane / 4, c = lane % 4;
  const int r0 = q0 + wg * 64 + (warp % 4) * 16 + g;
  const int off = p.sk - p.sq;
  const float sl2 = p.scale * LOG2E;
  float rl[2] = {0.f, 0.f}, rd[2] = {0.f, 0.f};
  int qseg[2] = {0, 0};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = r0 + 8 * e;
    if (r >= p.sq) continue;  // a 64-row problem: the tile's second half is padding
    const long long at = ((long long)b * p.h + hh) * p.sq + r;
    rl[e] = lse[at] * LOG2E;
    rd[e] = delta[at];
    if (p.q_seg) qseg[e] = p.q_seg[(long long)b * p.sq + r];
  }
  float acc[64], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  mbar_wait(bar_q, 0);

  for (int j = s_lo, i = 0; j < s_hi; ++j, ++i) {
    const int s = i % STAGES, k0 = j * STEP;
    const bf16* tk = sK + s * STEP * D;
    const bf16* tv = sV + s * STEP * D;
    mbar_wait(&full[s], (i / STAGES) & 1);
    // S = Q K^T and dP = dO V^T: (64 queries, 64 keys) each
    wg_fence();
    product64(sc, sQ, TILE, wg * 64, tk);
    wg_commit();
    product64(dp, sdO, TILE, wg * 64, tv);
    wg_commit();
    wg_wait<0>();
    keep(sc);
    keep(dp);

#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = ex2(sc[i] * sl2 - rl[(i >> 1) & 1]);
    if (p.q_seg != nullptr || j < f_lo || j >= f_hi) {  // the mask, under one uniform branch
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kcol = 8 * n + 2 * c + (e & 1);
          if (!admissible(p, r0 + 8 * (e >> 1) + off, k0 + kcol) ||
              (p.q_seg && sSeg[s * STEP + kcol] != qseg[e >> 1]))
            sc[4 * n + e] = 0.f;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = sc[i] * (dp[i] - rd[(i >> 1) & 1]);
    uint32_t da[16];
    to_a(dp, da);

    // dQ += dS K: (64 queries, D), reduced over the 64 keys
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < STEP / 16; ++kk)
      wgmma_rs128(acc, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3],
                  mnmajor(tk, STEP, kk));
    wg_commit();
    wg_wait<0>();
    keep(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = r0 + 8 * e;
    if (r >= p.sq) continue;
    bf16* qg = dq + b * lq.b + hh * lq.h + (long long)r * lq.s + 2 * c;
#pragma unroll
    for (int n = 0; n < 16; ++n)
      *reinterpret_cast<__nv_bfloat162*>(qg + 8 * n) =
          __floats2bfloat162_rn(acc[4 * n + 2 * e] * p.scale, acc[4 * n + 2 * e + 1] * p.scale);
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps and launches
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled is a driver-API call; it is taken through the
// runtime's entry-point query, so the library links no libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// a (B, heads, S, D) bf16 tensor with element strides `l` as a 4-D map
// (D, S, heads, B), loaded in (64, rows) boxes with the 128-byte swizzle;
// rows past S read as zeros
bool make_map(CUtensorMap* map, const void* base, int b, int heads, int s, const Layout& l,
              int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)s, (cuuint64_t)heads, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)l.s * 2, (cuuint64_t)l.h * 2, (cuuint64_t)l.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)SLAB, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Raise a kernel's dynamic shared-memory limit once per process (the first
// call is made outside any CUDA-graph capture: the wrappers' first use).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  *done = e == cudaSuccess;
  return e;
}
bool fwd_smem_set = false, dkdv_smem_set = false, dq_smem_set = false;

// a multiple of 64, and of 128 above 128
bool length_ok(int s) { return s > 0 && s % 64 == 0 && (s <= 128 || s % 128 == 0); }

bool shape_ok(int b, int h, int kvh, int sq, int sk, int d) {
  return b > 0 && kvh > 0 && h % kvh == 0 && d == D && length_ok(sq) && length_ok(sk);
}

int tiles(int s) { return (s + TILE - 1) / TILE; }

}  // namespace

static_assert(FWD_SMEM <= 232448 && DKDV_SMEM <= 232448 && DQ_SMEM <= 232448,
              "a CTA's shared memory must fit in the SM's 227 KB");

// strides: 3 per tensor, (batch, head, position) in elements; plan: the
// forward schedule (tile_plan("fwd", ...)).  Returns 0, a CUDA error code,
// -1 for a shape the kernels do not take or -2 when a tensor map is refused.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         void* lse, const void* q_seg, const void* kv_seg,
                                         const void* plan, int b, int h, int kvh, int sq, int sk,
                                         int d, const long long* strides, int causal, int window,
                                         float scale, void* stream) {
  if (!shape_ok(b, h, kvh, sq, sk, d) || (q_seg == nullptr) != (kv_seg == nullptr)) return -1;
  const Layout lq{strides[0], strides[1], strides[2]}, lk{strides[3], strides[4], strides[5]},
      lv{strides[6], strides[7], strides[8]}, lo{strides[9], strides[10], strides[11]};
  const Problem p{h, kvh, sq, sk, causal, window, scale, static_cast<const int*>(q_seg),
                  static_cast<const int*>(kv_seg), static_cast<const int*>(plan)};
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, b, h, sq, lq, TILE) || !make_map(&mk, k, b, kvh, sk, lk, STEP) ||
      !make_map(&mv, v, b, kvh, sk, lv, STEP))
    return -2;
  cudaError_t e = allow_smem(attn_fwd, FWD_SMEM, &fwd_smem_set);
  if (e != cudaSuccess) return (int)e;
  attn_fwd<<<dim3(h, b, tiles(sq)), THREADS, FWD_SMEM, static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, static_cast<bf16*>(o), static_cast<float*>(lse), lo, p);
  return (int)cudaGetLastError();
}

// strides: q, k, v, o, dout; dq / dk / dv share q's / k's / v's strides;
// delta (B, H, Sq) and dk_part / dv_part (B, H, Sk, D) are f32 scratch;
// plans: tile_plan("dkdv", ...) and tile_plan("dq", ...).
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         void* delta, void* dq, void* dk, void* dv,
                                         void* dk_part, void* dv_part, const void* q_seg,
                                         const void* kv_seg, const void* plan_dkdv,
                                         const void* plan_dq, int b, int h, int kvh, int sq,
                                         int sk, int d, const long long* strides, int causal,
                                         int window, float scale, void* stream) {
  if (!shape_ok(b, h, kvh, sq, sk, d) || (q_seg == nullptr) != (kv_seg == nullptr)) return -1;
  const Layout lq{strides[0], strides[1], strides[2]}, lk{strides[3], strides[4], strides[5]},
      lv{strides[6], strides[7], strides[8]}, lo{strides[9], strides[10], strides[11]},
      ldo{strides[12], strides[13], strides[14]};
  Problem p{h, kvh, sq, sk, causal, window, scale, static_cast<const int*>(q_seg),
            static_cast<const int*>(kv_seg), static_cast<const int*>(plan_dkdv)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  {  // 1. delta
    const long long rows = (long long)b * h * sq;
    attn_bwd_delta<<<(unsigned)((rows * 16 + 127) / 128), 128, 0, s>>>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout), static_cast<float*>(delta),
        lo, ldo, b, h, sq);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  {  // 2. dK, dV partials
    CUtensorMap mq, mdo, mk, mv;
    if (!make_map(&mq, q, b, h, sq, lq, STEP) || !make_map(&mdo, dout, b, h, sq, ldo, STEP) ||
        !make_map(&mk, k, b, kvh, sk, lk, STEP) || !make_map(&mv, v, b, kvh, sk, lv, STEP))
      return -2;
    if ((e = allow_smem(attn_bwd_dkdv, DKDV_SMEM, &dkdv_smem_set)) != cudaSuccess) return (int)e;
    attn_bwd_dkdv<<<dim3(h, b, sk / STEP), THREADS, DKDV_SMEM, s>>>(
        mq, mdo, mk, mv, static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dk_part), static_cast<float*>(dv_part), p);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  {  // 3. their sum over each group
    const long long groups = (long long)b * kvh * sk * (D / 4);
    attn_bwd_group_sum<<<(unsigned)((groups + 255) / 256), 256, 0, s>>>(
        static_cast<const float*>(dk_part), static_cast<const float*>(dv_part),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), lk, lv, b, h, kvh, sk);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  {  // 4. dQ
    CUtensorMap mq, mdo, mk, mv;
    if (!make_map(&mq, q, b, h, sq, lq, TILE) || !make_map(&mdo, dout, b, h, sq, ldo, TILE) ||
        !make_map(&mk, k, b, kvh, sk, lk, STEP) || !make_map(&mv, v, b, kvh, sk, lv, STEP))
      return -2;
    p.plan = static_cast<const int*>(plan_dq);
    if ((e = allow_smem(attn_bwd_dq, DQ_SMEM, &dq_smem_set)) != cudaSuccess) return (int)e;
    attn_bwd_dq<<<dim3(h, b, tiles(sq)), THREADS, DQ_SMEM, s>>>(
        mq, mdo, mk, mv, static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dq), lq, p);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}
