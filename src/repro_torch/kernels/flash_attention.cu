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
//   Sq and Sk are any positive lengths.  At a length the TPU kernel does not
//   take (above 128 and not a multiple of 128: whisper-tiny's 1,500 frames
//   and 448 tokens) the range is its blocks' counted up, cut at Sk, which at
//   any query with a key is every admissible key.  The last tile of a
//   ragged length is partial: TMA reads its rows past S as zeros, so the
//   schedule never marks it free and the mask gives keys at or past Sk
//   -inf in the forward and P = 0 in the backward, and query rows at or
//   past Sq P = 0 in the dK/dV pass; their outputs are not stored.
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
// The backward reads lse and delta in 64-row bulk copies of rows `ls`
// floats apart: Sq, or at a length that is not a multiple of 64 Sq rounded
// up to one, the wrapper's pad holding lse = +inf and delta = 0 (P = 0).
//
// Bound: at Sq = Sk = 2048, D = 128, causal, the forward does ~4*D flops per
// admissible (head, key, query) against ~(q + k + v + o) bytes read once:
// ~1,000 flop/B, above the card's ~295, so it is bound by operations; so is
// the backward (~2.5x the forward's flops).  At the BERT models' S = 128, D =
// 64, bidirectional, a (batch, head) does 4 S^2 D flops against 8 S D bytes
// of q, k, v and o: S / 2 = 64 flop/B, below the card's ~295, so that build
// is bound by bytes (bert-1.5b's micro-batch: ~26 MB, ~7.9 us), and each
// CTA's fixed cost (the Q load, the ring's fill, the epilogue) over its 2
// key steps is what it pays beyond that.  For the shapes bound by operations
// the design keeps the tensor cores fed: wgmma, loads overlapped with the products, and accumulators
// that fit in registers (ptxas -v reports no spills; a dK/dV CTA that held
// both dK and dV in one warpgroup spilled and serialized its wgmmas).
//
// Design, for Hopper: every CTA is two consumer warpgroups (64 rows each)
// and a producer warpgroup (at D = 256 no producer warpgroup: thread 0
// issues the loads, `producer` / `refill`).  The producer's one thread issues TMA loads
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
// schedule lists CTAs longest walk first.  The kernels are templates on the
// head dim D, instantiated in bf16 for D = 128 (qwen2.5-3b: a tile is two
// slabs, the D-wide products m64n128k16), D = 64 (the BERT models, group
// 1, bidirectional: a tile is one slab, the D-wide products m64n64k16 with
// half the accumulator registers) and D = 256 (recurrentgemma-2b's local
// attention, group 10, window 2,048: a tile is four slabs, the D-wide
// products two m64n128k16 halves, and a consumer thread's 64 x 256 f32
// accumulator takes 128 of its 232 registers; the dQ CTA's K / V ring has
// one stage, `DqSmem`).  With segment ids Sq and Sk must be multiples of
// 64 (their ids are copied 64 at a time); the wrapper raises on others.
//
// At recurrentgemma-2b's training shape (10 heads on 1 KV head, S 8,192,
// window 2,048, causal: 14.7 M admissible (query, key) pairs a head, 146.8
// M in all) the forward's 4 D flops a pair are ~1.5e11, ~152 us at the
// card's bf16 peak, against ~92 MB of q, k, v, o and dO (~27 us): bound by
// operations, the backward (~2.5x) too.  The window bites here: a forward
// CTA walks at most (2,048 + 128) / 64 = 34 key steps of the 128 below
// it, and the schedule skips the rest.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int SLAB = 64;     // bf16 columns of one 128-byte swizzled slab
constexpr int TILE = 128;    // query rows of a forward / dQ CTA
constexpr int STEP = 64;     // keys of a forward / dQ step and of a dK/dV CTA;
                             // query rows of a dK/dV step
constexpr int STAGES = 2;    // ring depth of the streamed tiles
constexpr int CONSUMER_WARPS = 8;  // two warpgroups
// plus a producer warpgroup: with 9 warps one SM sub-partition holds 3 of
// them and ptxas caps every thread at 168 registers; with 12, `setmaxnreg`
// moves the producer's registers to the consumers at run time (40 / 232 a
// thread), though ptxas still compiles every thread within 168
// (`OWN_PRODUCER`)
constexpr int THREADS = (CONSUMER_WARPS + 4) * 32;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int PLAN_COLS = 6;
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory a CTA may take
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Layout {  // element strides of a (B, heads, S, D) tensor, D contiguous
  long long b, h, s;
};

struct Problem {
  int h, kvh, sq, sk, causal, window;
  int ls;  // floats between the (b, h) rows of lse and delta: Sq, or padded (backward)
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

// a (rows, D) tile at position s: D / 64 slabs, columns [0, 64), [64, 128), ...
template <int D>
__device__ __forceinline__ void tma_tile(bf16* dst, int rows, const CUtensorMap* map,
                                         uint64_t* bar, int s, int h, int b) {
#pragma unroll
  for (int sl = 0; sl < D / SLAB; ++sl) tma_slab(dst + sl * rows * SLAB, map, bar, sl * SLAB, s, h, b);
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

// bytes from a K-major operand's k-step 0 to its k-step kk (`kmajor`)
__device__ __forceinline__ int kstep_bytes(int rows, int kk) {
  return ((kk / 4) * rows * SLAB + (kk % 4) * 16) * 2;
}

// descriptor `d` moved on by `bytes` (a multiple of 16 within shared
// memory: the start-address field counts 16-byte units and does not carry)
__device__ __forceinline__ uint64_t desc_at(uint64_t d, int bytes) { return d + (bytes >> 4); }

// `x`, opaque to the compiler.  At D = 256 a loop's operand descriptors
// are formed from one such base each, where they are used (`kstep`):
// otherwise the compiler hoists every k-step's descriptor out of the loop
// and keeps them all live across it (16 k-steps x 2 operands x 2
// registers; at a 168-register allocation the backward's kernels spilled
// 2.7-3.6x the bytes without it).  The D = 64 and 128 builds form each
// descriptor outright, as before the D = 256 build.
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  asm volatile("" : "+l"(x));
  return x;
}

// k-step kk's descriptor of a K-major operand (`kmajor`): at D = 256 from
// the opaque base of k-step 0
template <int D>
__device__ __forceinline__ uint64_t kstep(const bf16* tile, int rows, int r0, int kk,
                                          uint64_t base) {
  if constexpr (D == 256) return desc_at(base, kstep_bytes(rows, kk));
  else return kmajor(tile, rows, r0, kk);
}

// MN-major operand (the reduction axis is the tile's rows): rows [16 kk,
// 16 kk + 16) of a tile of `rows` rows, all D columns (slab 1, where D = 128
// has one, `lbo` bytes on)
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

// D (64 x 32 f32, registers) = A (64 x 16) . B (32 x 16)^T, the first
// k-step (write-only operands, as wgmma_ss64_first)
__device__ __forceinline__ void wgmma_ss32_first(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
      : "l"(a), "l"(b), "r"(0));
}

// D (64 x 32 f32, registers) += A (64 x 16) . B (32 x 16)^T; both K-major in shared memory
__device__ __forceinline__ void wgmma_ss32(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
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

// D (64 x 64 f32) += A (64 x 16 bf16 in registers, the accumulator's layout)
// . B (16 x 64 bf16 in shared memory, MN-major: N contiguous)
__device__ __forceinline__ void wgmma_rs64(float (&d)[32], uint32_t a0, uint32_t a1,
                                           uint32_t a2, uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// the D-wide register-A product of one 16-row k-step: acc (64 x D) += A (64
// x 16, registers) . rows [16 kk, 16 kk + 16) of a `rows`-row tile (all D
// columns, MN-major).  D = 64: one m64n64k16; D = 128: one m64n128k16; D =
// 256: two m64n128k16, one a 128-column half (slabs 0-1, then 2-3), whose
// accumulators are acc[0, 64) and acc[64, 128): the m64n256 layout, column
// 8 j + 2 c at acc[4 j + ...], cut at j = 16.
template <int D>
__device__ __forceinline__ void product_rs(float (&acc)[D / 2], const uint32_t* a,
                                           const bf16* tile, int rows, int kk) {
  if constexpr (D == 64) {
    wgmma_rs64(acc, a[0], a[1], a[2], a[3], mnmajor(tile, rows, kk));
  } else if constexpr (D == 128) {
    wgmma_rs128(acc, a[0], a[1], a[2], a[3], mnmajor(tile, rows, kk));
  } else {
    static_assert(D == 256, "K3 is instantiated for head dims 64, 128 and 256");
    const uint64_t b = desc_at(opaque(mnmajor(tile, rows, 0)), kk * 16 * SLAB * 2);
    float(&lo)[64] = *reinterpret_cast<float(*)[64]>(&acc[0]);
    float(&hi)[64] = *reinterpret_cast<float(*)[64]>(&acc[64]);
    wgmma_rs128(lo, a[0], a[1], a[2], a[3], b);
    wgmma_rs128(hi, a[0], a[1], a[2], a[3], desc_at(b, 2 * rows * SLAB * 2));
  }
}

// D (64 x N) = A . B^T reduced over the head dim D: A is rows [a_r0, a_r0 +
// 64) of an `a_rows`-row tile, B rows [b_r0, b_r0 + N) of a 64-row tile
// (both K-major); N = 64 or 32 (`SUB`)
template <int D, int N>
__device__ __forceinline__ void product_ss(float (&d)[N / 2], const bf16* a, int a_rows, int a_r0,
                                           const bf16* b, int b_r0) {
  uint64_t da = kmajor(a, a_rows, a_r0, 0), db = kmajor(b, STEP, b_r0, 0);
  if constexpr (D == 256) da = opaque(da), db = opaque(db);
  if constexpr (N == 64) {
    wgmma_ss64_first(d, da, db);
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk)
      wgmma_ss64(d, kstep<D>(a, a_rows, a_r0, kk, da), kstep<D>(b, STEP, b_r0, kk, db));
  } else {
    static_assert(N == 32, "a sub-step is 64 or 32 wide");
    wgmma_ss32_first(d, da, db);
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk)
      wgmma_ss32(d, kstep<D>(a, a_rows, a_r0, kk, da), kstep<D>(b, STEP, b_r0, kk, db));
  }
}

// The width of the (64 x SUB) score tiles (S, P, dP, dS) a consumer holds at
// once: a 64-wide step is taken as 64 / SUB sub-steps.  At D = 256 the
// 64 x 256 f32 accumulator takes 128 registers a thread, so the build takes
// 32-wide sub-steps (the scores' registers halved; the forward rescales O
// once a sub-step; the K-major operand is read from shared memory once a
// sub-step): ptxas -v counts 193-206 registers a thread for its three
// kernels and no spills, within the 255 of an 8-warp CTA (`OWN_PRODUCER`).
template <int D>
constexpr int SUB = D == 256 ? STEP / 2 : STEP;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}


// ---------------------------------------------------------------------------
// who issues a CTA's loads
// ---------------------------------------------------------------------------

// D = 64 and 128: a producer warpgroup of its own beside the two consumer
// warpgroups (12 warps).  ptxas allocates every thread of a 12-warp CTA
// within 168 registers, the consumers too (`setmaxnreg` moves registers at
// run time but does not widen that allocation: the same build with 240 for
// the consumers spilled the same bytes), and at D = 256 a consumer's 64 x
// 256 f32 accumulator alone takes 128 of them, so its CTAs are the 8
// consumer warps alone (up to 255 registers a thread) and thread 0 issues
// the loads, `ring` steps ahead, as the consumers release the stages.
template <int D>
constexpr bool OWN_PRODUCER = D != 256;
template <int D>
constexpr int CTA_THREADS = OWN_PRODUCER<D> ? THREADS : CONSUMER_WARPS * 32;

// A CTA's loads: `first()` (the tiles every step reads) and `step(i)` for
// each of its `n` steps, step i into ring stage i % ring, a stage reused
// once its `empty` barrier shows every consumer warp released it.  Returns
// true in a producer warpgroup's threads (which then leave), after they
// issued every load; without one, thread 0 issues first() and the first
// `ring` steps here and the rest from `refill`.
template <int D, typename First, typename Step>
__device__ __forceinline__ bool producer(int n, int ring, uint64_t* empty, First first,
                                         Step step) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if constexpr (OWN_PRODUCER<D>) {
    if (warp < CONSUMER_WARPS) {
      regs_inc<CONSUMER_REGS>();
      return false;
    }
    regs_dec<PRODUCER_REGS>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      first();
      for (int i = 0; i < n; ++i) {
        if (i >= ring) mbar_wait(&empty[i % ring], (i / ring - 1) & 1);
        step(i);
      }
    }
    return true;
  } else {
    if (threadIdx.x == 0) {
      first();
      for (int i = 0; i < n && i < ring; ++i) step(i);
    }
    return false;
  }
}

// Called by every consumer thread once its warp released step i's stage:
// without a producer warpgroup, thread 0 waits until every consumer warp
// has, then loads step i + ring into the stage.
template <int D, typename Step>
__device__ __forceinline__ void refill(int i, int n, int ring, uint64_t* empty, Step step) {
  if constexpr (!OWN_PRODUCER<D>) {
    if (threadIdx.x == 0 && i + ring < n) {
      mbar_wait(&empty[i % ring], (i / ring) & 1);
      step(i + ring);
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// bytes of a (128, D) and a (64, D) bf16 tile: multiples of 1024, so every
// tile of the maps below starts on a swizzle repeat
template <int D>
struct Tiles {
  static constexpr int TILE_BYTES = TILE * D * 2, STEP_BYTES = STEP * D * 2;
};

// a forward CTA's shared memory: Q, the K and V rings, key segment ids, barriers
template <int D>
struct FwdSmem : Tiles<D> {
  static constexpr int K = Tiles<D>::TILE_BYTES;
  static constexpr int V = K + STAGES * Tiles<D>::STEP_BYTES;
  static constexpr int SEG = V + STAGES * Tiles<D>::STEP_BYTES;
  static constexpr int BAR = SEG + STAGES * STEP * 4;
  static constexpr size_t BYTES = BAR + 8 * (1 + 3 * STAGES) + 1024;
};

// grid (H, B, query tiles in plan order); plan row: (q0, key step lo, hi,
// free lo, free hi, key end), in 64-key steps
template <int D>
__global__ void __launch_bounds__(CTA_THREADS<D>, 1) attn_fwd(
    const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
    const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o, float* __restrict__ lse,
    Layout lo, Problem p) {
  using M = FwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + M::K);
  bf16* sV = reinterpret_cast<bf16*>(smem + M::V);
  int* sSeg = reinterpret_cast<int*>(smem + M::SEG);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + M::BAR);
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

  const int n = t_hi - t_lo;
  auto load_q = [&] {
    mbar_expect_tx(bar_q, M::TILE_BYTES);
    tma_tile<D>(sQ, TILE, &mq, bar_q, q0, hh, b);
  };
  auto load_step = [&](int i) {  // key step t_lo + i
    const int s = i % STAGES, t = t_lo + i;
    mbar_expect_tx(&full_k[s], M::STEP_BYTES + (p.q_seg ? STEP * 4 : 0));
    tma_tile<D>(sK + s * STEP * D, STEP, &mk, &full_k[s], t * STEP, kh, b);
    if (p.q_seg)
      bulk_copy(sSeg + s * STEP, p.kv_seg + (long long)b * p.sk + t * STEP, STEP * 4,
                &full_k[s]);
    mbar_expect_tx(&full_v[s], M::STEP_BYTES);
    tma_tile<D>(sV + s * STEP * D, STEP, &mv, &full_v[s], t * STEP, kh, b);
  };
  if (producer<D>(n, STAGES, empty, load_q, load_step)) return;

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
  constexpr int N = SUB<D>;
  float acc[D / 2], sc[N / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  mbar_wait(bar_q, 0);

  for (int t = t_lo, i = 0; t < t_hi; ++t, ++i) {
    const int s = i % STAGES, parity = (i / STAGES) & 1;
    const bf16* tk = sK + s * STEP * D;
    const bf16* tv = sV + s * STEP * D;
    mbar_wait(&full_k[s], parity);
#pragma unroll
    for (int hf = 0; hf < STEP / N; ++hf) {  // sub-steps of N keys
      wg_fence();
      product_ss<D, N>(sc, sQ, TILE, wg * 64, tk, hf * N);
      wg_commit();
      wg_wait<0>();
      keep(sc);

      // logits in log2 units; masked (one uniform branch around the whole
      // step, so unmasked steps run none of it): -1e30 inside the visited
      // range, -inf past it
#pragma unroll
      for (int j = 0; j < N / 2; ++j) sc[j] *= sl2;
      if (p.q_seg != nullptr || t < f_lo || t >= f_hi) {
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kcol = hf * N + 8 * j + 2 * c + (e & 1), kpos = t * STEP + kcol;
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
      for (int j = 0; j < N / 8; ++j) {
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
      for (int j = 0; j < N / 2; ++j) {
        const float pr = ex2(sc[j] - m[(j >> 1) & 1]);
        sc[j] = pr;
        l[(j >> 1) & 1] += pr;
      }
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] *= alpha[(j >> 1) & 1];
      uint32_t pa[N / 4];
      to_a(sc, pa);

      mbar_wait(&full_v[s], parity);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        product_rs<D>(acc, pa + 4 * kk, tv, STEP, hf * (N / 16) + kk);
      wg_commit();
      wg_wait<0>();
      keep(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    refill<D>(i, n, STAGES, empty, load_step);
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
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(og + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * e] * inv, acc[4 * j + 2 * e + 1] * inv);
    if (c == 0)
      lse[((long long)b * p.h + hh) * p.ls + r] =
          m[e] == NEG ? NEG : (m[e] + __log2f(fmaxf(l[e], 1e-30f))) * LN2;
  }
}

// ---------------------------------------------------------------------------
// backward 1: delta = rowsum(dO * O), D / 8 lanes per (b, h, i) row (a half
// warp at D = 128, a quarter at 64), 8 columns a lane
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(128) attn_bwd_delta(
    const bf16* __restrict__ o, const bf16* __restrict__ dout, float* __restrict__ delta,
    Layout lo, Layout ldo, int b_count, int h, int sq, int ls) {
  constexpr int LANES = D / 8;
  const long long rowid = ((long long)blockIdx.x * 128 + threadIdx.x) / LANES;
  const int col = (threadIdx.x % LANES) * 8;
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
  for (int sh = LANES / 2; sh > 0; sh >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, sh);
  if (threadIdx.x % LANES == 0) delta[((long long)b * h + hh) * ls + i] = acc;
}

// ---------------------------------------------------------------------------
// backward 2: f32 partials of dK, dV for one (64-key tile, query head, batch)
// ---------------------------------------------------------------------------

// a dK/dV CTA's shared memory: K, V, the Q, dO, lse, delta and segment-id
// rings, barriers
template <int D>
struct DkdvSmem : Tiles<D> {
  static constexpr int V = Tiles<D>::STEP_BYTES;
  static constexpr int Q = 2 * Tiles<D>::STEP_BYTES;
  static constexpr int DO = Q + STAGES * Tiles<D>::STEP_BYTES;
  static constexpr int LSE = DO + STAGES * Tiles<D>::STEP_BYTES;
  static constexpr int DELTA = LSE + STAGES * STEP * 4;
  static constexpr int SEG = DELTA + STAGES * STEP * 4;
  static constexpr int BAR = SEG + STAGES * STEP * 4;
  static constexpr size_t BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;
};

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
template <int D, bool DK, typename After>
__device__ __forceinline__ void dkdv_consumer(const DkdvTiles& t, const Problem& p, int b, int hh,
                                              float* __restrict__ part, After after_step) {
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
  constexpr int N = SUB<D>;
  float acc[D / 2], st[N / 2], dpt[N / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int j = t.s_lo, i = 0; j < t.s_hi; ++j, ++i) {
    const int s = i % STAGES, q0 = j * STEP;
    const bf16* tq = t.q + s * STEP * D;
    const bf16* tdo = t.dout + s * STEP * D;
    const float* tl = t.lse + s * STEP;
    const float* td = t.delta + s * STEP;
    mbar_wait(&t.full[s], (i / STAGES) & 1);
#pragma unroll
    for (int hf = 0; hf < STEP / N; ++hf) {  // sub-steps of N queries
      // S^T = K Q^T (and for dK, dP^T = V dO^T): (64 keys, N queries)
      wg_fence();
      product_ss<D, N>(st, t.k, STEP, 0, tq, hf * N);
      wg_commit();
      if (DK) {
        product_ss<D, N>(dpt, t.v, STEP, 0, tdo, hf * N);
        wg_commit();
      }
      wg_wait<0>();
      keep(st);
      if (DK) keep(dpt);

      // P^T = exp(S^T scale - lse) on admissible pairs, 0 elsewhere (the
      // mask under one uniform branch)
#pragma unroll
      for (int n = 0; n < N / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[4 * n + e] =
              ex2(st[4 * n + e] * sl2 - tl[hf * N + 8 * n + 2 * c + (e & 1)] * LOG2E);
      if (p.q_seg != nullptr || j < t.f_lo || j >= t.f_hi) {
#pragma unroll
        for (int n = 0; n < N / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qcol = hf * N + 8 * n + 2 * c + (e & 1), kpos = kr0 + 8 * (e >> 1);
            if (kpos >= p.sk || q0 + qcol >= p.sq || !admissible(p, q0 + qcol + off, kpos) ||
                (p.q_seg && t.seg[s * STEP + qcol] != kseg[e >> 1]))
              st[4 * n + e] = 0.f;
          }
        }
      }
      uint32_t fa[N / 4];
      if (DK) {  // dS^T = P^T (dP^T - delta)
#pragma unroll
        for (int n = 0; n < N / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dpt[4 * n + e] =
                st[4 * n + e] * (dpt[4 * n + e] - td[hf * N + 8 * n + 2 * c + (e & 1)]);
        to_a(dpt, fa);
      } else {
        to_a(st, fa);
      }

      // dV += P^T dO or dK += dS^T Q: (64 keys, D), reduced over the N queries
      const bf16* rhs = DK ? tq : tdo;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        product_rs<D>(acc, fa + 4 * kk, rhs, STEP, hf * (N / 16) + kk);
      wg_commit();
      wg_wait<0>();
      keep(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&t.empty[s]);
    after_step(i);
  }

  const float mul = DK ? p.scale : 1.f;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int key = kr0 + 8 * e;
    if (key >= p.sk) continue;
    float* row = part + (((long long)b * p.h + hh) * p.sk + key) * D + 2 * c;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(row + 8 * n) =
          make_float2(acc[4 * n + 2 * e] * mul, acc[4 * n + 2 * e + 1] * mul);
  }
}

// grid (H, B, key tiles in plan order); plan row: (k0, query step lo, hi,
// free lo, free hi, Sq).  Writes dk_part / dv_part (B, H, Sk, D) f32, dK
// already scaled.
template <int D>
__global__ void __launch_bounds__(CTA_THREADS<D>, 1) attn_bwd_dkdv(
    const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mdo,
    const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk_part,
    float* __restrict__ dv_part, Problem p) {
  using M = DkdvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = reinterpret_cast<bf16*>(smem + M::V);
  bf16* sQ = reinterpret_cast<bf16*>(smem + M::Q);
  bf16* sdO = reinterpret_cast<bf16*>(smem + M::DO);
  float* sLse = reinterpret_cast<float*>(smem + M::LSE);
  float* sDelta = reinterpret_cast<float*>(smem + M::DELTA);
  int* sSeg = reinterpret_cast<int*>(smem + M::SEG);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + M::BAR);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + STAGES;

  const int* row = p.plan + blockIdx.z * PLAN_COLS;
  const int k0 = row[0], s_lo = row[1], s_hi = row[2];
  const int hh = blockIdx.x, b = blockIdx.y, kh = hh / (p.h / p.kvh);
  const int warp = threadIdx.x / 32;
  const long long lrow = ((long long)b * p.h + hh) * p.ls;  // (b, hh) row of lse / delta

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n = s_hi - s_lo;
  auto load_kv = [&] {
    mbar_expect_tx(bar_kv, 2 * M::STEP_BYTES);
    tma_tile<D>(sK, STEP, &mk, bar_kv, k0, kh, b);
    tma_tile<D>(sV, STEP, &mv, bar_kv, k0, kh, b);
  };
  auto load_step = [&](int i) {  // query step s_lo + i
    const int s = i % STAGES, q0 = (s_lo + i) * STEP;
    mbar_expect_tx(&full[s], 2 * M::STEP_BYTES + 2 * STEP * 4 + (p.q_seg ? STEP * 4 : 0));
    tma_tile<D>(sQ + s * STEP * D, STEP, &mq, &full[s], q0, hh, b);
    tma_tile<D>(sdO + s * STEP * D, STEP, &mdo, &full[s], q0, hh, b);
    bulk_copy(sLse + s * STEP, lse + lrow + q0, STEP * 4, &full[s]);
    bulk_copy(sDelta + s * STEP, delta + lrow + q0, STEP * 4, &full[s]);
    if (p.q_seg)
      bulk_copy(sSeg + s * STEP, p.q_seg + (long long)b * p.sq + q0, STEP * 4, &full[s]);
  };
  if (producer<D>(n, STAGES, empty, load_kv, load_step)) return;
  auto after_step = [&](int i) { refill<D>(i, n, STAGES, empty, load_step); };

  const DkdvTiles t{sK, sV, sQ, sdO, sLse, sDelta, sSeg, full, empty,
                    k0, s_lo, s_hi, row[3], row[4]};
  mbar_wait(bar_kv, 0);
  if (warp < 4)
    dkdv_consumer<D, false>(t, p, b, hh, dv_part, after_step);
  else
    dkdv_consumer<D, true>(t, p, b, hh, dk_part, after_step);
}

// ---------------------------------------------------------------------------
// backward 3: dK, dV = the g query heads' partials summed in head order (at
// g = 1 a cast of each partial to bf16)
// ---------------------------------------------------------------------------

template <int D>
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

// a dQ CTA's shared memory: Q, dO, the K, V and key segment-id rings of
// `R` stages, barriers
template <int D, int R>
struct DqRing : Tiles<D> {
  static constexpr int RING = R;
  static constexpr int DO = Tiles<D>::TILE_BYTES;
  static constexpr int K = 2 * Tiles<D>::TILE_BYTES;
  static constexpr int V = K + R * Tiles<D>::STEP_BYTES;
  static constexpr int SEG = V + R * Tiles<D>::STEP_BYTES;
  static constexpr int BAR = SEG + R * STEP * 4;
  static constexpr size_t BYTES = BAR + 8 * (1 + 2 * R) + 1024;
};

// `STAGES` when they fit, else one.  At D = 256 the Q and dO tiles take 128
// KB and two (K, V) stages another 128 KB, over the CTA's 227 KB; with one
// stage (192 KB) the producer loads step i + 1's K and V only once both
// consumer warpgroups have released step i, so the loads no longer overlap
// the products.  The other ways to fit (64-row query tiles, or K and V
// sharing a slot) change the schedule's tiles or serialize K against V
// within a step; one stage keeps the D = 64 and 128 builds' schedule and
// code, and the dQ pass is ~2/5 of the backward's products.
template <int D>
struct DqSmem
    : DqRing<D, (DqRing<D, STAGES>::BYTES <= SMEM_MAX ? STAGES : 1)> {};

// grid (H, B, query tiles in plan order); plan row: (q0, key step lo, hi,
// free lo, free hi, Sk)
template <int D>
__global__ void __launch_bounds__(CTA_THREADS<D>, 1) attn_bwd_dq(
    const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mdo,
    const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq,
    Layout lq, Problem p) {
  using M = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = reinterpret_cast<bf16*>(smem + M::DO);
  bf16* sK = reinterpret_cast<bf16*>(smem + M::K);
  bf16* sV = reinterpret_cast<bf16*>(smem + M::V);
  int* sSeg = reinterpret_cast<int*>(smem + M::SEG);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + M::BAR);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + M::RING;

  const int* row = p.plan + blockIdx.z * PLAN_COLS;
  const int q0 = row[0], s_lo = row[1], s_hi = row[2], f_lo = row[3], f_hi = row[4];
  const int hh = blockIdx.x, b = blockIdx.y, kh = hh / (p.h / p.kvh);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < M::RING; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n = s_hi - s_lo;
  auto load_q = [&] {
    mbar_expect_tx(bar_q, 2 * M::TILE_BYTES);
    tma_tile<D>(sQ, TILE, &mq, bar_q, q0, hh, b);
    tma_tile<D>(sdO, TILE, &mdo, bar_q, q0, hh, b);
  };
  auto load_step = [&](int i) {  // key step s_lo + i
    const int s = i % M::RING, k0 = (s_lo + i) * STEP;
    mbar_expect_tx(&full[s], 2 * M::STEP_BYTES + (p.q_seg ? STEP * 4 : 0));
    tma_tile<D>(sK + s * STEP * D, STEP, &mk, &full[s], k0, kh, b);
    tma_tile<D>(sV + s * STEP * D, STEP, &mv, &full[s], k0, kh, b);
    if (p.q_seg)
      bulk_copy(sSeg + s * STEP, p.kv_seg + (long long)b * p.sk + k0, STEP * 4, &full[s]);
  };
  if (producer<D>(n, M::RING, empty, load_q, load_step)) return;

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
    const long long at = ((long long)b * p.h + hh) * p.ls + r;
    rl[e] = lse[at] * LOG2E;
    rd[e] = delta[at];
    if (p.q_seg) qseg[e] = p.q_seg[(long long)b * p.sq + r];
  }
  constexpr int N = SUB<D>;
  float acc[D / 2], sc[N / 2], dp[N / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(bar_q, 0);

  for (int j = s_lo, i = 0; j < s_hi; ++j, ++i) {
    const int s = i % M::RING, k0 = j * STEP;
    const bf16* tk = sK + s * STEP * D;
    const bf16* tv = sV + s * STEP * D;
    mbar_wait(&full[s], (i / M::RING) & 1);
#pragma unroll
    for (int hf = 0; hf < STEP / N; ++hf) {  // sub-steps of N keys
      // S = Q K^T and dP = dO V^T: (64 queries, N keys) each
      wg_fence();
      product_ss<D, N>(sc, sQ, TILE, wg * 64, tk, hf * N);
      wg_commit();
      product_ss<D, N>(dp, sdO, TILE, wg * 64, tv, hf * N);
      wg_commit();
      wg_wait<0>();
      keep(sc);
      keep(dp);

#pragma unroll
      for (int i = 0; i < N / 2; ++i) sc[i] = ex2(sc[i] * sl2 - rl[(i >> 1) & 1]);
      if (p.q_seg != nullptr || j < f_lo || j >= f_hi) {  // the mask, under one uniform branch
#pragma unroll
        for (int n = 0; n < N / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kcol = hf * N + 8 * n + 2 * c + (e & 1);
            if (k0 + kcol >= p.sk || !admissible(p, r0 + 8 * (e >> 1) + off, k0 + kcol) ||
                (p.q_seg && sSeg[s * STEP + kcol] != qseg[e >> 1]))
              sc[4 * n + e] = 0.f;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < N / 2; ++i) dp[i] = sc[i] * (dp[i] - rd[(i >> 1) & 1]);
      uint32_t da[N / 4];
      to_a(dp, da);

      // dQ += dS K: (64 queries, D), reduced over the N keys
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        product_rs<D>(acc, da + 4 * kk, tk, STEP, hf * (N / 16) + kk);
      wg_commit();
      wg_wait<0>();
      keep(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    refill<D>(i, n, M::RING, empty, load_step);
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = r0 + 8 * e;
    if (r >= p.sq) continue;
    bf16* qg = dq + b * lq.b + hh * lq.h + (long long)r * lq.s + 2 * c;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
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

// a (B, heads, S, d) bf16 tensor with element strides `l` as a 4-D map
// (d, S, heads, B), loaded in (64, rows) boxes with the 128-byte swizzle;
// rows past S read as zeros
bool make_map(CUtensorMap* map, const void* base, int b, int heads, int s, int d, const Layout& l,
              int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)heads, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)l.s * 2, (cuuint64_t)l.h * 2, (cuuint64_t)l.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)SLAB, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Raise a kernel's dynamic shared-memory limit once per process (`done`: a
// static of the launching instantiation; the first call is made outside any
// CUDA-graph capture: the wrappers' first use).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  *done = e == cudaSuccess;
  return e;
}

// any positive length; with segment ids a multiple of 64
bool length_ok(int s, bool seg) { return s > 0 && (!seg || s % 64 == 0); }

// the head dims instantiated below
bool shape_ok(int b, int h, int kvh, int sq, int sk, int d, bool seg) {
  return b > 0 && kvh > 0 && h % kvh == 0 && (d == 64 || d == 128 || d == 256) &&
         length_ok(sq, seg) && length_ok(sk, seg);
}

int tiles(int s) { return (s + TILE - 1) / TILE; }
int steps(int s) { return (s + STEP - 1) / STEP; }

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, const Problem& p,
               int b, const long long* strides, cudaStream_t stream) {
  const Layout lq{strides[0], strides[1], strides[2]}, lk{strides[3], strides[4], strides[5]},
      lv{strides[6], strides[7], strides[8]}, lo{strides[9], strides[10], strides[11]};
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, b, p.h, p.sq, D, lq, TILE) || !make_map(&mk, k, b, p.kvh, p.sk, D, lk, STEP) ||
      !make_map(&mv, v, b, p.kvh, p.sk, D, lv, STEP))
    return -2;
  static bool smem_set = false;
  cudaError_t e = allow_smem(attn_fwd<D>, FwdSmem<D>::BYTES, &smem_set);
  if (e != cudaSuccess) return (int)e;
  attn_fwd<D><<<dim3(p.h, b, tiles(p.sq)), CTA_THREADS<D>, FwdSmem<D>::BYTES, stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), static_cast<float*>(lse), lo, p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const void* lse, void* delta, void* dq, void* dk, void* dv, void* dk_part,
               void* dv_part, const void* plan_dq, Problem p, int b, const long long* strides,
               cudaStream_t s) {
  const Layout lq{strides[0], strides[1], strides[2]}, lk{strides[3], strides[4], strides[5]},
      lv{strides[6], strides[7], strides[8]}, lo{strides[9], strides[10], strides[11]},
      ldo{strides[12], strides[13], strides[14]};
  const int h = p.h, kvh = p.kvh, sq = p.sq, sk = p.sk;
  static bool dkdv_smem_set = false, dq_smem_set = false;
  cudaError_t e;
  {  // 1. delta
    const long long rows = (long long)b * h * sq;
    attn_bwd_delta<D><<<(unsigned)((rows * (D / 8) + 127) / 128), 128, 0, s>>>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout), static_cast<float*>(delta),
        lo, ldo, b, h, sq, p.ls);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  {  // 2. dK, dV partials
    CUtensorMap mq, mdo, mk, mv;
    if (!make_map(&mq, q, b, h, sq, D, lq, STEP) || !make_map(&mdo, dout, b, h, sq, D, ldo, STEP) ||
        !make_map(&mk, k, b, kvh, sk, D, lk, STEP) || !make_map(&mv, v, b, kvh, sk, D, lv, STEP))
      return -2;
    if ((e = allow_smem(attn_bwd_dkdv<D>, DkdvSmem<D>::BYTES, &dkdv_smem_set)) != cudaSuccess)
      return (int)e;
    attn_bwd_dkdv<D><<<dim3(h, b, steps(sk)), CTA_THREADS<D>, DkdvSmem<D>::BYTES, s>>>(
        mq, mdo, mk, mv, static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dk_part), static_cast<float*>(dv_part), p);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  {  // 3. their sum over each group
    const long long groups = (long long)b * kvh * sk * (D / 4);
    attn_bwd_group_sum<D><<<(unsigned)((groups + 255) / 256), 256, 0, s>>>(
        static_cast<const float*>(dk_part), static_cast<const float*>(dv_part),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), lk, lv, b, h, kvh, sk);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  {  // 4. dQ
    CUtensorMap mq, mdo, mk, mv;
    if (!make_map(&mq, q, b, h, sq, D, lq, TILE) || !make_map(&mdo, dout, b, h, sq, D, ldo, TILE) ||
        !make_map(&mk, k, b, kvh, sk, D, lk, STEP) || !make_map(&mv, v, b, kvh, sk, D, lv, STEP))
      return -2;
    p.plan = static_cast<const int*>(plan_dq);
    if ((e = allow_smem(attn_bwd_dq<D>, DqSmem<D>::BYTES, &dq_smem_set)) != cudaSuccess)
      return (int)e;
    attn_bwd_dq<D><<<dim3(h, b, tiles(sq)), CTA_THREADS<D>, DqSmem<D>::BYTES, s>>>(
        mq, mdo, mk, mv, static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dq), lq, p);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// every instantiated head dim's CTAs fit in the SM's 227 KB
template <int D>
constexpr bool smem_fits() {
  return FwdSmem<D>::BYTES <= SMEM_MAX && DkdvSmem<D>::BYTES <= SMEM_MAX &&
         DqSmem<D>::BYTES <= SMEM_MAX;
}
static_assert(smem_fits<64>() && smem_fits<128>() && smem_fits<256>(),
              "a CTA's shared memory must fit in the SM's 227 KB");
static_assert(DqSmem<64>::RING == STAGES && DqSmem<128>::RING == STAGES,
              "the D = 64 and 128 dQ CTAs keep their two-stage ring");

// strides: 3 per tensor, (batch, head, position) in elements; plan: the
// forward schedule (tile_plan("fwd", ...)).  Returns 0, a CUDA error code,
// -1 for a shape the kernels do not take or -2 when a tensor map is refused.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         void* lse, const void* q_seg, const void* kv_seg,
                                         const void* plan, int b, int h, int kvh, int sq, int sk,
                                         int d, const long long* strides, int causal, int window,
                                         float scale, void* stream) {
  if (!shape_ok(b, h, kvh, sq, sk, d, q_seg != nullptr) ||
      (q_seg == nullptr) != (kv_seg == nullptr))
    return -1;
  const Problem p{h, kvh, sq, sk, causal, window, sq, scale, static_cast<const int*>(q_seg),
                  static_cast<const int*>(kv_seg), static_cast<const int*>(plan)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_fwd<64>(q, k, v, o, lse, p, b, strides, s);
    case 128: return launch_fwd<128>(q, k, v, o, lse, p, b, strides, s);
    default: return launch_fwd<256>(q, k, v, o, lse, p, b, strides, s);
  }
}

// strides: q, k, v, o, dout; dq / dk / dv share q's / k's / v's strides;
// lse and delta (B, H, ls) f32 (ls >= Sq, a multiple of 64 unless Sq is ls;
// the pad holds lse = +inf, delta = 0) and dk_part / dv_part (B, H, Sk, D)
// f32 scratch; plans: tile_plan("dkdv", ...) and tile_plan("dq", ...).
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         void* delta, void* dq, void* dk, void* dv,
                                         void* dk_part, void* dv_part, const void* q_seg,
                                         const void* kv_seg, const void* plan_dkdv,
                                         const void* plan_dq, int b, int h, int kvh, int sq,
                                         int sk, int d, int ls, const long long* strides,
                                         int causal, int window, float scale, void* stream) {
  if (!shape_ok(b, h, kvh, sq, sk, d, q_seg != nullptr) ||
      (q_seg == nullptr) != (kv_seg == nullptr) || ls < sq || (ls != sq && ls % STEP))
    return -1;
  const Problem p{h, kvh, sq, sk, causal, window, ls, scale, static_cast<const int*>(q_seg),
                  static_cast<const int*>(kv_seg), static_cast<const int*>(plan_dkdv)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_bwd<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, dk_part, dv_part,
                                   plan_dq, p, b, strides, s);
    case 128: return launch_bwd<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, dk_part, dv_part,
                                     plan_dq, p, b, strides, s);
    default: return launch_bwd<256>(q, k, v, o, dout, lse, delta, dq, dk, dv, dk_part, dv_part,
                                    plan_dq, p, b, strides, s);
  }
}
