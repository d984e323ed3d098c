// Paged flash attention for Hopper (sm_90a): the hand-written port of the
// TPU kernel `_paged_attn_kernel` / `paged_flash_attention`
// (src/repro/kernels/flash_attention.py:166, :238).
//
// Contract (pinned by tests/test_torch_kernels.py on the plain version and
// the tile plan, and by tests/test_torch_kernels_gpu.py and chip_smoke.py on
// the card):
//   q (T, H, D) bf16; k/v pools (P, page_size, KV, D) bf16, or int8 with
//   per-(row, kv head) f32 scales (P, page_size, KV); block tables
//   (num_slots, num_blocks) int32; q_pos (T,) int32; the tile plan (below).
//   Query t of slot s attends keys at absolute positions kp <= q_pos[t]
//   (and kp > q_pos[t] - window when window > 0) found through
//   tables[s, kp / page_size].  A table entry < 0 or >= P masks its whole
//   block and is never dereferenced.  Softcap s -> c*tanh(s/c) applies before
//   the mask.  Masked scores contribute exactly 0, so a padding query
//   (slot < 0) or a fully masked one writes an exact zero row.
//
// Bound: ~4*D flops per (head, key) against 2*D*sizeof(kv) bytes per
// (kv head, key) shared by the g = H/KV grouped heads: ~2 flop/B for bf16
// at g = 8 (2.5 at g = 10, 0.5 at g = 2), far under the card's ~295 flop/B,
// so the kernel is bound by the bytes of the pages it reads (and, at decode
// sizes, by latency).
//
// Six instances (`Inst` below): (D 128, g 8), qwen2.5-3b; (D 256, g 10),
// recurrentgemma-2b's local attention; (D 128, g 2), internlm2-1.8b and
// gemma3-27b; (D 128, g 9), starcoder2-7b; (D 128, g 6), mixtral-8x22b;
// (D 128, g 16), qwen3-moe-235b-a22b.  The numbers in brackets are
// (256, 10)'s; (128, 2) and (128, 6) are cut as (128, 8) is, and (128, 9)
// and (128, 16) as (256, 10).
//
// Design.  The tile plan (`paged_tile_plan` in flash_attention.py, one row
// per tile: first token, tokens, slot, block lo, block hi) cuts the step's
// tokens into tiles: runs of up to 8 (4) consecutive tokens of one slot,
// whose block range is the union of their tokens' admissible ranges.  A CTA takes
// one (tile, KV head) and, when the grid would be too small to fill the
// card (decode), one of `splits` slices of the tile's block range; so a
// prefill chunk's 64 tokens read their slot's pages 8 times, not 64.
//   * Staging: the slice's keys go through a 2-stage ring in shared memory,
//     64 (32) key positions (K and V rows of one KV head) a stage, gathered by
//     table entry with 16-byte `cp.async` (rows of bad entries and positions
//     past the slice zero-filled, never read), a 16-byte chunk of a row
//     stored at chunk ^ (row & 7) so that `ldmatrix` is conflict-free.  int8
//     pages are converted to bf16 in shared memory once a stage (exact).
//   * Products on tensor cores, `mma.sync` m16n8k16 (bf16 in, f32 out), with
//     keys on M and one token's heads on N, one n8 tile for g = 8 (two for
//     g = 10, heads 10-15 zero and never written; one for g = 2 or 6 with
//     heads 2-7 or 6-7 given zero queries, two for g = 9 and, unpadded,
//     g = 16): S^T (16 keys x 8 heads)
//     = K (16 x D) . Q^T, then O^T (D x 8) += V^T . P^T for each n8 tile,
//     V^T by `ldmatrix.trans`, P^T by `movmatrix.trans` of S^T's fragment.
//     A warp holds two tokens (one); 4 warps hold a tile of 8 (4) tokens,
//     and when the tile has fewer, the warps of one token group split the
//     stage's 16-key chunks between them.  At D 128 Q^T's fragments stay in
//     registers, ~160 a thread: three 128-thread CTAs an SM.  At D 256 one
//     token's accumulator alone is 16 x 2 x 4 = 128 registers, so Q goes
//     to shared memory (the tile's tokens, 16 swizzled rows each, zero rows
//     for the padding heads) and each k-step's two n8 fragments come from
//     one `ldmatrix.x4`; with 64 KB of 32-key stages and 32 KB of queries
//     (~97 KB a CTA), two CTAs an SM.  (128, 9) and (128, 16) take the same
//     layout with 64-key stages (64 + 16 KB a CTA, two an SM).  A padding
//     head (g = 2 or 6 on its one tile, g = 9 or 10 on their second)
//     computes a softmax of
//     zero scores in its own columns, which no real head reads (every
//     column's max, sum and accumulator are its own), and is never
//     written: the idle lanes cost the products only.
//   * Softmax: online, per (token, head), in registers, with that token's own
//     position mask, window and softcap; int8's k_scale multiplies the
//     scores and v_scale the rows of P (in f32, before P is rounded to bf16).
//   * A warp that owns its tokens alone writes them from its registers; the
//     warps of a token pair that shared the chunks merge through shared
//     memory first.  With one split the CTA writes the output; with several
//     it writes its partial (the accumulator only where a key was seen) and
//     `paged_attention_combine` merges the splits (a thread per (head, dim),
//     looping where g x D is over 1,024), launched
//     with programmatic dependent launch (its CTAs are scheduled while the
//     main kernel drains and wait for its partials in `griddepcontrol.wait`).
// All softmax math is f32; the output is rounded once to q's dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;
constexpr int kPlanCols = 5;

// How a CTA is cut for each served (head dim D, group G); INSTANCES in
// flash_attention.py mirrors it (tile tokens, stage keys, CTAs an SM).
//   kTokensPerWarp  query tokens a warp holds (a tile: kWarps of them);
//   kNTiles         n8 tiles of one token's heads (G padded to 8 kNTiles);
//   kStageKeys      key positions a ring stage (16-key mma chunks);
//   kQInSmem        the tile's Q staged in shared memory and read by
//                   `ldmatrix` each k-step, or held in registers;
//   kCtasPerSm      the launch bounds' CTAs an SM.
template <int D, int G>
struct Inst;
template <>
struct Inst<128, 8> {  // qwen2.5-3b: ~160 registers, 64 KB: three CTAs an SM
  static constexpr int kTokensPerWarp = 2, kNTiles = 1, kStageKeys = 64, kCtasPerSm = 3;
  static constexpr bool kQInSmem = false;
};
template <>
struct Inst<256, 10> {  // recurrentgemma-2b: the accumulator alone is 128 registers
  static constexpr int kTokensPerWarp = 1, kNTiles = 2, kStageKeys = 32, kCtasPerSm = 2;
  static constexpr bool kQInSmem = true;
};
template <>
struct Inst<128, 2> {  // internlm2-1.8b, gemma3-27b: (128, 8)'s cut, heads 2-7 padding
  static constexpr int kTokensPerWarp = 2, kNTiles = 1, kStageKeys = 64, kCtasPerSm = 3;
  static constexpr bool kQInSmem = false;
};
template <>
struct Inst<128, 9> {  // starcoder2-7b: (256, 10)'s cut, heads 9-15 padding, 64-key stages
  static constexpr int kTokensPerWarp = 1, kNTiles = 2, kStageKeys = 64, kCtasPerSm = 2;
  static constexpr bool kQInSmem = true;
};
template <>
struct Inst<128, 6> {  // mixtral-8x22b: (128, 8)'s cut, heads 6-7 padding
  static constexpr int kTokensPerWarp = 2, kNTiles = 1, kStageKeys = 64, kCtasPerSm = 3;
  static constexpr bool kQInSmem = false;
};
template <>
struct Inst<128, 16> {  // qwen3-moe-235b-a22b: (128, 9)'s cut, two full n8 tiles
  static constexpr int kTokensPerWarp = 1, kNTiles = 2, kStageKeys = 64, kCtasPerSm = 2;
  static constexpr bool kQInSmem = true;
};
static_assert(Inst<128, 8>::kTokensPerWarp * kWarps == 8 &&
                  Inst<256, 10>::kTokensPerWarp * kWarps == 4 &&
                  Inst<128, 2>::kTokensPerWarp * kWarps == 8 &&
                  Inst<128, 9>::kTokensPerWarp * kWarps == 4 &&
                  Inst<128, 6>::kTokensPerWarp * kWarps == 8 &&
                  Inst<128, 16>::kTokensPerWarp * kWarps == 4,
              "INSTANCES in flash_attention.py plans tiles of 8, 4, 8, 4, 8 and 4 tokens");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from gmem to smem, or 16 zero bytes when !ok (nothing read)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n"); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}
// c += a . b, m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float quad_max(float v) {  // over the 8 lanes of one lane % 4
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// Byte offset of 16-byte chunk `ch` of bf16 row `row` (D*2 bytes a row) in
// a swizzled buffer (key rows of a stage, or the tile's query rows).
template <int D>
__device__ __forceinline__ int swz(int row, int ch) {
  return row * D * 2 + ((ch ^ (row & 7)) << 4);
}

template <int D, int G, typename KVT, bool QUANT>
struct Smem {
  using I = Inst<D, G>;
  static constexpr int kTpw = I::kTokensPerWarp;
  static constexpr int kHp = I::kNTiles * 8;  // a token's heads, padded
  static constexpr int kTileTokens = kWarps * kTpw;
  // the ring: K then V rows of each stage, as stored in the pool (int8 rows
  // unswizzled; bf16 rows swizzled)
  static constexpr int kRowBytes = D * sizeof(KVT);
  static constexpr int kRing = kStages * 2 * I::kStageKeys * kRowBytes;
  // int8: one stage converted to bf16 (K then V, swizzled)
  static constexpr int kConv = QUANT ? 2 * I::kStageKeys * D * 2 : 0;
  // the warps' (acc, m, l) for the merge, over the ring once it is drained
  static constexpr int kMerge = kWarps * kTpw * kHp * D * 4;
  static constexpr int kBody = (kRing + kConv > kMerge) ? kRing + kConv : kMerge;
  // the tile's queries (kQInSmem): kHp swizzled rows a token, padding heads zero
  static constexpr int kQ = I::kQInSmem ? kTileTokens * kHp * D * 2 : 0;
  static constexpr int kMl = kWarps * kTpw * kHp * 2 * 4;
  static constexpr int kKeys = kStages * I::kStageKeys * 4 * (QUANT ? 3 : 1);  // ok, scales
  static constexpr int kBytes = kBody + kQ + kMl + kKeys;
};

template <int D, int G, typename KVT, bool QUANT>
__global__ void __launch_bounds__(kThreads, Inst<D, G>::kCtasPerSm) paged_attention_tc(
    const __nv_bfloat16* __restrict__ q, const KVT* __restrict__ k_pool,
    const KVT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ q_pos, const int* __restrict__ plan,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int KV, int num_pages, int page_size, int num_slots,
    int num_blocks, int blocks_per_split, int window, float softcap, float sm_scale) {
  using I = Inst<D, G>;
  using S = Smem<D, G, KVT, QUANT>;
  constexpr int kTpw = I::kTokensPerWarp, kNt = I::kNTiles, kHp = S::kHp;
  constexpr int kStageKeys = I::kStageKeys;
  constexpr int kChunks = kStageKeys / 16;  // 16-key mma tiles a stage
  static_assert(G <= kHp && kHp - G < 8, "a token's heads fill its n8 tiles");
  static_assert(I::kQInSmem ? kNt == 2 : kNt == 1,
                "Q from shared memory: one ldmatrix.x4 is two n8 tiles' fragments; from "
                "registers: one n8 tile, its padding heads' fragments zero");
  constexpr bool kPadded = kHp != G;  // padding heads on the (last) n8 tile
  static_assert(D % 16 == 0, "head dim in 16-wide mma steps");
  constexpr int kCh = S::kRowBytes / 16;  // 16-byte chunks a pool row
  constexpr int kPer16 = 16 / sizeof(KVT);
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  unsigned char* conv = smem + S::kRing;
  unsigned char* qs = smem + S::kBody;                                   // [tok * kHp + head]
  float* s_m = reinterpret_cast<float*>(smem + S::kBody + S::kQ);       // [warp][tok][head]
  float* s_l = s_m + kWarps * kTpw * kHp;
  int* s_ok = reinterpret_cast<int*>(smem + S::kBody + S::kQ + S::kMl);  // [stage][key]
  float* s_ks = reinterpret_cast<float*>(s_ok + kStages * kStageKeys);
  float* s_vs = s_ks + kStages * kStageKeys;

  asm volatile("griddepcontrol.launch_dependents;\n");  // the split merge may be scheduled
  const int* tile = plan + blockIdx.x * kPlanCols;
  const int t0 = tile[0], n_tok = tile[1], slot = tile[2];
  const int kvh = blockIdx.y, split = blockIdx.z, splits = gridDim.z;
  const int H = KV * G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (n_tok <= 0) return;  // an empty tile: padding rows of a step's fixed-size plan

  // this CTA's slice of the tile's block range, in key positions
  int b_begin = tile[3] + split * blocks_per_split;
  int b_end = min(min(tile[4], num_blocks), b_begin + blocks_per_split);
  if (slot < 0 || b_begin >= b_end) b_begin = b_end = 0;  // padding: nothing to read
  const int pos_begin = b_begin * page_size, pos_end = b_end * page_size;
  const int n_stages = (pos_end - pos_begin + kStageKeys - 1) / kStageKeys;
  const int* table = tables + (size_t)min(max(slot, 0), num_slots - 1) * num_blocks;

  // warps: token groups (kTpw tokens) x key-chunk splits of a stage
  const int pairs = (n_tok + kTpw - 1) / kTpw;
  int ks_n = 1;  // warps sharing a token group: a power of two, at most a stage's chunks
  while (2 * ks_n * pairs <= kWarps && 2 * ks_n <= kChunks) ks_n *= 2;
  const int pair = warp / ks_n, ks = warp % ks_n;
  const bool active = pair < pairs;
  const int tok0 = pair * kTpw;
  const int n_mine = active ? min(kTpw, n_tok - tok0) : 0;

  auto issue = [&](int st) {
    const int buf = st % kStages;
    const int p0 = pos_begin + st * kStageKeys;
    unsigned char* kdst = ring + buf * 2 * kStageKeys * S::kRowBytes;
    unsigned char* vdst = kdst + kStageKeys * S::kRowBytes;
    for (int idx = threadIdx.x; idx < kStageKeys * kCh; idx += kThreads) {
      const int key = idx / kCh, ch = idx % kCh;
      const int kp = p0 + key;
      bool ok = kp < pos_end;
      size_t row = 0;
      if (ok) {
        const int page = table[kp / page_size];
        ok = page >= 0 && page < num_pages;  // bad entry: masked, never read
        if (ok) row = ((size_t)page * page_size + kp % page_size) * KV + kvh;
      }
      const int dst = QUANT ? key * S::kRowBytes + ch * 16 : swz<D>(key, ch);
      cp_async16(kdst + dst, k_pool + row * D + ch * kPer16, ok);
      cp_async16(vdst + dst, v_pool + row * D + ch * kPer16, ok);
      if (ch == 0) {
        s_ok[buf * kStageKeys + key] = ok;
        if constexpr (QUANT) {
          cp_async4(s_ks + buf * kStageKeys + key, k_scale + row, ok);
          cp_async4(s_vs + buf * kStageKeys + key, v_scale + row, ok);
        }
      }
    }
  };

  issue(0);  // the pages first: the query loads overlap their flight
  if constexpr (I::kQInSmem) {  // the tile's queries, with stage 0's group
    constexpr int kQCh = D * 2 / 16;
    for (int idx = threadIdx.x; idx < S::kTileTokens * kHp * kQCh; idx += kThreads) {
      const int row = idx / kQCh, ch = idx % kQCh;
      const int tok = row / kHp, head = row % kHp;
      const bool ok = tok < n_tok && head < G;
      const size_t src = ok ? ((size_t)(t0 + tok) * H + kvh * G + head) * D + ch * 8 : 0;
      cp_async16(qs + swz<D>(row, ch), q + src, ok);
    }
  }
  cp_async_commit();
  if (n_stages > 1) issue(1);
  cp_async_commit();

  // Q^T as the mma's B operand (held in registers unless kQInSmem): per
  // token, per 16-wide step of D, per n8 tile, the pairs (d = 2*(lane%4) +
  // {0,1}, + 8) of head 8 nt + lane / 4
  constexpr int kQf = I::kQInSmem ? 1 : D / 16;
  uint32_t qf[kTpw][kQf][kNt][2];
  int qpos[kTpw];
  float m[kTpw][kNt][2], l[kTpw][kNt][2];
  float acc[kTpw][D / 16][kNt][4];
#pragma unroll
  for (int j = 0; j < kTpw; ++j) {
    const int t = t0 + tok0 + min(j, max(n_mine - 1, 0));
    qpos[j] = (j < n_mine) ? q_pos[t] : 0;
    if constexpr (!I::kQInSmem) {
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        // a padding head's lanes hold zero fragments and read nothing
        const int head = nt * 8 + (lane >> 2);
        const bool ok = j < n_mine && (!kPadded || head < G);
        const __nv_bfloat16* qr = q + ((size_t)t * H + kvh * G + head) * D + 2 * (lane & 3);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          qf[j][kk][nt][0] = ok ? *reinterpret_cast<const uint32_t*>(qr + kk * 16) : 0u;
          qf[j][kk][nt][1] = ok ? *reinterpret_cast<const uint32_t*>(qr + kk * 16 + 8) : 0u;
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      m[j][nt][0] = m[j][nt][1] = kNegInf;
      l[j][nt][0] = l[j][nt][1] = 0.f;
#pragma unroll
      for (int mt = 0; mt < D / 16; ++mt)
        acc[j][mt][nt][0] = acc[j][mt][nt][1] = acc[j][mt][nt][2] = acc[j][mt][nt][3] = 0.f;
    }
  }
  int pmin = qpos[0], pmax = qpos[0];
#pragma unroll
  for (int j = 1; j < kTpw; ++j) {
    if (j < n_mine) {
      pmin = min(pmin, qpos[j]);
      pmax = max(pmax, qpos[j]);
    }
  }

  for (int st = 0; st < n_stages; ++st) {
    const int buf = st % kStages;
    cp_async_wait1();
    __syncthreads();
    const unsigned char* kb = ring + buf * 2 * kStageKeys * S::kRowBytes;
    const unsigned char* vb = kb + kStageKeys * S::kRowBytes;
    if constexpr (QUANT) {  // int8 rows -> bf16, swizzled (exact)
      for (int idx = threadIdx.x; idx < 2 * kStageKeys * kCh; idx += kThreads) {
        const int which = idx / (kStageKeys * kCh), rem = idx % (kStageKeys * kCh);
        const int key = rem / kCh, ch = rem % kCh;
        const int4 raw = *reinterpret_cast<const int4*>(kb + which * kStageKeys * S::kRowBytes +
                                                        key * S::kRowBytes + ch * 16);
        const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
        uint32_t w[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) w[i] = pack_bf16((float)e[2 * i], (float)e[2 * i + 1]);
        unsigned char* dst = conv + which * kStageKeys * D * 2;
        *reinterpret_cast<uint4*>(dst + swz<D>(key, 2 * ch)) = make_uint4(w[0], w[1], w[2], w[3]);
        *reinterpret_cast<uint4*>(dst + swz<D>(key, 2 * ch + 1)) = make_uint4(w[4], w[5], w[6], w[7]);
      }
      __syncthreads();
      kb = conv;
      vb = conv + kStageKeys * D * 2;
    }
    const int p0 = pos_begin + st * kStageKeys;
    if (active) {
      for (int c = ks; c < kChunks; c += ks_n) {
        const int kc0 = p0 + c * 16;
        // the whole chunk past the slice, after every token, or before every window
        if (kc0 >= pos_end || kc0 > pmax || (window > 0 && kc0 + 15 <= pmin - window)) continue;
        float s[kTpw][kNt][4];
#pragma unroll
        for (int j = 0; j < kTpw; ++j)
#pragma unroll
          for (int nt = 0; nt < kNt; ++nt) s[j][nt][0] = s[j][nt][1] = s[j][nt][2] = s[j][nt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t a[4];
          ldsm_x4(a, kb + swz<D>(c * 16 + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
          for (int j = 0; j < kTpw; ++j) {
            if (j >= n_mine) continue;
            if constexpr (I::kQInSmem) {
              // matrices: heads 0-7 at d chunks 2kk, 2kk+1; heads 8-15 the same
              uint32_t b[4];
              ldsm_x4(b, qs + swz<D>((tok0 + j) * kHp + (lane & 7) + ((lane >> 4) << 3),
                                     2 * kk + ((lane >> 3) & 1)));
              mma_bf16(s[j][0], a, b[0], b[1]);
              mma_bf16(s[j][1], a, b[2], b[3]);
            } else {
#pragma unroll
              for (int nt = 0; nt < kNt; ++nt) mma_bf16(s[j][nt], a, qf[j][kk][nt][0], qf[j][kk][nt][1]);
            }
          }
        }
        // this lane's keys: rows r0 and r0 + 8 of the chunk
        const int r0 = lane >> 2;
        const int key0 = c * 16 + r0, key1 = key0 + 8;
        const bool ok0 = s_ok[buf * kStageKeys + key0], ok1 = s_ok[buf * kStageKeys + key1];
        float ksc0 = 1.f, ksc1 = 1.f, vsc0 = 1.f, vsc1 = 1.f;
        if constexpr (QUANT) {
          ksc0 = s_ks[buf * kStageKeys + key0];
          ksc1 = s_ks[buf * kStageKeys + key1];
          vsc0 = s_vs[buf * kStageKeys + key0];
          vsc1 = s_vs[buf * kStageKeys + key1];
        }
        uint32_t pb[kTpw][kNt][2];
#pragma unroll
        for (int j = 0; j < kTpw; ++j) {
#pragma unroll
          for (int nt = 0; nt < kNt; ++nt) pb[j][nt][0] = pb[j][nt][1] = 0u;
          if (j >= n_mine) continue;
          const int kp0 = p0 + key0, kp1 = p0 + key1;
          const bool in0 = ok0 && kp0 <= qpos[j] && (window <= 0 || kp0 > qpos[j] - window);
          const bool in1 = ok1 && kp1 <= qpos[j] && (window <= 0 || kp1 > qpos[j] - window);
#pragma unroll
          for (int nt = 0; nt < kNt; ++nt) {
            float p[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float x = s[j][nt][i] * sm_scale * (i < 2 ? ksc0 : ksc1);
              if (softcap > 0.f) x = softcap * tanhf(x / softcap);
              p[i] = (i < 2 ? in0 : in1) ? x : kNegInf;
            }
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const float m_new = fmaxf(m[j][nt][hh], quad_max(fmaxf(p[hh], p[2 + hh])));
              const float alpha = __expf(m[j][nt][hh] - m_new);
              // masked explicitly: with every key so far masked, m_new is
              // still kNegInf and exp(s - m_new) would be 1
              p[hh] = in0 ? __expf(p[hh] - m_new) : 0.f;
              p[2 + hh] = in1 ? __expf(p[2 + hh] - m_new) : 0.f;
              l[j][nt][hh] = l[j][nt][hh] * alpha + p[hh] + p[2 + hh];
              m[j][nt][hh] = m_new;
#pragma unroll
              for (int mt = 0; mt < D / 16; ++mt) {
                acc[j][mt][nt][hh] *= alpha;
                acc[j][mt][nt][2 + hh] *= alpha;
              }
            }
            // P^T as the B operand: (keys 0-7, heads) and (keys 8-15, heads)
            // of S^T's fragment, each transposed in registers
            pb[j][nt][0] = movmatrix_trans(pack_bf16(p[0] * vsc0, p[1] * vsc0));
            pb[j][nt][1] = movmatrix_trans(pack_bf16(p[2] * vsc1, p[3] * vsc1));
          }
        }
#pragma unroll
        for (int mt = 0; mt < D / 16; ++mt) {
          uint32_t a[4];
          ldsm_x4_trans(a, vb + swz<D>(c * 16 + (lane & 7) + ((lane >> 4) << 3),
                                       2 * mt + ((lane >> 3) & 1)));
#pragma unroll
          for (int j = 0; j < kTpw; ++j) {
            if (j >= n_mine) continue;
#pragma unroll
            for (int nt = 0; nt < kNt; ++nt) mma_bf16(acc[j][mt][nt], a, pb[j][nt][0], pb[j][nt][1]);
          }
        }
      }
    }
    __syncthreads();  // the stage's buffers are free
    if (st + kStages < n_stages) issue(st + kStages);
    cp_async_commit();
  }

  asm volatile("cp.async.wait_group 0;\n");  // (only empty groups are left)
  const int h0 = 2 * (lane & 3), r0 = lane >> 2;
#pragma unroll
  for (int j = 0; j < kTpw; ++j)
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      l[j][nt][0] = quad_sum(l[j][nt][0]);
      l[j][nt][1] = quad_sum(l[j][nt][1]);
    }
  if (ks_n == 1) {
    // one warp owns each token: its registers are the result.  A lane
    // holds dims mt*16 + r0 (+8) of heads 8 nt + h0, + 1; eight lanes write
    // 32 contiguous bytes of one head.
#pragma unroll
    for (int j = 0; j < kTpw; ++j) {  // unrolled: acc stays in registers
      if (j >= n_mine) continue;
      const int t = t0 + tok0 + j;
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int head = nt * 8 + h0 + hh;
          if (head >= G) continue;  // a padding head
          if (splits == 1) {
            const float inv = 1.f / fmaxf(l[j][nt][hh], 1e-30f);
            __nv_bfloat16* o = out + ((size_t)t * H + kvh * G + head) * D + r0;
#pragma unroll
            for (int mt = 0; mt < D / 16; ++mt) {
              o[mt * 16] = __float2bfloat16_rn(acc[j][mt][nt][hh] * inv);
              o[mt * 16 + 8] = __float2bfloat16_rn(acc[j][mt][nt][2 + hh] * inv);
            }
          } else {
            const size_t row = (((size_t)t * KV + kvh) * splits + split) * G + head;
            if (r0 == 0) {
              part_ml[row * 2] = m[j][nt][hh];
              part_ml[row * 2 + 1] = l[j][nt][hh];
            }
            if (l[j][nt][hh] > 0.f) {  // a split that saw no key leaves its acc unwritten
              float* pa = part_acc + row * D + r0;
#pragma unroll
              for (int mt = 0; mt < D / 16; ++mt) {
                pa[mt * 16] = acc[j][mt][nt][hh];
                pa[mt * 16 + 8] = acc[j][mt][nt][2 + hh];
              }
            }
          }
        }
      }
    }
    return;
  }

  // several warps share a token group: merge their (m, l, acc) through
  // shared memory (the ring is drained)
  __syncthreads();
  float* s_acc = reinterpret_cast<float*>(smem);  // [warp][tok][head][D]
#pragma unroll
  for (int j = 0; j < kTpw; ++j) {
    if (j >= n_mine) continue;
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int e = (warp * kTpw + j) * kHp + nt * 8 + h0 + hh;
        if (r0 == 0) {
          s_m[e] = m[j][nt][hh];
          s_l[e] = l[j][nt][hh];
        }
#pragma unroll
        for (int mt = 0; mt < D / 16; ++mt) {
          s_acc[(size_t)e * D + mt * 16 + r0] = acc[j][mt][nt][hh];
          s_acc[(size_t)e * D + mt * 16 + r0 + 8] = acc[j][mt][nt][2 + hh];
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_tok * G * D; i += kThreads) {
    const int tok = i / (G * D), hh = (i / D) % G, dd = i % D;
    const int pr = tok / kTpw, j = tok % kTpw;
    float mx = kNegInf;
    for (int w = pr * ks_n; w < (pr + 1) * ks_n; ++w)
      mx = fmaxf(mx, s_m[(w * kTpw + j) * kHp + hh]);
    float sum = 0.f, a = 0.f;
    for (int w = pr * ks_n; w < (pr + 1) * ks_n; ++w) {
      const int e = (w * kTpw + j) * kHp + hh;
      const float cw = __expf(s_m[e] - mx);
      sum += s_l[e] * cw;
      a += s_acc[(size_t)e * D + dd] * cw;
    }
    const int t = t0 + tok;
    if (splits == 1) {
      out[((size_t)t * H + kvh * G + hh) * D + dd] = __float2bfloat16_rn(a / fmaxf(sum, 1e-30f));
    } else {
      const size_t row = (((size_t)t * KV + kvh) * splits + split) * G + hh;
      if (sum > 0.f) part_acc[row * D + dd] = a;
      if (dd == 0) {
        part_ml[row * 2] = mx;
        part_ml[row * 2 + 1] = sum;
      }
    }
  }
}

// Threads of a merge CTA: one a (head, dim) up to the 1,024 a block may
// have, each looping over the rest ((256, 10) has 2,560 (head, dim) pairs).
template <int D, int G>
struct Combine {
  static constexpr int kThreads = G * D < 1024 ? G * D : 1024;
};

// Merge the splits' partials of one (token, KV head) into the output: the
// splits' (m, l) staged in shared memory first, then each thread one (head,
// dim) after another.  A split with l = 0 saw no admissible key and wrote
// no acc, so it is skipped (a token whose every split is empty gets an
// exact zero row).
template <int D, int G>
__global__ void __launch_bounds__(Combine<D, G>::kThreads) paged_attention_combine(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    __nv_bfloat16* __restrict__ out, int KV, int splits) {
  extern __shared__ float s_ml[];  // [split][head][m, l]
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the partials are complete
  const int t = blockIdx.x, kvh = blockIdx.y;
  const size_t row0 = ((size_t)t * KV + kvh) * splits * G;  // (split, head) rows
  for (int i = threadIdx.x; i < 2 * splits * G; i += blockDim.x) s_ml[i] = part_ml[row0 * 2 + i];
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int hh = i / D, d = i % D;
    float mx = kNegInf;
    for (int s = 0; s < splits; ++s) {
      if (s_ml[(s * G + hh) * 2 + 1] > 0.f) mx = fmaxf(mx, s_ml[(s * G + hh) * 2]);
    }
    float sum = 0.f, a = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float l = s_ml[(s * G + hh) * 2 + 1];
      if (l > 0.f) {
        const float c = __expf(s_ml[(s * G + hh) * 2] - mx);
        sum += l * c;
        a += part_acc[(row0 + (size_t)s * G + hh) * D + d] * c;
      }
    }
    out[((size_t)t * KV + kvh) * G * D + i] = __float2bfloat16_rn(a / fmaxf(sum, 1e-30f));
  }
}

struct Args {
  const void *q, *k_pool, *v_pool, *k_scale, *v_scale, *tables, *q_pos, *plan;
  void *out, *part_acc, *part_ml;
  int T, tiles, G, KV, num_pages, page_size, num_slots, num_blocks, splits, blocks_per_split,
      window;
  float softcap, sm_scale;
  cudaStream_t stream;
};

template <int D, int G, typename KVT, bool QUANT>
cudaError_t launch(const Args& a) {
  auto kernel = paged_attention_tc<D, G, KVT, QUANT>;
  const int smem = Smem<D, G, KVT, QUANT>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(a.tiles, a.KV, a.splits), kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const KVT*>(a.k_pool),
      static_cast<const KVT*>(a.v_pool), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.q_pos), static_cast<const int*>(a.plan),
      static_cast<__nv_bfloat16*>(a.out), static_cast<float*>(a.part_acc),
      static_cast<float*>(a.part_ml), a.KV, a.num_pages, a.page_size, a.num_slots,
      a.num_blocks, a.blocks_per_split, a.window, a.softcap, a.sm_scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.T, a.KV);
  cfg.blockDim = dim3(Combine<D, G>::kThreads);
  cfg.dynamicSmemBytes = 2 * a.splits * G * sizeof(float);
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, paged_attention_combine<D, G>,
                            static_cast<const float*>(a.part_acc),
                            static_cast<const float*>(a.part_ml),
                            static_cast<__nv_bfloat16*>(a.out), a.KV, a.splits);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Returns 0 on success, a CUDA
// error code when a launch is refused, or -1 for a shape the kernel does not
// take (the wrapper checks shapes first).  `plan` is (tiles, 5) int32 and
// must cover every token once (the wrapper's `paged_tile_plan`);
// `part_acc` (T, KV, splits, g, D) and `part_ml` (T, KV, splits, g, 2) f32
// scratch are used only when splits > 1.  The launches are asynchronous on
// `stream`; nothing is allocated here.
extern "C" int repro_paged_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* tables, const void* q_pos, const void* plan, void* out,
    void* part_acc, void* part_ml, int T, int tiles, int H, int KV, int D, int num_pages,
    int page_size, int num_slots, int num_blocks, int splits, int blocks_per_split, int window,
    float softcap, float sm_scale, int q_is_bf16, int kv_is_int8, void* stream) {
  if (T == 0) return 0;
  if (KV <= 0 || H % KV != 0 || page_size <= 0 || num_slots <= 0 || num_blocks <= 0 ||
      tiles <= 0 || splits <= 0 || blocks_per_split <= 0 ||
      (splits > 1 && (!part_acc || !part_ml))) {
    return -1;
  }
  const int G = H / KV;
  // Only the shapes the port serves are instantiated, with bf16 queries over
  // bf16 or int8 pools: qwen2.5-3b (D 128, g 8), recurrentgemma-2b's local
  // attention (D 256, g 10), internlm2-1.8b and gemma3-27b (D 128, g 2),
  // starcoder2-7b (D 128, g 9), mixtral-8x22b (D 128, g 6) and
  // qwen3-moe-235b-a22b (D 128, g 16).  Another (D, g) adds its Inst<D, G> above,
  // its launch here, and its entry to INSTANCES in flash_attention.py.
  if (!q_is_bf16) return -1;
  const Args a{q, k_pool, v_pool, k_scale, v_scale, tables, q_pos, plan, out, part_acc,
               part_ml, T, tiles, G, KV, num_pages, page_size, num_slots, num_blocks, splits,
               blocks_per_split, window, softcap, sm_scale, static_cast<cudaStream_t>(stream)};
  cudaError_t e;
  if (D == 128 && G == 8) {
    e = kv_is_int8 ? launch<128, 8, int8_t, true>(a) : launch<128, 8, __nv_bfloat16, false>(a);
  } else if (D == 256 && G == 10) {
    e = kv_is_int8 ? launch<256, 10, int8_t, true>(a) : launch<256, 10, __nv_bfloat16, false>(a);
  } else if (D == 128 && G == 2) {
    e = kv_is_int8 ? launch<128, 2, int8_t, true>(a) : launch<128, 2, __nv_bfloat16, false>(a);
  } else if (D == 128 && G == 9) {
    e = kv_is_int8 ? launch<128, 9, int8_t, true>(a) : launch<128, 9, __nv_bfloat16, false>(a);
  } else if (D == 128 && G == 6) {
    e = kv_is_int8 ? launch<128, 6, int8_t, true>(a) : launch<128, 6, __nv_bfloat16, false>(a);
  } else if (D == 128 && G == 16) {
    e = kv_is_int8 ? launch<128, 16, int8_t, true>(a) : launch<128, 16, __nv_bfloat16, false>(a);
  } else {
    return -1;
  }
  return static_cast<int>(e);
}
