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
//   h / g serves query head h (g = H / KV): k and v are never repeated
//   (the TPU wrapper's jnp.repeat, :127-129, is gone).
//   Forward writes o (B, H, Sq, D) through o's strides and the per-row
//   log-sum-exp lse (B, H, Sq) f32 of the scaled logits.
//   Key tiles outside the causal / window band are never visited.  The
//   visited range is the TPU kernel's own at its default 128/128 blocks
//   (lo/hi of :45-53 for the 128-row query block holding the row), walked
//   here in 64-key tiles; so a query with no admissible key returns, as the
//   TPU kernel does, the mean of the values in that range (every score is
//   -1e30, every weight exp(0)), and a query whose range is empty returns 0.
//
// Backward (grads of o through the saved lse): dq, dk, dv in q's / k's /
// v's layouts.  P is recomputed per tile from q, k and lse; the (S, S)
// matrix is never stored.  Inadmissible (q, k) pairs get P = 0, so a query
// with no admissible key receives and sends no gradient.  Three launches:
//   1. `attn_bwd_delta`: delta = rowsum(dO * O) per (b, h, i), f32;
//   2. `attn_bwd_dkdv`: one CTA per (32-key tile, KV head, batch) walks the
//      g query heads of its KV head and their query tiles, so dK and dV sum
//      over the group inside the CTA, in registers (wmma accumulators);
//   3. `attn_bwd_dq`: dQ by a second pass, one CTA per (64-query tile,
//      head, batch) over its key tiles.  No atomics anywhere: the backward
//      is deterministic from run to run.
//
// Bound: at Sq = Sk = 2048, D = 128, causal, the forward does ~4*D flops per
// admissible (head, key, query) against ~(q + k + v + o) bytes read once:
// ~1,000 flop/B, above the card's ~295, so it is bound by operations; so is
// the backward (~2.5x the forward's flops).
//
// Design, simple first: tensor cores through the CUDA wmma API (bf16
// 16x16x16 fragments, f32 accumulation), tiles staged in shared memory with
// 16-byte loads, four warps a CTA.  In the forward and the dQ pass each warp
// owns 16 query rows end to end (scores, softmax, accumulator), so the only
// CTA barriers are around the shared K/V tile; the online-softmax output
// accumulator lives in shared memory (f32) and is rescaled row by row.  No
// TMA, no wgmma, no pipelining yet: later PRs' work.  Only D = 128 in bf16 is
// instantiated (qwen2.5-3b); Sq and Sk must be multiples of 64, and of 128
// above 128 (the TPU kernel's block divisibility); the wrapper raises on any
// other shape.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int D = 128;
constexpr int BQ = 64;   // query rows of a forward / dQ tile (16 a warp)
constexpr int BK = 64;   // keys of a forward / dQ tile
constexpr int BKV = 32;  // keys of a dK/dV tile
constexpr int BQB = 64;  // query rows a dK/dV CTA takes at a time
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int LDH = D + 8;   // bf16 row stride of a (rows, D) tile in shared memory
constexpr int LDS = 64 + 4;  // f32 row stride of a 64-wide score tile
constexpr int LDP = 64 + 8;  // bf16 row stride of a 64-wide probability tile
constexpr int LDO = D + 4;   // f32 row stride of a (rows, D) accumulator
constexpr float NEG_INF = -1e30f;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBT;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

struct Layout {  // element strides of a (B, heads, S, D) tensor, D contiguous
  long long b, h, s;
};

struct Problem {
  int h, kvh, sq, sk, causal, window;
  float scale;
  const int* q_seg;   // (B, Sq) or null
  const int* kv_seg;  // (B, Sk) or null
};

__device__ __forceinline__ int floordiv(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// rows x D bf16 from global (row stride rs) into shared memory (row stride LDH)
template <int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long rs) {
  constexpr int VEC = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < ROWS * VEC; i += THREADS) {
    const int r = i / VEC, c = (i % VEC) * 8;
    *reinterpret_cast<uint4*>(dst + r * LDH + c) =
        *reinterpret_cast<const uint4*>(src + r * rs + c);
  }
}

// rows x D f32 from shared memory (row stride LDO), times `mul`, to bf16 rows
// in global memory (row stride rs)
template <int ROWS>
__device__ __forceinline__ void store_rows(bf16* dst, long long rs, const float* src, float mul) {
  constexpr int PAIRS = D / 2;
  for (int i = threadIdx.x; i < ROWS * PAIRS; i += THREADS) {
    const int r = i / PAIRS, c = (i % PAIRS) * 2;
    const float2 f = *reinterpret_cast<const float2*>(src + r * LDO + c);
    *reinterpret_cast<__nv_bfloat162*>(dst + r * rs + c) =
        __floats2bfloat162_rn(f.x * mul, f.y * mul);
  }
}

__device__ __forceinline__ bool admissible(const Problem& p, int b, int qpos, int qseg, int kpos) {
  bool ok = true;
  if (p.causal) ok = kpos <= qpos;
  if (p.window > 0) ok = ok && kpos > qpos - p.window;
  if (p.q_seg) ok = ok && p.kv_seg[(long long)b * p.sk + kpos] == qseg;
  return ok;
}

// (16 x 64) scores of one warp: rows of `a` (row stride LDH) against the 64
// rows of `bt` (row stride LDH), reduced over D, stored f32 at `out` (LDS).
__device__ __forceinline__ void warp_scores(const bf16* a, const bf16* bt, float* out) {
  FragC acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk * 16, LDH);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      FragBT fb;
      wmma::load_matrix_sync(fb, bt + j * 16 * LDH + kk * 16, LDH);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::store_matrix_sync(out + j * 16, acc[j], LDS, wmma::mem_row_major);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

constexpr size_t FWD_SMEM = sizeof(bf16) * (3 * BQ * LDH + BQ * LDP) + sizeof(float) * (BQ * LDS + BQ * LDO);

__global__ void __launch_bounds__(THREADS) attn_fwd(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, Layout lq, Layout lk, Layout lv, Layout lo,
    Problem p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * LDH;
  bf16* sV = sK + BK * LDH;
  bf16* sP = sV + BK * LDH;
  float* sS = reinterpret_cast<float*>(sP + BQ * LDP);
  float* sO = sS + BQ * LDS;

  const int q0 = blockIdx.x * BQ, hh = blockIdx.y, b = blockIdx.z;
  const int kh = hh / (p.h / p.kvh);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int off = p.sk - p.sq;
  const bf16* kb = k + b * lk.b + kh * lk.h;
  const bf16* vb = v + b * lv.b + kh * lv.h;

  load_rows<BQ>(sQ, q + b * lq.b + hh * lq.h + q0 * lq.s, lq.s);
  for (int i = threadIdx.x; i < BQ * LDO; i += THREADS) sO[i] = 0.f;

  // the TPU kernel's visited key blocks (flash_attention.py:45-53) at its
  // default 128/128 blocks, for the 128-row query block holding this tile
  const int bqs = min(128, p.sq), bks = min(128, p.sk);
  const int qs0 = (q0 / bqs) * bqs;
  int blk_hi = p.sk / bks;
  if (p.causal) blk_hi = min(floordiv(qs0 + bqs - 1 + off, bks) + 1, blk_hi);
  const int blk_lo = p.window > 0 ? max(floordiv(qs0 + off - p.window + 1, bks), 0) : 0;

  // lane pair (2r, 2r+1) owns row r of the warp's 16: 32 score columns and
  // 64 output columns each
  const int row = warp * 16 + (lane >> 1), half = lane & 1;
  const int qpos = q0 + row + off;
  const int qseg = p.q_seg ? p.q_seg[(long long)b * p.sq + q0 + row] : 0;
  float m = NEG_INF, l = 0.f;
  bf16* wP = sP + warp * 16 * LDP;
  float* wS = sS + warp * 16 * LDS;
  float* wO = sO + warp * 16 * LDO;
  __syncthreads();

  for (int k0 = blk_lo * bks; k0 < blk_hi * bks; k0 += BK) {
    load_rows<BK>(sK, kb + k0 * lk.s, lk.s);
    load_rows<BK>(sV, vb + k0 * lv.s, lv.s);
    __syncthreads();
    warp_scores(sQ + warp * 16 * LDH, sK, wS);
    __syncwarp();

    float s[32];
    float tmax = NEG_INF;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = half * 32 + c;
      s[c] = admissible(p, b, qpos, qseg, k0 + col) ? wS[(row - warp * 16) * LDS + col] * p.scale
                                                     : NEG_INF;
      tmax = fmaxf(tmax, s[c]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const float alpha = __expf(m - m_new);
    float rs = 0.f;
    bf16* prow = wP + (row - warp * 16) * LDP + half * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float e = __expf(s[c] - m_new);
      rs += e;
      prow[c] = __float2bfloat16_rn(e);
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    l = l * alpha + rs;
    m = m_new;
    float* orow = wO + (row - warp * 16) * LDO + half * 64;
#pragma unroll 8
    for (int c = 0; c < 64; ++c) orow[c] *= alpha;
    __syncwarp();

    FragA fp[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wmma::load_matrix_sync(fp[kk], wP + kk * 16, LDP);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      FragC acc;
      wmma::load_matrix_sync(acc, wO + j * 16, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        FragB fv;
        wmma::load_matrix_sync(fv, sV + kk * 16 * LDH + j * 16, LDH);
        wmma::mma_sync(acc, fp[kk], fv, acc);
      }
      wmma::store_matrix_sync(wO + j * 16, acc, LDO, wmma::mem_row_major);
    }
    __syncthreads();
  }

  __syncwarp();
  const float inv = 1.f / fmaxf(l, 1e-30f);
  const float* orow = wO + (row - warp * 16) * LDO + half * 64;
  bf16* og = o + b * lo.b + hh * lo.h + (long long)(q0 + row) * lo.s + half * 64;
#pragma unroll 8
  for (int c = 0; c < 64; c += 2)
    *reinterpret_cast<__nv_bfloat162*>(og + c) = __floats2bfloat162_rn(orow[c] * inv, orow[c + 1] * inv);
  if (half == 0) lse[((long long)b * p.h + hh) * p.sq + q0 + row] = m + logf(fmaxf(l, 1e-30f));
}

// ---------------------------------------------------------------------------
// backward 1: delta = rowsum(dO * O), one warp per (b, i, h) row
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS) attn_bwd_delta(
    const bf16* __restrict__ o, const bf16* __restrict__ dout, float* __restrict__ delta,
    Layout lo, Layout ldo, int b_count, int h, int sq) {
  const long long rowid = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (rowid >= (long long)b_count * h * sq) return;
  const int i = rowid % sq;
  const int hh = (rowid / sq) % h;
  const int b = rowid / ((long long)sq * h);
  const bf16* orow = o + b * lo.b + hh * lo.h + (long long)i * lo.s + lane * 4;
  const bf16* drow = dout + b * ldo.b + hh * ldo.h + (long long)i * ldo.s + lane * 4;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < 4; c += 2) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(orow + c));
    const float2 g = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(drow + c));
    acc += a.x * g.x + a.y * g.y;
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) delta[rowid] = acc;  // (B, H, Sq) order: rowid = (b * h + hh) * sq + i
}

// ---------------------------------------------------------------------------
// backward 2: dK, dV for one (32-key tile, KV head, batch), summed over the
// g query heads of the KV head and their query tiles
// ---------------------------------------------------------------------------

constexpr size_t DKDV_SMEM = sizeof(bf16) * (2 * BKV * LDH + 2 * BQB * LDH + 2 * BKV * LDP) +
                             sizeof(float) * (2 * BKV * LDS + 2 * BQB);

__global__ void __launch_bounds__(THREADS) attn_bwd_dkdv(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, Layout lq, Layout lk, Layout lv, Layout ldo,
    Problem p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BKV * LDH;
  bf16* sQ = sV + BKV * LDH;
  bf16* sdO = sQ + BQB * LDH;
  bf16* sPT = sdO + BQB * LDH;
  bf16* sdST = sPT + BKV * LDP;
  float* sST = reinterpret_cast<float*>(sdST + BKV * LDP);
  float* sdPT = sST + BKV * LDS;
  float* sLse = sdPT + BKV * LDS;
  float* sDelta = sLse + BQB;

  const int k0 = blockIdx.x * BKV, kh = blockIdx.y, b = blockIdx.z;
  const int g = p.h / p.kvh;
  const int warp = threadIdx.x / 32;
  const int off = p.sk - p.sq;
  load_rows<BKV>(sK, k + b * lk.b + kh * lk.h + k0 * lk.s, lk.s);
  load_rows<BKV>(sV, v + b * lv.b + kh * lv.h + k0 * lv.s, lv.s);

  // query tiles that can see a key of this tile
  int q_lo = 0, q_hi = p.sq;
  if (p.causal) q_lo = max(floordiv(k0 - off, BQB) * BQB, 0);
  if (p.window > 0) q_hi = min((floordiv(k0 + BKV - 1 + p.window - 1 - off, BQB) + 1) * BQB, p.sq);

  // warp w: rows [16 (w/2), +16) of the tile; score columns [32 (w%2), +32),
  // dK / dV columns [64 (w%2), +64)
  const int rf = warp >> 1, cf = warp & 1;
  FragC acc_dk[4], acc_dv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wmma::fill_fragment(acc_dk[j], 0.f);
    wmma::fill_fragment(acc_dv[j], 0.f);
  }
  // elementwise map: thread t takes key row t/4 and 16 query columns
  const int er = threadIdx.x >> 2, ec = (threadIdx.x & 3) * 16;

  for (int hh = kh * g; hh < (kh + 1) * g; ++hh) {
    for (int q0 = q_lo; q0 < q_hi; q0 += BQB) {
      __syncthreads();  // the previous step's readers of sQ / sdO / sPT / sdST are done
      load_rows<BQB>(sQ, q + b * lq.b + hh * lq.h + q0 * lq.s, lq.s);
      load_rows<BQB>(sdO, dout + b * ldo.b + hh * ldo.h + q0 * ldo.s, ldo.s);
      if (threadIdx.x < BQB) {
        const long long r = ((long long)b * p.h + hh) * p.sq + q0 + threadIdx.x;
        sLse[threadIdx.x] = lse[r];
        sDelta[threadIdx.x] = delta[r];
      }
      __syncthreads();
      // S^T = K Q^T and dP^T = V dO^T: (32 keys x 64 queries)
      {
        FragC st[2], dpt[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fill_fragment(st[j], 0.f);
          wmma::fill_fragment(dpt[j], 0.f);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          FragA fk, fv;
          wmma::load_matrix_sync(fk, sK + rf * 16 * LDH + kk * 16, LDH);
          wmma::load_matrix_sync(fv, sV + rf * 16 * LDH + kk * 16, LDH);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int qc = (cf * 2 + j) * 16;
            FragBT fq, fd;
            wmma::load_matrix_sync(fq, sQ + qc * LDH + kk * 16, LDH);
            wmma::load_matrix_sync(fd, sdO + qc * LDH + kk * 16, LDH);
            wmma::mma_sync(st[j], fk, fq, st[j]);
            wmma::mma_sync(dpt[j], fv, fd, dpt[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int qc = (cf * 2 + j) * 16;
          wmma::store_matrix_sync(sST + rf * 16 * LDS + qc, st[j], LDS, wmma::mem_row_major);
          wmma::store_matrix_sync(sdPT + rf * 16 * LDS + qc, dpt[j], LDS, wmma::mem_row_major);
        }
      }
      __syncthreads();
      {
        const int kpos = k0 + er;
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const int qi = q0 + ec + c;
          const int qseg = p.q_seg ? p.q_seg[(long long)b * p.sq + qi] : 0;
          float pr = 0.f;
          if (admissible(p, b, qi + off, qseg, kpos))
            pr = __expf(sST[er * LDS + ec + c] * p.scale - sLse[ec + c]);
          const float ds = pr * (sdPT[er * LDS + ec + c] - sDelta[ec + c]);
          sPT[er * LDP + ec + c] = __float2bfloat16_rn(pr);
          sdST[er * LDP + ec + c] = __float2bfloat16_rn(ds);
        }
      }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q  (the scale is applied to dK at the end)
#pragma unroll
      for (int kk = 0; kk < BQB / 16; ++kk) {
        FragA fp, fds;
        wmma::load_matrix_sync(fp, sPT + rf * 16 * LDP + kk * 16, LDP);
        wmma::load_matrix_sync(fds, sdST + rf * 16 * LDP + kk * 16, LDP);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int dc = (cf * 4 + j) * 16;
          FragB fdo, fq;
          wmma::load_matrix_sync(fdo, sdO + kk * 16 * LDH + dc, LDH);
          wmma::load_matrix_sync(fq, sQ + kk * 16 * LDH + dc, LDH);
          wmma::mma_sync(acc_dv[j], fp, fdo, acc_dv[j]);
          wmma::mma_sync(acc_dk[j], fds, fq, acc_dk[j]);
        }
      }
    }
  }
  __syncthreads();
  // stage through the (now free) Q / dO tiles: 2 x (32 x LDO) f32 fits in 2 x (64 x LDH) bf16
  float* stK = reinterpret_cast<float*>(sQ);
  float* stV = stK + BKV * LDO;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int dc = (cf * 4 + j) * 16;
    wmma::store_matrix_sync(stK + rf * 16 * LDO + dc, acc_dk[j], LDO, wmma::mem_row_major);
    wmma::store_matrix_sync(stV + rf * 16 * LDO + dc, acc_dv[j], LDO, wmma::mem_row_major);
  }
  __syncthreads();
  store_rows<BKV>(dk + b * lk.b + kh * lk.h + k0 * lk.s, lk.s, stK, p.scale);
  store_rows<BKV>(dv + b * lv.b + kh * lv.h + k0 * lv.s, lv.s, stV, 1.f);
}

// ---------------------------------------------------------------------------
// backward 3: dQ for one (64-query tile, head, batch), second pass
// ---------------------------------------------------------------------------

constexpr size_t DQ_SMEM = sizeof(bf16) * (4 * BQ * LDH + BQ * LDP) + sizeof(float) * (2 * BQ * LDS);

__global__ void __launch_bounds__(THREADS) attn_bwd_dq(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, Layout lq, Layout lk, Layout lv, Layout ldo, Problem p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + BQ * LDH;
  bf16* sK = sdO + BQ * LDH;
  bf16* sV = sK + BK * LDH;
  bf16* sdS = sV + BK * LDH;
  float* sS = reinterpret_cast<float*>(sdS + BQ * LDP);
  float* sdP = sS + BQ * LDS;

  const int q0 = blockIdx.x * BQ, hh = blockIdx.y, b = blockIdx.z;
  const int kh = hh / (p.h / p.kvh);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int off = p.sk - p.sq;
  load_rows<BQ>(sQ, q + b * lq.b + hh * lq.h + q0 * lq.s, lq.s);
  load_rows<BQ>(sdO, dout + b * ldo.b + hh * ldo.h + q0 * ldo.s, ldo.s);

  // key tiles holding an admissible key of this query tile
  int k_lo = 0, k_hi = p.sk;
  if (p.causal) k_hi = max(min((floordiv(q0 + BQ - 1 + off, BK) + 1) * BK, p.sk), 0);
  if (p.window > 0) k_lo = max(floordiv(q0 + off - p.window + 1, BK) * BK, 0);

  const int row = warp * 16 + (lane >> 1), half = lane & 1;
  const int wr = row - warp * 16;
  const int qpos = q0 + row + off;
  const int qseg = p.q_seg ? p.q_seg[(long long)b * p.sq + q0 + row] : 0;
  const long long r = ((long long)b * p.h + hh) * p.sq + q0 + row;
  const float row_lse = lse[r], row_delta = delta[r];
  float* wS = sS + warp * 16 * LDS;
  float* wdP = sdP + warp * 16 * LDS;
  bf16* wdS = sdS + warp * 16 * LDP;
  FragC acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's readers of sK / sV are done
    load_rows<BK>(sK, k + b * lk.b + kh * lk.h + k0 * lk.s, lk.s);
    load_rows<BK>(sV, v + b * lv.b + kh * lv.h + k0 * lv.s, lv.s);
    __syncthreads();
    warp_scores(sQ + warp * 16 * LDH, sK, wS);
    warp_scores(sdO + warp * 16 * LDH, sV, wdP);
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = half * 32 + c;
      float pr = 0.f;
      if (admissible(p, b, qpos, qseg, k0 + col))
        pr = __expf(wS[wr * LDS + col] * p.scale - row_lse);
      wdS[wr * LDP + col] = __float2bfloat16_rn(pr * (wdP[wr * LDS + col] - row_delta));
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      FragA fds;
      wmma::load_matrix_sync(fds, wdS + kk * 16, LDP);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        FragB fk;
        wmma::load_matrix_sync(fk, sK + kk * 16 * LDH + j * 16, LDH);
        wmma::mma_sync(acc[j], fds, fk, acc[j]);
      }
    }
  }
  __syncthreads();
  float* st = reinterpret_cast<float*>(sK);  // sK + sV + sdS hold 64 x LDO f32
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(st + warp * 16 * LDO + j * 16, acc[j], LDO, wmma::mem_row_major);
  __syncthreads();
  store_rows<BQ>(dq + b * lq.b + hh * lq.h + q0 * lq.s, lq.s, st, p.scale);
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

}  // namespace

static_assert(LDO * 64 * sizeof(float) <= 2 * BQ * LDH * sizeof(bf16) + BQ * LDP * sizeof(bf16),
              "dQ staging must fit in the K, V and dS tiles");
static_assert(2 * BKV * LDO * sizeof(float) <= 2 * BQB * LDH * sizeof(bf16),
              "dK/dV staging must fit in the Q and dO tiles");

// strides: 3 per tensor, (batch, head, position) in elements
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         void* lse, const void* q_seg, const void* kv_seg,
                                         int b, int h, int kvh, int sq, int sk, int d,
                                         const long long* strides, int causal, int window,
                                         float scale, void* stream) {
  if (!shape_ok(b, h, kvh, sq, sk, d) || (q_seg == nullptr) != (kv_seg == nullptr)) return -1;
  const Layout lq{strides[0], strides[1], strides[2]}, lk{strides[3], strides[4], strides[5]},
      lv{strides[6], strides[7], strides[8]}, lo{strides[9], strides[10], strides[11]};
  const Problem p{h, kvh, sq, sk, causal, window, scale, static_cast<const int*>(q_seg),
                  static_cast<const int*>(kv_seg)};
  cudaError_t e = allow_smem(attn_fwd, FWD_SMEM, &fwd_smem_set);
  if (e != cudaSuccess) return (int)e;
  attn_fwd<<<dim3(sq / BQ, h, b), THREADS, FWD_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), lq, lk, lv, lo, p);
  return (int)cudaGetLastError();
}

// strides: q, k, v, o, dout; dq / dk / dv share q's / k's / v's strides;
// delta is (B, H, Sq) f32 scratch
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         void* delta, void* dq, void* dk, void* dv,
                                         const void* q_seg, const void* kv_seg, int b, int h,
                                         int kvh, int sq, int sk, int d,
                                         const long long* strides, int causal, int window,
                                         float scale, void* stream) {
  if (!shape_ok(b, h, kvh, sq, sk, d) || (q_seg == nullptr) != (kv_seg == nullptr)) return -1;
  const Layout lq{strides[0], strides[1], strides[2]}, lk{strides[3], strides[4], strides[5]},
      lv{strides[6], strides[7], strides[8]}, lo{strides[9], strides[10], strides[11]},
      ldo{strides[12], strides[13], strides[14]};
  const Problem p{h, kvh, sq, sk, causal, window, scale, static_cast<const int*>(q_seg),
                  static_cast<const int*>(kv_seg)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)b * h * sq;
  attn_bwd_delta<<<(unsigned)((rows + WARPS - 1) / WARPS), THREADS, 0, s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), static_cast<float*>(delta), lo,
      ldo, b, h, sq);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if ((e = allow_smem(attn_bwd_dkdv, DKDV_SMEM, &dkdv_smem_set)) != cudaSuccess) return (int)e;
  attn_bwd_dkdv<<<dim3(sk / BKV, kvh, b), THREADS, DKDV_SMEM, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), lq, lk, lv,
      ldo, p);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if ((e = allow_smem(attn_bwd_dq, DQ_SMEM, &dq_smem_set)) != cudaSuccess) return (int)e;
  attn_bwd_dq<<<dim3(sq / BQ, h, b), THREADS, DQ_SMEM, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), lq, lk, lv, ldo, p);
  return (int)cudaGetLastError();
}
