// Mamba-2's SSD dual-form term for Hopper (sm_90a): the hand-written ports of
// the TPU kernels `_ssd_chunk_kernel` / `ssd_chunk` (K6,
// src/repro/kernels/ssd_chunk.py:27, :104) and `_ssd_segment_kernel` /
// `ssd_segment` (K5, :45, :65).
//
// Contract (pinned by tests/test_torch_kernels.py on the plain versions and
// the work plan, and by tests/test_torch_kernels_gpu.py and chip_smoke.py on
// the card), all f32 and contiguous:
//   x (G, L, H, P); dt, cum (G, L, H); b, c (G, L, N), shared by every head;
//   seg (L,) int32 for the segment kernel (G = 1, L the packed axis; each
//   segment one contiguous run, as serve.pack_step lays a step out).
//   y[g, i, h, :] = sum_j [mask_ij] (C_i . B_j) exp(-(cum_i - cum_j)) dt_j x_j
//   K6 (ssd_chunk_kernel): mask = j <= i inside each of the G chunks.
//   K5 (ssd_segment_kernel): mask = j <= i and seg_j == seg_i and seg_i >= 0.
//   The decay is always formed from the difference cum_j - cum_i, never as
//   exp(-cum_i) * exp(cum_j): over a packed axis cum reaches the thousands and
//   either factor alone over- or underflows.  A masked pair contributes an
//   exact 0 (a select, so its exp never reaches the sum), and a padding row
//   writes exact zeros.
//
// Bound: per admissible (i, j) pair, 2N flops for C_i . B_j (once for all
// heads) and 2P flops per head for the att . x product, against one read of
// x, dt, cum, B, C and one write of y.  On the FMA pipes (67 TFLOP/s f32) a
// 256-row chunk is bound by operations; with att . x on the tensor cores at
// f32 accuracy (three TF32 products, 495 TFLOP/s) it is about balanced with
// its bytes, and the short serving steps are bound by bytes and latency.
//
// Design.  A CTA is 4 warps on one 16-row query tile of one chunk and HG
// heads (HG = 4, 2, 1, picked by the wrapper so the grid fills the card:
// `ssd_plan` in ssd_chunk.py); blockIdx.x runs the row tiles from the last
// (the most key tiles) to the first.  Per key tile of 16 keys:
//   * S = C . B^T (16 x 16) once for the CTA's heads, on the FMA pipes in
//     f32: each warp computes 64 of its elements, each a dot product summed
//     in order over the state (the plain version's order), and writes them
//     to shared memory where every lane reads its fragment.  Three TF32
//     products missed the f32 checks on this product, and so did a split of
//     the state over the warps: where C_i . B_i cancels and the decay is
//     steep, a row is that one small term, and any other rounding of it
//     moves the row by more than the 1e-4 it is allowed.
//   * att = S exp(cum_j - cum_i) dt_j is formed on the lane's fragment of S
//     in registers and fed to att . x on the tensor cores, `mma.sync` m16n8k8
//     TF32 with f32 accumulators, each operand split into hi = tf32(v) and
//     lo = tf32(v - hi) and the product taken as lo.hi + hi.lo + hi.hi
//     ("3xTF32"): inside an 8-key k-step the key order is permuted (k = t <->
//     key 2t, k = t + 4 <-> key 2t + 1, t the lane's index in its quad), so a
//     lane's S elements are its own A elements, and x's B fragment reads keys
//     in the same order.  A warp holds one head and 64 / (4 / HG) columns.
//   * Loads: B, the heads' x rows, cum, dt (and seg for K5) of a key tile go
//     through a 3-stage `cp.async` ring, keys past L zero-filled; the tile's
//     C rows are staged once.  Rows are padded in shared memory (B, C to N +
//     4, x to P + 4 floats) so the loads are free of bank conflicts.  Two
//     barriers a key tile: the tile has landed; S is in.
//   * Key tiles run from the first the row tile needs to its diagonal: 0 for
//     K6; for K5 the start of the segment of its first non-padding row,
//     found in the kernel by walking `seg` back from that row (segments are
//     contiguous).  Key tiles right of the diagonal are never loaded.
// All arithmetic is f32; nothing is allocated here.
//
// K6's backward (no TPU kernel: JAX differentiates the reference's jnp form
// of the term).  With att_ij = S_ij e_ij dt_j, e_ij = exp(-(cum_i - cum_j)):
//   dx_j = dt_j u_j with u_j = sum_{i>=j} S_ij e_ij dy_i (per head);
//   ddt_j = x_j . u_j;
//   dcum_k = sum_i g_ik - sum_j g_kj (g_ij = (dy_i . x_j) att_ij), whose
//     column part is x_k . dx_k = dt_k ddt_k and whose row part is
//     dy_k . y_k (y the forward's output, saved by the autograd Function:
//     flash attention's "delta" trick, so no pass sums g by rows);
//   dS_ij = sum_h (dy_i . x_j) e_ij dt_j over every head (B and C are one
//     group), dC_i = sum_j dS_ij B_j, dB_j = sum_i dS_ij C_i.
// Bound: per admissible pair 2N flops each for S, dB and dC, and per head 2P
// each for u and q = dy . x, against reading x, dt, cum, B, C, dy, y once
// and writing the five gradients once.  At the training shape (32 chunks of
// 256, 24 heads) u and q are 89% of the operations: all of it on the FMA
// pipes takes ~109 us; u and q in 3xTF32 on the tensor cores take ~39 us,
// below the ~66 us its bytes take.  What an unfused design loses is the
// round trips: u and dS per head through memory, dy, x and C reloaded per
// pass.
// Design: two launches, no atomics, so two runs are bit-identical.
//   * the key-tile pass (ssd_bwd_keys_kernel), in the shape of flash
//     attention's dK/dV pass: a CTA of 4 warps owns one 16-key tile j of
//     one chunk and every head; blockIdx.x runs the key tiles from the first
//     (the most query tiles) to the last.
//     - phase 0: S_ij = C_i . B_j for every query tile i >= j, once for all
//       heads, in f32 on the FMA pipes summed in order over the state (the
//       forward's S, bit for bit; 2 keys x 2 queries a thread), pairs of C
//       tiles through a cp.async ring; S of the whole key column (16 x L)
//       stays in shared memory in the mma's fragment order, and so does dS,
//       zeroed; dt of the CTA's 16 rows for every head.
//     - phase 1, per head in order: warp w walks the query tiles j + w,
//       j + w + 4, ... (the heads-per-warp mapping would need u of 24
//       heads, 96 KB, in registers; splitting the query tiles over the warps
//       needs one head's u, 32 floats a lane), each tile's dy rows and cum
//       through the warp's own 2-stage cp.async ring, so no barrier stops a
//       warp inside a head.  Per tile: e_ij = exp(cum_j - cum_i) (__expf of
//       the difference, -inf past the diagonal: a select, no branch); u_j +=
//       (S_ij e_ij)^T dy_i and q^T = x_j dy_i^T on the tensor cores,
//       mma.sync m16n8k8 TF32 in 3xTF32 (operands split by truncation, the
//       small terms first; inside a k-step the queries or head-dim columns
//       are permuted so that an accumulator fragment is the next product's
//       A fragment and x_j's fragments are split once a head); q^T's
//       fragment lands on the lane's own elements of S, so dS_ij += q_ij
//       e_ij dt_j is a read-modify-write of shared memory no other lane
//       touches, the heads summed in order.  A head's rows of x_j, dy_j and
//       y_j and its cum_j, dt_j come in through a double-buffered slot
//       loaded a head ahead.  At the end of a head the four warps' u
//       partials are summed in order in shared memory and each warp writes
//       dx = dt u for 16 head-dim columns and its partials of ddt = x . u
//       and dy . y; ddt and dcum = dt ddt - dy . y of the head's 16 rows are
//       finished after the next head's first barrier (two barriers a head).
//       u never goes to memory.
//     - phase 2: dS of the key column into the (G, L, L) f32 scratch (the
//       blocks at or below the diagonal), and dB_j = sum_i dS_ij^T C_i on
//       the tensor cores (3xTF32, dS^T's fragments straight from its
//       fragment order), C through the ring again.
//   * the dC pass (ssd_bwd_dc_kernel): per (16-row query tile, chunk), dC_i
//     = sum_{j<=i} dS_ij B_j from the scratch in 3xTF32 mma.sync, each key
//     tile's 16 x 16 block of dS and B_j through a cp.async ring.
// The key-tile CTA takes 111 KB of shared memory at 24 heads (S and dS of 16
// tiles, 32 KB; two head slots, 26 KB; the warps' rings, 35 KB; the u
// partials, 16 KB): two CTAs an SM, 8 warps.  What bounds it now is each
// warp's chain of dependent mma.sync, exp and shared-memory steps within a
// tile (96 mma.sync a tile and head, with the splits, exps and loads
// between them), which two warps an SM sub-partition do not hide; wgmma
// over 64-query blocks (u^T = dy^T P with dy^T from registers, q = dy x^T
// from shared memory) is the next step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;   // rows of the query tile
constexpr int kKeys = 16;   // keys of a key tile
constexpr int kStages = 3;  // key tiles in the cp.async ring

struct Args {
  const float* x;
  const float* dt;
  const float* cum;
  const float* b;
  const float* c;
  const int* seg;
  float* y;
  int G, L, H;
};

// Shared-memory layout, in floats: the tile's C rows, then kStages key tiles
// (B rows, the heads' x rows, cum and dt as [key][head], seg), then S in
// the lanes' fragment order ([element][lane]).
template <int N, int P, int HG>
struct Smem {
  static constexpr int kBC = N + 4;  // a B or C row: 8 consecutive rows on distinct banks
  static constexpr int kX = P + 4;   // an x row: a B fragment's key rows 2t, 2t + 1 conflict-free
  static constexpr int b = 0;
  static constexpr int x = b + kKeys * kBC;
  static constexpr int cum = x + HG * kKeys * kX;
  static constexpr int dt = cum + kKeys * HG;
  static constexpr int seg = dt + kKeys * HG;
  static constexpr int stage = seg + kKeys;
  static constexpr int c = 0;
  static constexpr int stages = c + kRows * kBC;
  static constexpr int frag = stages + kStages * stage;
  static constexpr int floats = frag + kRows * kKeys;
  static_assert(stage % 4 == 0 && stages % 4 == 0 && x % 4 == 0, "16-byte cp.async targets");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes from gmem to smem, or zeros when !ok (nothing read)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v = hi + lo with hi, lo TF32 (hi the nearest TF32, lo the nearest to the rest)
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(v - __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b at f32 accuracy: lo.hi + hi.lo + hi.hi (the small terms first)
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], uint32_t bhi0,
                                           uint32_t bhi1, uint32_t blo0, uint32_t blo1) {
  mma_tf32(d, alo, bhi0, bhi1);
  mma_tf32(d, ahi, blo0, blo1);
  mma_tf32(d, ahi, bhi0, bhi1);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// The first key any row of [row0, row0 + 16) admits under K5's mask: the
// start of the segment of its first non-padding row (a later row's segment
// starts later, segments being contiguous runs), or -1 when every row is
// padding.  The warp walks back from that row 128 keys a step.
__device__ int segment_start(const int* __restrict__ seg, int row0, int L, int lane) {
  const int r = row0 + lane;
  const int sv = (lane < kRows && r < L) ? __ldg(seg + r) : -1;
  const unsigned valid = __ballot_sync(~0u, sv >= 0);
  if (!valid) return -1;
  const int first = __ffs(valid) - 1;
  const int s = __shfl_sync(~0u, sv, first);
  int start = row0 + first;
  while (start > 0) {
    bool differs[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = start - 1 - lane - 32 * q;
      differs[q] = j < 0 || __ldg(seg + j) != s;
    }
    int k = -1;  // keys start - 1 ... start - k equal s, key start - 1 - k does not
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned d = __ballot_sync(~0u, differs[q]);
      if (k < 0 && d) k = 32 * q + __ffs(d) - 1;
    }
    if (k >= 0) return start - k;
    start -= 128;
  }
  return 0;
}

// What a CTA of ssd_tile computes (see the header): K6's forward or K5's.
enum Mode { kChunk = 0, kSegment = 1 };

template <int N, int P, int HG, int MODE>
__device__ __forceinline__ void ssd_tile(const Args& a) {
  constexpr bool SEGMENT = MODE == kSegment;
  using S = Smem<N, P, HG>;
  constexpr int WS = kWarps / HG;  // warps on one head, each a slice of P
  constexpr int NT = P / 8 / WS;   // the mma's 8-column tiles of P a warp holds
  static_assert(kWarps % HG == 0 && P % (8 * WS) == 0 && N % 4 == 0, "tiles");
  static_assert(2 * kKeys * HG <= kThreads, "one cum / dt copy a thread");
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);

  const int L = a.L, H = a.H;
  // blockIdx.x -> (row tile, chunk, head group), the row tile with the most
  // key tiles first: the last (ssd_chunk.py's SsdPlan.work is the same map)
  const int groups = (H + HG - 1) / HG;
  const int tiles = (L + kRows - 1) / kRows;
  const int per_tile = a.G * groups;
  const int bid = blockIdx.x;
  const int qt = tiles - 1 - bid / per_tile;
  const int g = (bid % per_tile) / groups;
  const int h0 = (bid % groups) * HG;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int hh = warp / WS, ws = warp % WS;  // the warp's head (of the CTA's) and P slice
  const int h = h0 + hh;
  const int row0 = qt * kRows;
  const int ra = row0 + gid, rb = ra + 8;  // the lane's rows in the fragments

  const size_t gl = static_cast<size_t>(g) * L;
  const float* x = a.x + gl * H * P;
  const float* dt = a.dt + gl * H;
  const float* cum = a.cum + gl * H;
  const float* bm = a.b + gl * N;
  const float* cm = a.c + gl * N;
  float* y = a.y + gl * H * P;

  // the tile's C rows, once (the first cp.async group)
  constexpr int kChN = N / 4;
  for (int e = tid; e < kRows * kChN; e += kThreads) {
    const int r = e / kChN, ch = e % kChN;
    const bool ok = row0 + r < L;
    cp_async16(sm + S::c + r * S::kBC + ch * 4,
               cm + static_cast<size_t>(ok ? row0 + r : 0) * N + ch * 4, ok);
  }
  cp_async_commit();

  const bool head_ok = h < H;  // warp-uniform
  const float cqa = (head_ok && ra < L) ? __ldg(cum + static_cast<size_t>(ra) * H + h) : 0.f;
  const float cqb = (head_ok && rb < L) ? __ldg(cum + static_cast<size_t>(rb) * H + h) : 0.f;
  int sqa = -1, sqb = -1;
  if (SEGMENT) {
    sqa = ra < L ? __ldg(a.seg + ra) : -1;
    sqb = rb < L ? __ldg(a.seg + rb) : -1;
  }

  auto load_tile = [&](int buf, int kt) {
    float* st = sm + S::stages + buf * S::stage;
    const int j0 = kt * kKeys;
    for (int e = tid; e < kKeys * kChN; e += kThreads) {
      const int r = e / kChN, ch = e % kChN;
      const bool ok = j0 + r < L;
      cp_async16(st + S::b + r * S::kBC + ch * 4,
                 bm + static_cast<size_t>(ok ? j0 + r : 0) * N + ch * 4, ok);
    }
    constexpr int kChP = P / 4;  // a key's HG heads are contiguous in x: one run of HG * P floats
    for (int e = tid; e < kKeys * HG * kChP; e += kThreads) {
      const int ch = e % kChP, head = (e / kChP) % HG, r = e / (kChP * HG);
      const int j = j0 + r, hx = h0 + head;
      const bool ok = j < L && hx < H;
      cp_async16(st + S::x + (head * kKeys + r) * S::kX + ch * 4,
                 x + (ok ? (static_cast<size_t>(j) * H + hx) * P : 0) + ch * 4, ok);
    }
    if (tid < 2 * kKeys * HG) {
      const int which = tid / (kKeys * HG), r = (tid / HG) % kKeys, head = tid % HG;
      const int j = j0 + r, hx = h0 + head;
      const bool ok = j < L && hx < H;
      cp_async4(st + (which ? S::dt : S::cum) + r * HG + head,
                (which ? dt : cum) + (ok ? static_cast<size_t>(j) * H + hx : 0), ok);
    }
    if (SEGMENT && tid < kKeys) {
      const bool ok = j0 + tid < L;
      cp_async4(st + S::seg + tid, a.seg + (ok ? j0 + tid : 0), ok);
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int pt = 0; pt < NT; ++pt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[pt][e] = 0.f;

  // key tiles [lo, hi]: from the first the tile admits to its diagonal
  // (rows and key tiles are both 16 wide); the same in every warp
  const int hi = qt;
  int lo = 0;
  if (SEGMENT) {
    const int j = segment_start(a.seg, row0, L, lane);
    lo = j < 0 ? hi + 1 : j / kKeys;
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (lo + s <= hi) load_tile(s, lo + s);
    cp_async_commit();
  }
  // S: this lane computes row sr, keys sk and sk + 8, and stores them where
  // the lane that holds them as fragment elements reads them: element
  // (nt, e) of lane 4 gid + tig is row gid + 8 (e >> 1), key 8 nt + 2 tig + (e & 1)
  const int sr = 4 * warp + lane / 8, sk = lane % 8;
  const float* c_row = sm + S::c + sr * S::kBC;
  float* frag = sm + S::frag;
  const int to = ((2 * (sr >> 3) + (sk & 1)) * 32 + 4 * (sr & 7) + (sk >> 1));  // + 4 * 32 for sk + 8
  for (int kt = lo; kt <= hi; ++kt) {
    const int it = kt - lo;
    cp_async_wait<kStages - 2>();
    __syncthreads();  // key tile kt has landed; the buffer refilled next was read last iteration
    if (kt + kStages - 1 <= hi) load_tile((it + kStages - 1) % kStages, kt + kStages - 1);
    cp_async_commit();

    const float* st = sm + S::stages + (it % kStages) * S::stage;
    {
      const float* b0 = st + S::b + sk * S::kBC;
      const float* b1 = b0 + 8 * S::kBC;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
      for (int k = 0; k < N; k += 4) {
        const float4 cv = *reinterpret_cast<const float4*>(c_row + k);
        s0 = dot4(cv, *reinterpret_cast<const float4*>(b0 + k), s0);
        s1 = dot4(cv, *reinterpret_cast<const float4*>(b1 + k), s1);
      }
      frag[to] = s0;
      frag[to + 4 * 32] = s1;
    }
    __syncthreads();  // S is in (read before the next iteration's first barrier)
    if (!head_ok) continue;  // warp-uniform

    const int j0 = kt * kKeys;
    const float* sCum = st + S::cum;
    const float* sDt = st + S::dt;
    const float* sX = st + S::x + hh * kKeys * S::kX;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {  // att . x, k-step over keys 8 nt ... 8 nt + 7
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float s = frag[(nt * 4 + e) * 32 + lane];
        const int i = e < 2 ? ra : rb, jl = nt * 8 + 2 * tig + (e & 1);
        bool ok = j0 + jl <= i && i < L;
        if (SEGMENT) {
          const int si = e < 2 ? sqa : sqb;
          ok = ok && si >= 0 && reinterpret_cast<const int*>(st + S::seg)[jl] == si;
        }
        const float ck = sCum[jl * HG + hh], dk = sDt[jl * HG + hh];
        const float cq = e < 2 ? cqa : cqb;
        v[e] = ok ? s * expf(ck - cq) * dk : 0.f;
      }
      // A fragment (row, k): (gid, t) = key 2t -> v[0], (gid + 8, t) -> v[2],
      // (gid, t + 4) = key 2t + 1 -> v[1], (gid + 8, t + 4) -> v[3]
      uint32_t ah[4], al[4];
      split(v[0], ah[0], al[0]);
      split(v[2], ah[1], al[1]);
      split(v[1], ah[2], al[2]);
      split(v[3], ah[3], al[3]);
      const float* x0 = sX + (nt * 8 + 2 * tig) * S::kX;  // key 2t's row; key 2t + 1's next
#pragma unroll
      for (int pt = 0; pt < NT; ++pt) {
        const int p = (ws * NT + pt) * 8 + gid;
        uint32_t bh0, bl0, bh1, bl1;
        split(x0[p], bh0, bl0);
        split(x0[S::kX + p], bh1, bl1);
        mma_3xtf32(acc[pt], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  }
  cp_async_wait<0>();  // only empty groups, or C's when no key tile ran

  if (!head_ok) return;
#pragma unroll
  for (int pt = 0; pt < NT; ++pt) {
    const int p = (ws * NT + pt) * 8 + 2 * tig;
    if (ra < L)
      *reinterpret_cast<float2*>(y + (static_cast<size_t>(ra) * H + h) * P + p) =
          make_float2(acc[pt][0], acc[pt][1]);
    if (rb < L)
      *reinterpret_cast<float2*>(y + (static_cast<size_t>(rb) * H + h) * P + p) =
          make_float2(acc[pt][2], acc[pt][3]);
  }
}

template <int N, int P, int HG>
__global__ void __launch_bounds__(kThreads, 2) ssd_chunk_kernel(Args a) {
  ssd_tile<N, P, HG, kChunk>(a);
}

template <int N, int P, int HG>
__global__ void __launch_bounds__(kThreads, 2) ssd_segment_kernel(Args a) {
  ssd_tile<N, P, HG, kSegment>(a);
}

// The kernel instance, with its dynamic shared memory allowed, and its size.
template <int N, int P, int HG>
cudaError_t prepare(int mode, void (**kernel)(Args), size_t* bytes) {
  *bytes = Smem<N, P, HG>::floats * sizeof(float);
  *kernel = mode == kSegment ? ssd_segment_kernel<N, P, HG> : ssd_chunk_kernel<N, P, HG>;
  return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*bytes));
}

// Only mamba2-130m's widths are instantiated: state N 128, head dim P 64.
// Another config adds its instances here and its (N, P) to BUILT in
// ssd_chunk.py.
cudaError_t prepare(int heads_per_cta, int mode, void (**kernel)(Args), size_t* bytes) {
  if (mode != kChunk && mode != kSegment) return cudaErrorInvalidValue;
  switch (heads_per_cta) {
    case 1: return prepare<128, 64, 1>(mode, kernel, bytes);
    case 2: return prepare<128, 64, 2>(mode, kernel, bytes);
    case 4: return prepare<128, 64, 4>(mode, kernel, bytes);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// K6's backward: the key-tile pass and the dC pass (see the header)
// ---------------------------------------------------------------------------

constexpr int kBwdMaxTiles = 16;  // 16-row tiles of the longest chunk the backward takes
constexpr int kPairStages = 2;    // pairs of C tiles in the key-tile pass's phase 0 / 2 ring
constexpr int kDcStages = 4;      // key tiles in the dC pass's ring
constexpr int kWarpStages = 2;    // dy tiles in each warp's ring in the key-tile pass

struct BwdArgs {
  const float* x;
  const float* dt;
  const float* cum;
  const float* b;
  const float* c;
  const float* dy;
  const float* y;
  float* dx;
  float* ddt;
  float* dcum;
  float* db;
  float* dc;
  float* ds;  // scratch (G, L, L): dS summed over the heads, lower block triangle
  int G, L, H;
};

// Where the pair (key k, query q) of a 16 x 16 tile sits in fragment order
// ([element][lane]): the mma accumulator's (row k, column q), held by lane
// 4 (k % 8) + (q % 8) / 2 as its element 4 (q / 8) + 2 (k / 8) + q % 2.
__device__ __forceinline__ int frag_at(int k, int q) {
  return (4 * (q >> 3) + 2 * (k >> 3) + (q & 1)) * 32 + 4 * (k & 7) + ((q & 7) >> 1);
}

// v ~ hi + lo for the backward's 3xTF32 products, both TF32 by truncation:
// the tensor cores read a TF32 operand's top 19 bits and ignore the rest
// (CUTLASS's 3xTF32 passes its small part so), so hi is v itself and lo is
// v less its top 19 bits (exact in f32), read to its own top 19.  Dropped:
// below 2^-21 of v, as with `split`'s rounding, in two instructions.
__device__ __forceinline__ void split_trunc(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v);
  lo = __float_as_uint(v - __uint_as_float(hi & 0xffffe000u));
}

// acc[nb] += A . Bm over one 16-deep block in 3xTF32: A 16 x 16 given as
// its two k-steps' fragments (hi, lo), Bm 16 rows of row stride ld read in
// the permuted k order (k = t <-> row 2t, t + 4 <-> row 2t + 1 of a
// k-step); acc[nb] the accumulator of columns 8 (nb0 + nb) ... + 7.
template <int NB>
__device__ __forceinline__ void mma_rows(float (&acc)[NB][4], const uint32_t (&ah)[2][4],
                                         const uint32_t (&al)[2][4], const float* bm, int ld,
                                         int nb0, int gid, int tig) {
#pragma unroll
  for (int kt = 0; kt < 2; ++kt) {
    const float* b0 = bm + (kt * 8 + 2 * tig) * ld;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int n = (nb0 + nb) * 8 + gid;
      uint32_t bh0, bl0, bh1, bl1;
      split_trunc(b0[n], bh0, bl0);
      split_trunc(b0[ld + n], bh1, bl1);
      mma_3xtf32(acc[nb], ah[kt], al[kt], bh0, bh1, bl0, bl1);
    }
  }
}

// The key-tile pass's shared memory, in floats: S and dS of every query
// tile in fragment order, the ddt and dy . y partials of two heads, two
// slots of a head's rows of x_j, dy_j and y_j with its cum_j and dt_j, then
// one region used by phases 0 and 2 (B_j and a ring of pairs of C tiles)
// and by phase 1 (each warp's ring of dy tiles with their cum, each warp's
// u); then, sized by H, dt of the 16 rows for every head ([head][key]).
template <int N, int P>
struct BwdSmem {
  static constexpr int kBC = N + 4;  // a B or C row (as the forward's)
  static constexpr int kX = P + 4;   // a dy or x row: u's B fragment rows 2t, 2t + 1 conflict-free
  static constexpr int kTile = kRows * kKeys;
  static constexpr int slot = kRows * kX + kRows;  // a warp's ring slot: 16 dy rows, 16 cum
  static constexpr int xslot = 3 * kKeys * kX + 2 * kKeys;  // x_j, dy_j, y_j rows, cum_j, dt_j
  static constexpr int s = 0;
  static constexpr int d = s + kBwdMaxTiles * kTile;
  static constexpr int dd = d + kBwdMaxTiles * kTile;  // [head parity][ddt, dy.y][warp][key]
  static constexpr int xb = dd + 2 * 2 * kWarps * kKeys;
  static constexpr int region = xb + 2 * xslot;
  static constexpr int bj = region;
  static constexpr int cring = bj + kKeys * kBC;
  static constexpr int phase02 = cring + kPairStages * 2 * kRows * kBC;
  static constexpr int wring = region;
  static constexpr int red = wring + kWarps * kWarpStages * slot;
  static constexpr int phase1 = red + kWarps * kKeys * P;
  static constexpr int dt = phase02 > phase1 ? phase02 : phase1;
  static constexpr int floats(int H) { return dt + kKeys * H; }
  static_assert(xb % 4 == 0 && xslot % 4 == 0 && region % 4 == 0 && cring % 4 == 0 &&
                    slot % 4 == 0 && red % 4 == 0, "16-byte cp.async targets");
};

// One CTA: key tile jt of chunk g, every head (blockIdx.x -> (jt, g), the
// first key tile, which has the most query tiles, first).
template <int N, int P>
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_keys_kernel(BwdArgs a) {
  static_assert(kWarps == 4 && P % 16 == 0 && N % 32 == 0, "tiles");
  using S = BwdSmem<N, P>;
  constexpr int kX = S::kX, kBC = S::kBC, NT = P / 8, kChN = N / 4, kChP = P / 4;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* sS = sm + S::s;
  float* sD = sm + S::d;
  float* dd = sm + S::dd;
  float* sdt = sm + S::dt;
  const int L = a.L, H = a.H, T = L / kRows;

  const int jt = blockIdx.x / a.G, g = blockIdx.x % a.G;
  const int tiles = T - jt;  // query tiles jt ... T - 1
  const int pairs = (tiles + 1) / 2;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int j0 = jt * kKeys;
  const size_t gl = static_cast<size_t>(g) * L;

  // the rows of x_j, dy_j and y_j, cum_j and dt_j of head h into x slot h % 2
  auto load_x = [&](int h) {
    float* xs = sm + S::xb + (h & 1) * S::xslot;
    for (int e = tid; e < 3 * kKeys * kChP; e += kThreads) {
      const int w = e / (kKeys * kChP), r = (e / kChP) % kKeys, ch = e % kChP;
      const float* src = w == 0 ? a.x : w == 1 ? a.dy : a.y;
      cp_async16(xs + (w * kKeys + r) * kX + ch * 4, src + ((gl + j0 + r) * H + h) * P + ch * 4,
                 true);
    }
    if (tid < 2 * kKeys)
      cp_async4(xs + 3 * kKeys * kX + tid, (tid < kKeys ? a.cum : a.dt) +
                (gl + j0 + tid % kKeys) * H + h, true);
  };
  // C tiles jt + 2 p and (below T) jt + 2 p + 1 into ring buffer buf
  auto load_pair = [&](int buf, int p) {
    float* dst = sm + S::cring + buf * 2 * kRows * kBC;
    const int rows = min(2 * kRows, (T - jt - 2 * p) * kRows);
    for (int e = tid; e < rows * kChN; e += kThreads) {
      const int r = e / kChN, ch = e % kChN;
      cp_async16(dst + r * kBC + ch * 4, a.c + (gl + (jt + 2 * p) * kRows + r) * N + ch * 4, true);
    }
  };

  // ---- phase 0: S = B_j . C_i for every query tile, C through a ring; dt
  // of the 16 rows for every head
  for (int e = tid; e < kKeys * kChN; e += kThreads) {
    const int r = e / kChN, ch = e % kChN;
    cp_async16(sm + S::bj + r * kBC + ch * 4, a.b + (gl + j0 + r) * N + ch * 4, true);
  }
  load_x(0);
  for (int e = tid; e < kKeys * H; e += kThreads)  // row e / H, head e % H: read in order
    cp_async4(sdt + (e % H) * kKeys + e / H, a.dt + (gl + j0) * H + e, true);
#pragma unroll
  for (int s = 0; s < kPairStages - 1; ++s) {
    if (s < pairs) load_pair(s, s);
    cp_async_commit();
  }
  for (int e = tid; e < tiles * S::kTile; e += kThreads) sD[e] = 0.f;
  {
    // S(keys sk, sk + 8; queries sq, sq + 8) of the pair's tile tt: two B
    // and two C rows (float4 steps) feed four sums
    const int tt = tid / 64, sk = (tid / 8) % 8, sq = tid % 8;
    const float* b0 = sm + S::bj + sk * kBC;
    const float* b1 = b0 + 8 * kBC;
    for (int p = 0; p < pairs; ++p) {
      cp_async_wait<kPairStages - 2>();
      __syncthreads();  // pair p has landed; the buffer refilled next was read last iteration
      if (p + kPairStages - 1 < pairs)
        load_pair((p + kPairStages - 1) % kPairStages, p + kPairStages - 1);
      cp_async_commit();
      if (2 * p + tt >= tiles) continue;  // past T: the pair's second tile is not loaded
      const float* c0 = sm + S::cring + ((p % kPairStages) * 2 + tt) * kRows * kBC + sq * kBC;
      const float* c1 = c0 + 8 * kBC;
      float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;  // each summed in order over the state
#pragma unroll 4
      for (int n = 0; n < N; n += 4) {
        const float4 bv0 = *reinterpret_cast<const float4*>(b0 + n);
        const float4 bv1 = *reinterpret_cast<const float4*>(b1 + n);
        const float4 cv0 = *reinterpret_cast<const float4*>(c0 + n);
        const float4 cv1 = *reinterpret_cast<const float4*>(c1 + n);
        s00 = dot4(cv0, bv0, s00);
        s01 = dot4(cv1, bv0, s01);
        s10 = dot4(cv0, bv1, s10);
        s11 = dot4(cv1, bv1, s11);
      }
      float* st = sS + (2 * p + tt) * S::kTile;
      st[frag_at(sk, sq)] = s00;
      st[frag_at(sk, sq + 8)] = s01;
      st[frag_at(sk + 8, sq)] = s10;
      st[frag_at(sk + 8, sq + 8)] = s11;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // S, dS's zeros, dt and head 0's x slot are in; the region is free

  // ---- phase 1: per head, each warp walks its query tiles jt + warp + 4 r
  float* ring = sm + S::wring + warp * kWarpStages * S::slot;
  float* red = sm + S::red;
  const int n_w = tiles > warp ? (tiles - warp + kWarps - 1) / kWarps : 0;
  const int items = H * n_w;  // (head, query tile) in order, across the heads
  int next = 0;
  auto issue = [&]() {  // the warp's next item into its ring (an empty group past the last)
    if (next < items) {
      const int h = next / n_w, it = jt + warp + kWarps * (next % n_w);
      float* st = ring + (next % kWarpStages) * S::slot;
#pragma unroll
      for (int e = lane; e < kRows * kChP; e += 32) {
        const int r = e / kChP, ch = e % kChP;
        cp_async16(st + r * kX + ch * 4, a.dy + ((gl + it * kRows + r) * H + h) * P + ch * 4,
                   true);
      }
      if (lane < kRows)
        cp_async4(st + kRows * kX + lane, a.cum + (gl + it * kRows + lane) * H + h, true);
    }
    cp_async_commit();
    ++next;
  };
#pragma unroll
  for (int s = 0; s < kWarpStages - 1; ++s) issue();

  // ddt and dcum of key tid for head hp, from the four warps' partials in order
  auto finish_row = [&](int hp) {
    const float* p = dd + (hp & 1) * 2 * kWarps * kKeys + tid;
    const float d = ((p[0] + p[kKeys]) + p[2 * kKeys]) + p[3 * kKeys];
    const float* q = p + kWarps * kKeys;
    const float yy = ((q[0] + q[kKeys]) + q[2 * kKeys]) + q[3 * kKeys];
    const size_t at = (gl + j0 + tid) * H + hp;
    a.ddt[at] = d;
    a.dcum[at] = sdt[hp * kKeys + tid] * d - yy;
  };

  const size_t ka = gl + j0 + gid, kb = ka + 8;  // this lane's keys, as rows of the arrays
  for (int h = 0; h < H; ++h) {
    __syncthreads();  // x slot h % 2 is in; the last head's epilogue is done
    if (h > 0 && tid < kKeys) finish_row(h - 1);
    // head h + 1's x slot (the one the last head used): a warp without query
    // tiles loads its part now, in a group of its own, the others with their
    // first tile's dy
    if (n_w == 0) {
      if (h + 1 < H) load_x(h + 1);
      cp_async_commit();
    }
    const float* xs = sm + S::xb + (h & 1) * S::xslot;
    const float* xc = xs + 3 * kKeys * kX;
    const float cka = xc[gid], ckb = xc[gid + 8], dta = xc[kKeys + gid], dtb = xc[kKeys + gid + 8];
    // x_j as the A operand of q^T = x_j dy_i^T, split once a head; inside an
    // 8-wide k-step the head dim is permuted (k = t <-> 2t, t + 4 <-> 2t + 1)
    uint32_t xh[NT][4], xl[NT][4];
#pragma unroll
    for (int ks = 0; ks < NT; ++ks) {
      const float2 xa = *reinterpret_cast<const float2*>(xs + gid * kX + ks * 8 + 2 * tig);
      const float2 xb = *reinterpret_cast<const float2*>(xs + (gid + 8) * kX + ks * 8 + 2 * tig);
      split_trunc(xa.x, xh[ks][0], xl[ks][0]);
      split_trunc(xb.x, xh[ks][1], xl[ks][1]);
      split_trunc(xa.y, xh[ks][2], xl[ks][2]);
      split_trunc(xb.y, xh[ks][3], xl[ks][3]);
    }
    float u[NT][4];
#pragma unroll
    for (int pt = 0; pt < NT; ++pt)
#pragma unroll
      for (int e = 0; e < 4; ++e) u[pt][e] = 0.f;

    for (int r = 0; r < n_w; ++r) {
      const int k = h * n_w + r;
      cp_async_wait<0>();
      __syncwarp();  // item k has landed for every lane; slot k - 1 is read
      if (r == 0 && h + 1 < H) load_x(h + 1);  // in item k + 1's group
      issue();
      const float* st = ring + (k % kWarpStages) * S::slot;
      const float* cq = st + kRows * kX;
      const int rt = warp + kWarps * r;  // the query tile, counted from jt
      const float* sf = sS + rt * S::kTile;
      float* df = sD + rt * S::kTile;
      float ex[8];
      // u_j += (S_ij e_ij)^T dy_i: rows keys, k the queries (permuted as the
      // forward's att . x), columns the head dim
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float pv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // exp(-inf) = 0 for a pair past the diagonal: a select, no branch;
          // __expf (ex2.approx of t log2 e: a few ulp where t is small, and
          // where it is large the term is small) in place of expf's ten
          // instructions
          const int kl = gid + 8 * (e >> 1), ql = nt * 8 + 2 * tig + (e & 1);
          const float t = (e >> 1 ? ckb : cka) - cq[ql];
          ex[nt * 4 + e] = __expf(rt > 0 || ql >= kl ? t : __uint_as_float(0xff800000u));
          pv[e] = sf[(nt * 4 + e) * 32 + lane] * ex[nt * 4 + e];
        }
        uint32_t ah[4], al[4];
        split_trunc(pv[0], ah[0], al[0]);
        split_trunc(pv[2], ah[1], al[1]);
        split_trunc(pv[1], ah[2], al[2]);
        split_trunc(pv[3], ah[3], al[3]);
        const float* d0 = st + (nt * 8 + 2 * tig) * kX;  // query 2t's dy row; 2t + 1's next
#pragma unroll
        for (int pt = 0; pt < NT; ++pt) {
          const int p = pt * 8 + gid;
          uint32_t bh0, bl0, bh1, bl1;
          split_trunc(d0[p], bh0, bl0);
          split_trunc(d0[kX + p], bh1, bl1);
          mma_3xtf32(u[pt], ah, al, bh0, bh1, bl0, bl1);
        }
      }
      // q^T = x_j dy_i^T (keys x queries over the head dim), four partial
      // sums per 8-query column tile (k-steps ks % 4) for independent chains
      float q[2][4][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) q[nt][c][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < NT; ++ks)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float2 dv =
              *reinterpret_cast<const float2*>(st + (nt * 8 + gid) * kX + ks * 8 + 2 * tig);
          uint32_t bh0, bl0, bh1, bl1;
          split_trunc(dv.x, bh0, bl0);
          split_trunc(dv.y, bh1, bl1);
          mma_3xtf32(q[nt][ks % 4], xh[ks], xl[ks], bh0, bh1, bl0, bl1);
        }
      // dS_ij += q_ij e_ij dt_j, this lane's elements, the heads in order
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int f = nt * 4 + e;
          const float qv = (q[nt][0][e] + q[nt][1][e]) + (q[nt][2][e] + q[nt][3][e]);
          df[f * 32 + lane] += qv * ex[f] * (e >> 1 ? dtb : dta);
        }
    }
    float* rw = red + warp * kKeys * P;  // this warp's u partial, fragment order
#pragma unroll
    for (int pt = 0; pt < NT; ++pt)
#pragma unroll
      for (int e = 0; e < 4; ++e) rw[(pt * 4 + e) * 32 + lane] = u[pt][e];
    __syncthreads();  // every warp's u partial is in

    // epilogue of head h: warp w the head-dim tiles pt = 2w, 2w + 1 of u
    // (the four partials summed in order); dx = dt u; this warp's partials
    // of ddt = x . u and of dy . y over its 16 columns per key
    float pa = 0.f, pb = 0.f, ya = 0.f, yb = 0.f;
#pragma unroll
    for (int m = 0; m < NT / kWarps; ++m) {
      const int pt = (NT / kWarps) * warp + m;
      float uu[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int at = (pt * 4 + e) * 32 + lane;
        uu[e] = ((red[at] + red[kKeys * P + at]) + red[2 * kKeys * P + at]) + red[3 * kKeys * P + at];
      }
      const int p = pt * 8 + 2 * tig;
      *reinterpret_cast<float2*>(a.dx + (ka * H + h) * P + p) = make_float2(dta * uu[0], dta * uu[1]);
      *reinterpret_cast<float2*>(a.dx + (kb * H + h) * P + p) = make_float2(dtb * uu[2], dtb * uu[3]);
      const float* xr = xs + gid * kX + p;  // rows gid of x_j, dy_j, y_j; gid + 8 below
      const float2 xa = *reinterpret_cast<const float2*>(xr);
      const float2 xb = *reinterpret_cast<const float2*>(xr + 8 * kX);
      const float2 da = *reinterpret_cast<const float2*>(xr + kKeys * kX);
      const float2 db = *reinterpret_cast<const float2*>(xr + (kKeys + 8) * kX);
      const float2 va = *reinterpret_cast<const float2*>(xr + 2 * kKeys * kX);
      const float2 vb = *reinterpret_cast<const float2*>(xr + (2 * kKeys + 8) * kX);
      pa = fmaf(xa.y, uu[1], fmaf(xa.x, uu[0], pa));
      pb = fmaf(xb.y, uu[3], fmaf(xb.x, uu[2], pb));
      ya = fmaf(da.y, va.y, fmaf(da.x, va.x, ya));
      yb = fmaf(db.y, vb.y, fmaf(db.x, vb.x, yb));
    }
#pragma unroll
    for (int o = 1; o < 4; o *= 2) {
      pa += __shfl_xor_sync(~0u, pa, o);
      pb += __shfl_xor_sync(~0u, pb, o);
      ya += __shfl_xor_sync(~0u, ya, o);
      yb += __shfl_xor_sync(~0u, yb, o);
    }
    if (tig == 0) {
      float* w = dd + (h & 1) * 2 * kWarps * kKeys + warp * kKeys;
      w[gid] = pa;
      w[gid + 8] = pb;
      w[kWarps * kKeys + gid] = ya;
      w[kWarps * kKeys + gid + 8] = yb;
    }
    cp_async_wait<0>();  // head h + 1's x slot (and the next dy tile) before the next barrier
  }
  __syncthreads();
  if (tid < kKeys) finish_row(H - 1);
  cp_async_wait<0>();  // only empty groups
  __syncthreads();     // the warps' rings are read: the region is free again

  // ---- phase 2: dS to the scratch (rows i >= j0, columns of this key tile),
  // then dB_j = sum_i dS_ij^T C_i, C through the ring again
  for (int e = tid; e < tiles * S::kTile; e += kThreads) {
    const int rt = e / S::kTile, q = (e / kKeys) % kRows, k = e % kKeys;
    a.ds[(gl + (jt + rt) * kRows + q) * L + j0 + k] = sD[rt * S::kTile + frag_at(k, q)];
  }
#pragma unroll
  for (int s = 0; s < kPairStages - 1; ++s) {
    if (s < pairs) load_pair(s, s);
    cp_async_commit();
  }
  // on the tensor cores (3xTF32): warp w the columns 32 w ... 32 w + 31,
  // dS_ij^T's fragments straight from dS's fragment order (a lane's
  // accumulator elements are its A elements, as P's in phase 1)
  constexpr int NB = N / 8 / kWarps;
  float acc[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
  for (int p = 0; p < pairs; ++p) {
    cp_async_wait<kPairStages - 2>();
    __syncthreads();
    if (p + kPairStages - 1 < pairs)
      load_pair((p + kPairStages - 1) % kPairStages, p + kPairStages - 1);
    cp_async_commit();
    for (int t2 = 0; t2 < 2 && 2 * p + t2 < tiles; ++t2) {
      const float* dsf = sD + (2 * p + t2) * S::kTile + lane;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        split_trunc(dsf[(4 * kt + 0) * 32], ah[kt][0], al[kt][0]);
        split_trunc(dsf[(4 * kt + 2) * 32], ah[kt][1], al[kt][1]);
        split_trunc(dsf[(4 * kt + 1) * 32], ah[kt][2], al[kt][2]);
        split_trunc(dsf[(4 * kt + 3) * 32], ah[kt][3], al[kt][3]);
      }
      mma_rows(acc, ah, al, sm + S::cring + ((p % kPairStages) * 2 + t2) * kRows * kBC, kBC,
               NB * warp, gid, tig);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int n = (NB * warp + nb) * 8 + 2 * tig;
    *reinterpret_cast<float2*>(a.db + (gl + j0 + gid) * N + n) = make_float2(acc[nb][0], acc[nb][1]);
    *reinterpret_cast<float2*>(a.db + (gl + j0 + gid + 8) * N + n) =
        make_float2(acc[nb][2], acc[nb][3]);
  }
}

// dC_i = sum_{j <= i} dS_ij B_j for one 16-row query tile of one chunk
// (blockIdx.x -> (tile, chunk), the last tile, which has the most key
// tiles, first): per key tile the 16 x 16 block of the scratch and B_j's
// rows through a cp.async ring, on the tensor cores in 3xTF32 (warp w the
// columns 32 w ... 32 w + 31), the key tiles in order.
template <int N>
__global__ void __launch_bounds__(kThreads) ssd_bwd_dc_kernel(BwdArgs a) {
  constexpr int kBC = N + 4, kDS = kKeys + 8, kChN = N / 4, NB = N / 8 / kWarps;
  constexpr int kStage = kRows * kDS + kKeys * kBC;  // kDS: A's float2 rows conflict-free
  __shared__ __align__(16) float sm[kDcStages * kStage];
  const int L = a.L, T = L / kRows;
  const int it = T - 1 - blockIdx.x / a.G, g = blockIdx.x % a.G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const size_t gl = static_cast<size_t>(g) * L;
  auto load = [&](int buf, int jt) {
    float* st = sm + buf * kStage;
    if (tid < kRows * 4) {
      const int r = tid / 4, ch = tid % 4;
      cp_async16(st + r * kDS + ch * 4, a.ds + (gl + it * kRows + r) * L + jt * kKeys + ch * 4,
                 true);
    }
    for (int e = tid; e < kKeys * kChN; e += kThreads) {
      const int r = e / kChN, ch = e % kChN;
      cp_async16(st + kRows * kDS + r * kBC + ch * 4, a.b + (gl + jt * kKeys + r) * N + ch * 4,
                 true);
    }
  };
  float acc[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
#pragma unroll
  for (int s = 0; s < kDcStages - 1; ++s) {
    if (s <= it) load(s, s);
    cp_async_commit();
  }
  for (int jt = 0; jt <= it; ++jt) {
    cp_async_wait<kDcStages - 2>();
    __syncthreads();
    if (jt + kDcStages - 1 <= it) load((jt + kDcStages - 1) % kDcStages, jt + kDcStages - 1);
    cp_async_commit();
    const float* st = sm + (jt % kDcStages) * kStage;
    // A = dS rows (queries) x keys, keys permuted as B's rows: a float2 a row
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {
      const float2 ra = *reinterpret_cast<const float2*>(st + gid * kDS + kt * 8 + 2 * tig);
      const float2 rb = *reinterpret_cast<const float2*>(st + (gid + 8) * kDS + kt * 8 + 2 * tig);
      split_trunc(ra.x, ah[kt][0], al[kt][0]);
      split_trunc(rb.x, ah[kt][1], al[kt][1]);
      split_trunc(ra.y, ah[kt][2], al[kt][2]);
      split_trunc(rb.y, ah[kt][3], al[kt][3]);
    }
    mma_rows(acc, ah, al, st + kRows * kDS, kBC, NB * warp, gid, tig);
  }
  cp_async_wait<0>();
  float* out = a.dc + (gl + it * kRows + gid) * N;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int n = (NB * warp + nb) * 8 + 2 * tig;
    *reinterpret_cast<float2*>(out + n) = make_float2(acc[nb][0], acc[nb][1]);
    *reinterpret_cast<float2*>(out + 8 * N + n) = make_float2(acc[nb][2], acc[nb][3]);
  }
}

// The key-tile pass, with its dynamic shared memory allowed, and its size
// for H heads.
cudaError_t prepare_bwd(int H, size_t* bytes) {
  *bytes = BwdSmem<128, 64>::floats(H) * sizeof(float);
  return cudaFuncSetAttribute(ssd_bwd_keys_kernel<128, 64>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*bytes));
}

}  // namespace

// Plain C entry point (loaded with ctypes).  segment = 0: K6 over G chunks of
// L rows; segment = 1: K5 over one packed axis of L tokens (G must be 1, seg
// given).  heads_per_cta (1, 2 or 4) is chosen by ssd_plan in ssd_chunk.py.
// Returns 0 on success, a CUDA error code when a launch is refused, or -1
// for a shape the kernel is not built for (the wrapper checks shapes first).
// The launch is asynchronous on `stream`.
extern "C" int repro_ssd(const void* x, const void* dt, const void* cum, const void* b,
                         const void* c, const void* seg, void* y, int G, int L, int H, int P,
                         int N, int segment, int heads_per_cta, void* stream) {
  if (G == 0 || L == 0 || H == 0) return 0;
  if (G < 0 || L < 0 || H < 0 || (segment && (G != 1 || !seg))) return -1;
  if (P != 64 || N != 128 || (heads_per_cta != 1 && heads_per_cta != 2 && heads_per_cta != 4))
    return -1;
  const long long ctas = static_cast<long long>((L + kRows - 1) / kRows) * G *
                         ((H + heads_per_cta - 1) / heads_per_cta);
  if (ctas > 0x7fffffffLL) return -1;
  void (*kernel)(Args);
  size_t bytes;
  const cudaError_t e = prepare(heads_per_cta, segment ? kSegment : kChunk, &kernel, &bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Args a{static_cast<const float*>(x), static_cast<const float*>(dt),
               static_cast<const float*>(cum), static_cast<const float*>(b),
               static_cast<const float*>(c), static_cast<const int*>(seg),
               static_cast<float*>(y), G, L, H};
  kernel<<<static_cast<unsigned>(ctas), kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of instance (heads_per_cta, mode: 0 K6, 1 K5) that fit on one SM
// (registers and shared memory, as the runtime counts them), its dynamic
// shared memory in *smem_bytes; -1 for an instance not built.
extern "C" int repro_ssd_occupancy(int heads_per_cta, int mode, int* smem_bytes) {
  void (*kernel)(Args);
  size_t bytes;
  if (prepare(heads_per_cta, mode, &kernel, &bytes) != cudaSuccess) return -1;
  int ctas = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, kThreads, bytes) != cudaSuccess)
    return -1;
  *smem_bytes = static_cast<int>(bytes);
  return ctas;
}

// The same for K6's backward at H heads: kernel 0 the key-tile pass (its
// dynamic shared memory grows with H), 1 the dC pass (static, *smem_bytes 0).
extern "C" int repro_ssd_bwd_occupancy(int kernel, int heads, int* smem_bytes) {
  size_t bytes = 0;
  int ctas = 0;
  cudaError_t e;
  if (kernel == 0) {
    if (heads < 1 || prepare_bwd(heads, &bytes) != cudaSuccess) return -1;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, ssd_bwd_keys_kernel<128, 64>,
                                                      kThreads, bytes);
  } else if (kernel == 1) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, ssd_bwd_dc_kernel<128>, kThreads, 0);
  } else {
    return -1;
  }
  if (e != cudaSuccess) return -1;
  *smem_bytes = static_cast<int>(bytes);
  return ctas;
}

// K6's backward: given dy, the cotangent of y = ssd_chunk(x, dt, cum, b, c),
// writes dx, ddt, dcum (G, L, H[, P]) and db, dc (G, L, N).  Two launches on
// `stream`, asynchronous: the key-tile pass (dx, ddt, dcum, db, and dS summed
// over the heads into `ds`, a (G, L, L) f32 scratch the caller allocates, of
// which the blocks at or below the diagonal are written and read) and the dC
// pass.  L must be a multiple of 16 up to 256.  Returns 0, the first refused
// launch's CUDA error code, or -1 for a shape it is not built for.
extern "C" int repro_ssd_bwd(const void* x, const void* dt, const void* cum, const void* b,
                             const void* c, const void* dy, const void* y, void* dx, void* ddt,
                             void* dcum, void* db, void* dc, void* ds, int G, int L, int H,
                             int P, int N, void* stream) {
  if (G == 0 || L == 0 || H == 0) return 0;
  if (G < 0 || L < 0 || H < 0 || L % kRows || L > kBwdMaxTiles * kRows || P != 64 || N != 128)
    return -1;
  const long long ctas = static_cast<long long>(G) * (L / kRows);
  if (ctas > 0x7fffffffLL) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  size_t bytes;
  cudaError_t e = prepare_bwd(H, &bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const BwdArgs ba{static_cast<const float*>(x),  static_cast<const float*>(dt),
                   static_cast<const float*>(cum), static_cast<const float*>(b),
                   static_cast<const float*>(c),  static_cast<const float*>(dy),
                   static_cast<const float*>(y),  static_cast<float*>(dx),
                   static_cast<float*>(ddt),      static_cast<float*>(dcum),
                   static_cast<float*>(db),       static_cast<float*>(dc),
                   static_cast<float*>(ds),       G, L, H};
  ssd_bwd_keys_kernel<128, 64><<<static_cast<unsigned>(ctas), kThreads, bytes, st>>>(ba);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_dc_kernel<128><<<static_cast<unsigned>(ctas), kThreads, 0, st>>>(ba);
  return static_cast<int>(cudaGetLastError());
}
