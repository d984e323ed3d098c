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
// Four launches, no atomics, so two runs are bit-identical:
//   * column pass: ssd_tile in kColumn mode, the forward's CTA with the roles
//     of queries and keys swapped (its rows are 16 keys j and HG heads, its
//     key tiles the query tiles i >= j, staged "C" rows = B_j, streamed "B"
//     rows = C_i, streamed "x" = dy, no dt factor, decay exp(cum_j - cum_i));
//     S = B_j . C_i in f32 FMA in the forward's order, u in 3xTF32 mma.sync;
//     it writes u where dx goes;
//   * ds pass: per (query tile, chunk, split of the heads) dS over the
//     split's heads in f32 FMA, into an (splits, G, L, L) scratch;
//   * bc pass: per (16-row tile, chunk) dC (kind 0) or dB (kind 1) from the
//     scratch summed over the splits in order, f32 FMA;
//   * finish pass: a warp a (row, head): ddt, dcum, and dx = dt u in place.
// Bound: per admissible pair 2N flops for S, 2N each for dB and dC, and per
// head 2P for u and 2P for q = dy . x: about twice the forward's operations,
// against reading x, dt, cum, B, C, dy, y once and writing the five
// gradients once.  This first version is simple: the ds pass reloads x per
// (head, key tile) and keeps its sums in shared memory, and the finish pass
// re-reads u, x, dy and y from memory.
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

// What a CTA of ssd_tile computes (see the header): K6's forward, K5's, or
// the column pass of K6's backward.
enum Mode { kChunk = 0, kSegment = 1, kColumn = 2 };

template <int N, int P, int HG, int MODE>
__device__ __forceinline__ void ssd_tile(const Args& a) {
  constexpr bool SEGMENT = MODE == kSegment, COLUMN = MODE == kColumn;
  using S = Smem<N, P, HG>;
  constexpr int WS = kWarps / HG;  // warps on one head, each a slice of P
  constexpr int NT = P / 8 / WS;   // the mma's 8-column tiles of P a warp holds
  static_assert(kWarps % HG == 0 && P % (8 * WS) == 0 && N % 4 == 0, "tiles");
  static_assert(2 * kKeys * HG <= kThreads, "one cum / dt copy a thread");
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);

  const int L = a.L, H = a.H;
  // blockIdx.x -> (row tile, chunk, head group), the row tile with the most
  // key tiles first: the last for the forward (ssd_chunk.py's SsdPlan.work
  // is the same map), the first for the column pass
  const int groups = (H + HG - 1) / HG;
  const int tiles = (L + kRows - 1) / kRows;
  const int per_tile = a.G * groups;
  const int bid = blockIdx.x;
  const int qt = COLUMN ? bid / per_tile : tiles - 1 - bid / per_tile;
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
  // (rows and key tiles are both 16 wide), for the column pass from the
  // diagonal to the last; the same in every warp
  const int hi = COLUMN ? tiles - 1 : qt;
  int lo = COLUMN ? qt : 0;
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
        // the column pass's rows are keys and its key tiles queries: a pair
        // is admitted when the query comes at or after the key
        bool ok = (COLUMN ? j0 + jl >= i && j0 + jl < L : j0 + jl <= i) && i < L;
        if (SEGMENT) {
          const int si = e < 2 ? sqa : sqb;
          ok = ok && si >= 0 && reinterpret_cast<const int*>(st + S::seg)[jl] == si;
        }
        const float ck = sCum[jl * HG + hh], dk = sDt[jl * HG + hh];
        const float cq = e < 2 ? cqa : cqb;
        if (COLUMN)
          v[e] = ok ? s * expf(cq - ck) : 0.f;
        else
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

template <int N, int P, int HG>
__global__ void __launch_bounds__(kThreads, 2) ssd_column_kernel(Args a) {
  ssd_tile<N, P, HG, kColumn>(a);
}

// The kernel instance, with its dynamic shared memory allowed, and its size.
template <int N, int P, int HG>
cudaError_t prepare(int mode, void (**kernel)(Args), size_t* bytes) {
  *bytes = Smem<N, P, HG>::floats * sizeof(float);
  *kernel = mode == kSegment  ? ssd_segment_kernel<N, P, HG>
            : mode == kColumn ? ssd_column_kernel<N, P, HG>
                              : ssd_chunk_kernel<N, P, HG>;
  return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*bytes));
}

// Only mamba2-130m's widths are instantiated: state N 128, head dim P 64.
// Another config adds its instances here and its (N, P) to BUILT in
// ssd_chunk.py.
cudaError_t prepare(int heads_per_cta, int mode, void (**kernel)(Args), size_t* bytes) {
  if (mode != kChunk && mode != kSegment && mode != kColumn) return cudaErrorInvalidValue;
  switch (heads_per_cta) {
    case 1: return prepare<128, 64, 1>(mode, kernel, bytes);
    case 2: return prepare<128, 64, 2>(mode, kernel, bytes);
    case 4: return prepare<128, 64, 4>(mode, kernel, bytes);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// K6's backward: the ds, bc and finish passes (the column pass is ssd_tile's
// kColumn mode above)
// ---------------------------------------------------------------------------

struct BwdArgs {
  const float* x;
  const float* dt;
  const float* cum;
  const float* b;
  const float* c;
  const float* dy;
  const float* y;
  float* dx;   // u from the column pass on entry to the finish pass; dx after it
  float* ddt;
  float* dcum;
  float* db;
  float* dc;
  float* ds;   // scratch (splits, G, L, L): each split's dS, lower block triangle
  int G, L, H, splits;
};

// dS_ij over split s's heads: sum_h (dy_i[h] . x_j[h]) exp(cum_j[h] - cum_i[h])
// dt_j[h] for j <= i.  A CTA is one 16-row query tile of one chunk and one
// split of the heads; it walks its heads in order and, per head, the key
// tiles from the first to its diagonal.  Thread t owns the elements (row
// t / 8, keys t % 8 and t % 8 + 8) of every key tile, kept in shared memory
// and summed over the heads in order (no other thread touches them), each
// q a dot product over the head dim summed in order.  blockIdx.x -> (query
// tile, chunk, split), the last query tile (the most key tiles) first.
template <int P>
__global__ void __launch_bounds__(kThreads) ssd_bwd_ds_kernel(BwdArgs a) {
  constexpr int kX = P + 4;
  constexpr int kMaxL = 256;
  __shared__ __align__(16) float dyS[kRows * kX];
  __shared__ __align__(16) float xS[kKeys * kX];
  __shared__ float cumI[kRows], cumJ[kKeys], dtJ[kKeys];
  __shared__ float dS[kRows * kMaxL];

  const int L = a.L, H = a.H, tiles = L / kRows;
  const int per_tile = a.G * a.splits;
  const int it = tiles - 1 - blockIdx.x / per_tile;
  const int g = (blockIdx.x % per_tile) / a.splits;
  const int s = blockIdx.x % a.splits;
  const int per = (H + a.splits - 1) / a.splits;
  const int h_lo = s * per, h_hi = min(H, h_lo + per);

  const int tid = threadIdx.x, sr = tid / 8, sk = tid % 8;
  const int i = it * kRows + sr;
  const size_t gl = static_cast<size_t>(g) * L;
  constexpr int kChP = P / 4;
  for (int jt = 0; jt <= it; ++jt) {
    dS[sr * kMaxL + jt * kKeys + sk] = 0.f;
    dS[sr * kMaxL + jt * kKeys + sk + 8] = 0.f;
  }
  for (int h = h_lo; h < h_hi; ++h) {
    for (int jt = 0; jt <= it; ++jt) {
      __syncthreads();  // the last tile's reads are done
      if (jt == 0) {
        for (int e = tid; e < kRows * kChP; e += kThreads) {
          const int r = e / kChP, ch = e % kChP;
          *reinterpret_cast<float4*>(dyS + r * kX + ch * 4) = __ldg(
              reinterpret_cast<const float4*>(a.dy + ((gl + it * kRows + r) * H + h) * P) + ch);
        }
        if (tid < kRows) cumI[tid] = __ldg(a.cum + (gl + it * kRows + tid) * H + h);
      }
      for (int e = tid; e < kKeys * kChP; e += kThreads) {
        const int r = e / kChP, ch = e % kChP;
        *reinterpret_cast<float4*>(xS + r * kX + ch * 4) = __ldg(
            reinterpret_cast<const float4*>(a.x + ((gl + jt * kKeys + r) * H + h) * P) + ch);
      }
      if (tid < kKeys) {
        cumJ[tid] = __ldg(a.cum + (gl + jt * kKeys + tid) * H + h);
        dtJ[tid] = __ldg(a.dt + (gl + jt * kKeys + tid) * H + h);
      }
      __syncthreads();
      const float* dr = dyS + sr * kX;
      const float* x0 = xS + sk * kX;
      const float* x1 = x0 + 8 * kX;
      float q0 = 0.f, q1 = 0.f;
#pragma unroll
      for (int k = 0; k < P; k += 4) {
        const float4 d4 = *reinterpret_cast<const float4*>(dr + k);
        q0 = dot4(d4, *reinterpret_cast<const float4*>(x0 + k), q0);
        q1 = dot4(d4, *reinterpret_cast<const float4*>(x1 + k), q1);
      }
      const int j0 = jt * kKeys + sk, j1 = j0 + 8;
      if (j0 <= i) dS[sr * kMaxL + j0] += q0 * expf(cumJ[sk] - cumI[sr]) * dtJ[sk];
      if (j1 <= i) dS[sr * kMaxL + j1] += q1 * expf(cumJ[sk + 8] - cumI[sr]) * dtJ[sk + 8];
    }
  }
  float* out = a.ds + ((static_cast<size_t>(s) * a.G + g) * L + i) * L;
  for (int jt = 0; jt <= it; ++jt) {
    out[jt * kKeys + sk] = dS[sr * kMaxL + jt * kKeys + sk];
    out[jt * kKeys + sk + 8] = dS[sr * kMaxL + jt * kKeys + sk + 8];
  }
}

// dC_t = sum_{j <= t's rows} dS[t rows, j] B_j (kind 0) or dB_t = sum_{i >=
// t's rows} dS[i, t rows]^T C_i (kind 1) for one 16-row tile t of one chunk:
// per source tile, the 16 x 16 block of dS summed over the splits in order
// (the upper half of a diagonal block is zeros) and the tile's 16 rows of B
// or C in shared memory, then 16 outputs a thread (row tid / 8, columns
// 4 (tid % 8) + 32 m + 0..3) summed in order over the source rows.
// blockIdx.x -> (tile, chunk, kind).
template <int N>
__global__ void __launch_bounds__(kThreads) ssd_bwd_bc_kernel(BwdArgs a) {
  constexpr int kBC = N + 4;
  constexpr int kM = N / 32;  // float4 column groups a thread
  static_assert(N % 32 == 0, "columns");
  __shared__ __align__(16) float rowsS[kKeys * kBC];
  __shared__ float blk[kRows][kKeys + 1];

  const int L = a.L, tiles = L / kRows;
  const int kind = blockIdx.x % 2;
  const int g = (blockIdx.x / 2) % a.G;
  const int t = blockIdx.x / (2 * a.G);
  const int tid = threadIdx.x, r = tid / 8, cb = tid % 8;
  const size_t gl = static_cast<size_t>(g) * L;
  const float* src = kind ? a.c : a.b;
  const size_t split_stride = static_cast<size_t>(a.G) * L * L;

  float acc[kM][4];
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] = 0.f;

  const int lo = kind ? t : 0, hi = kind ? tiles - 1 : t;
  for (int u = lo; u <= hi; ++u) {
    __syncthreads();  // the last block's reads are done
    for (int e = tid; e < kRows * kKeys; e += kThreads) {
      const int br = e / kKeys, bc = e % kKeys;
      // kind 0: dS[t rows, u cols]; kind 1: dS[u rows, t cols], transposed
      const size_t at = kind ? (gl + u * kRows + br) * L + t * kKeys + bc
                             : (gl + t * kRows + br) * L + u * kKeys + bc;
      float v = a.ds[at];
      for (int sp = 1; sp < a.splits; ++sp) v += a.ds[sp * split_stride + at];
      if (kind)
        blk[bc][br] = v;
      else
        blk[br][bc] = v;
    }
    constexpr int kChN = N / 4;
    for (int e = tid; e < kKeys * kChN; e += kThreads) {
      const int rr = e / kChN, ch = e % kChN;
      *reinterpret_cast<float4*>(rowsS + rr * kBC + ch * 4) =
          __ldg(reinterpret_cast<const float4*>(src + (gl + u * kKeys + rr) * N) + ch);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kKeys; ++k) {
      const float w = blk[r][k];
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const float4 v = *reinterpret_cast<const float4*>(rowsS + k * kBC + 4 * cb + 32 * m);
        acc[m][0] = fmaf(w, v.x, acc[m][0]);
        acc[m][1] = fmaf(w, v.y, acc[m][1]);
        acc[m][2] = fmaf(w, v.z, acc[m][2]);
        acc[m][3] = fmaf(w, v.w, acc[m][3]);
      }
    }
  }
  float* out = (kind ? a.db : a.dc) + (gl + t * kRows + r) * N;
#pragma unroll
  for (int m = 0; m < kM; ++m)
    *reinterpret_cast<float4*>(out + 4 * cb + 32 * m) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
}

// Per (chunk, row, head), one warp: ddt = x . u, dcum = dt ddt - dy . y (the
// column part of dcum is sum_i g_ij = x_j . dx_j = dt_j ddt_j, the row part
// sum_j g_ij = dy_i . y_i), dx = dt u written over u.  Lane sums combined by
// a fixed butterfly, so runs are bit-identical.
template <int P>
__global__ void __launch_bounds__(256) ssd_bwd_finish_kernel(BwdArgs a) {
  static_assert(P == 64, "two columns a lane");
  const int lane = threadIdx.x % 32;
  const size_t row = static_cast<size_t>(blockIdx.x) * 8 + threadIdx.x / 32;
  if (row >= static_cast<size_t>(a.G) * a.L * a.H) return;  // warp-uniform
  const size_t at = row * P + 2 * lane;
  const float2 u = *reinterpret_cast<const float2*>(a.dx + at);
  const float2 x = __ldg(reinterpret_cast<const float2*>(a.x + at));
  const float2 d = __ldg(reinterpret_cast<const float2*>(a.dy + at));
  const float2 y = __ldg(reinterpret_cast<const float2*>(a.y + at));
  float sx = fmaf(x.y, u.y, x.x * u.x), sy = fmaf(d.y, y.y, d.x * y.x);
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    sx += __shfl_xor_sync(~0u, sx, o);
    sy += __shfl_xor_sync(~0u, sy, o);
  }
  const float dtv = __ldg(a.dt + row);
  *reinterpret_cast<float2*>(a.dx + at) = make_float2(dtv * u.x, dtv * u.y);
  if (lane == 0) {
    a.ddt[row] = sx;
    a.dcum[row] = dtv * sx - sy;
  }
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

// CTAs of instance (heads_per_cta, mode: 0 K6, 1 K5, 2 the backward's column
// pass) that fit on one SM (registers and shared memory, as the runtime
// counts them), its dynamic shared memory in *smem_bytes; -1 for an instance
// not built.
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

// K6's backward: given dy, the cotangent of y = ssd_chunk(x, dt, cum, b, c),
// writes dx, ddt, dcum (G, L, H[, P]) and db, dc (G, L, N).  Four launches on
// `stream`, asynchronous: the column pass (u into dx, heads_per_cta heads a
// CTA), the ds pass (into `ds`, (splits, G, L, L) f32 scratch the caller
// allocates), the bc pass (db, dc from ds) and the finish pass (ddt, dcum,
// dx = dt u).  L must be a multiple of 16 up to 256.  Returns 0, the first
// refused launch's CUDA error code, or -1 for a shape it is not built for.
extern "C" int repro_ssd_bwd(const void* x, const void* dt, const void* cum, const void* b,
                             const void* c, const void* dy, const void* y, void* dx, void* ddt,
                             void* dcum, void* db, void* dc, void* ds, int G, int L, int H,
                             int P, int N, int heads_per_cta, int splits, void* stream) {
  if (G == 0 || L == 0 || H == 0) return 0;
  if (G < 0 || L < 0 || H < 0 || L % kRows || L > 256 || P != 64 || N != 128) return -1;
  if (splits < 1 || splits > H || (heads_per_cta != 1 && heads_per_cta != 2 && heads_per_cta != 4))
    return -1;
  const long long tiles = L / kRows;
  const long long col = tiles * G * ((H + heads_per_cta - 1) / heads_per_cta);
  const long long rows = static_cast<long long>(G) * L * H;
  if (col > 0x7fffffffLL || tiles * G * splits > 0x7fffffffLL || (rows + 7) / 8 > 0x7fffffffLL)
    return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  void (*kernel)(Args);
  size_t bytes;
  cudaError_t e = prepare(heads_per_cta, kColumn, &kernel, &bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Args ca{static_cast<const float*>(dy), static_cast<const float*>(dt),
                static_cast<const float*>(cum), static_cast<const float*>(c),
                static_cast<const float*>(b), nullptr, static_cast<float*>(dx), G, L, H};
  kernel<<<static_cast<unsigned>(col), kThreads, bytes, st>>>(ca);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const BwdArgs ba{static_cast<const float*>(x),  static_cast<const float*>(dt),
                   static_cast<const float*>(cum), static_cast<const float*>(b),
                   static_cast<const float*>(c),  static_cast<const float*>(dy),
                   static_cast<const float*>(y),  static_cast<float*>(dx),
                   static_cast<float*>(ddt),      static_cast<float*>(dcum),
                   static_cast<float*>(db),       static_cast<float*>(dc),
                   static_cast<float*>(ds),       G, L, H, splits};
  ssd_bwd_ds_kernel<64><<<static_cast<unsigned>(tiles * G * splits), kThreads, 0, st>>>(ba);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_bc_kernel<128><<<static_cast<unsigned>(tiles * G * 2), kThreads, 0, st>>>(ba);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_finish_kernel<64><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, st>>>(ba);
  return static_cast<int>(cudaGetLastError());
}
