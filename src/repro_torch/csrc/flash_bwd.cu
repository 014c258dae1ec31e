// Causal GQA flash-attention backward for Hopper (sm_90a), plain C interface:
// the two recompute sweeps.
//
// Replaces: src/repro/kernels/flash_attention_bwd.py, _dq_kernel and
// _dkv_kernel (both launched by flash_attention_bwd_pallas). Same contract:
// q/dO (B,S,Hq,D), k/v (B,T,Hkv,D), query row i and key j at positions i
// and j, causal, optional sliding window, tanh logit softcap. From the
// forward's lse (B,Hq,S) and delta = rowsum(dO * O) (B,Hq,S), both f32, each
// tile recomputes
//   s  = softcap((q . k) * dscale)
//   p  = live ? exp(s - lse_safe) : 0,   lse_safe = lse > NEG_INF/2 ? lse : 0
//   dS = p * (dO . v - delta) * (1 - (s/c)^2 if softcap) * dscale
// and accumulates dq = sum_j dS K (dq sweep: keys innermost) and
// dk = sum_{i,g} dS^T Q, dv = sum_{i,g} p^T dO (dk/dv sweep: queries
// innermost, the G query heads of a GQA group summed into their kv head).
// Neither sweep uses atomics: the result is deterministic. Outputs are in
// the input dtype, accumulated in f32. A fully-masked row (lse = NEG_INF)
// gets exactly zero gradients.
//
// What bounds them on this card: at the training shape (B4 S512 Hq32 Hkv8
// D64 bf16, causal) the dq sweep does 3 and the dk/dv sweep 4 products of
// the causal half, ~6.4 and ~8.6 GFLOP, against ~25 MB of operands: both sit
// above the ~295 flop/byte ridge, so the tensor cores bound them (~6.5 and
// ~8.7 us). What held dk/dv far from that was the chain of one CTA: the CTA
// of key tile 0 walked the G = 4 query heads of its group times 8 query
// tiles, 32 tiles in series, each loaded synchronously between barriers.
//
// dk/dv, bf16 (redesigned for Hopper; building blocks in hopper.cuh):
//  - the G query heads of a group come off the serial chain: a thread-block
//    cluster of C = min(G, 8) CTAs per (64 keys, kv head, batch), CTA r
//    taking heads r, r + C, ...; at the training shape each CTA walks 8
//    query tiles, not 32. The C partial dK/dV are summed over distributed
//    shared memory in fixed rank order (no atomics: bitwise reproducible),
//    one launch; key tile 0 (the most query tiles) is launched first;
//  - K and V are loaded once per CTA by TMA; Q, dO, lse and delta tiles of
//    64 queries stream through a 3-stage ring filled by TMA (4-D maps over
//    (B, S, Hq, D) in the 128-byte swizzle; 1-D maps over lse and delta),
//    completion on one mbarrier per stage, one elected thread issuing;
//    after the loop the ring holds the partial sums, so a CTA takes ~69 KB
//    at head_dim 64 and three share an SM;
//  - one warpgroup issues wgmma: S^T = K Q^T and dP^T = V dO^T with both
//    operands in shared memory, then dV += P^T dO and dK += dS^T Q with P^T
//    and dS^T taken from the accumulators in registers and dO/Q read as
//    MN-major operands; the dV/dK products are not waited for: the next
//    tile's S^T and dP^T are issued behind them. p in the exp2 domain; the
//    mask only on tiles that cross the diagonal, the window's edge, S or T.
// dq, bf16: the PR 13 design until its own redesign: mma.sync m16n8k16 (bf16
//  in, f32 accumulate), one CTA per (64 query rows, query head, batch), 4
//  warps x 16 rows, Q and dO held as A fragments, 64-key K/V tiles staged
//  synchronously in padded shared memory, the key loop from the window's
//  band start to the causal diagonal; dS re-packed in registers as the A
//  operand of dS.K.
// f32: plain FMA kernels, one lane per key (dq) or per query (dk/dv), so the
//  f32 checks hold 2e-5.
// Rows >= S and keys >= T are masked in the kernels and their tiles
// zero-filled (0 x NaN is NaN inside an MMA): no padded copies.
#include "hopper.cuh"

using hopper::pack_bf16;

#define NEG_INF (-1e30f)

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__device__ __forceinline__ bool live_at(int key, int row, int S, int T,
                                        int window) {
  return row < S && key < T && key <= row && (window <= 0 || row - key < window);
}

__device__ __forceinline__ float capped(float x, float cap) {
  return cap > 0.f ? cap * tanhf(x / cap) : x;
}

// p and dS of one (row, key) entry from its raw q.k and dO.v products
__device__ __forceinline__ void p_ds(float qk, float dov, float lse,
                                     float delta, bool live, float cap,
                                     float dscale, float& p, float& ds) {
  const float s = capped(qk * dscale, cap);
  const float lse_safe = lse > 0.5f * NEG_INF ? lse : 0.f;
  p = live ? expf(s - lse_safe) : 0.f;
  float d = p * (dov - delta);
  if (cap > 0.f) {
    const float u = s / cap;
    d *= 1.f - u * u;
  }
  ds = d * dscale;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments (16 rows x D) of rows r0 and r0 + 8 of a (rows, stride) bf16
// matrix; rows >= n_rows read as zero
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&f)[D / 16][4],
                                       const __nv_bfloat16* base,
                                       int64_t stride, int r0, int n_rows,
                                       int t) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    auto ld = [&](int row, int col) -> uint32_t {
      return row < n_rows
                 ? *reinterpret_cast<const uint32_t*>(base + row * stride + col)
                 : 0u;
    };
    f[kk][0] = ld(r0, c);
    f[kk][1] = ld(r1, c);
    f[kk][2] = ld(r0, c + 8);
    f[kk][3] = ld(r1, c + 8);
  }
}

// stage rows [r0, r0 + ROWS) of a (rows, stride) bf16 matrix in shared
// memory with row pitch LDS; rows >= n_rows are zero-filled
template <int D, int ROWS>
__device__ __forceinline__ void stage(__nv_bfloat16* dst,
                                      const __nv_bfloat16* base,
                                      int64_t stride, int r0, int n_rows) {
  constexpr int LDS = D + 8, CH = D / 8;            // 16-byte chunks per row
  for (int c = threadIdx.x; c < ROWS * CH; c += blockDim.x) {
    const int row = c / CH, col = (c % CH) * 8, r = r0 + row;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r < n_rows) x = *reinterpret_cast<const uint4*>(base + r * stride + col);
    *reinterpret_cast<uint4*>(&dst[row * LDS + col]) = x;
  }
}

// acc (16 x 8n) += A (16 x N, as C fragments) . B (N x D staged in smem,
// N = rows of the tile): B read column-wise, the forward's PV pattern
template <int D, int N>
__device__ __forceinline__ void mma_acc(float (&acc)[D / 8][4],
                                        const float (&a)[N / 8][4],
                                        const __nv_bfloat16* Bs, int g, int t) {
  constexpr int LDS = D + 8;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(a[2 * kk][0], a[2 * kk][1]),
                            pack_bf16(a[2 * kk][2], a[2 * kk][3]),
                            pack_bf16(a[2 * kk + 1][0], a[2 * kk + 1][1]),
                            pack_bf16(a[2 * kk + 1][2], a[2 * kk + 1][3])};
    const __nv_bfloat16* b0 = &Bs[(kk * 16 + 2 * t) * LDS + g];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const __nv_bfloat16* bc = b0 + j * 8;
      __nv_bfloat162 lo, hi;
      lo.x = bc[0];        lo.y = bc[LDS];
      hi.x = bc[8 * LDS];  hi.y = bc[9 * LDS];
      mma_bf16(acc[j], pa, *reinterpret_cast<uint32_t*>(&lo),
               *reinterpret_cast<uint32_t*>(&hi));
    }
  }
}

// c (16 x N) = A (16 x D, fragments) . Bs^T (Bs: N rows x D in smem): the
// forward's QK^T pattern
template <int D, int N>
__device__ __forceinline__ void mma_abt(float (&c)[N / 8][4],
                                        const uint32_t (&a)[D / 16][4],
                                        const __nv_bfloat16* Bs, int g, int t) {
  constexpr int LDS = D + 8;
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
    const __nv_bfloat16* brow = &Bs[(n * 8 + g) * LDS + 2 * t];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(brow + kk * 16);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(brow + kk * 16 + 8);
      mma_bf16(c[n], a[kk], b0, b1);
    }
  }
}

template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, int64_t stride,
                                           const float (&acc)[D / 8][4], int r0,
                                           int n_rows, int t) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (r0 < n_rows)
      *reinterpret_cast<uint32_t*>(base + r0 * stride + c) =
          pack_bf16(acc[j][0], acc[j][1]);
    if (r0 + 8 < n_rows)
      *reinterpret_cast<uint32_t*>(base + (r0 + 8) * stride + c) =
          pack_bf16(acc[j][2], acc[j][3]);
  }
}

// ------------------------------------------------------- bf16 dq sweep

constexpr int BM = 64;   // query rows per dq CTA (4 warps x 16)
constexpr int BN = 64;   // keys per tile / per dk-dv CTA (4 warps x 16)

template <int D>
__global__ void __launch_bounds__(128)
flash_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dq, int S, int T, int Hq,
                     int Hkv, int window, float cap, float dscale) {
  constexpr int LDS = D + 8;
  __shared__ __align__(16) __nv_bfloat16 Ks[BN * LDS];
  __shared__ __align__(16) __nv_bfloat16 Vs[BN * LDS];

  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

  const int64_t q_stride = static_cast<int64_t>(Hq) * D;
  const int64_t kv_stride = static_cast<int64_t>(Hkv) * D;
  const int64_t q_off = static_cast<int64_t>(b) * S * q_stride + h * D;
  const __nv_bfloat16* kb = k + static_cast<int64_t>(b) * T * kv_stride + hk * D;
  const __nv_bfloat16* vb = v + static_cast<int64_t>(b) * T * kv_stride + hk * D;
  const float* lb = lse + (static_cast<int64_t>(b) * Hq + h) * S;
  const float* db = delta + (static_cast<int64_t>(b) * Hq + h) * S;

  uint32_t qf[D / 16][4], df[D / 16][4];
  load_a<D>(qf, q + q_off, q_stride, q0 + warp * 16 + g, S, t);
  load_a<D>(df, dout + q_off, q_stride, q0 + warp * 16 + g, S, t);
  const float L0 = r0 < S ? lb[r0] : 0.f, L1 = r1 < S ? lb[r1] : 0.f;
  const float E0 = r0 < S ? db[r0] : 0.f, E1 = r1 < S ? db[r1] : 0.f;

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int last_row = min(S, q0 + BM) - 1;
  int k_begin = window > 0 ? max(0, q0 - (window - 1)) : 0;
  k_begin = (k_begin / BN) * BN;
  const int k_end = min(T, last_row + 1);

  for (int kt = k_begin; kt < k_end; kt += BN) {
    __syncthreads();
    stage<D, BN>(Ks, kb, kv_stride, kt, T);
    stage<D, BN>(Vs, vb, kv_stride, kt, T);
    __syncthreads();
    float s[BN / 8][4], dp[BN / 8][4];
    mma_abt<D, BN>(s, qf, Ks, g, t);
    mma_abt<D, BN>(dp, df, Vs, g, t);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt + n * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? r0 : r1;
        float p, ds;
        p_ds(s[n][e], dp[n][e], e < 2 ? L0 : L1, e < 2 ? E0 : E1,
             live_at(key, row, S, T, window), cap, dscale, p, ds);
        s[n][e] = ds;
      }
    }
    mma_acc<D, BN>(acc, s, Ks, g, t);               // dq += dS . K
  }
  store_rows<D>(dq + q_off, q_stride, acc, r0, S, t);
}

// ---------------------------------------------------- bf16 dk/dv sweep

template <int D>
struct DkvSmem {
  static constexpr int STAGES = 3;
  static constexpr int TILE = BN * D * 2;             // bytes of a 64-row tile
  static constexpr int V_OFF = TILE;                  // K first
  static constexpr int RING_OFF = 2 * TILE;
  // a stage: Q, dO, lse (64 f32), delta (64 f32), padded to 1024 bytes
  static constexpr int L_OFF = 2 * TILE, E_OFF = L_OFF + 256;
  static constexpr int STAGE = 2 * TILE + 1024;
  // after the loop the ring holds this CTA's f32 partial dK and dV
  static constexpr int PITCH = D + 4;                 // f32 row of a partial
  static_assert(2 * BN * PITCH * 4 <= STAGES * STAGE, "partials fit the ring");
  static constexpr int BAR_OFF = RING_OFF + STAGES * STAGE;
  // + the barriers (K/V, one per stage), + slack for 1024-byte alignment
  static constexpr int BYTES = BAR_OFF + 8 * (1 + STAGES) + 1024;
};

// p^T and dS^T of a (64 keys x 64 queries) tile in place, from the raw
// products s = K Q^T and dp = V dO^T and the queries' lse and delta
template <bool CAP>
__device__ __forceinline__ void p_ds_tile(float (&s)[32], float (&dp)[32],
                                          const float* Ls, const float* Es,
                                          int t, float dscale, float cap) {
  using hopper::LOG2E;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 lv = *reinterpret_cast<const float2*>(Ls + 8 * j + 2 * t);
    const float2 ev = *reinterpret_cast<const float2*>(Es + 8 * j + 2 * t);
    // lse_safe (NEG_INF swapped for 0) in log2 units
    const float l2[2] = {(lv.x > 0.5f * NEG_INF ? lv.x : 0.f) * LOG2E,
                         (lv.y > 0.5f * NEG_INF ? lv.y : 0.f) * LOG2E};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      const float delta = (e & 1) ? ev.y : ev.x;
      if (CAP) {
        const float th = tanhf(s[i] * (dscale / cap));  // capped s = cap * th
        const float p = exp2f(fmaf(cap * th, LOG2E, -l2[e & 1]));
        dp[i] = p * (dp[i] - delta) * (1.f - th * th) * dscale;
        s[i] = p;
      } else {
        const float p = exp2f(fmaf(s[i], dscale * LOG2E, -l2[e & 1]));
        dp[i] = p * fmaf(dp[i], dscale, -delta * dscale);
        s[i] = p;
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(128, D == 64 ? 3 : 1)
flash_dkv_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap omap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap lmap,
                      const __grid_constant__ CUtensorMap emap,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int S, int T, int Hq,
                      int Hkv, int window, float cap, float dscale) {
  using namespace hopper;
  using L = DkvSmem<D>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint8_t* Ks = smem;
  const uint8_t* Vs = smem + L::V_OFF;
  float* red = reinterpret_cast<float*>(smem + L::RING_OFF);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* kvbar = bars;
  uint64_t* full = bars + 1;

  // cluster of C CTAs along x, one per query head of the group (in turn
  // when G > C); key tile 0 (the most query tiles) first
  const int C = gridDim.x, rank = blockIdx.x;
  const int hk = blockIdx.y % Hkv, b = blockIdx.y / Hkv;
  const int k0 = blockIdx.z * BN;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int c0 = k0 + warp * 16 + g, c1 = c0 + 8;   // this thread's two keys

  // queries that can see a key of this tile: the causal diagonal up to the
  // window's far edge
  const int last_key = min(T, k0 + BN) - 1;
  const int q_end = window > 0 ? min(S, last_key + window) : S;
  const int n_qt = q_end > k0 ? (q_end - k0 + BN - 1) / BN : 0;
  const int n_heads = (G - rank + C - 1) / C;         // this CTA's heads
  const int n_items = n_heads * n_qt;

  const CUtensorMap *qm = &qmap, *om = &omap, *lm = &lmap, *em = &emap;
  auto load_item = [&](int stage, int i) {
    const int h = hk * G + rank + C * (i / n_qt);
    const int qt = k0 + (i % n_qt) * BN;
    uint8_t* dst = smem + L::RING_OFF + stage * L::STAGE;
    mbar_expect_tx(&full[stage], 2 * L::TILE + 512);
    tma_tile<D>(dst, qm, &full[stage], h, qt, b);
    tma_tile<D>(dst + L::TILE, om, &full[stage], h, qt, b);
    const int row = (b * Hq + h) * S + qt;
    tma_load_1d(dst + L::L_OFF, lm, &full[stage], row);
    tma_load_1d(dst + L::E_OFF, em, &full[stage], row);
  };
  if (tid == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
    if (n_items > 0) {
      mbar_expect_tx(kvbar, 2 * L::TILE);
      tma_tile<D>(smem, &kmap, kvbar, hk, k0, b);
      tma_tile<D>(smem + L::V_OFF, &vmap, kvbar, hk, k0, b);
      for (int s = 0; s < STAGES && s < n_items; ++s) load_item(s, s);
    }
  }
  __syncthreads();

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  // P^T and dS^T as A fragments, read by the async dV and dK products
  uint32_t pa[4][4] = {}, da[4][4] = {};

  if (n_items > 0) mbar_wait(kvbar, 0);
  for (int i = 0; i < n_items; ++i) {
    const int stage = i % STAGES;
    const uint32_t parity = (i / STAGES) & 1;
    const int qt = k0 + (i % n_qt) * BN;
    const uint8_t* st = smem + L::RING_OFF + stage * L::STAGE;
    const uint8_t* Qs = st;
    const uint8_t* Os = st + L::TILE;

    // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries), issued behind
    // the previous tile's dV and dK products
    float s[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;
    mbar_wait(&full[stage], parity);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_kmajor(Ks, kk), desc_kmajor(Qs, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_kmajor(Vs, kk), desc_kmajor(Os, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();                 // these products and the last tile's
    fence_regs(s);
    fence_regs(dp);
    fence_regs(dka);
    fence_regs(dva);
    fence_regs(pa);
    fence_regs(da);
    if (i > 0) {                      // the previous stage is free: refill it
      __syncthreads();
      const int done = i - 1;
      if (tid == 0 && done + STAGES < n_items)
        load_item(done % STAGES, done + STAGES);
    }

    // p^T and dS^T; the mask only where the tile crosses the diagonal, the
    // window's edge, S or T
    const float* Ls = reinterpret_cast<const float*>(st + L::L_OFF);
    const float* Es = reinterpret_cast<const float*>(st + L::E_OFF);
    if (cap > 0.f) p_ds_tile<true>(s, dp, Ls, Es, t, dscale, cap);
    else p_ds_tile<false>(s, dp, Ls, Es, t, dscale, cap);
    const bool masked = qt < k0 + BN - 1 || k0 + BN > T || qt + BN > S ||
                        (window > 0 && qt + BN - 1 - k0 >= window);
    if (masked) {
#pragma unroll
      for (int j = 0; j < 32; ++j)
        if (!live_at(j % 4 < 2 ? c0 : c1, qt + 8 * (j / 4) + 2 * t + (j & 1), S,
                     T, window))
          s[j] = dp[j] = 0.f;
    }

    // dV += P^T dO, dK += dS^T Q: the accumulators are the A fragments; the
    // products run while the next tile's S^T and dP^T are issued
    to_a_frags<64>(pa, s);
    to_a_frags<64>(da, dp);
    fence_regs(dva);
    fence_regs(dka);
    fence_regs(pa);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(dva, pa[kk], desc_mnmajor(Os, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(dka, da[kk], desc_mnmajor(Qs, kk));
    wgmma_commit();
    fence_regs(dva);
    fence_regs(dka);
  }
  wgmma_wait_all();
  fence_regs(dva);
  fence_regs(dka);
  __syncthreads();                    // the ring is free: it takes the sums

  // this CTA's partial dK and dV (f32) into its shared memory ...
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t, r = warp * 16 + g;
    *reinterpret_cast<float2*>(red + r * L::PITCH + c) =
        make_float2(dka[4 * j], dka[4 * j + 1]);
    *reinterpret_cast<float2*>(red + (r + 8) * L::PITCH + c) =
        make_float2(dka[4 * j + 2], dka[4 * j + 3]);
    *reinterpret_cast<float2*>(red + (BN + r) * L::PITCH + c) =
        make_float2(dva[4 * j], dva[4 * j + 1]);
    *reinterpret_cast<float2*>(red + (BN + r + 8) * L::PITCH + c) =
        make_float2(dva[4 * j + 2], dva[4 * j + 3]);
  }
  cluster_sync();
  // ... then CTA r sums rows [64r/C, 64(r+1)/C) of dK and dV over the
  // cluster in rank order and writes them
  const int r_lo = rank * BN / C, r_hi = (rank + 1) * BN / C;
  const int64_t kv_stride = static_cast<int64_t>(Hkv) * D;
  const int64_t kv_off = static_cast<int64_t>(b) * T * kv_stride + hk * D;
  const int per = (r_hi - r_lo) * (D / 4);
  for (int idx = tid; idx < 2 * per; idx += blockDim.x) {
    const int which = idx / per, rem = idx % per;     // 0: dK, 1: dV
    const int r = r_lo + rem / (D / 4), c = (rem % (D / 4)) * 4;
    const float* src = red + (which * BN + r) * L::PITCH + c;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int cta = 0; cta < C; ++cta) {
      const float4 x = ld_dsmem_f4(src, cta);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    const int key = k0 + r;
    if (key < T) {
      __nv_bfloat16* dst = (which ? dv : dk) + kv_off + key * kv_stride + c;
      *reinterpret_cast<uint2*>(dst) =
          make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
    }
  }
  cluster_sync();             // no CTA leaves while another reads its sums
}

// ------------------------------------------------------------ f32 sweeps

constexpr int FRW = 2;          // rows (dq) or keys (dk/dv) per warp
constexpr int FB = 4 * FRW;     // per CTA (4 warps)
constexpr int FT = 32;          // keys (dq) or queries (dk/dv) per tile: one per lane

template <int D>
__global__ void __launch_bounds__(128)
flash_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int S, int T, int Hq, int Hkv, int window, float cap,
                    float dscale) {
  __shared__ float Qs[FB][D], Os[FB][D];
  __shared__ float Ks[FT][D + 1], Vs[FT][D + 1];   // +1: lanes hit distinct banks

  const int q0 = blockIdx.x * FB, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t q_stride = static_cast<int64_t>(Hq) * D;
  const int64_t kv_stride = static_cast<int64_t>(Hkv) * D;
  const int64_t q_off = static_cast<int64_t>(b) * S * q_stride + h * D;
  const float* kb = k + static_cast<int64_t>(b) * T * kv_stride + hk * D;
  const float* vb = v + static_cast<int64_t>(b) * T * kv_stride + hk * D;
  const float* lb = lse + (static_cast<int64_t>(b) * Hq + h) * S;
  const float* db = delta + (static_cast<int64_t>(b) * Hq + h) * S;

  for (int i = threadIdx.x; i < FB * D; i += blockDim.x) {
    const int row = q0 + i / D;
    Qs[i / D][i % D] = row < S ? q[q_off + row * q_stride + i % D] : 0.f;
    Os[i / D][i % D] = row < S ? dout[q_off + row * q_stride + i % D] : 0.f;
  }
  float L[FRW], E[FRW], acc[FRW][D / 32];
#pragma unroll
  for (int r = 0; r < FRW; ++r) {
    const int row = q0 + warp * FRW + r;
    L[r] = row < S ? lb[row] : 0.f;
    E[r] = row < S ? db[row] : 0.f;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) acc[r][i] = 0.f;
  }

  const int last_row = min(S, q0 + FB) - 1;
  int k_begin = window > 0 ? max(0, q0 - (window - 1)) : 0;
  k_begin = (k_begin / FT) * FT;
  const int k_end = min(T, last_row + 1);

  for (int kt = k_begin; kt < k_end; kt += FT) {
    __syncthreads();
    for (int i = threadIdx.x; i < FT * D; i += blockDim.x) {
      const int key = kt + i / D, d = i % D;
      Ks[i / D][d] = key < T ? kb[key * kv_stride + d] : 0.f;
      Vs[i / D][d] = key < T ? vb[key * kv_stride + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < FRW; ++r) {
      const int rr = warp * FRW + r, row = q0 + rr, key = kt + lane;
      float qk = 0.f, dov = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        qk = fmaf(Qs[rr][d], Ks[lane][d], qk);
        dov = fmaf(Os[rr][d], Vs[lane][d], dov);
      }
      float p, ds;
      p_ds(qk, dov, L[r], E[r], live_at(key, row, S, T, window), cap, dscale,
           p, ds);
      for (int jj = 0; jj < FT; ++jj) {
        const float dsj = __shfl_sync(0xffffffffu, ds, jj);
#pragma unroll
        for (int i = 0; i < D / 32; ++i)
          acc[r][i] = fmaf(dsj, Ks[jj][lane + 32 * i], acc[r][i]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < FRW; ++r) {
    const int row = q0 + warp * FRW + r;
    if (row >= S) continue;
#pragma unroll
    for (int i = 0; i < D / 32; ++i)
      dq[q_off + row * q_stride + lane + 32 * i] = acc[r][i];
  }
}

template <int D>
__global__ void __launch_bounds__(128)
flash_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int S, int T, int Hq, int Hkv,
                     int window, float cap, float dscale) {
  __shared__ float Qs[FT][D + 1], Os[FT][D + 1];
  __shared__ float Ks[FB][D], Vs[FB][D];
  __shared__ float Ls[FT], Es[FT];

  const int k0 = blockIdx.x * FB, hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t q_stride = static_cast<int64_t>(Hq) * D;
  const int64_t kv_stride = static_cast<int64_t>(Hkv) * D;
  const int64_t kv_off = static_cast<int64_t>(b) * T * kv_stride + hk * D;

  for (int i = threadIdx.x; i < FB * D; i += blockDim.x) {
    const int key = k0 + i / D;
    Ks[i / D][i % D] = key < T ? k[kv_off + key * kv_stride + i % D] : 0.f;
    Vs[i / D][i % D] = key < T ? v[kv_off + key * kv_stride + i % D] : 0.f;
  }
  float dka[FRW][D / 32], dva[FRW][D / 32];
#pragma unroll
  for (int r = 0; r < FRW; ++r)
#pragma unroll
    for (int i = 0; i < D / 32; ++i) dka[r][i] = dva[r][i] = 0.f;

  const int last_key = min(T, k0 + FB) - 1;
  const int q_begin = (k0 / FT) * FT;
  const int q_end = window > 0 ? min(S, last_key + window) : S;

  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const int64_t q_off = static_cast<int64_t>(b) * S * q_stride + h * D;
    const float* lb = lse + (static_cast<int64_t>(b) * Hq + h) * S;
    const float* db = delta + (static_cast<int64_t>(b) * Hq + h) * S;
    for (int qt = q_begin; qt < q_end; qt += FT) {
      __syncthreads();
      for (int i = threadIdx.x; i < FT * D; i += blockDim.x) {
        const int row = qt + i / D, d = i % D;
        Qs[i / D][d] = row < S ? q[q_off + row * q_stride + d] : 0.f;
        Os[i / D][d] = row < S ? dout[q_off + row * q_stride + d] : 0.f;
      }
      for (int i = threadIdx.x; i < FT; i += blockDim.x) {
        Ls[i] = qt + i < S ? lb[qt + i] : 0.f;
        Es[i] = qt + i < S ? db[qt + i] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < FRW; ++r) {
        const int kr = warp * FRW + r, key = k0 + kr, row = qt + lane;
        float qk = 0.f, dov = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) {
          qk = fmaf(Qs[lane][d], Ks[kr][d], qk);
          dov = fmaf(Os[lane][d], Vs[kr][d], dov);
        }
        float p, ds;
        p_ds(qk, dov, Ls[lane], Es[lane], live_at(key, row, S, T, window),
             cap, dscale, p, ds);
        for (int jj = 0; jj < FT; ++jj) {
          const float pj = __shfl_sync(0xffffffffu, p, jj);
          const float dsj = __shfl_sync(0xffffffffu, ds, jj);
#pragma unroll
          for (int i = 0; i < D / 32; ++i) {
            dva[r][i] = fmaf(pj, Os[jj][lane + 32 * i], dva[r][i]);
            dka[r][i] = fmaf(dsj, Qs[jj][lane + 32 * i], dka[r][i]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < FRW; ++r) {
    const int key = k0 + warp * FRW + r;
    if (key >= T) continue;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      dk[kv_off + key * kv_stride + lane + 32 * i] = dka[r][i];
      dv[kv_off + key * kv_stride + lane + 32 * i] = dva[r][i];
    }
  }
}

// ------------------------------------------------------------ launchers

// Each returns cudaGetLastError() after its launch (0 = launched), or
// cudaErrorInvalidValue for a head_dim the kernels do not take.
extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse,
                                   const float* delta, void* dq, int B, int S,
                                   int T, int Hq, int Hkv, int D, int window,
                                   float cap, float dscale, int is_bf16,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using bf = __nv_bfloat16;
    const dim3 grid((S + BM - 1) / BM, Hq, B);
    auto qq = static_cast<const bf*>(q), kk = static_cast<const bf*>(k),
         vv = static_cast<const bf*>(v), oo = static_cast<const bf*>(dout);
    auto out = static_cast<bf*>(dq);
    if (D == 64)
      flash_dq_bf16_kernel<64><<<grid, 128, 0, st>>>(
          qq, kk, vv, oo, lse, delta, out, S, T, Hq, Hkv, window, cap, dscale);
    else if (D == 128)
      flash_dq_bf16_kernel<128><<<grid, 128, 0, st>>>(
          qq, kk, vv, oo, lse, delta, out, S, T, Hq, Hkv, window, cap, dscale);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    const dim3 grid((S + FB - 1) / FB, Hq, B);
    auto qq = static_cast<const float*>(q), kk = static_cast<const float*>(k),
         vv = static_cast<const float*>(v), oo = static_cast<const float*>(dout);
    auto out = static_cast<float*>(dq);
    if (D == 64)
      flash_dq_f32_kernel<64><<<grid, 128, 0, st>>>(
          qq, kk, vv, oo, lse, delta, out, S, T, Hq, Hkv, window, cap, dscale);
    else if (D == 128)
      flash_dq_f32_kernel<128><<<grid, 128, 0, st>>>(
          qq, kk, vv, oo, lse, delta, out, S, T, Hq, Hkv, window, cap, dscale);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
static int launch_dkv_bf16(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, void* dk, void* dv, int B,
                           int S, int T, int Hq, int Hkv, int window, float cap,
                           float dscale, cudaStream_t st) {
  CUtensorMap qmap, omap, kmap, vmap, lmap, emap;
  const int64_t rows = static_cast<int64_t>(B) * Hq * S;
  int rc = hopper::map_bf16_bshd(&qmap, q, B, S, Hq, D);
  if (rc == 0) rc = hopper::map_bf16_bshd(&omap, dout, B, S, Hq, D);
  if (rc == 0) rc = hopper::map_bf16_bshd(&kmap, k, B, T, Hkv, D);
  if (rc == 0) rc = hopper::map_bf16_bshd(&vmap, v, B, T, Hkv, D);
  if (rc == 0) rc = hopper::map_f32_flat(&lmap, lse, rows);
  if (rc == 0) rc = hopper::map_f32_flat(&emap, delta, rows);
  if (rc != 0) return rc;
  constexpr int bytes = DkvSmem<D>::BYTES;
  static bool configured = false;          // once per process and head_dim
  if (!configured) {
    rc = static_cast<int>(cudaFuncSetAttribute(
        flash_dkv_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes));
    if (rc != 0) return rc;
    configured = true;
  }
  const int C = min(Hq / Hkv, 8);                   // CTAs per cluster
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, Hkv * B, (T + BN - 1) / BN);
  cfg.blockDim = dim3(128, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, flash_dkv_bf16_kernel<D>, qmap, omap, kmap, vmap, lmap, emap,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S, T,
      Hq, Hkv, window, cap, dscale));
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                    const void* dout, const float* lse,
                                    const float* delta, void* dk, void* dv,
                                    int B, int S, int T, int Hq, int Hkv, int D,
                                    int window, float cap, float dscale,
                                    int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D == 64)
      return launch_dkv_bf16<64>(q, k, v, dout, lse, delta, dk, dv, B, S, T,
                                 Hq, Hkv, window, cap, dscale, st);
    if (D == 128)
      return launch_dkv_bf16<128>(q, k, v, dout, lse, delta, dk, dv, B, S, T,
                                  Hq, Hkv, window, cap, dscale, st);
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    const dim3 grid((T + FB - 1) / FB, Hkv, B);
    auto qq = static_cast<const float*>(q), kk = static_cast<const float*>(k),
         vv = static_cast<const float*>(v), oo = static_cast<const float*>(dout);
    auto gk = static_cast<float*>(dk), gv = static_cast<float*>(dv);
    if (D == 64)
      flash_dkv_f32_kernel<64><<<grid, 128, 0, st>>>(
          qq, kk, vv, oo, lse, delta, gk, gv, S, T, Hq, Hkv, window, cap,
          dscale);
    else if (D == 128)
      flash_dkv_f32_kernel<128><<<grid, 128, 0, st>>>(
          qq, kk, vv, oo, lse, delta, gk, gv, S, T, Hq, Hkv, window, cap,
          dscale);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
