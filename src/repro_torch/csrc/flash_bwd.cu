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
// gets exactly zero gradients. Every kernel is instantiated at head_dim 64,
// 128 and 192; the wrapper pads any other head_dim up to the next of those
// (kernels/head_dim.py), with the true head_dim's dscale.
//
// What bounds them on this card: at the training shape (B4 S512 Hq32 Hkv8
// D64 bf16, causal) the dq sweep does 3 and the dk/dv sweep 4 products of
// the causal half, ~6.4 and ~8.6 GFLOP, against ~25 MB of operands: both sit
// above the ~295 flop/byte ridge, so the tensor cores bound them (~6.5 and
// ~8.7 us). What holds a sweep from that is the chain of one CTA: its tiles
// in series, each with its loads, products and elementwise p/dS pass.
//
// Both bf16 sweeps are built from the blocks of hopper.cuh: TMA loads from
// 4-D maps over (B, rows, heads, D) in the 128-byte swizzle wgmma reads,
// completion on mbarriers, one elected thread issuing; 1-D maps over lse
// and delta; wgmma with both operands in shared memory for the two score
// products, and with the A operand in registers (the accumulators of the
// score products re-packed as bf16 fragments) for the gradient products,
// which read a tile already in shared memory as an MN-major operand: one
// load, two roles. p and dS run in the exp2 domain, the mask only on tiles
// that cross the causal diagonal, the window's edge, S or T.
//
// dq, bf16 (redesigned for Hopper):
//  - one CTA per (64 query rows, query head, batch), one warpgroup; the
//    heaviest query tiles (the most key tiles) are launched first;
//  - Q, dO, lse and delta of the tile are loaded once by TMA; K and V tiles
//    of 64 keys stream through a 2-stage ring, the key loop from the
//    window's band start to the causal diagonal;
//  - S = Q K^T and dP = dO V^T (SS), p and dS in registers, then dQ += dS K
//    (RS: dS packed from the accumulators, K read MN-major from the tile
//    that fed S); dQ += dS K is not waited for: the next tile's S and dP are
//    issued behind it and one wait covers all three;
//  - at head_dim 192 dQ's accumulator is 96 registers a thread, S and dP
//    32 each.
// dk/dv, bf16:
//  - the G query heads of a group come off the serial chain: a thread-block
//    cluster of C = min(G, 8) CTAs per (64 keys, kv head, batch), CTA r
//    taking heads r, r + C, ...; the C partial dK/dV are summed over
//    distributed shared memory in fixed rank order (no atomics: bitwise
//    reproducible), one launch; key tile 0 (the most query tiles) first;
//  - K and V are loaded once per CTA; Q, dO, lse and delta tiles of 64
//    queries stream through a 3-stage ring; after the loop the ring holds
//    the partial sums;
//  - S^T = K Q^T and dP^T = V dO^T (SS), then dV += P^T dO and dK += dS^T Q
//    (RS), not waited for under the next tile's S^T and dP^T;
//  - head_dim 64 and 128: one warpgroup owns both dK and dV. Head_dim 192:
//    dK and dV would take 2 x 96 accumulator registers a thread before S^T
//    and dP^T, so two consumer warpgroups split them: warpgroup 0 owns dV
//    (S^T -> P^T, dV += P^T dO), warpgroup 1 owns dK (S^T and dP^T -> dS^T,
//    dK += dS^T Q); S^T is computed by both, one product of five extra.
// f32: plain FMA kernels, one lane per key (dq) or per query (dk/dv), so the
//  f32 checks hold 2e-5.
// Rows >= S and keys >= T are masked in the kernels and TMA zero-fills
// their tiles (0 x NaN is NaN inside an MMA): no padded copies.
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

constexpr int BM = 64;   // query rows per dq CTA (one warpgroup)
constexpr int BN = 64;   // keys per tile / per dk-dv CTA

// ------------------------------------------------------- bf16 dq sweep

template <int D>
struct DqSmem {
  static constexpr int STAGES = 2;
  static constexpr int TILE = BM * D * 2;             // bytes of a 64-row tile
  static constexpr int DO_OFF = TILE;                 // Q first, then dO
  static constexpr int L_OFF = 2 * TILE, E_OFF = L_OFF + 256;   // lse, delta
  static constexpr int RING_OFF = 2 * TILE + 1024;    // K, V per stage
  static constexpr int STAGE = 2 * TILE;
  static constexpr int BAR_OFF = RING_OFF + STAGES * STAGE;
  // + the barriers (Q, one per stage), + slack for 1024-byte alignment
  static constexpr int BYTES = BAR_OFF + 8 * (1 + STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(128)
flash_dq_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap omap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap lmap,
                     const __grid_constant__ CUtensorMap emap,
                     __nv_bfloat16* __restrict__ dq, int S, int T, int Hq,
                     int Hkv, int window, float cap, float dscale) {
  using namespace hopper;
  using L = DqSmem<D>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint8_t* Qs = smem;
  const uint8_t* Os = smem + L::DO_OFF;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;

  // heaviest query tiles first: z = 0 is the last tile
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;       // this thread's rows
  const int r0 = q0 + lr0, r1 = q0 + lr1;

  const int last_row = min(S, q0 + BM) - 1;
  int k_begin = window > 0 ? max(0, q0 - (window - 1)) : 0;
  k_begin = (k_begin / BN) * BN;
  const int k_end = min(T, last_row + 1);              // causal diagonal
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;

  const int64_t q_stride = static_cast<int64_t>(Hq) * D;
  __nv_bfloat16* db = dq + static_cast<int64_t>(b) * S * q_stride + h * D;

  if (n_tiles == 0) {                  // no live key: every row fully masked
    for (int i = tid; i < BM * D / 8; i += blockDim.x) {
      const int row = q0 + i / (D / 8);
      if (row < S)
        *reinterpret_cast<uint4*>(db + row * q_stride + (i % (D / 8)) * 8) =
            make_uint4(0, 0, 0, 0);
    }
    return;
  }

  const CUtensorMap *km = &kmap, *vm = &vmap;
  auto load_kv = [&](int stage, int kt) {
    uint8_t* dst = smem + L::RING_OFF + stage * L::STAGE;
    mbar_expect_tx(&full[stage], 2 * L::TILE);
    tma_tile<D>(dst, km, &full[stage], hk, kt, b);
    tma_tile<D>(dst + L::TILE, vm, &full[stage], hk, kt, b);
  };
  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
    mbar_expect_tx(qbar, 2 * L::TILE + 512);
    tma_tile<D>(smem, &qmap, qbar, h, q0, b);
    tma_tile<D>(smem + L::DO_OFF, &omap, qbar, h, q0, b);
    const int row = (b * Hq + h) * S + q0;
    tma_load_1d(smem + L::L_OFF, &lmap, qbar, row);
    tma_load_1d(smem + L::E_OFF, &emap, qbar, row);
    for (int s = 0; s < STAGES && s < n_tiles; ++s)
      load_kv(s, k_begin + s * BN);
  }
  __syncthreads();

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  uint32_t da[4][4] = {};           // dS as A fragments, read by the async dS K

  mbar_wait(qbar, 0);
  // the rows' lse_safe (NEG_INF swapped for 0) in log2 units, and delta;
  // rows >= S read a neighbour's values or zeros and are masked below
  const float* Ls = reinterpret_cast<const float*>(smem + L::L_OFF);
  const float* Es = reinterpret_cast<const float*>(smem + L::E_OFF);
  const float l2[2] = {(Ls[lr0] > 0.5f * NEG_INF ? Ls[lr0] : 0.f) * LOG2E,
                       (Ls[lr1] > 0.5f * NEG_INF ? Ls[lr1] : 0.f) * LOG2E};
  const float de[2] = {Es[lr0], Es[lr1]};

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % STAGES;
    const uint32_t parity = (it / STAGES) & 1;
    const int kt = k_begin + it * BN;
    const uint8_t* Ks = smem + L::RING_OFF + stage * L::STAGE;
    const uint8_t* Vs = Ks + L::TILE;

    // S = Q K^T and dP = dO V^T (64 rows x 64 keys), issued behind the
    // previous tile's dQ += dS K
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    mbar_wait(&full[stage], parity);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_kmajor(Qs, kk), desc_kmajor(Ks, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_kmajor(Os, kk), desc_kmajor(Vs, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();                 // these products and the last tile's
    fence_regs(s);
    fence_regs(dp);
    fence_regs(acc);
    fence_regs(da);
    if (it > 0) {                     // the previous stage is free: refill it
      __syncthreads();
      const int done = it - 1;
      if (tid == 0 && done + STAGES < n_tiles)
        load_kv(done % STAGES, k_begin + (done + STAGES) * BN);
    }

    // p and dS in place of dp; entry 4j + e is row lr0 (e < 2) or lr1, key
    // kt + 8j + 2t + (e & 1)
    if (cap > 0.f) {
      const float inv = dscale / cap;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float th = tanhf(s[i] * inv);            // capped s = cap * th
        const float p = exp2f(fmaf(cap * th, LOG2E, -l2[(i & 3) >> 1]));
        dp[i] = p * (dp[i] - de[(i & 3) >> 1]) * (1.f - th * th) * dscale;
      }
    } else {
      const float sc = dscale * LOG2E;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float p = exp2f(fmaf(s[i], sc, -l2[(i & 3) >> 1]));
        dp[i] = p * fmaf(dp[i], dscale, -de[(i & 3) >> 1] * dscale);
      }
    }
    const bool masked = kt + BN - 1 > q0 || kt + BN > T || q0 + BM > S ||
                        (window > 0 && q0 + BM - 1 - kt >= window);
    if (masked) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (!live_at(kt + 8 * (i / 4) + 2 * t + (i & 1),
                     (i & 3) < 2 ? r0 : r1, S, T, window))
          dp[i] = 0.f;
    }

    // dQ += dS K: dS's accumulators are the A fragments, K is read
    // MN-major from the tile that fed S; the product runs while the next
    // tile's S and dP are issued
    to_a_frags<64>(da, dp);
    fence_regs(acc);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(acc, da[kk], desc_mnmajor(Ks, kk));
    wgmma_commit();
    fence_regs(acc);
  }
  wgmma_wait_all();
  fence_regs(acc);

#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(db + r0 * q_stride + c) =
          pack_bf16(acc[4 * j], acc[4 * j + 1]);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(db + r1 * q_stride + c) =
          pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// ---------------------------------------------------- bf16 dk/dv sweep

template <int D>
struct DkvSmem {
  // head_dim 192 splits dK and dV over two warpgroups (see the header)
  static constexpr int WARPGROUPS = D == 192 ? 2 : 1;
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

// p^T and (DS) dS^T of a (64 keys x 64 queries) tile in place, from the raw
// products s = K Q^T and dp = V dO^T and the queries' lse and delta
template <bool CAP, bool DS>
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
        if (DS) dp[i] = p * (dp[i] - delta) * (1.f - th * th) * dscale;
        s[i] = p;
      } else {
        const float p = exp2f(fmaf(s[i], dscale * LOG2E, -l2[e & 1]));
        if (DS) dp[i] = p * fmaf(dp[i], dscale, -delta * dscale);
        s[i] = p;
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(128 * DkvSmem<D>::WARPGROUPS,
                                  D == 64 ? 3 : 1)
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
  // SPLIT: warpgroup 0 owns dV, warpgroup 1 owns dK; else one owns both
  constexpr bool SPLIT = L::WARPGROUPS == 2;
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
  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int c0 = k0 + warp * 16 + g, c1 = c0 + 8;   // this thread's two keys
  const bool owns_dv = !SPLIT || wg == 0, owns_dk = !SPLIT || wg == 1;

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

  // dva: dV (or, SPLIT, this warpgroup's one sum); dka: dK (unused, SPLIT)
  float dva[D / 2], dka[SPLIT ? 1 : D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dva[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (SPLIT ? 1 : D / 2); ++i) dka[i] = 0.f;
  // P^T and dS^T (SPLIT: this warpgroup's one of them) as A fragments, read
  // by the async dV and dK products
  uint32_t pa[4][4] = {}, da[SPLIT ? 1 : 4][4] = {};

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
    if (owns_dk) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dp, desc_kmajor(Vs, kk), desc_kmajor(Os, kk), kk > 0);
    }
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
    if (owns_dk) {
      if (cap > 0.f) p_ds_tile<true, true>(s, dp, Ls, Es, t, dscale, cap);
      else p_ds_tile<false, true>(s, dp, Ls, Es, t, dscale, cap);
    } else {
      if (cap > 0.f) p_ds_tile<true, false>(s, dp, Ls, Es, t, dscale, cap);
      else p_ds_tile<false, false>(s, dp, Ls, Es, t, dscale, cap);
    }
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
    if constexpr (SPLIT) {
      if (wg == 0) to_a_frags<64>(pa, s);
      else to_a_frags<64>(pa, dp);
      const uint8_t* Bs = wg == 0 ? Os : Qs;
      fence_regs(dva);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D>(dva, pa[kk], desc_mnmajor(Bs, kk));
    } else {
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
    }
    wgmma_commit();
    fence_regs(dva);
    fence_regs(dka);
  }
  wgmma_wait_all();
  fence_regs(dva);
  fence_regs(dka);
  __syncthreads();                    // the ring is free: it takes the sums

  // this CTA's partial dK and dV (f32) into its shared memory: rows 0..63
  // dK, 64..127 dV ...
  const int r = warp * 16 + g;
  auto park = [&](const float (&a)[D / 2], int row0) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * t;
      *reinterpret_cast<float2*>(red + (row0 + r) * L::PITCH + c) =
          make_float2(a[4 * j], a[4 * j + 1]);
      *reinterpret_cast<float2*>(red + (row0 + r + 8) * L::PITCH + c) =
          make_float2(a[4 * j + 2], a[4 * j + 3]);
    }
  };
  if constexpr (SPLIT) {
    park(dva, wg == 0 ? BN : 0);
  } else {
    park(dka, 0);
    park(dva, BN);
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
    const int rr = r_lo + rem / (D / 4), c = (rem % (D / 4)) * 4;
    const float* src = red + (which * BN + rr) * L::PITCH + c;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int cta = 0; cta < C; ++cta) {
      const float4 x = ld_dsmem_f4(src, cta);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    const int key = k0 + rr;
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

// dynamic shared memory of the f32 sweeps (+1 columns: lanes read distinct
// banks): dq holds Q and dO rows and K and V tiles, dk/dv Q and dO tiles,
// K and V rows, lse and delta; 61 KB at head_dim 192
template <int D>
constexpr int f32_smem_bytes() {
  return 4 * (2 * FB * D + 2 * FT * (D + 1) + 2 * FT);
}

// raise a kernel's dynamic shared memory limit to `bytes`, once per process
template <typename Kernel>
static int allow_smem(Kernel kernel, int bytes, bool& configured) {
  if (configured) return 0;
  const int rc = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  configured = rc == 0;
  return rc;
}

template <int D>
__global__ void __launch_bounds__(128)
flash_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int S, int T, int Hq, int Hkv, int window, float cap,
                    float dscale) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  auto Qs = reinterpret_cast<float (*)[D]>(smem_raw);
  auto Os = Qs + FB;
  auto Ks = reinterpret_cast<float (*)[D + 1]>(Os + FB);
  auto Vs = Ks + FT;

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
  extern __shared__ __align__(16) uint8_t smem_raw[];
  auto Qs = reinterpret_cast<float (*)[D + 1]>(smem_raw);
  auto Os = Qs + FT;
  auto Ks = reinterpret_cast<float (*)[D]>(Os + FT);
  auto Vs = Ks + FB;
  float* Ls = reinterpret_cast<float*>(Vs + FB);
  float* Es = Ls + FT;

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

template <int D>
static int launch_dq_bf16(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, void* dq, int B, int S, int T,
                          int Hq, int Hkv, int window, float cap, float dscale,
                          cudaStream_t st) {
  CUtensorMap qmap, omap, kmap, vmap, lmap, emap;
  const int64_t rows = static_cast<int64_t>(B) * Hq * S;
  int rc = hopper::map_bf16_bshd(&qmap, q, B, S, Hq, D);
  if (rc == 0) rc = hopper::map_bf16_bshd(&omap, dout, B, S, Hq, D);
  if (rc == 0) rc = hopper::map_bf16_bshd(&kmap, k, B, T, Hkv, D);
  if (rc == 0) rc = hopper::map_bf16_bshd(&vmap, v, B, T, Hkv, D);
  if (rc == 0) rc = hopper::map_f32_flat(&lmap, lse, rows);
  if (rc == 0) rc = hopper::map_f32_flat(&emap, delta, rows);
  if (rc != 0) return rc;
  constexpr int bytes = DqSmem<D>::BYTES;
  static bool configured = false;          // once per process and head_dim
  rc = allow_smem(flash_dq_bf16_kernel<D>, bytes, configured);
  if (rc != 0) return rc;
  const dim3 grid(Hq, B, (S + BM - 1) / BM);
  flash_dq_bf16_kernel<D><<<grid, 128, bytes, st>>>(
      qmap, omap, kmap, vmap, lmap, emap, static_cast<__nv_bfloat16*>(dq), S,
      T, Hq, Hkv, window, cap, dscale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
static int launch_dq_f32(const float* q, const float* k, const float* v,
                         const float* dout, const float* lse,
                         const float* delta, float* dq, int B, int S, int T,
                         int Hq, int Hkv, int window, float cap, float dscale,
                         cudaStream_t st) {
  constexpr int bytes = f32_smem_bytes<D>();
  static bool configured = false;
  const int rc = allow_smem(flash_dq_f32_kernel<D>, bytes, configured);
  if (rc != 0) return rc;
  const dim3 grid((S + FB - 1) / FB, Hq, B);
  flash_dq_f32_kernel<D><<<grid, 128, bytes, st>>>(
      q, k, v, dout, lse, delta, dq, S, T, Hq, Hkv, window, cap, dscale);
  return static_cast<int>(cudaGetLastError());
}

// Each returns cudaGetLastError() after its launch (0 = launched), or
// cudaErrorInvalidValue for a head_dim the kernels do not take (64, 128,
// 192) or tensors TMA cannot map.
extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse,
                                   const float* delta, void* dq, int B, int S,
                                   int T, int Hq, int Hkv, int D, int window,
                                   float cap, float dscale, int is_bf16,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
#define DQ_BF16(DD)                                                          \
  if (D == DD)                                                               \
    return launch_dq_bf16<DD>(q, k, v, dout, lse, delta, dq, B, S, T, Hq,   \
                              Hkv, window, cap, dscale, st);
    DQ_BF16(64) DQ_BF16(128) DQ_BF16(192)
#undef DQ_BF16
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto qq = static_cast<const float*>(q), kk = static_cast<const float*>(k),
       vv = static_cast<const float*>(v), oo = static_cast<const float*>(dout);
  auto out = static_cast<float*>(dq);
#define DQ_F32(DD)                                                           \
  if (D == DD)                                                               \
    return launch_dq_f32<DD>(qq, kk, vv, oo, lse, delta, out, B, S, T, Hq,  \
                             Hkv, window, cap, dscale, st);
  DQ_F32(64) DQ_F32(128) DQ_F32(192)
#undef DQ_F32
  return static_cast<int>(cudaErrorInvalidValue);
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
  rc = allow_smem(flash_dkv_bf16_kernel<D>, bytes, configured);
  if (rc != 0) return rc;
  const int C = min(Hq / Hkv, 8);                   // CTAs per cluster
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, Hkv * B, (T + BN - 1) / BN);
  cfg.blockDim = dim3(128 * DkvSmem<D>::WARPGROUPS, 1, 1);
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

template <int D>
static int launch_dkv_f32(const float* q, const float* k, const float* v,
                          const float* dout, const float* lse,
                          const float* delta, float* dk, float* dv, int B,
                          int S, int T, int Hq, int Hkv, int window, float cap,
                          float dscale, cudaStream_t st) {
  constexpr int bytes = f32_smem_bytes<D>();
  static bool configured = false;
  const int rc = allow_smem(flash_dkv_f32_kernel<D>, bytes, configured);
  if (rc != 0) return rc;
  const dim3 grid((T + FB - 1) / FB, Hkv, B);
  flash_dkv_f32_kernel<D><<<grid, 128, bytes, st>>>(
      q, k, v, dout, lse, delta, dk, dv, S, T, Hq, Hkv, window, cap, dscale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                    const void* dout, const float* lse,
                                    const float* delta, void* dk, void* dv,
                                    int B, int S, int T, int Hq, int Hkv, int D,
                                    int window, float cap, float dscale,
                                    int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
#define DKV_BF16(DD)                                                         \
  if (D == DD)                                                               \
    return launch_dkv_bf16<DD>(q, k, v, dout, lse, delta, dk, dv, B, S, T,  \
                               Hq, Hkv, window, cap, dscale, st);
    DKV_BF16(64) DKV_BF16(128) DKV_BF16(192)
#undef DKV_BF16
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto qq = static_cast<const float*>(q), kk = static_cast<const float*>(k),
       vv = static_cast<const float*>(v), oo = static_cast<const float*>(dout);
  auto gk = static_cast<float*>(dk), gv = static_cast<float*>(dv);
#define DKV_F32(DD)                                                          \
  if (D == DD)                                                               \
    return launch_dkv_f32<DD>(qq, kk, vv, oo, lse, delta, gk, gv, B, S, T,  \
                              Hq, Hkv, window, cap, dscale, st);
  DKV_F32(64) DKV_F32(128) DKV_F32(192)
#undef DKV_F32
  return static_cast<int>(cudaErrorInvalidValue);
}
