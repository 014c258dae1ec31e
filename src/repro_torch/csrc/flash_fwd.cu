// Causal GQA flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/flash_attention.py, _flash_kernel (launched by
// _flash_forward). Same contract: q (B,S,Hq,D), k/v (B,T,Hkv,D), query row i
// and key j at positions i and j, causal, optional sliding window, tanh logit
// softcap taken before masking, f32 online softmax, p re-masked to 0 on masked
// entries, O = acc / l where l > 0 and 0 elsewhere, lse = m + log(l) where
// l > 0 and NEG_INF (-1e30) elsewhere. Outputs O (B,S,Hq,D) in q's dtype and
// lse (B,Hq,S) f32.
//
// What bounds it on this card: at the serving prefill shape (B1, S = T =
// 512, Hq 32, Hkv 8, D 64, bf16) the causal half of QK^T and PV is ~1.1
// GFLOP against ~4.7 MB of q/k/v/O/lse, 1.1 us on the tensor cores and 1.6
// us of memory traffic: a few microseconds of work spread over 256 CTAs of
// at most 8 key tiles each. What sets the time is the chain of one CTA: the
// heaviest query tile walks 8 key tiles in series, and each tile's loads,
// two products and softmax follow one another unless they are overlapped.
//
// Design (bf16):
//  - one CTA per (64-row query tile, query head, batch): one warpgroup of
//    128 threads issuing wgmma; the grid runs the heaviest query tiles (the
//    most key tiles) first, so the long chains start at once;
//  - Q is loaded once and K/V tiles of 64 keys stream through a ring of
//    STAGES stages in shared memory, filled by TMA from 4-D tensor maps over
//    (B, T, Hkv, D) in the 128-byte swizzle wgmma reads; one elected thread
//    issues the loads, completion goes to one mbarrier per tile and operand,
//    keys past T arrive as zeros, and the next tiles are in flight while one
//    is multiplied. At head_dim 64 two stages (40 KB a CTA) let four CTAs
//    share an SM, whose softmax and products interleave;
//  - S = Q K^T is wgmma m64n64k16 with both operands in shared memory; O +=
//    P V is m64nDk16 with P taken from S's accumulators in registers and V
//    read as an MN-major (transposed) operand: no shared-memory trip for P.
//    P V is not waited for: the next tile's S is issued behind it, and one
//    wait covers both;
//  - the softmax runs in the exp2 domain with log2(e) folded into the scale,
//    and the mask is evaluated only on tiles that cross the causal diagonal,
//    the window's edge or T.
//  f32 (the test path of the 2e-5 checks): a plain FMA kernel, one warp per
//  4 query rows, one lane per key for QK^T and per 1/32 of head_dim for PV.
//  Rows >= S and keys >= T are masked in the kernels: no padded copies.
//  Both are instantiated at head_dim 64, 128 and 192; the wrapper pads any
//  other head_dim up to the next of those (kernels/head_dim.py).
#include "hopper.cuh"

#define NEG_INF (-1e30f)

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__device__ __forceinline__ bool key_live(int key, int row, int T, int window) {
  return key < T && key <= row && (window <= 0 || row - key < window);
}

__device__ __forceinline__ float capped(float x, float cap) {
  return cap > 0.f ? cap * tanhf(x / cap) : x;
}

// raw q.k products -> scaled (and tanh-capped) scores in log2 units
template <bool CAP>
__device__ __forceinline__ void log2_scores(float (&s)[32], float dscale,
                                            float cap) {
  if (CAP) {
    const float inv = dscale / cap, c2 = cap * hopper::LOG2E;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = c2 * tanhf(s[i] * inv);
  } else {
    const float sc = dscale * hopper::LOG2E;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= sc;
  }
}

// ------------------------------------------------------------------ bf16 path

constexpr int BM = 64;   // query rows per CTA (one warpgroup)
constexpr int BN = 64;   // keys per tile

template <int D>
struct FwdSmem {
  // D 64: 2 stages keep a CTA at 40 KB, so 4 fit an SM (the register
  // limit) where 3 stages fit 3; D 128 fits 2 CTAs either way; D 192
  // (O's accumulator alone 96 registers) fits one, at 120 KB with 2
  static constexpr int STAGES = D == 128 ? 3 : 2;
  static constexpr int TILE = BN * D * 2;            // bytes of a 64-row tile
  static constexpr int K_OFF = TILE;                 // Q first
  static constexpr int V_OFF = K_OFF + STAGES * TILE;
  static constexpr int BAR_OFF = V_OFF + STAGES * TILE;
  // + the barriers (Q, K and V per stage), + slack for 1024-byte alignment
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(128)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                      int S, int T, int Hq, int Hkv, int window, float cap,
                      float dscale) {
  using namespace hopper;
  using L = FwdSmem<D>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Qs = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* qbar = bars;
  uint64_t* kfull = bars + 1;
  uint64_t* vfull = bars + 1 + STAGES;

  // heaviest query tiles first: z = 0 is the last tile
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;   // this thread's two rows

  const int last_row = min(S, q0 + BM) - 1;
  int k_begin = window > 0 ? max(0, q0 - (window - 1)) : 0;
  k_begin = (k_begin / BN) * BN;
  const int k_end = min(T, last_row + 1);            // causal diagonal
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;

  const int64_t q_stride = static_cast<int64_t>(Hq) * D;
  __nv_bfloat16* ob = out + static_cast<int64_t>(b) * S * q_stride + h * D;
  float* lb = lse + (static_cast<int64_t>(b) * Hq + h) * S;

  if (n_tiles == 0) {                  // no live key: every row fully masked
    for (int i = tid; i < BM * D / 8; i += blockDim.x) {
      const int row = q0 + i / (D / 8);
      if (row < S)
        *reinterpret_cast<uint4*>(ob + row * q_stride + (i % (D / 8)) * 8) =
            make_uint4(0, 0, 0, 0);
    }
    if (tid < BM && q0 + tid < S) lb[q0 + tid] = NEG_INF;
    return;
  }

  const CUtensorMap *km = &kmap, *vm = &vmap;
  auto load_kv = [&](int stage, int kt) {
    mbar_expect_tx(&kfull[stage], L::TILE);
    tma_tile<D>(smem + L::K_OFF + stage * L::TILE, km, &kfull[stage], hk,
                kt, b);
    mbar_expect_tx(&vfull[stage], L::TILE);
    tma_tile<D>(smem + L::V_OFF + stage * L::TILE, vm, &vfull[stage], hk,
                kt, b);
  };
  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
    }
    fence_barrier_init();
    mbar_expect_tx(qbar, L::TILE);
    tma_tile<D>(Qs, &qmap, qbar, h, q0, b);
    for (int s = 0; s < STAGES && s < n_tiles; ++s)
      load_kv(s, k_begin + s * BN);
  }
  __syncthreads();

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;   // m in log2 units
  uint32_t pa[4][4] = {};           // P as A fragments, read by the async P V

  mbar_wait(qbar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % STAGES;
    const uint32_t parity = (it / STAGES) & 1;
    const int kt = k_begin + it * BN;
    const uint8_t* Ks = smem + L::K_OFF + stage * L::TILE;
    const uint8_t* Vs = smem + L::V_OFF + stage * L::TILE;

    // S = Q K^T (64 rows x 64 keys), issued behind the previous tile's P V
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    mbar_wait(&kfull[stage], parity);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_kmajor(Qs, kk), desc_kmajor(Ks, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();                 // this tile's S and the last tile's P V
    fence_regs(s);
    fence_regs(o);
    fence_regs(pa);
    if (it > 0) {                     // the previous stage is free: refill it
      __syncthreads();
      const int done = it - 1;
      if (tid == 0 && done + STAGES < n_tiles)
        load_kv(done % STAGES, k_begin + (done + STAGES) * BN);
    }

    // scores in log2 units; the mask only where the tile crosses the
    // diagonal, the window's edge or T
    if (cap > 0.f) log2_scores<true>(s, dscale, cap);
    else log2_scores<false>(s, dscale, cap);
    const bool masked = kt + BN - 1 > q0 || kt + BN > T ||
                        (window > 0 && q0 + BM - 1 - kt >= window);
    if (masked) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (!key_live(kt + 8 * (i / 4) + 2 * t + (i & 1), i % 4 < 2 ? r0 : r1,
                      T, window))
          s[i] = NEG_INF;
    }
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * j + e] = exp2f(s[4 * j + e] - (e < 2 ? mn0 : mn1));
    }
    // p re-masked to 0 (a fully-masked row has s - m == 0 and would claim 1)
    if (masked) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (!key_live(kt + 8 * (i / 4) + 2 * t + (i & 1), i % 4 < 2 ? r0 : r1,
                      T, window))
          s[i] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      l0 += s[4 * j] + s[4 * j + 1];
      l1 += s[4 * j + 2] + s[4 * j + 3];
    }

    // O += P V: S's accumulators are the A fragments of P; the product runs
    // while the next tile's S is issued
    to_a_frags<64>(pa, s);
    mbar_wait(&vfull[stage], parity);
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(o, pa[kk], desc_mnmajor(Vs, kk));
    wgmma_commit();
    fence_regs(o);
  }
  wgmma_wait_all();
  fence_regs(o);

  // finalize: l was summed per thread; reduce over the quad sharing a row
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(ob + r0 * q_stride + c) =
          pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(ob + r1 * q_stride + c) =
          pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
  if (t == 0) {
    if (r0 < S) lb[r0] = l0 > 0.f ? (m0 + log2f(l0)) * LN2 : NEG_INF;
    if (r1 < S) lb[r1] = l1 > 0.f ? (m1 + log2f(l1)) * LN2 : NEG_INF;
  }
}

// ------------------------------------------------------------------- f32 path

constexpr int FBM = 16;  // query rows per CTA (4 warps x 4 rows)
constexpr int FBN = 32;  // keys per tile (one per lane)

// dynamic shared memory of the f32 kernel: Q rows, K (+1: lanes read
// distinct banks) and V tiles; 61 KB at head_dim 192
template <int D>
constexpr int f32_smem_bytes() {
  return 4 * (FBM * D + FBN * (D + 1) + FBN * D);
}

template <int D>
__global__ void __launch_bounds__(128)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int S, int T, int Hq, int Hkv,
                     int window, float cap, float dscale) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  auto Qs = reinterpret_cast<float (*)[D]>(smem_raw);
  auto Ks = reinterpret_cast<float (*)[D + 1]>(Qs + FBM);
  auto Vs = reinterpret_cast<float (*)[D]>(Ks + FBN);

  const int q0 = blockIdx.x * FBM, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t q_stride = static_cast<int64_t>(Hq) * D;
  const int64_t kv_stride = static_cast<int64_t>(Hkv) * D;
  const float* qb = q + static_cast<int64_t>(b) * S * q_stride + h * D;
  const float* kb = k + static_cast<int64_t>(b) * T * kv_stride + hk * D;
  const float* vb = v + static_cast<int64_t>(b) * T * kv_stride + hk * D;

  for (int i = threadIdx.x; i < FBM * D; i += blockDim.x) {
    const int row = q0 + i / D;
    Qs[i / D][i % D] = row < S ? qb[row * q_stride + i % D] : 0.f;
  }

  float m[4], l[4], acc[4][D / 32];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) acc[r][i] = 0.f;
  }

  const int last_row = min(S, q0 + FBM) - 1;
  int k_begin = window > 0 ? max(0, q0 - (window - 1)) : 0;
  k_begin = (k_begin / FBN) * FBN;
  const int k_end = min(T, last_row + 1);

  for (int kt = k_begin; kt < k_end; kt += FBN) {
    __syncthreads();
    for (int i = threadIdx.x; i < FBN * D; i += blockDim.x) {
      const int key = kt + i / D, d = i % D;
      Ks[i / D][d] = key < T ? kb[key * kv_stride + d] : 0.f;
      Vs[i / D][d] = key < T ? vb[key * kv_stride + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int rr = warp * 4 + r, row = q0 + rr, key = kt + lane;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(Qs[rr][d], Ks[lane][d], dot);
      const bool ok = key_live(key, row, T, window);
      const float s = ok ? capped(dot * dscale, cap) : NEG_INF;
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - mn);
      const float p = ok ? expf(s - mn) : 0.f;
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[r] = alpha * l[r] + ps;
      m[r] = mn;
#pragma unroll
      for (int i = 0; i < D / 32; ++i) acc[r][i] *= alpha;
      for (int jj = 0; jj < FBN; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, p, jj);
#pragma unroll
        for (int i = 0; i < D / 32; ++i)
          acc[r][i] = fmaf(pj, Vs[jj][lane + 32 * i], acc[r][i]);
      }
    }
  }

  float* ob = out + static_cast<int64_t>(b) * S * q_stride + h * D;
  float* lb = lse + (static_cast<int64_t>(b) * Hq + h) * S;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + warp * 4 + r;
    if (row >= S) continue;
    const bool live = l[r] > 0.f;
#pragma unroll
    for (int i = 0; i < D / 32; ++i)
      ob[row * q_stride + lane + 32 * i] = live ? acc[r][i] / l[r] : 0.f;
    if (lane == 0) lb[row] = live ? m[r] + logf(l[r]) : NEG_INF;
  }
}

// ------------------------------------------------------------------- launcher

template <int D>
static int launch_bf16(const void* q, const void* k, const void* v, void* out,
                       float* lse, int B, int S, int T, int Hq, int Hkv,
                       int window, float cap, float dscale, cudaStream_t st) {
  CUtensorMap qmap, kmap, vmap;
  int rc = hopper::map_bf16_bshd(&qmap, q, B, S, Hq, D);
  if (rc == 0) rc = hopper::map_bf16_bshd(&kmap, k, B, T, Hkv, D);
  if (rc == 0) rc = hopper::map_bf16_bshd(&vmap, v, B, T, Hkv, D);
  if (rc != 0) return rc;
  constexpr int bytes = FwdSmem<D>::BYTES;
  static bool configured = false;          // once per process and head_dim
  if (!configured) {
    rc = static_cast<int>(cudaFuncSetAttribute(
        flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes));
    if (rc != 0) return rc;
    configured = true;
  }
  const dim3 grid(Hq, B, (S + BM - 1) / BM);
  flash_fwd_bf16_kernel<D><<<grid, 128, bytes, st>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), lse, S, T, Hq, Hkv,
      window, cap, dscale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
static int launch_f32(const float* q, const float* k, const float* v,
                      float* out, float* lse, int B, int S, int T, int Hq,
                      int Hkv, int window, float cap, float dscale,
                      cudaStream_t st) {
  constexpr int bytes = f32_smem_bytes<D>();
  static bool configured = false;          // once per process and head_dim
  if (!configured) {
    const int rc = static_cast<int>(cudaFuncSetAttribute(
        flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes));
    if (rc != 0) return rc;
    configured = true;
  }
  const dim3 grid((S + FBM - 1) / FBM, Hq, B);
  flash_fwd_f32_kernel<D><<<grid, 128, bytes, st>>>(q, k, v, out, lse, S, T,
                                                    Hq, Hkv, window, cap,
                                                    dscale);
  return static_cast<int>(cudaGetLastError());
}

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a head_dim the kernel does not take (64, 128,
// 192) or tensors TMA cannot map.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, float* lse, int B, int S, int T,
                                int Hq, int Hkv, int D, int window, float cap,
                                float dscale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D == 64)
      return launch_bf16<64>(q, k, v, out, lse, B, S, T, Hq, Hkv, window, cap,
                             dscale, st);
    if (D == 128)
      return launch_bf16<128>(q, k, v, out, lse, B, S, T, Hq, Hkv, window, cap,
                              dscale, st);
    if (D == 192)
      return launch_bf16<192>(q, k, v, out, lse, B, S, T, Hq, Hkv, window, cap,
                              dscale, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qq = static_cast<const float*>(q);
  const auto* kk = static_cast<const float*>(k);
  const auto* vv = static_cast<const float*>(v);
  auto* oo = static_cast<float*>(out);
  if (D == 64)
    return launch_f32<64>(qq, kk, vv, oo, lse, B, S, T, Hq, Hkv, window, cap,
                          dscale, st);
  if (D == 128)
    return launch_f32<128>(qq, kk, vv, oo, lse, B, S, T, Hq, Hkv, window, cap,
                           dscale, st);
  if (D == 192)
    return launch_f32<192>(qq, kk, vv, oo, lse, B, S, T, Hq, Hkv, window, cap,
                           dscale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
