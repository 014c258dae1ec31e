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
// What bounds it on this card: at the serving prefill shape (S = T = 512,
// Hq = 32, Hkv = 8, D = 64) the causal half of QK^T and PV is ~1.1 GFLOP per
// layer against ~4.7 MB of q/k/v/O/lse traffic, ~230 FLOP per byte, which sits
// just below the H100's ~295 FLOP/byte ridge: the tensor cores and the memory
// are about equally near their limit, and a simple kernel is bound by neither
// but by latency (no load/compute overlap, one CTA's worth of warps per tile).
//
// Design (a simple kernel that is right, to be made fast later):
//  - one CTA per (64-row query tile, query head, batch); 4 warps, each owning
//    16 query rows; the key loop runs only from the window's band start to the
//    causal diagonal, so dead key tiles are never visited (block_live);
//  - bf16: QK^T and PV on the tensor cores with mma.sync m16n8k16 (bf16 in,
//    f32 accumulate); Q stays in registers as A fragments, K/V tiles of 64 keys
//    are staged in padded shared memory, the S accumulator fragments are
//    re-packed in registers as the A operand of PV (no shared-memory trip);
//  - f32: a plain FMA path (one warp per 4 query rows, one lane per key for
//    QK^T, one lane per 1/32 of head_dim for PV), so the f32 check can hold
//    the reference's 2e-5;
//  - rows >= S and keys >= T are masked in the kernel: no padded copies.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------------------ bf16 path

constexpr int BM = 64;   // query rows per CTA (4 warps x 16)
constexpr int BN = 64;   // keys per tile

template <int D>
__global__ void __launch_bounds__(128)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                      int S, int T, int Hq, int Hkv, int window, float cap,
                      float dscale) {
  constexpr int LDS = D + 8;               // padded row: conflict-free B loads
  __shared__ __align__(16) __nv_bfloat16 Ks[BN * LDS];
  __shared__ __align__(16) __nv_bfloat16 Vs[BN * LDS];

  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;   // this thread's two rows

  const int64_t q_stride = static_cast<int64_t>(Hq) * D;
  const int64_t kv_stride = static_cast<int64_t>(Hkv) * D;
  const __nv_bfloat16* qb = q + static_cast<int64_t>(b) * S * q_stride + h * D;
  const __nv_bfloat16* kb = k + static_cast<int64_t>(b) * T * kv_stride + hk * D;
  const __nv_bfloat16* vb = v + static_cast<int64_t>(b) * T * kv_stride + hk * D;

  // Q as m16n8k16 A fragments, D/16 k-steps
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    auto ld = [&](int row, int col) -> uint32_t {
      return row < S ? *reinterpret_cast<const uint32_t*>(qb + row * q_stride + col)
                     : 0u;
    };
    qf[kk][0] = ld(r0, c);
    qf[kk][1] = ld(r1, c);
    qf[kk][2] = ld(r0, c + 8);
    qf[kk][3] = ld(r1, c + 8);
  }

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  const int last_row = min(S, q0 + BM) - 1;
  int k_begin = window > 0 ? max(0, q0 - (window - 1)) : 0;
  k_begin = (k_begin / BN) * BN;
  const int k_end = min(T, last_row + 1);          // causal diagonal

  for (int kt = k_begin; kt < k_end; kt += BN) {
    __syncthreads();                                // previous tile consumed
    constexpr int CH = D / 8;                       // 16-byte chunks per row
    for (int c = threadIdx.x; c < BN * CH; c += blockDim.x) {
      const int row = c / CH, col = (c % CH) * 8, key = kt + row;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (key < T) {
        kv = *reinterpret_cast<const uint4*>(kb + key * kv_stride + col);
        vv = *reinterpret_cast<const uint4*>(vb + key * kv_stride + col);
      }
      *reinterpret_cast<uint4*>(&Ks[row * LDS + col]) = kv;
      *reinterpret_cast<uint4*>(&Vs[row * LDS + col]) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x BN keys
    float s[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* krow = &Ks[(n * 8 + g) * LDS + 2 * t];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_bf16(s[n], qf[kk], b0, b1);
      }
    }

    // scale, softcap, mask; running row max
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt + n * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? r0 : r1;
        const float x = capped(s[n][e] * dscale, cap);
        s[n][e] = key_live(key, row, T, window) ? x : NEG_INF;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= a0; o[j][1] *= a0; o[j][2] *= a1; o[j][3] *= a1;
    }
    // p, re-masked to 0 (a fully-masked row has s - m == 0 and would claim 1)
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt + n * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? r0 : r1;
        const float p = key_live(key, row, T, window)
                            ? expf(s[n][e] - (e < 2 ? mn0 : mn1)) : 0.f;
        s[n][e] = p;
        if (e < 2) l0 += p; else l1 += p;
      }
    }

    // O += P V: the S accumulators are the A fragments of P
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* v0 = &Vs[(kk * 16 + 2 * t) * LDS + g];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const __nv_bfloat16* vc = v0 + j * 8;
        __nv_bfloat162 lo, hi;
        lo.x = vc[0];        lo.y = vc[LDS];
        hi.x = vc[8 * LDS];  hi.y = vc[9 * LDS];
        mma_bf16(o[j], pa, *reinterpret_cast<uint32_t*>(&lo),
                 *reinterpret_cast<uint32_t*>(&hi));
      }
    }
  }

  // finalize: l was summed per thread; reduce over the quad sharing a row
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  __nv_bfloat16* ob = out + static_cast<int64_t>(b) * S * q_stride + h * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(ob + r0 * q_stride + c) =
          pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(ob + r1 * q_stride + c) =
          pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
  }
  if (t == 0) {
    float* lb = lse + (static_cast<int64_t>(b) * Hq + h) * S;
    if (r0 < S) lb[r0] = l0 > 0.f ? m0 + logf(l0) : NEG_INF;
    if (r1 < S) lb[r1] = l1 > 0.f ? m1 + logf(l1) : NEG_INF;
  }
}

// ------------------------------------------------------------------- f32 path

constexpr int FBM = 16;  // query rows per CTA (4 warps x 4 rows)
constexpr int FBN = 32;  // keys per tile (one per lane)

template <int D>
__global__ void __launch_bounds__(128)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int S, int T, int Hq, int Hkv,
                     int window, float cap, float dscale) {
  __shared__ float Qs[FBM][D];
  __shared__ float Ks[FBN][D + 1];          // +1: lanes read distinct banks
  __shared__ float Vs[FBN][D];

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

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a head_dim the kernel does not take.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, float* lse, int B, int S, int T,
                                int Hq, int Hkv, int D, int window, float cap,
                                float dscale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const dim3 grid((S + BM - 1) / BM, Hq, B);
    const auto* qq = static_cast<const __nv_bfloat16*>(q);
    const auto* kk = static_cast<const __nv_bfloat16*>(k);
    const auto* vv = static_cast<const __nv_bfloat16*>(v);
    auto* oo = static_cast<__nv_bfloat16*>(out);
    if (D == 64)
      flash_fwd_bf16_kernel<64><<<grid, 128, 0, st>>>(qq, kk, vv, oo, lse, S, T,
                                                      Hq, Hkv, window, cap, dscale);
    else if (D == 128)
      flash_fwd_bf16_kernel<128><<<grid, 128, 0, st>>>(qq, kk, vv, oo, lse, S, T,
                                                       Hq, Hkv, window, cap, dscale);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    const dim3 grid((S + FBM - 1) / FBM, Hq, B);
    const auto* qq = static_cast<const float*>(q);
    const auto* kk = static_cast<const float*>(k);
    const auto* vv = static_cast<const float*>(v);
    auto* oo = static_cast<float*>(out);
    if (D == 64)
      flash_fwd_f32_kernel<64><<<grid, 128, 0, st>>>(qq, kk, vv, oo, lse, S, T,
                                                     Hq, Hkv, window, cap, dscale);
    else if (D == 128)
      flash_fwd_f32_kernel<128><<<grid, 128, 0, st>>>(qq, kk, vv, oo, lse, S, T,
                                                      Hq, Hkv, window, cap, dscale);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
