// Paged-attention decode for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/paged_attention.py, _paged_kernel (launched by
// paged_attention_pallas). Same contract: q (B,Hq,D) is the one current token
// per sequence (post-RoPE); k/v pages (NP,ps,Hkv,D); tables (B,TW) int32
// physical page per ring slot; lens (B,) int32 tokens written, query position
// lens-1. Page-granular ring math exactly as the Pallas kernel does it
// (cur = q_pos / ps, rem = cur % TW, base = cur - rem + j [- TW]); a page that
// lies wholly below the sliding window is skipped; in-page positions are masked
// by recency and window; f32 online softmax; a slot with len 0 writes zeros.
// TRASH_PAGE (0) entries are legal pool indices and are always masked.
//
// What bounds it on this card: bytes. One decode step reads every live K/V
// page once and does ~4 FLOP per byte read (one q row per kv head per key):
// far below the H100's ~295 FLOP/byte ridge, so its floor is the pages'
// bytes over 3.35 TB/s.
//
// Design (simple and right first): one CTA per (sequence, kv head) with one
// warp per query head of the GQA group, so the G query rows share each staged
// page. The table and lens are read on the device (no host sync); the block
// table sweep is sequential inside the CTA and each live page is staged in
// shared memory as f32, then each warp scores one key per lane and
// accumulates PV with one lane per 1/32 of head_dim. Pool offsets are 64-bit.
// At the granite-3-2b decode shape this gives only B*Hkv = 64 CTAs for 132
// SMs, and the page loads are not overlapped with compute; splitting the
// table sweep across CTAs (split-K with a second combine pass) is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define NEG_INF (-1e30f)

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int D>
__global__ void paged_attention_kernel(const T* __restrict__ q,
                                       const T* __restrict__ k_pages,
                                       const T* __restrict__ v_pages,
                                       const int* __restrict__ tables,
                                       const int* __restrict__ lens,
                                       T* __restrict__ out, int Hq, int Hkv,
                                       int ps, int TW, int window, float cap,
                                       float dscale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, hk = blockIdx.y, G = Hq / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;   // warp = query head in group
  float* Ks = smem;                         // [ps][D + 1]
  float* Vs = Ks + ps * (D + 1);            // [ps][D]
  float* Qs = Vs + ps * D;                  // [G][D]

  const T* qb = q + (static_cast<int64_t>(b) * Hq + hk * G) * D;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) Qs[i] = to_f32(qb[i]);

  float m = NEG_INF, l = 0.f, acc[D / 32];
#pragma unroll
  for (int i = 0; i < D / 32; ++i) acc[i] = 0.f;

  const int len = lens[b];
  const int q_pos = len - 1;
  const int64_t slot_stride = static_cast<int64_t>(Hkv) * D;
  const int64_t page_stride = slot_stride * ps;
  if (len > 0) {                            // uniform over the CTA
    const int cur = q_pos / ps;             // q_pos >= 0: truncation is floor
    const int rem = cur % TW;
    const float* qrow = Qs + warp * D;
    for (int j = 0; j < TW; ++j) {
      const int base = j <= rem ? cur - rem + j : cur - rem + j - TW;
      bool live = base >= 0;
      if (window > 0) live = live && base * ps + ps - 1 >= q_pos - (window - 1);
      if (!live) continue;                  // uniform over the CTA
      const int64_t page = tables[static_cast<int64_t>(b) * TW + j];
      const T* kp = k_pages + page * page_stride + hk * D;
      const T* vp = v_pages + page * page_stride + hk * D;
      __syncthreads();                      // previous page consumed, Qs ready
      for (int i = threadIdx.x; i < ps * D; i += blockDim.x) {
        const int s = i / D, d = i % D;
        Ks[s * (D + 1) + d] = to_f32(kp[s * slot_stride + d]);
        Vs[s * D + d] = to_f32(vp[s * slot_stride + d]);
      }
      __syncthreads();
      for (int c0 = 0; c0 < ps; c0 += 32) {
        const int s = c0 + lane, kpos = base * ps + s;
        const bool ok = s < ps && kpos <= q_pos &&
                        (window <= 0 || q_pos - kpos < window);
        float x = NEG_INF;
        if (ok) {
          float dot = 0.f;
#pragma unroll 16
          for (int d = 0; d < D; ++d) dot = fmaf(qrow[d], Ks[s * (D + 1) + d], dot);
          x = dot * dscale;
          if (cap > 0.f) x = cap * tanhf(x / cap);
        }
        float mx = x;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float mn = fmaxf(m, mx);
        const float alpha = expf(m - mn);
        const float p = ok ? expf(x - mn) : 0.f;   // re-masked
        float psum = p;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          psum += __shfl_xor_sync(0xffffffffu, psum, off);
        l = alpha * l + psum;
        m = mn;
#pragma unroll
        for (int i = 0; i < D / 32; ++i) acc[i] *= alpha;
        const int n = min(32, ps - c0);
        for (int jj = 0; jj < n; ++jj) {
          const float pj = __shfl_sync(0xffffffffu, p, jj);
          const float* vrow = Vs + (c0 + jj) * D + lane;
#pragma unroll
          for (int i = 0; i < D / 32; ++i) acc[i] = fmaf(pj, vrow[32 * i], acc[i]);
        }
      }
    }
  }
  T* ob = out + (static_cast<int64_t>(b) * Hq + hk * G + warp) * D;
  const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
  for (int i = 0; i < D / 32; ++i) store(ob + lane + 32 * i, acc[i] * inv);
}

template <typename T, int D>
static int launch(const void* q, const void* kp, const void* vp,
                  const int* tables, const int* lens, void* out, int B, int Hq,
                  int Hkv, int ps, int TW, int window, float cap, float dscale,
                  cudaStream_t st) {
  const int G = Hq / Hkv;
  const size_t smem = sizeof(float) * (ps * (D + 1) + ps * D + G * D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  paged_attention_kernel<T, D><<<dim3(B, Hkv), 32 * G, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      tables, lens, static_cast<T*>(out), Hq, Hkv, ps, TW, window, cap, dscale);
  return static_cast<int>(cudaGetLastError());
}

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a head_dim or group size the kernel does not take.
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages, const int* tables,
                                      const int* lens, void* out, int B, int Hq,
                                      int Hkv, int D, int ps, int TW, int window,
                                      float cap, float dscale, int is_bf16,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hq % Hkv != 0 || Hq / Hkv > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16) {
    if (D == 64) return launch<__nv_bfloat16, 64>(q, k_pages, v_pages, tables, lens, out,
                                                  B, Hq, Hkv, ps, TW, window, cap, dscale, st);
    if (D == 128) return launch<__nv_bfloat16, 128>(q, k_pages, v_pages, tables, lens, out,
                                                    B, Hq, Hkv, ps, TW, window, cap, dscale, st);
  } else {
    if (D == 64) return launch<float, 64>(q, k_pages, v_pages, tables, lens, out,
                                          B, Hq, Hkv, ps, TW, window, cap, dscale, st);
    if (D == 128) return launch<float, 128>(q, k_pages, v_pages, tables, lens, out,
                                            B, Hq, Hkv, ps, TW, window, cap, dscale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
