// The HWA weight-averaging kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the five Pallas launches of src/repro/kernels/wa_update.py, over
// the packed state (one flat buffer of P elements for the whole parameter
// set; ring rows are P apart):
//
//   wa_sync_fused     <- _wa_sync_fused_kernel      (wa_sync_fused_2d)
//     mean = (sum_k stacked[k]) * inv_k;  total' = (total + mean) - full*old;
//     ring[idx] = mean;  avg = total' * inv_count          (f32 ring)
//   wa_window_update  <- _wa_window_update_kernel   (wa_window_update_2d)
//     the same push of a given new = W-bar                  (f32 ring)
//   online_mean       <- _online_mean_kernel        (online_mean_2d)
//     out = (sum_k stacked[k]) * inv_k, stacked f32 or bf16, out f32
//   wa_window_update_c <- _wa_window_update_c_kernel (wa_window_update_c_2d)
//     bf16 ring, f32 total with a Kahan compensation comp:
//     slot = bf16(new);  y = (f32(slot) - full*f32(ring[idx])) - comp;
//     total' = total + y;  comp' = (total' - total) - y;
//     ring[idx] = slot;  avg = total' * inv_count
//   wa_sync_fused_c   <- _wa_sync_fused_c_kernel    (wa_sync_fused_c_2d)
//     the same with new = the K-mean of an f32 stack
//
// ring, total and comp are written in place (the reference aliases them);
// only ring row idx is touched. idx (int32), full and inv_count (f32) are
// read from a 3-word device tensor, so no sync reads the window state back
// to the host.
//
// What bounds them on this card: bytes. Each element costs a few f32 adds
// and multiplies against 12-32 bytes of traffic (at K = 2: window update 24,
// online mean 12, bf16-ring update 28, bf16-ring sync 32; the f32 sync
// (K + 5) * 4), hundreds of times below the H100's ~20 flop/byte f32 ridge.
// The least time is those bytes times P over 3.35 TB/s.
//
// Design (simple and right first): a grid-stride loop, four elements per
// thread and step: 16-byte loads and stores of f32, 8-byte ones of bf16
// (P % 4 == 0: packed buffers are ALIGN multiples). Every operation is an
// explicit round-to-nearest intrinsic (__fadd_rn, __fsub_rn, __fmul_rn,
// __float2bfloat16_rn), which nvcc never contracts into an FMA nor
// reassociates, with the reference's association: an FMA or a reassociation
// would change the bits, and in the Kahan step cancel the compensation. So
// every kernel is bit-identical to its plain PyTorch version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

struct Scalars {
  int idx;
  float full, inv_count;
};

__device__ __forceinline__ Scalars read_scalars(const float* scalars) {
  return {reinterpret_cast<const int*>(scalars)[0], scalars[1], scalars[2]};
}

// four consecutive elements (group i) as f32
__device__ __forceinline__ void ld4(const float* p, int64_t i, float v[4]) {
  const float4 x = reinterpret_cast<const float4*>(p)[i];
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ void ld4(const __nv_bfloat16* p, int64_t i,
                                    float v[4]) {
  const uint2 u = reinterpret_cast<const uint2*>(p)[i];
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void st4(float* p, int64_t i, const float v[4]) {
  reinterpret_cast<float4*>(p)[i] = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void st4(__nv_bfloat16* p, int64_t i,
                                    const __nv_bfloat16 v[4]) {
  uint2 u;
  *reinterpret_cast<__nv_bfloat162*>(&u.x) = __halves2bfloat162(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&u.y) = __halves2bfloat162(v[2], v[3]);
  reinterpret_cast<uint2*>(p)[i] = u;
}

// (sum_k stacked[k]) * inv_k for group i, in XLA's reduce order: one replica
// is taken as it is; more are added onto a +0 start (which turns a -0 into
// +0), from k = 0 up
template <typename T>
__device__ __forceinline__ void kmean4(const T* stacked, int64_t P, int K,
                                       float inv_k, int64_t i, float m[4]) {
  if (K == 1) {
    ld4(stacked, i, m);
  } else {
    m[0] = m[1] = m[2] = m[3] = 0.f;
    for (int k = 0; k < K; ++k) {
      float x[4];
      ld4(stacked + static_cast<int64_t>(k) * P, i, x);
#pragma unroll
      for (int j = 0; j < 4; ++j) m[j] = __fadd_rn(m[j], x[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) m[j] = __fmul_rn(m[j], inv_k);
}

// f32 ring: total' = (total + new) - full*old, slot <- new
__device__ __forceinline__ void push4(float* slot, float* total, float* avg,
                                      const float n[4], Scalars s,
                                      int64_t i) {
  float old[4], t[4], a[4];
  ld4(slot, i, old);
  ld4(total, i, t);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    t[j] = __fsub_rn(__fadd_rn(t[j], n[j]), __fmul_rn(old[j], s.full));
    a[j] = __fmul_rn(t[j], s.inv_count);
  }
  st4(slot, i, n);
  st4(total, i, t);
  st4(avg, i, a);
}

// bf16 ring with the Kahan pair (total, comp)
__device__ __forceinline__ void push4_c(__nv_bfloat16* slot, float* total,
                                        float* comp, float* avg,
                                        const float n[4], Scalars s,
                                        int64_t i) {
  float old[4], t[4], c[4], a[4];
  __nv_bfloat16 q[4];
  ld4(slot, i, old);
  ld4(total, i, t);
  ld4(comp, i, c);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    q[j] = __float2bfloat16_rn(n[j]);
    const float stored = __bfloat162float(q[j]);
    const float y = __fsub_rn(__fsub_rn(stored, __fmul_rn(s.full, old[j])),
                              c[j]);
    const float t2 = __fadd_rn(t[j], y);
    c[j] = __fsub_rn(__fsub_rn(t2, t[j]), y);
    t[j] = t2;
    a[j] = __fmul_rn(t2, s.inv_count);
  }
  st4(slot, i, q);
  st4(total, i, t);
  st4(comp, i, c);
  st4(avg, i, a);
}

#define GRID_STRIDE(i, n4)                                                 \
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +         \
                   threadIdx.x;                                            \
       i < (n4); i += static_cast<int64_t>(gridDim.x) * blockDim.x)

// The ring slot and the total are loaded before the replicas. Loaded after
// them, the same arithmetic (through kmean4/push4, or written out on float4
// pointers) ran about 3x slower on the H100 at P = 687.9M, K = 2; the cause
// is an open question (PERF.md). So this kernel writes push4's arithmetic
// out and does not call push4: keep it so until the cause is known, and
// re-time any change with kernels/wa_sync_ab.py, which builds and times the
// three orders against each other.
__global__ void __launch_bounds__(256)
wa_sync_fused_kernel(const float* __restrict__ stacked, float* ring,
                     float* total, float* __restrict__ avg,
                     const float* __restrict__ scalars, int64_t P, int K,
                     float inv_k) {
  const Scalars s = read_scalars(scalars);
  float* slot = ring + static_cast<int64_t>(s.idx) * P;
  GRID_STRIDE(i, P / 4) {
    float m[4], old[4], t[4], a[4];
    ld4(slot, i, old);
    ld4(total, i, t);
    kmean4(stacked, P, K, inv_k, i, m);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      t[j] = __fsub_rn(__fadd_rn(t[j], m[j]), __fmul_rn(old[j], s.full));
      a[j] = __fmul_rn(t[j], s.inv_count);
    }
    st4(slot, i, m);
    st4(total, i, t);
    st4(avg, i, a);
  }
}

__global__ void __launch_bounds__(256)
wa_window_update_kernel(float* ring, float* total,
                        const float* __restrict__ new_,
                        float* __restrict__ avg,
                        const float* __restrict__ scalars, int64_t P) {
  const Scalars s = read_scalars(scalars);
  float* slot = ring + static_cast<int64_t>(s.idx) * P;
  GRID_STRIDE(i, P / 4) {
    float n[4];
    ld4(new_, i, n);
    push4(slot, total, avg, n, s, i);
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
online_mean_kernel(const T* __restrict__ stacked, float* __restrict__ out,
                   int64_t P, int K, float inv_k) {
  GRID_STRIDE(i, P / 4) {
    float m[4];
    kmean4(stacked, P, K, inv_k, i, m);
    st4(out, i, m);
  }
}

__global__ void __launch_bounds__(256)
wa_window_update_c_kernel(__nv_bfloat16* ring, float* total, float* comp,
                          const float* __restrict__ new_,
                          float* __restrict__ avg,
                          const float* __restrict__ scalars, int64_t P) {
  const Scalars s = read_scalars(scalars);
  __nv_bfloat16* slot = ring + static_cast<int64_t>(s.idx) * P;
  GRID_STRIDE(i, P / 4) {
    float n[4];
    ld4(new_, i, n);
    push4_c(slot, total, comp, avg, n, s, i);
  }
}

__global__ void __launch_bounds__(256)
wa_sync_fused_c_kernel(const float* __restrict__ stacked,
                       __nv_bfloat16* ring, float* total, float* comp,
                       float* __restrict__ avg,
                       const float* __restrict__ scalars, int64_t P, int K,
                       float inv_k) {
  const Scalars s = read_scalars(scalars);
  __nv_bfloat16* slot = ring + static_cast<int64_t>(s.idx) * P;
  GRID_STRIDE(i, P / 4) {
    float m[4];
    kmean4(stacked, P, K, inv_k, i, m);
    push4_c(slot, total, comp, avg, m, s, i);
  }
}

constexpr int kThreads = 256;

// grid for P / 4 groups: at most 8 CTAs per SM, the loop strides over the rest
unsigned grid_for(int64_t P, int n_sm) {
  int64_t blocks = (P / 4 + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(n_sm) * 8;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned>(blocks);
}

cudaStream_t as_stream(void* stream) {
  return static_cast<cudaStream_t>(stream);
}

int bad_args(int64_t P, int K) {
  return (P % 4 != 0 || P < 4 || K < 1)
             ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

}  // namespace

// All pointers: device memory, 16-byte aligned (8-byte for bf16 buffers);
// stacked (K, P), ring (I, P), total/comp/new/avg/out (P,); P % 4 == 0.
// scalars: device pointer to {idx as int32 bits, full, inv_count}. Each
// launcher returns cudaGetLastError() after the launch (0 = launched).

extern "C" int wa_sync_fused_launch(const float* stacked, float* ring,
                                    float* total, float* avg,
                                    const float* scalars, int64_t P, int K,
                                    float inv_k, int n_sm, void* stream) {
  if (int rc = bad_args(P, K)) return rc;
  wa_sync_fused_kernel<<<grid_for(P, n_sm), kThreads, 0,
                         as_stream(stream)>>>(stacked, ring, total, avg,
                                              scalars, P, K, inv_k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wa_window_update_launch(float* ring, float* total,
                                       const float* new_, float* avg,
                                       const float* scalars, int64_t P,
                                       int n_sm, void* stream) {
  if (int rc = bad_args(P, 1)) return rc;
  wa_window_update_kernel<<<grid_for(P, n_sm), kThreads, 0,
                            as_stream(stream)>>>(ring, total, new_, avg,
                                                 scalars, P);
  return static_cast<int>(cudaGetLastError());
}

// stacked_bf16: 0 = stacked is f32, 1 = bf16
extern "C" int online_mean_launch(const void* stacked, int stacked_bf16,
                                  float* out, int64_t P, int K, float inv_k,
                                  int n_sm, void* stream) {
  if (int rc = bad_args(P, K)) return rc;
  if (stacked_bf16) {
    online_mean_kernel<__nv_bfloat16>
        <<<grid_for(P, n_sm), kThreads, 0, as_stream(stream)>>>(
            static_cast<const __nv_bfloat16*>(stacked), out, P, K, inv_k);
  } else {
    online_mean_kernel<float>
        <<<grid_for(P, n_sm), kThreads, 0, as_stream(stream)>>>(
            static_cast<const float*>(stacked), out, P, K, inv_k);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wa_window_update_c_launch(void* ring, float* total,
                                         float* comp, const float* new_,
                                         float* avg, const float* scalars,
                                         int64_t P, int n_sm, void* stream) {
  if (int rc = bad_args(P, 1)) return rc;
  wa_window_update_c_kernel<<<grid_for(P, n_sm), kThreads, 0,
                              as_stream(stream)>>>(
      static_cast<__nv_bfloat16*>(ring), total, comp, new_, avg, scalars, P);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wa_sync_fused_c_launch(const float* stacked, void* ring,
                                      float* total, float* comp, float* avg,
                                      const float* scalars, int64_t P, int K,
                                      float inv_k, int n_sm, void* stream) {
  if (int rc = bad_args(P, K)) return rc;
  wa_sync_fused_c_kernel<<<grid_for(P, n_sm), kThreads, 0,
                           as_stream(stream)>>>(
      stacked, static_cast<__nv_bfloat16*>(ring), total, comp, avg, scalars,
      P, K, inv_k);
  return static_cast<int>(cudaGetLastError());
}
