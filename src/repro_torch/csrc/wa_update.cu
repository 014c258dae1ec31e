// The whole HWA sync in one pass, for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/wa_update.py, _wa_sync_fused_kernel (launched
// by wa_sync_fused_2d). Same contract, over the packed f32 state:
//   mean         = (sum_k stacked[k]) * inv_k        (sum from k = 0, in order)
//   total'       = (total + mean) - full * ring[idx]
//   ring[idx]    = mean                               (in place: the slot IS W-bar)
//   total        = total'                             (in place)
//   avg          = total' * inv_count                 (W-double-bar)
// idx (int32), full and inv_count (f32) are read from a 3-word device
// tensor, so the caller never reads the window state back to the host.
//
// What bounds it on this card: bytes. Each element costs (K + 2) f32 reads
// (K replicas, the ring slot, the total) and 3 f32 writes (ring slot, total,
// avg) for K + 3 flops: at K = 2 that is 20 bytes per ~1.5 flops, hundreds of
// times below the H100's ~20 flop/byte f32 ridge. The least time is
// (K + 5) * 4 * P bytes over 3.35 TB/s.
//
// Design (simple and right first): a grid-stride loop with float4 loads and
// stores (P % 4 == 0: packed buffers are ALIGN multiples). Every operation is
// an explicit round-to-nearest intrinsic (__fadd_rn, __fsub_rn, __fmul_rn),
// which nvcc never contracts into an FMA, with the reference's association,
// so the result is bit-identical to the plain PyTorch version.
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__global__ void __launch_bounds__(256)
wa_sync_fused_kernel(const float4* __restrict__ stacked, float4* ring,
                     float4* total, float4* __restrict__ avg,
                     const float* __restrict__ scalars, int64_t n4, int K,
                     float inv_k) {
  const int idx = reinterpret_cast<const int*>(scalars)[0];
  const float full = scalars[1];
  const float inv_count = scalars[2];
  float4* slot = ring + static_cast<int64_t>(idx) * n4;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n4; i += step) {
    // XLA's reduce order: one replica is taken as it is; more are added
    // onto a +0 start (which turns a -0 into +0), from k = 0 up
    float4 s = stacked[i];
    if (K > 1) s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = K > 1 ? 0 : 1; k < K; ++k) {
      const float4 x = stacked[static_cast<int64_t>(k) * n4 + i];
      s.x = __fadd_rn(s.x, x.x);
      s.y = __fadd_rn(s.y, x.y);
      s.z = __fadd_rn(s.z, x.z);
      s.w = __fadd_rn(s.w, x.w);
    }
    const float4 m = make_float4(__fmul_rn(s.x, inv_k), __fmul_rn(s.y, inv_k),
                                 __fmul_rn(s.z, inv_k), __fmul_rn(s.w, inv_k));
    const float4 old = slot[i];
    const float4 t = total[i];
    const float4 nt = make_float4(
        __fsub_rn(__fadd_rn(t.x, m.x), __fmul_rn(old.x, full)),
        __fsub_rn(__fadd_rn(t.y, m.y), __fmul_rn(old.y, full)),
        __fsub_rn(__fadd_rn(t.z, m.z), __fmul_rn(old.z, full)),
        __fsub_rn(__fadd_rn(t.w, m.w), __fmul_rn(old.w, full)));
    slot[i] = m;
    total[i] = nt;
    avg[i] = make_float4(__fmul_rn(nt.x, inv_count), __fmul_rn(nt.y, inv_count),
                         __fmul_rn(nt.z, inv_count), __fmul_rn(nt.w, inv_count));
  }
}

// stacked (K, P), ring (I, P), total (P,), avg (P,): f32, P % 4 == 0, 16-byte
// aligned. scalars: device pointer to {idx as int32 bits, full, inv_count}.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int wa_sync_fused_launch(const float* stacked, float* ring,
                                    float* total, float* avg,
                                    const float* scalars, int64_t P, int K,
                                    float inv_k, int n_sm, void* stream) {
  if (P % 4 != 0 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n4 = P / 4;
  const int threads = 256;
  int64_t blocks = (n4 + threads - 1) / threads;
  const int64_t cap = static_cast<int64_t>(n_sm) * 8;   // 8 CTAs per SM
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  wa_sync_fused_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(stacked), reinterpret_cast<float4*>(ring),
      reinterpret_cast<float4*>(total), reinterpret_cast<float4*>(avg),
      scalars, n4, K, inv_k);
  return static_cast<int>(cudaGetLastError());
}
