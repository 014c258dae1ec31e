// Paged-attention decode for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/paged_attention.py, _paged_kernel (launched by
// paged_attention_pallas). Same contract: q (B,Hq,D) is the one current token
// per sequence (post-RoPE); k/v pages (NP,ps,Hkv,D); tables (B,TW) int32
// physical page per ring slot; lens (B,) int32 tokens written, query position
// lens-1. Page-granular ring math exactly as the Pallas kernel does it
// (cur = q_pos / ps, rem = cur % TW, base = cur - rem + j [- TW]); a page that
// lies wholly below the sliding window is skipped; in-page positions are masked
// by recency and window; tanh logit softcap; f32 online softmax; a slot with
// len 0 writes zeros. TRASH_PAGE (0) entries are legal pool indices and are
// always masked. Pool offsets are 64-bit. Instantiated at head_dim 64, 128
// and 192 in bf16 and f32; the wrapper pads any other head_dim up to the
// next of those (kernels/head_dim.py) and passes the true one's dscale.
//
// What bounds it on this card: bytes. One decode step reads every live K/V
// page once and does ~4 FLOP per byte read (one q row per kv head per key):
// far below the H100's ~295 FLOP/byte ridge, so its floor is the pages'
// bytes over 3.35 TB/s — ~1.4 us at the granite-3-2b decode shape (B8,
// Hkv 8, D 64, ~2,400 cached tokens). Getting near it is about parallelism
// and loads in flight, not tensor cores.
//
// Design:
//  - the page sweep of one (sequence, kv head) is split over a thread-block
//    cluster of C CTAs (C = the largest power of two <= min(8, TW), 8 — the
//    portable cluster size — at the serving shape: 512 CTAs at B8 Hkv8 where
//    one CTA per pair gave 64 for 132 SMs). The ring slots are taken in
//    logical page order: the live pages are the logical pages
//    max(0, cur - TW + 1, first page of the window) .. cur, each held in
//    slot p % TW — the same set the ring math above enumerates. CTA r takes
//    a contiguous run of ceil(n_live / C) of them, computed here from lens
//    and the window with no host read, so the launch can be captured in a
//    CUDA graph;
//  - one warp per query head of the GQA group (G <= 32 warps), so the G
//    query rows share each staged page; a lane scores one key (the dot over
//    head_dim from 16-byte shared-memory reads, four partial sums), or half
//    of one where a page has at most 16 rows (the half-warps add), and owns
//    2 x D/64 columns of the PV sum;
//  - q, lens and the block-table row are read at once; pages stream
//    through a ring of 4 stages (2 where 4 would cost occupancy) with
//    cp.async 16-byte copies (a page of one kv head is ps rows of D at a
//    stride of Hkv x D: row by row, no tensor map to encode on a host-bound
//    path), kept in their own dtype in shared memory, rows padded by 16
//    bytes so the lanes' 16-byte reads hit distinct banks; arithmetic in
//    f32, softmax in the exp2 domain;
//  - each CTA keeps (m, l, acc) per head; the C partials are combined over
//    distributed shared memory in fixed rank order in the same launch (one
//    launch per paged attention, as the reference; no combine pass, no
//    atomics: bitwise reproducible). A CTA whose run is empty (short
//    sequences, a window that skips pages, len 0) still arrives at the
//    cluster barriers and contributes m = -1e30, l = 0.
#include "hopper.cuh"

#define NEG_INF (-1e30f)

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

constexpr int MAX_CLUSTER = 8;      // portable thread-block cluster size
constexpr int MAX_SMEM = 232448;    // dynamic shared memory a CTA may take

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(hopper::smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float2 to_f2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 to_f2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// q . row over N columns, row in shared memory (its own dtype), q f32;
// four independent partial sums, so the FMAs do not form one chain
template <int N>
__device__ __forceinline__ float dot_row(const float* q, const float* row) {
  float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int d = 0; d < N; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(row + d);
    const float4 y = *reinterpret_cast<const float4*>(q + d);
    a[0] = fmaf(x.x, y.x, a[0]);
    a[1] = fmaf(x.y, y.y, a[1]);
    a[2] = fmaf(x.z, y.z, a[2]);
    a[3] = fmaf(x.w, y.w, a[3]);
  }
  return (a[0] + a[1]) + (a[2] + a[3]);
}
template <int N>
__device__ __forceinline__ float dot_row(const float* q,
                                         const __nv_bfloat16* row) {
  float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int d = 0; d < N; d += 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + d);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(h[e]);
      const float2 y = *reinterpret_cast<const float2*>(q + d + 2 * e);
      a[e] = fmaf(x.x, y.x, a[e]);
      a[e] = fmaf(x.y, y.y, a[e]);
    }
  }
  return (a[0] + a[1]) + (a[2] + a[3]);
}

// shared memory of one CTA: the page ring (K and V of STAGES pages, rows of
// PITCH elements), q (G x D f32), the partial (acc G x D, m G, l G f32)
// and the sequence's block-table row (TW int32)
template <typename T, int D>
struct PagedSmem {
  static constexpr int PITCH = D + 16 / sizeof(T);   // +16 bytes a row
  static constexpr int CH = D * sizeof(T) / 16;      // 16-byte chunks a row
  __host__ __device__ static size_t page_bytes(int ps) {
    return sizeof(T) * ps * PITCH;
  }
  __host__ __device__ static size_t ring_bytes(int ps, int stages) {
    return 2 * stages * page_bytes(ps);
  }
  static size_t bytes(int ps, int stages, int G, int TW) {
    return ring_bytes(ps, stages) + sizeof(float) * (2 * G * D + 2 * G) +
           sizeof(int) * TW;
  }
};

template <typename T, int D, int STAGES>
__global__ void __launch_bounds__(1024)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int* __restrict__ tables,
                       const int* __restrict__ lens, T* __restrict__ out,
                       int Hq, int Hkv, int ps, int TW, int window, float cap,
                       float dscale) {
  using L = PagedSmem<T, D>;
  constexpr int PITCH = L::PITCH, CH = L::CH, EPC = 16 / sizeof(T);
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int C = gridDim.x, rank = blockIdx.x;       // the cluster: x
  const int hk = blockIdx.y, b = blockIdx.z, G = Hq / Hkv;
  const int nthr = blockDim.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;       // warp = query head of group
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int page_elems = ps * PITCH;
  float* Qs = reinterpret_cast<float*>(smem_raw + L::ring_bytes(ps, STAGES));
  float* part = Qs + G * D;                         // acc [G][D], m [G], l [G]
  int* tbl = reinterpret_cast<int*>(part + G * D + 2 * G);

  // q, the table row and the length are read together: the page
  // addresses wait on one memory latency, not three
  const int len = lens[b];
  const T* qb = q + (static_cast<int64_t>(b) * Hq + hk * G) * D;
  for (int i = tid; i < G * D; i += nthr) Qs[i] = to_f32(qb[i]);
  for (int j = tid; j < TW; j += nthr)
    tbl[j] = tables[static_cast<int64_t>(b) * TW + j];
  __syncthreads();

  // this CTA's run of live logical pages, from lens and the window
  const int q_pos = len - 1;
  int first = 0, n_live = 0;
  if (len > 0) {
    const int cur = q_pos / ps;              // q_pos >= 0: truncation is floor
    first = max(0, cur - TW + 1);            // the ring holds the last TW
    if (window > 0)                          // pages wholly below it: skipped
      first = max(first, max(0, q_pos - (window - 1)) / ps);
    n_live = cur - first + 1;
  }
  const int per = (n_live + C - 1) / C;
  const int p_lo = first + rank * per;
  const int n_mine = max(0, min(first + n_live, p_lo + per) - p_lo);

  const int64_t slot_stride = static_cast<int64_t>(Hkv) * D;
  const int64_t page_stride = slot_stride * ps;
  auto issue = [&](int i) {                // page p_lo + i into its stage
    const int p = p_lo + i;
    const int64_t page = tbl[p % TW];
    const T* kp = k_pages + page * page_stride + hk * D;
    const T* vp = v_pages + page * page_stride + hk * D;
    T* ks = ring + (i % STAGES) * 2 * page_elems;
    T* vs = ks + page_elems;
    for (int c = tid; c < ps * CH; c += nthr) {
      const int row = c / CH, col = (c % CH) * EPC;
      cp_async16(ks + row * PITCH + col, kp + row * slot_stride + col);
      cp_async16(vs + row * PITCH + col, vp + row * slot_stride + col);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < n_mine) issue(s);
    cp_async_commit();                     // empty groups keep the count
  }

  // lane owns columns 64c + 2 lane + {0, 1}, c < D / 64
  constexpr int NC = D / 64;
  float m = NEG_INF, l = 0.f, acc[2 * NC];  // m in log2 units
#pragma unroll
  for (int i = 0; i < 2 * NC; ++i) acc[i] = 0.f;
  const float* qrow = Qs + warp * D;
  const float sc = dscale * hopper::LOG2E;
  // pages of at most 16 rows: the two half-warps score the same 16 keys,
  // each over half of head_dim, and add their halves
  const bool halves = ps <= 16;
  const int kpc = halves ? 16 : 32;                 // keys a chunk
  const int key = halves ? lane & 15 : lane, half = halves ? lane >> 4 : 0;

  for (int i = 0; i < n_mine; ++i) {
    cp_async_wait<STAGES - 1>();
    __syncthreads();                       // page i (and Qs) visible to all
    const T* ks = ring + (i % STAGES) * 2 * page_elems;
    const T* vs = ks + page_elems;
    const int base = p_lo + i;             // logical page
    for (int c0 = 0; c0 < ps; c0 += kpc) {
      const int s = c0 + key, kpos = base * ps + s;
      const bool ok = s < ps && kpos <= q_pos &&
                      (window <= 0 || q_pos - kpos < window);
      float dot = 0.f;
      if (halves) {
        if (ok)
          dot = dot_row<D / 2>(qrow + half * (D / 2),
                               ks + s * PITCH + half * (D / 2));
        dot += __shfl_xor_sync(0xffffffffu, dot, 16);
      } else if (ok) {
        dot = dot_row<D>(qrow, ks + s * PITCH);
      }
      float x = NEG_INF;
      if (ok)
        x = cap > 0.f ? cap * tanhf(dot * dscale / cap) * hopper::LOG2E
                      : dot * sc;
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m, mx);
      const float alpha = exp2f(m - mn);
      // re-masked; with halves the upper half-warp repeats the lower's keys
      const float p = ok && half == 0 ? exp2f(x - mn) : 0.f;
      float psum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l = alpha * l + psum;
      m = mn;
#pragma unroll
      for (int j = 0; j < 2 * NC; ++j) acc[j] *= alpha;
      const int n = min(kpc, ps - c0);
#pragma unroll 8
      for (int jj = 0; jj < n; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, p, jj);
        const T* vrow = vs + (c0 + jj) * PITCH + 2 * lane;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float2 v2 = to_f2(vrow + 64 * c);
          acc[2 * c] = fmaf(pj, v2.x, acc[2 * c]);
          acc[2 * c + 1] = fmaf(pj, v2.y, acc[2 * c + 1]);
        }
      }
    }
    __syncthreads();                       // page i consumed: refill its stage
    if (i + STAGES < n_mine) issue(i + STAGES);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // this CTA's partial, then the cluster's combine in rank order
  float* pacc = part + warp * D;
#pragma unroll
  for (int c = 0; c < NC; ++c)
    store2(pacc + 64 * c + 2 * lane, acc[2 * c], acc[2 * c + 1]);
  if (lane == 0) {
    part[G * D + warp] = m;
    part[G * D + G + warp] = l;
  }
  hopper::cluster_sync();
  // CTA r writes pairs [r n / C, (r + 1) n / C) of the G x D outputs
  const int n_pairs = G * D / 2;
  const int lo = rank * n_pairs / C, hi = (rank + 1) * n_pairs / C;
  T* ob = out + (static_cast<int64_t>(b) * Hq + hk * G) * D;
  for (int idx = lo + tid; idx < hi; idx += nthr) {
    const int gq = idx / (D / 2), col = (idx % (D / 2)) * 2;
    // every rank's (m, l, acc) first, so the remote loads overlap
    float mr[MAX_CLUSTER], lr[MAX_CLUSTER];
    float2 ar[MAX_CLUSTER];
    float M = NEG_INF;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) {
      if (r < C) {
        mr[r] = hopper::ld_dsmem_f32(part + G * D + gq, r);
        lr[r] = hopper::ld_dsmem_f32(part + G * D + G + gq, r);
        ar[r] = hopper::ld_dsmem_f2(part + gq * D + col, r);
        M = fmaxf(M, mr[r]);
      }
    }
    float lsum = 0.f, o0 = 0.f, o1 = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) {        // in rank order
      if (r < C) {
        const float w = exp2f(mr[r] - M);
        lsum = fmaf(lr[r], w, lsum);
        o0 = fmaf(ar[r].x, w, o0);
        o1 = fmaf(ar[r].y, w, o1);
      }
    }
    const float inv = lsum > 0.f ? 1.f / lsum : 0.f;   // len 0: zeros
    store2(ob + gq * D + col, o0 * inv, o1 * inv);
  }
  hopper::cluster_sync();        // no CTA leaves while another reads its part
}

template <typename T, int D, int STAGES>
static int launch_stages(const void* q, const void* kp, const void* vp,
                         const int* tables, const int* lens, void* out, int B,
                         int Hq, int Hkv, int ps, int TW, int window, float cap,
                         float dscale, cudaStream_t st) {
  const int G = Hq / Hkv;
  const size_t bytes = PagedSmem<T, D>::bytes(ps, STAGES, G, TW);
  static size_t allowed = 48 * 1024;       // raised once per instance
  if (bytes > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T, D, STAGES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = bytes;
  }
  int C = 1;                               // CTAs per (sequence, kv head)
  while (2 * C <= MAX_CLUSTER && 2 * C <= TW) C *= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, Hkv, B);
  cfg.blockDim = dim3(32 * G, 1, 1);
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
      &cfg, paged_attention_kernel<T, D, STAGES>, static_cast<const T*>(q),
      static_cast<const T*>(kp), static_cast<const T*>(vp), tables, lens,
      static_cast<T*>(out), Hq, Hkv, ps, TW, window, cap, dscale));
}

// 4 pages in flight where that keeps a CTA within 48 KB (4 CTAs an SM, so
// the 512 CTAs of a B8 Hkv8 step run in one wave), else 2
template <typename T, int D>
static int launch(const void* q, const void* kp, const void* vp,
                  const int* tables, const int* lens, void* out, int B, int Hq,
                  int Hkv, int ps, int TW, int window, float cap, float dscale,
                  cudaStream_t st) {
  const int G = Hq / Hkv;
  if (PagedSmem<T, D>::bytes(ps, 4, G, TW) <= 48 * 1024)
    return launch_stages<T, D, 4>(q, kp, vp, tables, lens, out, B, Hq, Hkv, ps,
                                  TW, window, cap, dscale, st);
  if (PagedSmem<T, D>::bytes(ps, 2, G, TW) <= MAX_SMEM)
    return launch_stages<T, D, 2>(q, kp, vp, tables, lens, out, B, Hq, Hkv, ps,
                                  TW, window, cap, dscale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a head_dim (64, 128, 192), group size (<= 32) or
// page size and table width (2 pages must fit shared memory) the kernel
// does not take.
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages, const int* tables,
                                      const int* lens, void* out, int B, int Hq,
                                      int Hkv, int D, int ps, int TW, int window,
                                      float cap, float dscale, int is_bf16,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hq % Hkv != 0 || Hq / Hkv > 32 || TW < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define PAGED(TT, DD)                                                        \
  if (D == DD)                                                               \
    return launch<TT, DD>(q, k_pages, v_pages, tables, lens, out, B, Hq, Hkv, \
                          ps, TW, window, cap, dscale, st);
  if (is_bf16) {
    PAGED(__nv_bfloat16, 64) PAGED(__nv_bfloat16, 128) PAGED(__nv_bfloat16, 192)
  } else {
    PAGED(float, 64) PAGED(float, 128) PAGED(float, 192)
  }
#undef PAGED
  return static_cast<int>(cudaErrorInvalidValue);
}
