// P4: the per-group floor probe for Hopper.
//
// Replaces scripts/probe_star_floor.py (seven pallas_calls, :64, :81, :102,
// :123, :148, :176, :232), which found the fixed cost of one TPU grid step
// by adding one input stream at a time to an empty kernel.  On the card the
// group unit is one stream-ordered launch per group from a loop in the C
// entry (star_sgns.cu, walk_sgns.cu), so each variant here launches one
// small kernel (one CTA of 128 threads) per group over G groups, and the
// last group writes the value the TPU variant returns into stats[0]:
//   1  bare         nothing read; 1.0
//   2  slots        the group's 1024 slots read one at a time by one thread
//                   (the TPU's SMEM reads); float(slots[(G-1)*1024])
//   7  slots tile   the same slots as an [8, 128] tile read by the whole
//                   block (the TPU's VMEM block); the same value
//   3  smem streams 2, and at every 8th group the 1024-entry pool block and
//                   the two scalars, one thread; + pool[((G-1)/8)*1024]
//   4  meta         2 + the group's [8, 128] meta tile read by the block;
//                   + meta[(G-1)*8, 0]
//   5  table        2 + a [V, d] copy of emb into `table` at group 0 (the
//                   TPU's DMA into its aliased output); the value of 2
//   6  gather       5 + the 1024 rows table[slots] gathered into phi
//                   [1024, d] (probe_rows.cuh, 32 rows in flight per warp,
//                   the TPU's unroll); phi[0, 0] = emb[slots[(G-1)*1024], 0]
// Every index read is folded into a sum stored in `sinks` (one word per
// thread), so none of the reads is dead code; the gathered rows are stored.
//
// What bounds it: launches.  The streams are a few KB a group; the copy
// and the gather are bytes (2 V d 4 bytes once, 1024 d 4 a group).

#include "probe_rows.cuh"

#define FLOOR_CHECK_LAUNCH()                      \
  do {                                            \
    cudaError_t e_ = cudaGetLastError();          \
    if (e_ != cudaSuccess) return (int)e_;        \
  } while (0)

namespace {

constexpr int NWL = 1024;
constexpr int THREADS = 128;

template <int VAR>
__global__ void __launch_bounds__(THREADS)
floor_group_kernel(const int* __restrict__ slots, const int* __restrict__ pool,
                   const float* __restrict__ scal,
                   const int* __restrict__ meta, const float* __restrict__ phi,
                   float* __restrict__ stats, unsigned* __restrict__ sinks,
                   int g, int G) {
  const int tid = threadIdx.x;
  const size_t base = (size_t)g * NWL;
  unsigned sink = 0;
  bool wrote = false;
  if (VAR != 1 && VAR != 7 && tid == 0) {  // scalar slot reads
    for (int i = 0; i < NWL; ++i) sink += (unsigned)slots[base + i];
    wrote = true;
  }
  if (VAR == 3 && g % 8 == 0 && tid == 0) {
    for (int i = 0; i < NWL; ++i) sink += (unsigned)pool[(size_t)(g / 8) * NWL + i];
    sink += __float_as_uint(scal[0]) + __float_as_uint(scal[1]);
  }
  if (VAR == 7 || VAR == 4) {  // an [8, 128] tile read by the block
    const int* tile = (VAR == 7 ? slots : meta) + base;
#pragma unroll
    for (int r = 0; r < 8; ++r) sink += (unsigned)tile[r * 128 + tid];
    wrote = true;
  }
  if (wrote) sinks[tid] = sink;
  if (g == G - 1 && tid == 0) {
    const int s0 = slots[base];
    float v = 1.0f;
    if (VAR == 2 || VAR == 7 || VAR == 5) v = (float)s0;
    if (VAR == 3) v = (float)(s0 + pool[(size_t)(g / 8) * NWL]);
    if (VAR == 4) v = (float)(s0 + meta[base]);
    if (VAR == 6) v = phi[0];
    stats[0] = v;
  }
}

// dst[i] = src[i] for n16 16-byte chunks.
__global__ void copy_kernel(const float4* __restrict__ src,
                            float4* __restrict__ dst, size_t n16) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n16;
       i += (size_t)gridDim.x * blockDim.x)
    dst[i] = src[i];
}

template <int VAR>
int floor_groups(const int* slots, const int* pool, const float* scal,
                 const int* meta, const float* emb, float* table, float* phi,
                 float* stats, unsigned* sinks, int G, int V, int d,
                 cudaStream_t stream) {
  if (VAR == 6) {
    const cudaError_t e = come::rows_allow_smem<32>(d);
    if (e != cudaSuccess) return (int)e;
  }
  for (int g = 0; g < G; ++g) {
    if ((VAR == 5 || VAR == 6) && g == 0) {
      const size_t n16 = (size_t)V * d / 4;
      copy_kernel<<<132 * 8, 256, 0, stream>>>(
          reinterpret_cast<const float4*>(emb), reinterpret_cast<float4*>(table),
          n16);
      FLOOR_CHECK_LAUNCH();
    }
    if (VAR == 6) {
      const cudaError_t e = come::launch_rows<32>(
          false, table, slots + (size_t)g * NWL, phi, NWL, d, 0.0f, stream);
      if (e != cudaSuccess) return (int)e;
    }
    floor_group_kernel<VAR><<<1, THREADS, 0, stream>>>(
        slots, pool, scal, meta, phi, stats, sinks, g, G);
    FLOOR_CHECK_LAUNCH();
  }
  return 0;
}

}  // namespace

// One run of variant `variant` (1-7, above) over G groups.  Device
// pointers: slots [G * 1024] i32; pool [ceil(G / 8) * 1024] i32; scal [2]
// f32; meta [G * 8, 128] i32; emb, table [V, d] f32 (d a multiple of 4);
// phi [1024, d] f32; stats [2] f32; sinks [128] u32.  Pointers a variant
// does not read may be null.  Returns 0 or the first CUDA error code;
// launches on `stream`, does not synchronise.
extern "C" int come_floor_probe(int variant, const int* slots, const int* pool,
                                const float* scal, const int* meta,
                                const float* emb, float* table, float* phi,
                                float* stats, unsigned* sinks, int G, int V,
                                int d, void* stream_ptr) {
  cudaStream_t s = (cudaStream_t)stream_ptr;
  if (G < 1 || d % 4) return (int)cudaErrorInvalidValue;
  switch (variant) {
    case 1: return floor_groups<1>(slots, pool, scal, meta, emb, table, phi, stats, sinks, G, V, d, s);
    case 2: return floor_groups<2>(slots, pool, scal, meta, emb, table, phi, stats, sinks, G, V, d, s);
    case 3: return floor_groups<3>(slots, pool, scal, meta, emb, table, phi, stats, sinks, G, V, d, s);
    case 4: return floor_groups<4>(slots, pool, scal, meta, emb, table, phi, stats, sinks, G, V, d, s);
    case 5: return floor_groups<5>(slots, pool, scal, meta, emb, table, phi, stats, sinks, G, V, d, s);
    case 6: return floor_groups<6>(slots, pool, scal, meta, emb, table, phi, stats, sinks, G, V, d, s);
    case 7: return floor_groups<7>(slots, pool, scal, meta, emb, table, phi, stats, sinks, G, V, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
