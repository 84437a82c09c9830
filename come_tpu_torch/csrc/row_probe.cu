// P1: the row-gather floor probe for Hopper.
//
// Replaces scripts/probe_dma.py (kern_seq :36, kern_pipe :47, pallas_call
// :72), which measured the TPU's scattered-row DMA floor: a walk group
// pages 2048 random 512 B rows of a [500 000, 128] f32 table, DEPTH copies
// in flight, and sums element 0 of each row as its checksum.  Here the same
// work is a gather of N rows of a [V, d] f32 or bf16 table, and its inverse,
// a scatter-add of N rows back (unique rows, so each element takes one
// plain add and the result is exact).  It is the row-traffic yardstick of
// the walk kernels K1 and K3: every slot gathers and writes back rows like
// these.
//
// What bounds it on the H100: bytes.  A gather reads N rows and writes N,
// the scatter-add reads 2N and writes N; there is no arithmetic to speak of.
// The design: the rows are a flat run of 16-byte chunks (a row of 512 B is
// one warp-wide load, 256 B half of one); each thread moves UNROLL chunks
// of UNROLL different rows per iteration, all loads issued before the first
// store, so a warp keeps UNROLL rows in flight (the card's DEPTH).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr int MAX_BLOCKS = 132 * 16;

__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Element 0 of a chunk that starts a row, widened to f64.
__device__ __forceinline__ double first_elem(uint4 v, bool bf16) {
  return bf16 ? (double)__uint_as_float(v.x << 16) : (double)__uint_as_float(v.x);
}

// out[i] = table[idx[i]] for i < n, rows of `cpr` 16-byte chunks;
// *checksum += sum_i element 0 of row i.  grid <= MAX_BLOCKS, block THREADS.
__global__ void __launch_bounds__(THREADS)
row_gather_kernel(const uint4* __restrict__ table, const int* __restrict__ idx,
                  uint4* __restrict__ out, double* __restrict__ checksum,
                  long long n, int cpr, bool bf16) {
  const long long total = n * cpr;
  const long long stride = (long long)gridDim.x * blockDim.x;
  double sum = 0.0;
  for (long long c0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       c0 < total; c0 += stride * UNROLL) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long c = c0 + u * stride;
      if (c < total) {
        const long long r = c / cpr;
        v[u] = table[(long long)idx[r] * cpr + (c - r * cpr)];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long c = c0 + u * stride;
      if (c < total) {
        out[c] = v[u];
        if (c % cpr == 0) sum += first_elem(v[u], bf16);
      }
    }
  }
  sum = warp_sum_d(sum);
  if ((threadIdx.x & 31) == 0 && sum != 0.0) atomicAdd(checksum, sum);
}

__device__ __forceinline__ uint4 add_chunk(uint4 a, uint4 b, bool bf16) {
  unsigned* pa = reinterpret_cast<unsigned*>(&a);
  const unsigned* pb = reinterpret_cast<const unsigned*>(&b);
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    if (bf16) {
      __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&pa[w]);
      const __nv_bfloat162 y = *reinterpret_cast<const __nv_bfloat162*>(&pb[w]);
      const float lo = __fadd_rn(__low2float(x), __low2float(y));
      const float hi = __fadd_rn(__high2float(x), __high2float(y));
      x = __floats2bfloat162_rn(lo, hi);
      pa[w] = *reinterpret_cast<unsigned*>(&x);
    } else {
      pa[w] = __float_as_uint(__fadd_rn(__uint_as_float(pa[w]),
                                        __uint_as_float(pb[w])));
    }
  }
  return a;
}

// table[idx[i]] += rows[i] for i < n (idx unique: plain read-add-write,
// round to nearest even for bf16).  grid <= MAX_BLOCKS, block THREADS.
__global__ void __launch_bounds__(THREADS)
row_scatter_add_kernel(uint4* __restrict__ table, const int* __restrict__ idx,
                       const uint4* __restrict__ rows, long long n, int cpr,
                       bool bf16) {
  const long long total = n * cpr;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       c0 < total; c0 += stride * UNROLL) {
    uint4 t[UNROLL], s[UNROLL];
    long long dst[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long c = c0 + u * stride;
      if (c < total) {
        const long long r = c / cpr;
        dst[u] = (long long)idx[r] * cpr + (c - r * cpr);
        t[u] = table[dst[u]];
        s[u] = rows[c];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (c0 + u * stride < total) table[dst[u]] = add_chunk(t[u], s[u], bf16);
    }
  }
}

int blocks_for(long long total) {
  const long long b = (total + (long long)THREADS * UNROLL - 1) /
                      ((long long)THREADS * UNROLL);
  return (int)(b < 1 ? 1 : (b > MAX_BLOCKS ? MAX_BLOCKS : b));
}

}  // namespace

// Gather n rows of row_bytes (a multiple of 16) from `table` at `idx` into
// `out` [n, row_bytes] and add the sum of each row's element 0 (f32, or
// bf16 with elem_bf16) to *checksum (f64).  Device pointers, 16-byte
// aligned.  Returns 0 or the CUDA launch error; launches on `stream`, does
// not synchronise.
extern "C" int come_row_gather(const void* table, const int* idx, void* out,
                               double* checksum, int n, int row_bytes,
                               int elem_bf16, void* stream) {
  if (row_bytes % 16 || n < 0) return (int)cudaErrorInvalidValue;
  const int cpr = row_bytes / 16;
  row_gather_kernel<<<blocks_for((long long)n * cpr), THREADS, 0,
                      (cudaStream_t)stream>>>(
      (const uint4*)table, idx, (uint4*)out, checksum, n, cpr, elem_bf16 != 0);
  return (int)cudaGetLastError();
}

// table[idx[i]] += rows[i] for n unique idx, rows of d elements (f32, or
// bf16 with elem_bf16; d * element size a multiple of 16).
extern "C" int come_row_scatter_add(void* table, const int* idx,
                                    const void* rows, int n, int d,
                                    int elem_bf16, void* stream) {
  const int row_bytes = d * (elem_bf16 ? 2 : 4);
  if (row_bytes % 16 || n < 0) return (int)cudaErrorInvalidValue;
  const int cpr = row_bytes / 16;
  row_scatter_add_kernel<<<blocks_for((long long)n * cpr), THREADS, 0,
                           (cudaStream_t)stream>>>(
      (uint4*)table, idx, (const uint4*)rows, n, cpr, elem_bf16 != 0);
  return (int)cudaGetLastError();
}
