// Row gather and scatter-add with U rows in flight per warp, for the probes
// P3 (star_probe.cu, its gather and scatter sections) and P4
// (floor_probe.cu, variant 6).
//
// They take the place of the TPU probes' unrolled row loops
// (scripts/probe_star.py:62-71 and :129-138, scripts/probe_star_floor.py
// :216-225): a TPU core copies U rows per loop step with one scalar index
// read each, and U sets how many copies it keeps in flight.  On the card a
// warp issues U rows of asynchronous 16-byte copies (cp.async) into shared
// memory before it waits for the first, so U is the rows a warp keeps in
// flight; one warp per CTA, 1024 / U CTAs per 1024-row group.  Rows are d
// f32 elements with d a multiple of 4.  The gathered rows are stored to
// device memory (the TPU's VMEM scratch), so no load is dead.
//
// What bounds them: bytes (each row read once and written once, or read
// and added atomically); U trades warps for loads in flight per warp.

#pragma once

#include <cuda_runtime.h>

namespace come {

static __device__ __forceinline__ void cp_async16(void* smem,
                                                  const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

static __device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// out[blockIdx.x * U + r] = table[ids[blockIdx.x * U + r]] for r < U.
// grid rows / U, block 32, dynamic shared memory U * d * 4 bytes.
template <int U>
static __global__ void __launch_bounds__(32)
gather_rows_kernel(const float* __restrict__ table,
                   const int* __restrict__ ids, float* __restrict__ out,
                   int d) {
  extern __shared__ float4 rows_buf[];
  const int cpr = d >> 2;  // 16-byte chunks per row
  const int base = blockIdx.x * U;
  const float4* t4 = reinterpret_cast<const float4*>(table);
  for (int i = threadIdx.x; i < U * cpr; i += 32) {
    const int r = i / cpr;
    cp_async16(&rows_buf[i], t4 + (size_t)ids[base + r] * cpr + (i - r * cpr));
  }
  cp_async_wait_all();
  __syncwarp();
  float4* o4 = reinterpret_cast<float4*>(out) + (size_t)base * cpr;
  for (int i = threadIdx.x; i < U * cpr; i += 32) o4[i] = rows_buf[i];
}

// table[ids[r]] += alpha * rows[r] (atomic: ids may repeat) for the U rows
// of each CTA.  grid rows / U, block 32, dynamic shared memory U * d * 4.
template <int U>
static __global__ void __launch_bounds__(32)
scatter_rows_kernel(float* __restrict__ table, const int* __restrict__ ids,
                    const float* __restrict__ rows, int d, float alpha) {
  extern __shared__ float4 rows_buf[];
  const int cpr = d >> 2;
  const int base = blockIdx.x * U;
  const float4* r4 = reinterpret_cast<const float4*>(rows) + (size_t)base * cpr;
  for (int i = threadIdx.x; i < U * cpr; i += 32) cp_async16(&rows_buf[i], r4 + i);
  cp_async_wait_all();
  __syncwarp();
  for (int i = threadIdx.x; i < U * cpr; i += 32) {
    const int r = i / cpr;
    float* dst = table + (size_t)ids[base + r] * d + 4 * (i - r * cpr);
    const float4 v = rows_buf[i];
    atomicAdd(dst + 0, alpha * v.x);
    atomicAdd(dst + 1, alpha * v.y);
    atomicAdd(dst + 2, alpha * v.z);
    atomicAdd(dst + 3, alpha * v.w);
  }
}

static inline size_t rows_smem_bytes(int U, int d) {
  return sizeof(float) * (size_t)U * d;
}

// Allow U * d * 4 bytes of dynamic shared memory for both row kernels.
template <int U>
static cudaError_t rows_allow_smem(int d) {
  const int bytes = (int)rows_smem_bytes(U, d);
  cudaError_t e = cudaFuncSetAttribute(
      gather_rows_kernel<U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(scatter_rows_kernel<U>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// Gather (scatter == false) or scatter-add the n rows (n a multiple of U)
// on `stream`.  Returns the launch error.
template <int U>
static cudaError_t launch_rows(bool scatter, float* table, const int* ids,
                               float* rows, int n, int d, float alpha,
                               cudaStream_t stream) {
  const size_t smem = rows_smem_bytes(U, d);
  if (scatter)
    scatter_rows_kernel<U><<<n / U, 32, smem, stream>>>(table, ids, rows, d,
                                                        alpha);
  else
    gather_rows_kernel<U><<<n / U, 32, smem, stream>>>(table, ids, rows, d);
  return cudaGetLastError();
}

// The U the probes take: 8, 16, 32, 64 or 128 rows in flight per warp.
#define COME_ROWS_DISPATCH(U_VAR, CALL)    \
  switch (U_VAR) {                         \
    case 8: { constexpr int U = 8; CALL; } break;     \
    case 16: { constexpr int U = 16; CALL; } break;   \
    case 32: { constexpr int U = 32; CALL; } break;   \
    case 64: { constexpr int U = 64; CALL; } break;   \
    case 128: { constexpr int U = 128; CALL; } break; \
    default: return (int)cudaErrorInvalidValue;       \
  }

}  // namespace come
