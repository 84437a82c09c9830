// P2: the shared-memory capacity probe for Hopper.
//
// Replaces scripts/probe_vmem.py (probe :10, pallas_call :15), which asked
// how large a VMEM scratch buffer a TPU kernel may hold: it compiled kernels
// with an [n, 128] f32 scratch of 8 to 120 MB, each copying x[0, :] into
// scratch row 0 and returning that row's sum (128.0 for ones), until one
// failed.  On the card the counterpart of VMEM is a block's shared memory:
// the kernel here takes `bytes` of dynamic shared memory as an [n, 128] f32
// buffer, copies x[0, :] (128 floats) into its row 0 and writes the row's
// sum.  Above 48 KB a launch needs
// cudaFuncAttributeMaxDynamicSharedMemorySize, which the card refuses past
// cudaDevAttrMaxSharedMemoryPerBlockOptin (232 448 bytes on an H100) with
// cudaErrorInvalidValue: that refusal is the measurement.
//
// What bounds it: nothing but the launch (512 bytes read, 4 written).

#include <cuda_runtime.h>

namespace {

constexpr int ROW = 128;

__global__ void __launch_bounds__(ROW)
smem_probe_kernel(const float* __restrict__ x, float* __restrict__ out) {
  extern __shared__ float buf[];  // [bytes / 512][128]
  buf[threadIdx.x] = x[threadIdx.x];
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int k = 0; k < ROW; ++k) s += buf[k];
    out[0] = s;
  }
}

}  // namespace

// Launch the probe with `bytes` of dynamic shared memory (at least 512):
// out[0] = sum of x[0:128].  Device pointers.  Returns 0, or the CUDA error
// code of the refused attribute or launch; launches on `stream`, does not
// synchronise.
extern "C" int come_smem_probe(const float* x, float* out, int bytes,
                               void* stream) {
  if (bytes < ROW * (int)sizeof(float)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      smem_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) {
    cudaGetLastError();  // the refusal is an answer: clear it for the next call
    return (int)e;
  }
  smem_probe_kernel<<<1, ROW, bytes, (cudaStream_t)stream>>>(x, out);
  return (int)cudaGetLastError();
}

// cudaDevAttrMaxSharedMemoryPerBlockOptin of the current device, or -1.
extern "C" int come_smem_optin(void) {
  int dev = 0, v = -1;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return v;
}

// The name of a CUDA error code ("cudaErrorInvalidValue", ...).
extern "C" const char* come_cuda_error_name(int code) {
  return cudaGetErrorName((cudaError_t)code);
}
