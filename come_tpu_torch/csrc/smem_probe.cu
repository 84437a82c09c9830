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
// What bounds it: nothing but the launch (512 bytes read, 4 written).  So
// the call does nothing else: the attribute is set once per device for the
// largest size asked so far (a smaller launch needs no new cap), the kernel
// writes out[0] itself (no zero fill before it) and sums the row with warp
// shuffles, not one thread's serial loop.

#include <cuda_runtime.h>

namespace {

constexpr int ROW = 128;
constexpr int MAX_DEVICES = 64;

__global__ void __launch_bounds__(ROW)
smem_probe_kernel(const float* __restrict__ x, float* __restrict__ out) {
  // no static shared memory: the dynamic buffer may take the whole opt-in
  extern __shared__ float buf[];  // [bytes / 512][128]
  const int t = threadIdx.x;
  buf[t] = x[t];
  __syncthreads();
  float s = buf[t];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  __syncthreads();  // every row value read: buf[0:4] takes the warps' sums
  if ((t & 31) == 0) buf[t >> 5] = s;
  __syncthreads();
  if (t == 0) out[0] = (buf[0] + buf[1]) + (buf[2] + buf[3]);
}

// per device: the largest dynamic shared memory the kernel's cap allows
int g_cap[MAX_DEVICES] = {};

}  // namespace

// Launch the probe with `bytes` of dynamic shared memory (at least 512):
// out[0] = sum of x[0:128].  Device pointers.  Returns 0, or the CUDA error
// code of the refused attribute or launch; launches on `stream`, does not
// synchronise.
extern "C" int come_smem_probe(const float* x, float* out, int bytes,
                               void* stream) {
  if (bytes < ROW * (int)sizeof(float)) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (bytes > g_cap[dev]) {
    e = cudaFuncSetAttribute(smem_probe_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) {
      cudaGetLastError();  // the refusal is an answer: clear it for the next
      return (int)e;       // call
    }
    g_cap[dev] = bytes;
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
