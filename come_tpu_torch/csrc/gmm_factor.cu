// G1: the GMM's Cholesky factor and inverse covariances for Hopper.
//
// The port's own kernel.  The JAX package factors each M-step's covariances
// with XLA's jax.lax.linalg.cholesky (come_tpu/losses/gmm.py:52, :241) and
// inverts the chosen restart's with cho_solve (:151, :339), inside one jitted
// EM program.  PyTorch's counterparts (torch.linalg.cholesky and
// torch.cholesky_inverse on a batch) go to MAGMA or cuSOLVER, which load at
// their first call in a process and check the factor's info flag on the
// host, so neither can sit inside a captured EM iteration.  This kernel can:
// it reads nothing back and writes the info flag to a device buffer.
//
//   come_gmm_factor:  for each of the n_init * K matrices b,
//       A = cov[b] / nk[b] + reg * I   (the lower triangle is read; the f32
//                                       division and sum are torch's)
//       L[b] = the lower Cholesky factor of A, zeros above the diagonal
//       info[b] = 0, or k + 1 for the first column k whose pivot is not
//                 positive (torch.linalg.cholesky_ex's convention)
//   come_gmm_inverse: inv[b] = (L[b] L[b]^T)^-1 = L^-T L^-1, symmetric.
//
// Design: one CTA per matrix; the d x d matrix (d <= 128) sits in shared
// memory with a row stride of d + 1 floats, so a column is read without bank
// conflicts.  The factor goes column by column (left-looking): thread i
// forms A[i][k] - sum_{p<k} L[i][p] L[k][p] for its row, in double, and
// rounds once to f32 after the division by the pivot; two barriers a column.
// The inverse solves L W = I column by column (thread j owns column j of W,
// in double in shared memory) and forms W^T W in double.  So each element of
// L and of inv is rounded once, where the trailing-update (right-looking)
// form rounds an element once per column before it: the plain version's
// f32 rounding, not the kernel's, is most of their difference.
//
// What bounds it: neither bytes nor operations.  A matrix is 64 KiB and d^3/3
// multiply-adds (0.7 M at d = 128); 78 of them (BlogCatalog: n_init 2, K 39)
// move 10.2 MB (3 us at 3.35 TB/s) and 55 M flops (1 us at 67 TFLOP/s in
// f32).  The kernel's time is its critical path: d columns, two barriers
// each, and thread 0's d^2/2 serial multiply-adds in the inverse.

#include <cuda_runtime.h>

namespace {

constexpr int MAXD = 128;
constexpr int FACTOR_THREADS = 128;   // one thread a row
constexpr int INVERSE_THREADS = 256;  // the product W^T W spreads wider

__host__ __device__ __forceinline__ int stride(int d) { return d + 1; }

__global__ void __launch_bounds__(FACTOR_THREADS)
gmm_factor_kernel(const float* __restrict__ cov, const float* __restrict__ nk,
                  float reg, float* __restrict__ L, int* __restrict__ info,
                  int d) {
  extern __shared__ float a[];  // [d][d + 1]: A, then L below the diagonal
  __shared__ double pivot[MAXD];
  __shared__ int first_bad;
  const int b = blockIdx.x, t = threadIdx.x, s = stride(d);
  const float* c = cov + (size_t)b * d * d;
  const float n = nk[b];
  for (int e = t; e < d * d; e += blockDim.x) {
    int i = e / d, j = e - i * d;
    if (j <= i) {
      float v = c[e] / n;
      a[i * s + j] = (i == j) ? v + reg : v;
    }
  }
  if (t == 0) first_bad = 0;
  __syncthreads();
  for (int k = 0; k < d; ++k) {
    double v = 0.0;
    const int i = t;
    if (i >= k && i < d) {
      v = (double)a[i * s + k];
      for (int p = 0; p < k; ++p)
        v -= (double)a[i * s + p] * (double)a[k * s + p];
      if (i == k) {
        if (!(v > 0.0) && first_bad == 0) first_bad = k + 1;
        pivot[k] = sqrt(v);  // NaN past a bad pivot: info says so
      }
    }
    __syncthreads();
    if (i > k && i < d) a[i * s + k] = (float)(v / pivot[k]);
    __syncthreads();
  }
  float* out = L + (size_t)b * d * d;
  for (int e = t; e < d * d; e += blockDim.x) {
    int i = e / d, j = e - i * d;
    out[e] = (j < i) ? a[i * s + j] : (j == i ? (float)pivot[i] : 0.0f);
  }
  if (t == 0) info[b] = first_bad;
}

__global__ void __launch_bounds__(INVERSE_THREADS)
gmm_inverse_kernel(const float* __restrict__ L, float* __restrict__ inv,
                   int d) {
  extern __shared__ double w[];  // W = L^-1: [d][d + 1] doubles, then L
  const int b = blockIdx.x, t = threadIdx.x, s = stride(d);
  float* l = reinterpret_cast<float*>(w + d * s);  // [d][d + 1] floats
  const float* src = L + (size_t)b * d * d;
  for (int e = t; e < d * d; e += blockDim.x) {
    int i = e / d, j = e - i * d;
    if (j <= i) l[i * s + j] = src[e];
  }
  __syncthreads();
  // column j of W: W[i][j] = (delta_ij - sum_{j<=p<i} L[i][p] W[p][j]) / L[i][i]
  if (t < d) {
    const int j = t;
    for (int i = j; i < d; ++i) {
      double v = (i == j) ? 1.0 : 0.0;
      for (int p = j; p < i; ++p) v -= (double)l[i * s + p] * w[p * s + j];
      w[i * s + j] = v / (double)l[i * s + i];
    }
  }
  __syncthreads();
  // inv[i][j] = sum_{p >= max(i, j)} W[p][i] W[p][j]: the same products in
  // the same order for (i, j) and (j, i), so inv is exactly symmetric
  float* out = inv + (size_t)b * d * d;
  for (int e = t; e < d * d; e += blockDim.x) {
    int i = e / d, j = e - i * d;
    double v = 0.0;
    for (int p = max(i, j); p < d; ++p) v += w[p * s + i] * w[p * s + j];
    out[e] = (float)v;
  }
}

size_t factor_smem(int d) { return (size_t)d * stride(d) * sizeof(float); }

size_t inverse_smem(int d) {
  return (size_t)d * stride(d) * (sizeof(double) + sizeof(float));
}

}  // namespace

// Raise both kernels' dynamic shared-memory caps to what d = 128 needs, on
// the current device.  Call once per device, outside any stream capture.
// Returns 0 or a CUDA error code.
extern "C" int come_gmm_factor_setup(void) {
  cudaError_t e = cudaFuncSetAttribute(
      gmm_factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)factor_smem(MAXD));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gmm_inverse_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)inverse_smem(MAXD));
  return (int)e;
}

// L[b], info[b] for b < nmat (see the note above).  cov, L: [nmat, d, d]
// f32; nk: [nmat] f32; info: [nmat] int32; device pointers, 1 <= d <= 128.
// Launches on `stream`, does not synchronise; capture-safe.  Returns 0 or
// the launch's CUDA error code.
extern "C" int come_gmm_factor(const float* cov, const float* nk, float reg,
                               float* L, int* info, int nmat, int d,
                               void* stream) {
  if (d < 1 || d > MAXD || nmat < 1) return (int)cudaErrorInvalidValue;
  gmm_factor_kernel<<<nmat, FACTOR_THREADS, factor_smem(d),
                      (cudaStream_t)stream>>>(cov, nk, reg, L, info, d);
  return (int)cudaGetLastError();
}

// inv[b] = (L[b] L[b]^T)^-1 for b < nmat.  L, inv: [nmat, d, d] f32.
extern "C" int come_gmm_inverse(const float* L, float* inv, int nmat, int d,
                                void* stream) {
  if (d < 1 || d > MAXD || nmat < 1) return (int)cudaErrorInvalidValue;
  gmm_inverse_kernel<<<nmat, INVERSE_THREADS, inverse_smem(d),
                       (cudaStream_t)stream>>>(L, inv, d);
  return (int)cudaGetLastError();
}
