// G1: the GMM's Cholesky factor and inverse covariances for Hopper.
//
// The port's own kernel.  The JAX package factors each M-step's covariances
// with XLA's jax.lax.linalg.cholesky (come_tpu/losses/gmm.py:52, :241) and
// inverts the chosen restart's with cho_solve (:163, :337), inside one jitted
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
// What bounds it: neither bytes nor operations.  A matrix is 64 KiB and d^3/3
// multiply-adds (0.7 M at d = 128); 78 of them (BlogCatalog: n_init 2, K 39)
// move 10.2 MB (3 us at 3.35 TB/s) and 55 M flops (1 us at 67 TFLOP/s in
// f32).  Every preset fits 10 to 195 matrices, so one CTA a matrix fills at
// most 132 SMs a wave, and a matrix's time is its critical path: the d
// pivots one after another, each a reciprocal square root, and the steps
// between them that need all of the CTA (a barrier each).
//
// Design: one CTA of 256 threads (8 warps) a matrix.  The input is staged
// into shared memory with asynchronous copies, then held in f64 (dp x 128
// doubles, 128 KiB at d = 128; dp is d rounded up to the block width
// NB = 16, padded with an identity block, which factors and inverts to
// itself), each row's columns XOR-swizzled inside their group of 16 so
// that the tensor cores' fragments (8 rows by 4 columns) hit distinct banks.
// Every update is made in f64; each element of L and of inv is rounded to
// f32 once, at the end.  Products of 16 x 16 blocks run on the FP64 tensor
// cores (mma.sync m16n8k8, the full-rate f64 shape on sm_90).
//
// The factor is right-looking by panels of 16 columns, two barriers a
// panel (16 at d = 128, where one column a step took 256):
//   (1) one warp factors the 16 x 16 diagonal block in registers, a row a
//       lane: a shuffle, the pivot's reciprocal square root, the column
//       scaled, the rest of the block updated, no barrier; the same steps
//       invert the block (W11 = L11^-1);
//   (2) the rows below it, L21 = A21 W11^T, a warp a 16-row block;
//   (3) the trailing lower triangle takes A22 -= L21 L21^T, a warp a
//       16 x 16 block.
// (1) for the next panel overlaps (3): warp 0 updates the next diagonal
// block first and factors it while the other warps update the rest and
// write the finished panel's columns of L out.  The longest dependent chain
// is the d pivots of (1) with a short (2) between panels; where it was,
// thread d-1's d^2/2 serial multiply-adds and 256 barriers.
//
// The inverse keeps L in f32 (exact, 64 KiB) beside W = L^-1 in f64:
//   (1) the d/16 diagonal blocks are inverted at once, a warp each, by
//       forward substitution (a column a lane, 16 dependent steps);
//   (2) W's blocks below the diagonal follow right-looking, one barrier a
//       block column: step p subtracts L_qp W_pj from every block (q > p,
//       j <= p), a warp a block, and the block (p+1, j) is then multiplied
//       by W_{p+1,p+1}: d/16 - 1 barrier steps in place of thread 0's
//       d^2/2 chain;
//   (3) inv = W^T W over its lower 16 x 16 blocks, a warp a block in an
//       order that evens out their lengths, both (i, j) and (j, i) written
//       from one f64 sum, so inv is exactly symmetric.
//
// Past d = 128 a [dp][dp] f64 tile outgrows shared memory (512 KiB at d =
// 256), so gmm_factor_global_kernel and gmm_inverse_global_kernel run the
// same steps, the same device functions, on a matrix in global memory: an
// f64 scratch of nmat [dp][dp] matrices that the caller passes (41 MB for
// BlogCatalog's 78 at d = 256), read and written through L1 and L2 by the
// one CTA that owns it; W11 stays in shared memory.  L is read from its
// input (the identity past d) and inv written straight out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXD = 128;  // the widest d in shared memory; its row stride
constexpr int NB = 16;     // panel and block width
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ __forceinline__ int padded(int d) {
  return (d + NB - 1) / NB * NB;
}

// Element (r, c) of a [dp][MAXD] f64 tile: the column XORed inside its
// group of 16 by a per-row value that is a bijection on r mod 16 and, for
// four rows r0..r0+3 (r0 a multiple of 4), differs only in bits 2-3.  So 16
// rows reading one column, and a tensor-core fragment register (rows r0 +
// lane / 4, columns c0 + lane % 4, either way round), fall in 16 distinct
// 8-byte bank pairs per half warp.
__device__ __forceinline__ int at64(int r, int c) {
  return r * MAXD + (c ^ (((r & 3) << 2) | ((r >> 2) & 3)));
}

// The same for f32: the column XORed inside its group of 32, so a fragment
// of 8 rows by 4 columns falls in 32 distinct banks.
__device__ __forceinline__ int at32(int r, int c) {
  return r * MAXD + (c ^ (((r & 7) << 2) | ((r >> 3) & 3)));
}

// Where element (r, c) of a matrix lies: the shared tile's (at64), or row
// r * ld + c of a [dp][dp] matrix in global memory (d > MAXD).
struct SharedAt {
  __device__ __forceinline__ int operator()(int r, int c) const {
    return at64(r, c);
  }
};
struct GlobalAt {
  int ld;
  __device__ __forceinline__ size_t operator()(int r, int c) const {
    return (size_t)r * ld + c;
  }
};

// D = A B + D on the FP64 tensor cores, a 16 x 8 tile over a depth of 8
// (m16n8k8, the shape that runs at the full f64 rate on sm_90): with
// g = lane / 4 and s = lane % 4, a[i] = A[g + 8 (i & 1)][s + 4 (i >> 1)],
// b[i] = B[s + 4 i][g] and d[i] = D[g + 8 (i >> 1)][2 s + (i & 1)].
__device__ __forceinline__ void mma16(double (&d)[4], const double (&a)[4],
                                      const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// acc += A B for a 16 x 16 block over a depth of 16, four m16n8k8
// products: A(r, k) and B(k, c) read the operands (block coordinates), and
// acc[h][i] is the element (g + 8 (i >> 1), 8 h + 2 s + (i & 1)).
template <typename FA, typename FB>
__device__ __forceinline__ void mma_block(double (&acc)[2][4], FA A, FB B,
                                          int lane) {
  const int g = lane >> 2, s = lane & 3;
#pragma unroll
  for (int k = 0; k < NB; k += 8) {
    const double av[4] = {A(g, k + s), A(g + 8, k + s), A(g, k + s + 4),
                          A(g + 8, k + s + 4)};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const double bv[2] = {B(k + s, 8 * h + g), B(k + s + 4, 8 * h + g)};
      mma16(acc[h], av, bv);
    }
  }
}

// f(r, c, acc[h][i]) for the elements of a 16 x 16 block held as mma_block's
// accumulators, in block coordinates.
template <typename F>
__device__ __forceinline__ void for_acc(double (&acc)[2][4], int lane, F f) {
  const int g = lane >> 2, s = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f(g + 8 * (i >> 1), 8 * h + 2 * s + (i & 1), acc[h][i]);
}

// (u, v), v <= u, of the idx-th element of a lower triangle by rows.
__device__ __forceinline__ void tri_index(int idx, int& u, int& v) {
  u = (int)((sqrtf(8.0f * idx + 1.0f) - 1.0f) * 0.5f);
  while ((u + 1) * (u + 2) / 2 <= idx) ++u;
  while (u * (u + 1) / 2 > idx) --u;
  v = idx - u * (u + 1) / 2;
}

// Copies the n f32 at src to shared memory at dst (16-byte aligned) with
// asynchronous copies, all of a thread's in flight at once (16 bytes each
// where src allows), and waits for the thread's own; the caller syncs.
__device__ __forceinline__ void stage(float* dst, const float* src, int n,
                                      int t) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (n & 3) == 0) {
    for (int e = 4 * t; e < n; e += 4 * THREADS)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                   :: "r"(s + 4 * e), "l"(src + e));
  } else {
    for (int e = t; e < n; e += THREADS)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                   :: "r"(s + 4 * e), "l"(src + e));
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The rows d..dp-1 of the identity padding, at and below the diagonal:
// warp w of the CTA takes rows d + w, d + w + 8, ...
template <typename T, int (*AT)(int, int)>
__device__ void pad_identity(T* s, int d, int dp, int warp, int lane) {
  for (int i = d + warp; i < dp; i += WARPS)
    for (int j = lane; j <= i; j += 32) s[AT(i, j)] = (i == j) ? T(1) : T(0);
}

// ---------------------------------------------------------------- factor

// Element (r, c) of a 16 x 16 f64 block, swizzled as at64.
__device__ __forceinline__ int at16(int r, int c) {
  return r * NB + (c ^ (((r & 3) << 2) | ((r >> 2) & 3)));
}

// (1): warp 0 factors the diagonal block at k0: lane i (and i + 16) holds
// row k0 + i left of the diagonal in x and its diagonal element in dg, so
// the chain from one pivot to the next (a shuffle, a reciprocal square
// root, a multiply and a multiply-add) passes through one shuffle.  The
// same steps invert the block by forward substitution, column i of W11 in
// lane i's v, from the shuffled column of L each step broadcasts anyway.
// Writes L11 to a, W11 to w11 (at16) and the first bad pivot's column + 1.
template <typename At>
__device__ void diag_factor(double* a, At at, double* w11, int* first_bad,
                            int k0, int d, int lane) {
  const int i = lane & 15;
  double x[NB], v[NB];
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    x[c] = (c < i) ? a[at(k0 + i, k0 + c)] : 0.0;
    v[c] = (c == i) ? 1.0 : 0.0;
  }
  double dg = a[at(k0 + i, k0 + i)];
  bool bad = false;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const double piv = __shfl_sync(FULL, dg, j);
    const double r = rsqrt(piv);  // NaN past a bad pivot: info says so
    if (i == j) {
      bad = !(piv > 0.0);
      dg = piv * r;
    }
    x[j] *= r;
    if (i > j) dg = fma(-x[j], x[j], dg);
    v[j] *= r;  // W11[j][i]
#pragma unroll
    for (int c = j + 1; c < NB; ++c) {
      const double lc = __shfl_sync(FULL, x[j], c);  // L[c][j]
      if (i > c) x[c] = fma(-x[j], lc, x[c]);
      v[c] = fma(-lc, v[j], v[c]);
    }
  }
  if (lane < 16) {
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      if (c < i) a[at(k0 + i, k0 + c)] = x[c];
      w11[at16(c, i)] = v[c];
    }
    a[at(k0 + i, k0 + i)] = dg;
  }
  const unsigned m = __ballot_sync(FULL, bad && lane < 16 && k0 + i < d);
  if (lane == 0 && m != 0 && *first_bad == 0) *first_bad = k0 + __ffs(m);
}

// (2): the 16 rows at r0 below the block at k0: L21 = A21 W11^T, on the
// tensor cores, in place.
template <typename At>
__device__ void solve_block(double* a, At at, const double* w11, int k0,
                            int r0, int lane) {
  double acc[2][4] = {};
  mma_block(
      acc, [&](int r, int k) { return a[at(r0 + r, k0 + k)]; },
      [&](int k, int c) { return w11[at16(c, k)]; }, lane);
  __syncwarp();
  for_acc(acc, lane, [&](int r, int c, double& v) {
    a[at(r0 + r, k0 + c)] = v;
  });
}

// (3) for one 16 x 16 block at (r0, c0): A -= L21[r0] L21[c0]^T over the
// panel at k0, on the tensor cores.  A diagonal block's upper half lands
// above the diagonal, which nothing reads.
template <typename At>
__device__ void update_block(double* a, At at, int k0, int r0, int c0,
                             int lane) {
  double acc[2][4];
  for_acc(acc, lane, [&](int r, int c, double& v) {
    v = a[at(r0 + r, c0 + c)];
  });
  mma_block(
      acc, [&](int r, int k) { return -a[at(r0 + r, k0 + k)]; },
      [&](int k, int c) { return a[at(c0 + c, k0 + k)]; }, lane);
  for_acc(acc, lane, [&](int r, int c, double& v) {
    a[at(r0 + r, c0 + c)] = v;
  });
}

// Columns k0 .. k0 + 15 (fewer past d) of L, every row, from a, by the
// threads t0, t0 + n, ... of the CTA (n a multiple of 16): a half warp a
// row, a lane a column.
template <typename At>
__device__ void store_strip(const double* a, At at, float* out, int d, int k0,
                            int t0, int n) {
  const int j = k0 + (t0 & 15);
  if (j >= d) return;
  for (int i = t0 >> 4; i < d; i += n >> 4)
    out[(size_t)i * d + j] = (j <= i) ? (float)a[at(i, j)] : 0.0f;
}

// The panels of the factor of the padded [dp][dp] A held at `a` (lower
// triangle), written to out ([d][d] f32, zeros above the diagonal), the
// first bad pivot's column + 1 to *first_bad.  All THREADS threads call.
template <typename At>
__device__ void factor_panels(double* a, At at, double* w11, int* first_bad,
                              float* out, int d, int dp) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  if (warp == 0) diag_factor(a, at, w11, first_bad, 0, d, lane);
  __syncthreads();
  // panel p (columns k0..k0+15): the rows below solved; then warp 0 takes
  // the next diagonal block's update and factors it while the other warps
  // update the rest of the trailing matrix and write panel p's columns out
  for (int k0 = 0; k0 + NB < dp; k0 += NB) {
    const int k1 = k0 + NB;
    for (int r0 = k1 + warp * NB; r0 < dp; r0 += WARPS * NB)
      solve_block(a, at, w11, k0, r0, lane);
    __syncthreads();
    if (warp == 0) {
      update_block(a, at, k0, k1, k1, lane);
      __syncwarp();
      diag_factor(a, at, w11, first_bad, k1, d, lane);
    } else {
      store_strip(a, at, out, d, k0, t - 32, THREADS - 32);
      const int nbk = (dp - k1) / NB;
      for (int idx = warp; idx < nbk * (nbk + 1) / 2; idx += WARPS - 1) {
        int u, v;
        tri_index(idx, u, v);
        update_block(a, at, k0, k1 + u * NB, k1 + v * NB, lane);
      }
    }
    __syncthreads();
  }
  store_strip(a, at, out, d, dp - NB, t, THREADS);
}

__global__ void __launch_bounds__(THREADS, 1)
gmm_factor_kernel(const float* __restrict__ cov, const float* __restrict__ nk,
                  float reg, float* __restrict__ L, int* __restrict__ info,
                  int d) {
  extern __shared__ double a[];  // [dp][MAXD] (at64): A, then L
  __shared__ double w11[NB * NB];
  __shared__ int first_bad;
  const int b = blockIdx.x, t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int dp = padded(d);
  const float n = nk[b];
  float* out = L + (size_t)b * d * d;
  // A = cov / n + reg I, the lower triangle, in torch's f32 ops
  float* st = reinterpret_cast<float*>(a + dp * MAXD);  // cov[b], staged
  stage(st, cov + (size_t)b * d * d, d * d, t);
  __syncthreads();
  for (int i = warp; i < d; i += WARPS) {
    float v[MAXD / 32];  // the row's loads first: st and a may alias
#pragma unroll
    for (int q = 0; q < MAXD / 32; ++q)
      if (lane + 32 * q <= i) v[q] = st[i * d + lane + 32 * q];
#pragma unroll
    for (int q = 0; q < MAXD / 32; ++q) {
      const int j = lane + 32 * q;
      if (j <= i) {
        const float y = v[q] / n;
        a[at64(i, j)] = (double)(i == j ? y + reg : y);
      }
    }
  }
  pad_identity<double, at64>(a, d, dp, warp, lane);
  if (t == 0) first_bad = 0;
  __syncthreads();
  factor_panels(a, SharedAt{}, w11, &first_bad, out, d, dp);
  if (t == 0) info[b] = first_bad;
}

// The factor for d > MAXD: what gmm_factor_kernel computes, the same
// panels, with A held in global memory (`work`, [nmat][dp][dp] f64, row
// major) instead of shared memory, which a [dp][dp] f64 tile outgrows
// (512 KiB at d = 256).  A CTA's matrix stays in L2 and its L1 (512 KiB at
// d = 256; BlogCatalog's 78 are 41 MB); only W11 is in shared memory.
__global__ void __launch_bounds__(THREADS, 1)
gmm_factor_global_kernel(const float* __restrict__ cov,
                         const float* __restrict__ nk, float reg,
                         float* __restrict__ L, int* __restrict__ info, int d,
                         double* work) {
  __shared__ double w11[NB * NB];
  __shared__ int first_bad;
  const int b = blockIdx.x, t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int dp = padded(d);
  const GlobalAt at{dp};
  double* a = work + (size_t)b * dp * dp;
  const float n = nk[b];
  const float* src = cov + (size_t)b * d * d;
  // A = cov / n + reg I, the lower triangle, in torch's f32 ops; the rows
  // d..dp-1 of the identity padding
  for (int i = warp; i < dp; i += WARPS)
    for (int j = lane; j <= i; j += 32) {
      double v = (i == j) ? 1.0 : 0.0;
      if (i < d) {
        const float y = src[(size_t)i * d + j] / n;
        v = (double)(i == j ? y + reg : y);
      }
      a[at(i, j)] = v;
    }
  if (t == 0) first_bad = 0;
  __syncthreads();
  factor_panels(a, at, w11, &first_bad, L + (size_t)b * d * d, d, dp);
  if (t == 0) info[b] = first_bad;
}

// --------------------------------------------------------------- inverse

// (1): warp w inverts the diagonal block at k0 = 16 w; lane c (and c + 16)
// holds column c of W_ww, zeros above the diagonal included.
template <typename LAt, typename XAt>
__device__ void diag_inverse(LAt l, double* x, XAt xat, int k0, int lane) {
  const int c = lane & 15;
  const double rd = 1.0 / (double)l(k0 + c, k0 + c);
  double v[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) v[i] = (i == c) ? 1.0 : 0.0;
#pragma unroll
  for (int p = 0; p < NB; ++p) {
    const double w = v[p] * __shfl_sync(FULL, rd, p);
    v[p] = w;
#pragma unroll
    for (int i = p + 1; i < NB; ++i)
      v[i] = fma(-(double)l(k0 + i, k0 + p), w, v[i]);
  }
  if (lane < 16) {
#pragma unroll
    for (int i = 0; i < NB; ++i) x[xat(k0 + i, k0 + c)] = v[i];
  }
}

// (2): block (q, j) of step p: B_qj -= L_qp W_pj; for q = p + 1 then
// W_qj = W_qq B_qj, in place.
template <typename LAt, typename XAt>
__device__ void subst_block(LAt l, double* x, XAt xat, int p, int q, int j,
                            int lane) {
  const int r0 = q * NB, c0 = j * NB, k0 = p * NB;
  double acc[2][4];
  for_acc(acc, lane, [&](int r, int c, double& v) {
    v = x[xat(r0 + r, c0 + c)];
  });
  mma_block(
      acc, [&](int r, int k) { return -(double)l(r0 + r, k0 + k); },
      [&](int k, int c) { return x[xat(k0 + k, c0 + c)]; }, lane);
  if (q == p + 1) {
    for_acc(acc, lane, [&](int r, int c, double& v) {
      x[xat(r0 + r, c0 + c)] = v;
      v = 0.0;
    });
    __syncwarp();
    mma_block(
        acc, [&](int r, int k) { return x[xat(r0 + r, r0 + k)]; },
        [&](int k, int c) { return x[xat(r0 + k, c0 + c)]; }, lane);
    __syncwarp();
  }
  for_acc(acc, lane, [&](int r, int c, double& v) {
    x[xat(r0 + r, c0 + c)] = v;
  });
}

// (3): block (I, C), C <= I, of inv = W^T W: sum over R >= I of
// W_RI^T W_RC, handed to out(i, c, v) for c <= i (which writes (i, c) and
// (c, i)).
template <typename XAt, typename Out>
__device__ void product_block(const double* x, XAt xat, Out out, int I, int C,
                              int np, int lane) {
  const int i0 = I * NB, c0 = C * NB;
  double acc[2][4] = {};
  for (int R = I; R < np; ++R) {
    const int k0 = R * NB;
    mma_block(
        acc, [&](int r, int k) { return x[xat(k0 + k, i0 + r)]; },
        [&](int k, int c) { return x[xat(k0 + k, c0 + c)]; }, lane);
  }
  for_acc(acc, lane, [&](int r, int c, double& v) {
    const int i = i0 + r, j = c0 + c;
    if (j <= i) out(i, j, (float)v);
  });
}

// (2) and (3) of the inverse, W = L^-1 at x (its diagonal blocks already
// inverted, the blocks below them zero), inv = W^T W handed to out.  All
// THREADS threads call.
template <typename LAt, typename XAt, typename Out>
__device__ void inverse_steps(LAt l, double* x, XAt xat, Out out, int np) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int p = 0; p + 1 < np; ++p) {
    const int nj = p + 1;
    for (int idx = warp; idx < (np - 1 - p) * nj; idx += WARPS)
      subst_block(l, x, xat, p, p + 1 + idx / nj, idx % nj, lane);
    __syncthreads();
  }
  // blocks (I, C) by rows, I ascending (a row's blocks take np - I
  // products), dealt to the warps back and forth
  for (int u = 0, I = 0, C = 0; I < np; ++u) {
    const int round = u / WARPS, w = u % WARPS;
    if ((round & 1 ? WARPS - 1 - w : w) == warp)
      product_block(x, xat, out, I, C, np, lane);
    if (++C > I) C = 0, ++I;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 1)
gmm_inverse_kernel(const float* __restrict__ L, float* __restrict__ inv,
                   int d) {
  extern __shared__ double x[];  // [dp][MAXD] (at64): W = L^-1
  const int b = blockIdx.x, t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int dp = padded(d), np = dp / NB, dd = d * d;
  float* l = reinterpret_cast<float*>(x + dp * MAXD);  // (at32): L, then inv
  float* st = reinterpret_cast<float*>(x);  // L[b], staged where W goes
  stage(st, L + (size_t)b * dd, dd, t);
  __syncthreads();
  for (int i = warp; i < d; i += WARPS) {
    float v[MAXD / 32];  // the row's loads first: st and l may alias
#pragma unroll
    for (int q = 0; q < MAXD / 32; ++q)
      if (lane + 32 * q <= i) v[q] = st[i * d + lane + 32 * q];
#pragma unroll
    for (int q = 0; q < MAXD / 32; ++q)
      if (lane + 32 * q <= i) l[at32(i, lane + 32 * q)] = v[q];
  }
  pad_identity<float, at32>(l, d, dp, warp, lane);
  __syncthreads();
  // W's blocks below the block diagonal start as the identity's: zero
  for (int i = NB + warp; i < dp; i += WARPS) {
#pragma unroll
    for (int q = 0; q < MAXD / 32; ++q)
      if (lane + 32 * q < i / NB * NB) x[at64(i, lane + 32 * q)] = 0.0;
  }
  __syncthreads();
  const auto lat = [&](int r, int c) { return l[at32(r, c)]; };
  if (warp < np) diag_inverse(lat, x, SharedAt{}, warp * NB, lane);
  __syncthreads();
  inverse_steps(lat, x, SharedAt{}, [&](int i, int j, float v) {
    l[at32(i, j)] = l[at32(j, i)] = v;
  }, np);
  float* out = inv + (size_t)b * dd;
  for (int i = warp; i < d; i += WARPS) {
    float v[MAXD / 32];
#pragma unroll
    for (int q = 0; q < MAXD / 32; ++q)
      if (lane + 32 * q < d) v[q] = l[at32(i, lane + 32 * q)];
#pragma unroll
    for (int q = 0; q < MAXD / 32; ++q)
      if (lane + 32 * q < d) out[i * d + lane + 32 * q] = v[q];
  }
}

// The inverse for d > MAXD: what gmm_inverse_kernel computes, with W held
// in global memory (`work`, [nmat][dp][dp] f64) and L read from its input
// (the identity past d), inv written straight to the output.
__global__ void __launch_bounds__(THREADS, 1)
gmm_inverse_global_kernel(const float* __restrict__ L,
                          float* __restrict__ inv, int d, double* work) {
  const int b = blockIdx.x, t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int dp = padded(d), np = dp / NB;
  const GlobalAt xat{dp};
  double* x = work + (size_t)b * dp * dp;
  const float* lb = L + (size_t)b * d * d;
  float* out = inv + (size_t)b * d * d;
  const auto lat = [&](int r, int c) {
    return (r < d && c < d) ? lb[(size_t)r * d + c] : (r == c ? 1.0f : 0.0f);
  };
  // W's blocks below the block diagonal start as the identity's: zero
  for (int i = NB + warp; i < dp; i += WARPS)
    for (int j = lane; j < i / NB * NB; j += 32) x[xat(i, j)] = 0.0;
  for (int w = warp; w < np; w += WARPS)
    diag_inverse(lat, x, xat, w * NB, lane);
  __syncthreads();
  inverse_steps(lat, x, xat, [&](int i, int j, float v) {
    if (i < d && j < d) out[(size_t)i * d + j] = out[(size_t)j * d + i] = v;
  }, np);
}

size_t factor_smem(int d) {
  return (size_t)padded(d) * MAXD * sizeof(double) + (size_t)d * d * sizeof(float);
}

size_t inverse_smem(int d) {
  return (size_t)padded(d) * MAXD * (sizeof(double) + sizeof(float));
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
// f32; nk: [nmat] f32; info: [nmat] int32; work: f64 scratch of nmat
// [dp][dp] matrices for d > 128, dp = d rounded up to 16 (else unused,
// may be null); device pointers, d >= 1.  Launches on
// `stream`, does not synchronise; capture-safe.  Returns 0 or the launch's
// CUDA error code.
extern "C" int come_gmm_factor(const float* cov, const float* nk, float reg,
                               float* L, int* info, int nmat, int d,
                               double* work, void* stream) {
  if (d < 1 || nmat < 1 || (d > MAXD && work == nullptr))
    return (int)cudaErrorInvalidValue;
  if (d > MAXD)
    gmm_factor_global_kernel<<<nmat, THREADS, 0, (cudaStream_t)stream>>>(
        cov, nk, reg, L, info, d, work);
  else
    gmm_factor_kernel<<<nmat, THREADS, factor_smem(d),
                        (cudaStream_t)stream>>>(cov, nk, reg, L, info, d);
  return (int)cudaGetLastError();
}

// inv[b] = (L[b] L[b]^T)^-1 for b < nmat.  L, inv: [nmat, d, d] f32; work
// as come_gmm_factor's.
extern "C" int come_gmm_inverse(const float* L, float* inv, int nmat, int d,
                                double* work, void* stream) {
  if (d < 1 || nmat < 1 || (d > MAXD && work == nullptr))
    return (int)cudaErrorInvalidValue;
  if (d > MAXD)
    gmm_inverse_global_kernel<<<nmat, THREADS, 0, (cudaStream_t)stream>>>(
        L, inv, d, work);
  else
    gmm_inverse_kernel<<<nmat, THREADS, inverse_smem(d),
                         (cudaStream_t)stream>>>(L, inv, d);
  return (int)cudaGetLastError();
}
