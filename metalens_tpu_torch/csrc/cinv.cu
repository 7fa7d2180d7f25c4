// Batched explicit inverse of complex64 matrices by unpivoted Gauss-Jordan.
//
// Replaces: metalens_tpu/solver/pallas_inv.py::_inv_kernel (the TPU kernel
// behind cpx.solve), which inverts G matrices per grid step by 2x2 block
// recursion down to an unpivoted Gauss-Jordan base.  The recursion is
// algebraically that same elimination, so this kernel runs the elimination
// directly, with the same unpivoted contract: the caller guarantees
// well-conditioned leading blocks (the lossy EPS_REF doubling basis and the
// Hermitian positive-definite eps Toeplitz matrices of the RCWA hot path).
//
// What bounds it on an H100: one n x n elimination is n rank-1 updates, each
// a pass over the whole matrix with a barrier between passes, so the kernel
// is bound by the bandwidth of the memory that holds the working copy and by
// barrier latency -- not by FLOPs (8 n^3 flops per matrix).  The design keeps
// the working copy in shared memory: 8 n^2 bytes, 80 KB at n = 100 (two
// blocks per SM under the 227 KB opt-in limit), so device memory sees one
// read of A and one write of A^-1.  Matrices too large for shared memory
// (n >= 170, e.g. n = 200 at numG = 100) are eliminated in place in the
// output buffer in global memory, where the working set of the resident
// blocks stays in the 50 MB L2.  One thread block per matrix; the batch
// (cells x directions, ~10^3 on the hot path) fills the 132 SMs.
//
// Layout: row-major (batch, n, n) interleaved complex64 (float2), as torch
// stores complex64.  Plain f32 FMAs, no tensor cores.

#include <cuda_runtime.h>

namespace {

// Threads per block: 32 columns x kRows* rows of the matrix per pass.
// Measured on an H100 (700 W): rows 8 / 16 / 32 give 1.62 / 1.29 / 1.34 ms
// for 1024 inverses at n = 100 (shared), and rows 8 / 16 / 32 give 22.2 /
// 17.0 / 14.6 ms for 256 at n = 200 (global: more warps hide L2 latency).
constexpr int kBlockX = 32;
constexpr int kRowsShared = 16;
constexpr int kRowsGlobal = 32;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// In-place Gauss-Jordan inverse of the n x n matrix w (shared or global).
// Step k: with p = 1 / w[k][k], column c = w[:, k] and pivot row
// r = p * w[k, :] (r[k] = p), every entry becomes
//     w[k][j] = r[j],   w[i][j] = (j == k ? 0 : w[i][j]) - c[i] r[j]  (i != k)
// which leaves the inverse in w after n steps.
__device__ void gauss_jordan(float2* __restrict__ w, float2* __restrict__ col,
                             float2* __restrict__ row, int n) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int k = 0; k < n; ++k) {
    const float2 p = w[k * n + k];
    const float d = p.x * p.x + p.y * p.y;
    const float2 pinv = make_float2(p.x / d, -p.y / d);
    for (int i = tid; i < n; i += nthreads) {
      col[i] = w[i * n + k];
      const float2 r = (i == k) ? make_float2(1.f, 0.f) : w[k * n + i];
      row[i] = cmul(r, pinv);
    }
    __syncthreads();
    for (int i = threadIdx.y; i < n; i += blockDim.y) {
      const float2 c = col[i];
      float2* wi = w + i * n;
      if (i == k) {
        for (int j = threadIdx.x; j < n; j += blockDim.x) wi[j] = row[j];
      } else {
        for (int j = threadIdx.x; j < n; j += blockDim.x) {
          const float2 r = row[j];
          float2 v = (j == k) ? make_float2(0.f, 0.f) : wi[j];
          v.x = fmaf(-c.x, r.x, fmaf(c.y, r.y, v.x));
          v.y = fmaf(-c.x, r.y, fmaf(-c.y, r.x, v.y));
          wi[j] = v;
        }
      }
    }
    __syncthreads();
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kBlockX * (kShared ? kRowsShared : kRowsGlobal))
cinv_kernel(const float2* __restrict__ a, float2* __restrict__ out, int n) {
  extern __shared__ float2 smem[];
  const size_t nn = static_cast<size_t>(n) * n;
  float2* col = smem;
  float2* row = smem + n;
  float2* dst = out + blockIdx.x * nn;
  float2* w = kShared ? smem + 2 * n : dst;
  const float2* src = a + blockIdx.x * nn;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (size_t e = tid; e < nn; e += nthreads) w[e] = src[e];
  __syncthreads();
  gauss_jordan(w, col, row, n);
  if (kShared) {
    for (size_t e = tid; e < nn; e += nthreads) dst[e] = w[e];
  }
}

}  // namespace

// out[b] = inverse(a[b]) for b < batch; a and out are distinct device
// buffers of batch * n * n complex64.  Returns the cudaError_t of the launch.
extern "C" int cinv_c64(const void* a, void* out, int n, int batch,
                        void* stream) {
  if (n < 1 || n > 256 || batch < 0) return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t vec_bytes = 2 * static_cast<size_t>(n) * sizeof(float2);
  const size_t full_bytes = vec_bytes + static_cast<size_t>(n) * n * sizeof(float2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* pa = static_cast<const float2*>(a);
  float2* po = static_cast<float2*>(out);
  if (full_bytes <= static_cast<size_t>(optin)) {
    cudaError_t err = cudaFuncSetAttribute(
        cinv_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(full_bytes));
    if (err != cudaSuccess) return err;
    cinv_kernel<true><<<batch, dim3(kBlockX, kRowsShared), full_bytes, s>>>(
        pa, po, n);
  } else {
    cinv_kernel<false><<<batch, dim3(kBlockX, kRowsGlobal), vec_bytes, s>>>(
        pa, po, n);
  }
  return cudaGetLastError();
}
