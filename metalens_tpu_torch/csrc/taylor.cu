// Batched complex64 GEMM with a fused Paterson-Stockmeyer epilogue: the
// building block of the thin-slab Taylor factors.
//
// Replaces: metalens_tpu/solver/pallas_taylor.py::_taylor_kernel, which
// evaluates the cos / sinc / R series of Y0 = F G (sharing Y0's powers by
// Paterson-Stockmeyer chunking, t^{2k} folded into the coefficient table)
// and the wrapper products S F, G S and G (R F), all in one VMEM-resident
// kernel per matrix.  Here the host wrapper (solver/taylor.py) launches this
// kernel once per stage -- Y0, the powers, the Horner steps of the three
// series, the four wrapper products -- and each launch computes
//
//     C[b] = A[b] B[b] + sum_{m < n_terms} coef[b, off + m] * P_m[b]
//
// where P_0 = I and P_m (m >= 1) is the m-th stored power of Y0.  The sum is
// one Paterson-Stockmeyer chunk; with A = null the product is skipped (the
// top chunk of each series, which Horner starts from).
//
// What bounds it on an H100: an n = 100 complex product is 8 MFLOP against
// 240 KB of operands, so at the hot path's batch (~10^3 matrices per stage)
// the work is FLOP-bound on the f32 FMA pipes -- the tensor cores are not
// used here, so no TF32 rounding can enter.  The design is the classic
// shared-memory tiled GEMM: a 32 x 32 output tile per 256-thread block, each
// thread accumulating 2 x 2 complex outputs from 16-deep K slabs staged in
// shared memory, ragged edges masked in the loads and the store (no padding
// to a multiple of 8 as on the TPU).  The epilogue reads the powers once per
// output element, so a chunk costs one extra pass over s powers instead of a
// separate kernel per scalar-times-matrix add.
//
// Layout: row-major interleaved complex64 (float2); each operand has its own
// batch stride (in complex elements) so the wrapper can address one power
// inside its (batch, s, n, n) scratch.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kDepth = 16;
constexpr int kThreadsX = 16;
constexpr int kThreadsY = 16;

__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, fmaf(-a.y, b.y, acc.x));
  acc.y = fmaf(a.x, b.y, fmaf(a.y, b.x, acc.y));
}

__global__ void __launch_bounds__(kThreadsX * kThreadsY)
cgemm_ps_kernel(const float2* __restrict__ A, long long sA,
                const float2* __restrict__ B, long long sB,
                float2* __restrict__ C, long long sC, int n,
                const float* __restrict__ coef, int coef_stride, int coef_off,
                int n_terms, const float2* __restrict__ pows, long long sP) {
  __shared__ float2 As[kDepth][kTile + 1];   // As[k][i] = A[row0 + i][k0 + k]
  __shared__ float2 Bs[kDepth][kTile + 1];   // Bs[k][j] = B[k0 + k][col0 + j]
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const float2 zero = make_float2(0.f, 0.f);
  float2 acc[2][2] = {{zero, zero}, {zero, zero}};

  if (A != nullptr) {
    const float2* Ab = A + b * sA;
    const float2* Bb = B + b * sB;
    for (int k0 = 0; k0 < n; k0 += kDepth) {
      for (int e = tid; e < kTile * kDepth; e += kThreadsX * kThreadsY) {
        const int ai = e / kDepth, ak = e % kDepth;
        const int ar = row0 + ai, ac = k0 + ak;
        As[ak][ai] = (ar < n && ac < n) ? Ab[static_cast<long long>(ar) * n + ac] : zero;
        const int bk = e / kTile, bj = e % kTile;
        const int br = k0 + bk, bc = col0 + bj;
        Bs[bk][bj] = (br < n && bc < n) ? Bb[static_cast<long long>(br) * n + bc] : zero;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kDepth; ++k) {
        const float2 a0 = As[k][ty], a1 = As[k][ty + kThreadsY];
        const float2 b0 = Bs[k][tx], b1 = Bs[k][tx + kThreadsX];
        cfma(acc[0][0], a0, b0);
        cfma(acc[0][1], a0, b1);
        cfma(acc[1][0], a1, b0);
        cfma(acc[1][1], a1, b1);
      }
      __syncthreads();
    }
  }

  const long long nn = static_cast<long long>(n) * n;
#pragma unroll
  for (int di = 0; di < 2; ++di) {
#pragma unroll
    for (int dj = 0; dj < 2; ++dj) {
      const int i = row0 + ty + di * kThreadsY;
      const int j = col0 + tx + dj * kThreadsX;
      if (i >= n || j >= n) continue;
      float2 v = acc[di][dj];
      const long long ij = static_cast<long long>(i) * n + j;
      if (coef != nullptr && n_terms > 0) {
        const float* c = coef + static_cast<long long>(b) * coef_stride + coef_off;
        if (i == j) v.x += c[0];
        const float2* P = pows + b * sP + ij;
        for (int m = 1; m < n_terms; ++m) {
          const float2 p = P[(m - 1) * nn];
          v.x = fmaf(c[m], p.x, v.x);
          v.y = fmaf(c[m], p.y, v.y);
        }
      }
      C[b * sC + ij] = v;
    }
  }
}

}  // namespace

// C[b] = A[b] B[b] + sum_{m < n_terms} coef[b * coef_stride + coef_off + m] P_m[b]
// for b < batch, all matrices n x n complex64.  P_0 = I; P_m for m >= 1 is
// read at pows + b * sP + (m - 1) * n * n.  A == null skips the product;
// coef == null or n_terms == 0 skips the sum.  C must not alias A, B or the
// powers read.  Strides are in complex elements.  Returns the cudaError_t.
extern "C" int cgemm_ps_c64(const void* A, int sA, const void* B, int sB,
                            void* C, int sC, int n, int batch,
                            const void* coef, int coef_stride, int coef_off,
                            int n_terms, const void* pows, int sP,
                            void* stream) {
  if (n < 1 || batch < 0 || batch > 65535) return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  const int tiles = (n + kTile - 1) / kTile;
  const dim3 grid(tiles, tiles, batch);
  const dim3 block(kThreadsX, kThreadsY);
  cgemm_ps_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(A), sA, static_cast<const float2*>(B), sB,
      static_cast<float2*>(C), sC, n, static_cast<const float*>(coef),
      coef_stride, coef_off, n_terms, static_cast<const float2*>(pows), sP);
  return cudaGetLastError();
}
